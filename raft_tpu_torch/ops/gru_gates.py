"""Fused ConvGRU gate chains: the CUDA kernels' wrappers and their plain
versions (the port of ``raft_tpu/ops/pallas_gru.py:84-189``).

- :func:`gru_gate_rh`     -- ``sigmoid(r_raw) * h``
- :func:`gru_gate_blend`  -- ``(1-sigmoid(z_raw))*h + sigmoid(z_raw)*tanh(q_raw)``

Math is fp32 whatever the storage type, and each result has its
operand's dtype (fp32 or bf16), as in the JAX kernels.
``csrc/gru_gates.cu`` replaces ``_rh_fwd_kernel`` and ``_blend_fwd_kernel``
and their backward kernels ``_rh_bwd_kernel`` and ``_blend_bwd_kernel``.
:class:`GruGateRh` and :class:`GruGateBlend` are the
``torch.autograd.Function``s around them: they save only the raw inputs,
and the backward kernel recomputes sigmoid and tanh from them, as the
JAX ``custom_vjp`` does.

Launch: the operands are read in place as ``(B, inner)`` with a batch
stride each (a channel half of the convzr output, a channel slice of a
gradient).  The two forwards and the rh backward share one design and
one plan (:func:`gate_plan`): 16-byte vectors when every address, batch
stride and ``inner`` allow them (always at the model's 128- and
96-channel halves), one value per access otherwise, and a grid of one
wave of resident blocks that walk (sample, chunk) units; the blend
backward runs one value per thread.

A wrapper takes the plain versions (forward and backward) only for
tensors on the CPU.  For any other device it launches the kernel or
raises; nothing falls back.  ``LAUNCHES`` counts kernel launches,
forward and backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from raft_tpu_torch.obs import cost
from raft_tpu_torch.ops import build

LAUNCHES = {"gru_gate_rh": 0, "gru_gate_blend": 0, "gru_gate_rh_bwd": 0,
            "gru_gate_blend_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the vectorized gates' geometry (csrc/gru_gates.cu): GATE_THREADS a
# block, GATE_BLOCKS_PER_SM resident blocks an SM, and each kernel's
# vectors of every input in flight a thread (RH_FWD_UNROLL,
# BLEND_FWD_UNROLL, RH_BWD_UNROLL)
GATE_THREADS, GATE_BLOCKS_PER_SM = 256, 4
GATE_UNROLL = {"gru_gate_rh": 2, "gru_gate_blend": 1, "gru_gate_rh_bwd": 2}


def gru_gate_rh_plain(r_raw: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gru_gate_rh`."""
    return (torch.sigmoid(r_raw.float()) * h.float()).to(h.dtype)


def gru_gate_blend_plain(z_raw: torch.Tensor, q_raw: torch.Tensor,
                         h: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gru_gate_blend`."""
    sz = torch.sigmoid(z_raw.float())
    tq = torch.tanh(q_raw.float())
    return ((1.0 - sz) * h.float() + sz * tq).to(h.dtype)


def gru_gate_rh_bwd_plain(r_raw: torch.Tensor, h: torch.Tensor,
                          g: torch.Tensor):
    """Plain version of the rh backward: ``(dr, dh)`` from the raw inputs
    and the output gradient ``g``, fp32 math in ``_rh_bwd_kernel``'s
    operation order, each result in its operand's dtype."""
    s = torch.sigmoid(r_raw.float())
    gf = g.float()
    return ((gf * h.float() * s * (1.0 - s)).to(r_raw.dtype),
            (gf * s).to(h.dtype))


def gru_gate_blend_bwd_plain(z_raw: torch.Tensor, q_raw: torch.Tensor,
                             h: torch.Tensor, g: torch.Tensor):
    """Plain version of the blend backward: ``(dz, dq, dh)``, fp32 math in
    ``_blend_bwd_kernel``'s operation order, each result in its operand's
    dtype."""
    sz = torch.sigmoid(z_raw.float())
    tq = torch.tanh(q_raw.float())
    gf = g.float()
    return ((gf * (tq - h.float()) * sz * (1.0 - sz)).to(z_raw.dtype),
            (gf * sz * (1.0 - tq * tq)).to(q_raw.dtype),
            (gf * (1.0 - sz)).to(h.dtype))


def gate_plan(kernel: str, addresses, strides, inner: int, batch: int,
              itemsize: int, sm_count: int):
    """``(values per access, grid blocks)`` of a vectorized gate
    (``GATE_UNROLL``'s keys): 16-byte vectors when every base address
    (inputs and outputs), every input batch stride and ``inner`` (the
    outputs' batch stride), in bytes, is a multiple of 16, else one
    value; the grid is one wave of ``GATE_BLOCKS_PER_SM`` blocks per SM,
    or one block per unit of ``GATE_UNROLL[kernel] * GATE_THREADS``
    accesses when there are fewer."""
    vec = 16 // itemsize
    if any(a % 16 for a in addresses) or any(
            s * itemsize % 16 for s in (*strides, inner)):
        vec = 1
    chunk = GATE_UNROLL[kernel] * GATE_THREADS
    units = batch * -(-(inner // vec) // chunk)
    return vec, min(units, sm_count * GATE_BLOCKS_PER_SM)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fn(symbol: str, n_inputs: int, n_outputs: int):
    fn = getattr(build.load("gru_gates"), symbol)
    if fn.argtypes is None:
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        plan = [] if symbol == "gru_gate_blend_bwd" else [ci, ci]
        fn.argtypes = ([ci, ci] + [vp, ll] * n_inputs + [vp] * n_outputs
                       + [ll, ll] + plan + [vp])
        fn.restype = ci
    return fn


def _batch_strided(t: torch.Tensor):
    """``(t, batch stride)`` with each sample's block contiguous: a
    contiguous tensor or a channel split of one is read in place; any
    other layout (channels-last, say) is copied to a contiguous one."""
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            t = t.contiguous()
            break
        expect *= size
    return t, (t.stride(0) if t.shape[0] > 1 else t[0].numel())


def _launch(name: str, inputs, h: torch.Tensor, n_outputs: int = 1):
    """Launch kernel ``name`` on same-shape, same-dtype operands (batch
    strided, read in place); returns its ``n_outputs`` contiguous results
    in ``h``'s dtype."""
    build.check_device(name, *inputs)
    if h.dim() < 1:
        raise ValueError(f"{name}: expected at least one dimension")
    for t in inputs:
        if t.shape != h.shape or t.dtype != h.dtype or t.device != h.device:
            raise ValueError(
                f"{name}: operands must share shape, dtype and device; got "
                f"{tuple(t.shape)} {t.dtype} {t.device} against "
                f"{tuple(h.shape)} {h.dtype} {h.device}")
    if h.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {h.dtype} not in float32/bfloat16")
    outs = [torch.empty(h.shape, dtype=h.dtype, device=h.device)
            for _ in range(n_outputs)]
    total = h.numel()
    if total == 0:
        return outs
    inputs = [_batch_strided(t) for t in inputs]
    args = []
    for t, s in inputs:
        args += [t.data_ptr(), s]
    symbol = name if name.endswith("_bwd") else name + "_fwd"
    inner = total // h.shape[0]
    index = h.device.index or 0
    plan = []
    if name in GATE_UNROLL:
        plan = gate_plan(
            name,
            [t.data_ptr() for t, _ in inputs] + [o.data_ptr() for o in outs],
            [s for _, s in inputs], inner, h.shape[0], h.element_size(),
            _sm_count(index))
    rc = _fn(symbol, len(inputs), n_outputs)(
        index, _DTYPE_CODES[h.dtype], *args, *[o.data_ptr() for o in outs],
        inner, total, *plan, build.stream_handle(h))
    build.check_status(name, rc)
    LAUNCHES[name] += 1
    if cost.counting_active() and name in ("gru_gate_rh", "gru_gate_blend"):
        # the JAX package's formula for its fused gate forward (a cost
        # count cannot see a ctypes launch; the backwards count zero)
        cost.note_analytic(name, *cost.analytic_gru_gate_cost(
            h.shape, name[len("gru_gate_"):], h.element_size()))
    return outs


class GruGateRh(torch.autograd.Function):
    """``(r_raw, h) -> sigmoid(r_raw) * h``; saves the raw inputs only.
    The kernels on the card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, r_raw, h):
        ctx.save_for_backward(r_raw, h)
        if h.device.type == "cpu":
            return gru_gate_rh_plain(r_raw, h)
        return _launch("gru_gate_rh", [r_raw, h], h)[0]

    @staticmethod
    def backward(ctx, g):
        r_raw, h = ctx.saved_tensors
        if h.device.type == "cpu":
            return gru_gate_rh_bwd_plain(r_raw, h, g)
        return tuple(_launch("gru_gate_rh_bwd", [r_raw, h, g], h, 2))


class GruGateBlend(torch.autograd.Function):
    """``(z_raw, q_raw, h) -> (1-s(z))h + s(z)tanh(q)``; saves the raw
    inputs only.  The kernels on the card, the plain versions on the
    CPU."""

    @staticmethod
    def forward(ctx, z_raw, q_raw, h):
        ctx.save_for_backward(z_raw, q_raw, h)
        if h.device.type == "cpu":
            return gru_gate_blend_plain(z_raw, q_raw, h)
        return _launch("gru_gate_blend", [z_raw, q_raw, h], h)[0]

    @staticmethod
    def backward(ctx, g):
        z_raw, q_raw, h = ctx.saved_tensors
        if h.device.type == "cpu":
            return gru_gate_blend_bwd_plain(z_raw, q_raw, h, g)
        return tuple(_launch("gru_gate_blend_bwd", [z_raw, q_raw, h, g], h,
                             3))


def gru_gate_rh(r_raw: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Fused ``sigmoid(r_raw) * h`` (the reset-gated hidden state);
    ``r_raw`` is the r half of the convzr output before the sigmoid."""
    return GruGateRh.apply(r_raw, h)


def gru_gate_blend(z_raw: torch.Tensor, q_raw: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """Fused GRU hidden-state blend
    ``(1-sigmoid(z_raw))*h + sigmoid(z_raw)*tanh(q_raw)`` from the raw
    (pre-sigmoid / pre-tanh) conv outputs."""
    return GruGateBlend.apply(z_raw, q_raw, h)
