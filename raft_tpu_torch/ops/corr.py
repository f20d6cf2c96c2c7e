"""Correlation volumes and window lookups: the plain PyTorch paths (the
port of ``raft_tpu/ops/corr.py:188-435``).

- ``'allpairs'``: :func:`build_corr_pyramid` materializes
  ``<f1(x), f2(y)> / sqrt(C)`` for every pair of 1/8-res pixels and
  average-pools it over the target dims; :func:`corr_lookup` samples the
  bilinear ``(2r+1)^2`` window around ``coords / 2^l`` at each level.
- ``'chunked'``: :func:`chunked_corr_lookup` never materializes the
  volume; per block of queries it correlates against the pooled target
  features (:func:`pool_fmap_pyramid`) and samples the windows.  Pooling
  is linear, so both paths compute the same function.  It is the plain
  version of the on-demand CUDA kernel (``ops/corr_kernels.py``).

Window sampling is written as two dense 1-D interpolation-weight
products, as in the JAX package; the semantics are those of
``grid_sample(align_corners=True, padding_mode='zeros')``.

Pyramid layout.  The materialized pyramid is query-major, level l being
``(B, N, H/2^l, W/2^l)`` with ``N = H*W`` queries, for both ``'allpairs'``
and ``'allpairs_pallas'``: the two configurations share one pyramid build
and differ only in the lookup.  On the GPU each query's correlation row is
then contiguous, so the lookup kernel reads each window as a few short
runs and its backward writes each query's dense ``dcorr`` row coalesced,
without atomics and without query padding.  The JAX package's
``build_corr_pyramid_flat`` stores the same values query-minor,
``(B, Hl, Wl, Npad)`` with N padded to a multiple of 128, because the TPU
wants queries in its 128 lanes; ``level.permute(0, 3, 1, 2)[:, :N]`` of
that layout is this one.  Levels are stored in ``out_dtype`` (the
config's ``corr_dtype``); the volume and its pooling are computed in fp32
and the lookups accumulate in fp32.

Quantized storage (the port of ``raft_tpu/ops/corr.py:77-169``).  With a
quantized ``out_dtype`` (int8, fp8 e4m3fn or e5m2) each level is a
:class:`QuantizedLevel`: codes ``q = clip(round(corr / scale))`` in the
level's layout and one symmetric fp32 scale per batch element, calibrated
from the level's largest magnitude.  Sampling is linear in the stored
values, so a lookup samples the codes in fp32 and multiplies the taps by
the scale; no dequantized volume is made.  The quantize step is detached:
codes have no tangent space, so no gradient flows through the volume to
the feature encoder (as in the JAX package, which stop-gradients it).

Precision (``corr_precision``, JAX's vocabulary).  The volume's matrix
product and the two products of the window sampling run at the
precision asked for, in forward and in backward, as XLA runs them on a
GPU: ``'highest'`` (and ``'auto'``) full fp32, ``'high'`` and
``'default'`` TF32.  ``'highest'`` is the plain product, fp32 because
every entry point turns cuBLAS TF32 off (``config.entry_precision``).
On the CPU every value computes fp32, as XLA:CPU does.  The CUDA
kernels (``ops/corr_kernels.py``, ``ops/pyramid_kernels.py``,
``ops/lookup_encode.py``) compute in fp32 whatever the value; only the
materialized pyramid's volume, built here, follows it on their paths.

Tap-order contract: the output channel is ``l * k^2 + i * k + j`` with
``k = 2r+1``, where ``i`` walks x (displacement ``i - r``) and ``j`` walks
y.  Public functions take and return the JAX layout: NHWC feature maps,
``(B, H, W, 2)`` coords with ``(x, y)`` last, ``(B, H, W, L*k^2)`` taps.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from raft_tpu_torch.parallel import mesh as mesh_mod

CORR_PRECISIONS = ("auto", "default", "high", "highest")


def validate_corr_precision(value: str,
                            flag: str = "corr_precision") -> str:
    """``value`` if it names a correlation precision, else a
    ``ValueError`` naming the allowed set (JAX's message)."""
    if value not in CORR_PRECISIONS:
        raise ValueError(
            f"invalid {flag}={value!r}; allowed: "
            f"{', '.join(CORR_PRECISIONS)}")
    return value


@contextlib.contextmanager
def _matmul_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` (same batch dims) on the card with cuBLAS TF32 on for the
    forward and the backward products alike."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with _matmul_tf32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _matmul_tf32():
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                gb = torch.matmul(a.transpose(-1, -2), g)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str = "highest") -> torch.Tensor:
    """``a @ b`` at ``precision``: TF32 on the card for ``'high'`` and
    ``'default'``; otherwise (and on the CPU) the plain product, fp32
    under the entry points' cuBLAS setting (``config.entry_precision``)."""
    if (validate_corr_precision(precision) in ("default", "high")
            and a.device.type == "cuda"):
        return _TF32Matmul.apply(a, b)
    return torch.matmul(a, b)


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor,
                          precision: str = "highest") -> torch.Tensor:
    """``(B, H1, W1, C) x (B, H2, W2, C) -> (B, H1*W1, H2, W2)`` fp32
    volume.  The two grids may differ: a shard of the image's rows
    correlates its queries against the whole ``fmap2``."""
    B, H1, W1, C = fmap1.shape
    _, H2, W2, _ = fmap2.shape
    f1 = fmap1.reshape(B, H1 * W1, C).float()
    f2 = fmap2.reshape(B, H2 * W2, C).float()
    corr = matmul(f1, f2.transpose(1, 2), precision) * (1.0 / math.sqrt(C))
    return corr.reshape(B, H1 * W1, H2, W2)


def _avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pool over the last two dims of ``(B, N, H, W)``;
    an odd trailing row/col is dropped (torch ``avg_pool2d``)."""
    B, N, H, W = x.shape
    H2, W2 = H // 2, W // 2
    x = x[:, :, :H2 * 2, :W2 * 2].reshape(B, N, H2, 2, W2, 2)
    return x.sum(dim=(3, 5)) * 0.25


class QuantizedLevel(NamedTuple):
    """One quantized pyramid level: ``values`` are the codes in the
    level's layout ``(B, N, Hl, Wl)`` (int8 or fp8), ``scale`` is
    ``(B, 1, 1, 1)`` fp32 with ``corr ~ values * scale``."""

    values: torch.Tensor
    scale: torch.Tensor


CorrLevel = Union[torch.Tensor, QuantizedLevel]

# name -> (code dtype, qmax): qmax is the largest magnitude the codes
# represent (127 for int8, the finite maximum for the fp8 formats), so the
# scale maps the level's largest magnitude onto the top of the code range.
_QUANT_SPECS = {
    "int8": (torch.int8, 127.0),
    "float8_e4m3fn": (torch.float8_e4m3fn, 448.0),
    "float8_e5m2": (torch.float8_e5m2, 57344.0),
}
_QUANT_NAMES = {dt: name for name, (dt, _) in _QUANT_SPECS.items()}


def corr_quant_spec(dtype: Union[str, torch.dtype]
                    ) -> Optional[Tuple[torch.dtype, float]]:
    """``(code dtype, qmax)`` of a quantized storage dtype, given by name or
    as a torch dtype; None for a plain one."""
    if isinstance(dtype, torch.dtype):
        dtype = _QUANT_NAMES.get(dtype)
    return _QUANT_SPECS.get(dtype)


def quantize_corr_level(corr: torch.Tensor,
                        spec: Tuple[torch.dtype, float]) -> QuantizedLevel:
    """Calibrate and quantize one fp32 level (detached): the largest
    magnitude per batch element, ``scale = max(amax, 1e-12) / qmax``,
    ``q = corr / scale``, rounded half to even for int8 only (the fp8
    casts round themselves), clipped to +-qmax and cast.  An empty level
    gives zeros with scale 1.  Under a mesh that splits the queries' rows
    the largest magnitude is the spatial group's, so every shard stores
    the whole volume's codes."""
    dtype, qmax = spec
    c = corr.detach().float()
    if c.numel() == 0:
        return QuantizedLevel(torch.zeros(c.shape, dtype=dtype,
                                          device=c.device),
                              torch.ones(c.shape[0], 1, 1, 1,
                                         device=c.device))
    amax = c.abs().amax(dim=(1, 2, 3), keepdim=True)
    mesh = mesh_mod.active_spatial()
    if mesh is not None:    # the whole image's queries share one scale
        mesh_mod.spatial_max_(amax, mesh)
    scale = torch.clamp(amax, min=1e-12) / qmax
    q = c / scale
    if not dtype.is_floating_point:
        q = torch.round(q)
    return QuantizedLevel(torch.clamp(q, -qmax, qmax).to(dtype), scale)


def dequantize_level(level: CorrLevel) -> torch.Tensor:
    """fp32 view of a level (tests; the lookups never make one)."""
    if isinstance(level, QuantizedLevel):
        return level.values.float() * level.scale
    return level.float()


def _store_level(corr: torch.Tensor, out_dtype) -> CorrLevel:
    """One fp32 level in its storage form: cast, or quantized."""
    spec = corr_quant_spec(out_dtype)
    if spec is not None:
        return quantize_corr_level(corr, spec)
    return corr.to(out_dtype)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4,
                       out_dtype: Union[str, torch.dtype] = torch.float32,
                       precision: str = "highest") -> List[CorrLevel]:
    """Materialized pyramid: level l is ``(B, H1*W1, H/2^l, W/2^l)``,
    pooled in fp32 and stored in ``out_dtype``: fp32 or bf16, or a
    quantized dtype (``torch.int8``, ``torch.float8_e4m3fn``,
    ``torch.float8_e5m2`` or their names), which gives
    :class:`QuantizedLevel` levels.  The volume's product runs at
    ``precision``."""
    corr = all_pairs_correlation(fmap1, fmap2, precision)
    pyramid = [_store_level(corr, out_dtype)]
    for _ in range(num_levels - 1):
        corr = _avg_pool_2x2(corr)
        pyramid.append(_store_level(corr, out_dtype))
    return pyramid


def _interp_weights_1d(c: torch.Tensor, n: int,
                       radius: int) -> torch.Tensor:
    """Dense bilinear weights ``w[..., t, p] = max(0, 1 - |c + t - r - p|)``
    for positions ``p in [0, n)``: at most two nonzero weights per tap,
    all-zero rows for taps outside the image (zeros padding)."""
    k = 2 * radius + 1
    taps = torch.arange(k, dtype=torch.float32, device=c.device) - radius
    pos = torch.arange(n, dtype=torch.float32, device=c.device)
    return torch.clamp(
        1.0 - torch.abs(c[..., None, None] + taps[:, None] - pos), min=0.0)


def _sample_windows(corr: torch.Tensor, coords: torch.Tensor,
                    radius: int, precision: str = "highest") -> torch.Tensor:
    """Bilinear window sampling of one level.

    Args:
      corr: ``(B, N, H, W)`` correlation rows of N query pixels.
      coords: ``(B, N, 2)`` query centers in this level's pixel units.

    Returns:
      ``(B, N, (2r+1)^2)`` taps, x-major.
    """
    B, N, H, W = corr.shape
    k = 2 * radius + 1
    c = coords.float()
    wx = _interp_weights_1d(c[..., 0], W, radius)       # (B, N, k, W)
    wy = _interp_weights_1d(c[..., 1], H, radius)       # (B, N, k, H)
    a = matmul(wy, corr.float(), precision)             # (B, N, k_j, W)
    taps = matmul(wx, a.transpose(-1, -2), precision)   # (B, N, k_i, k_j)
    return taps.reshape(B, N, k * k)


def corr_lookup(pyramid: Sequence[CorrLevel], coords: torch.Tensor,
                radius: int, precision: str = "highest") -> torch.Tensor:
    """Sample the materialized pyramid at ``(B, H1, W1, 2)`` level-0
    coords -> ``(B, H1, W1, levels * (2r+1)^2)`` fp32.  A quantized level's
    codes are sampled in fp32 and its taps multiplied by its scale."""
    B, H1, W1, _ = coords.shape
    c = coords.reshape(B, H1 * W1, 2).float()
    outs = []
    for lvl, corr in enumerate(pyramid):
        if isinstance(corr, QuantizedLevel):
            taps = _sample_windows(corr.values, c / (2.0 ** lvl), radius,
                                   precision)
            outs.append(taps * corr.scale.reshape(B, 1, 1))
        else:
            outs.append(_sample_windows(corr, c / (2.0 ** lvl), radius,
                                        precision))
    return torch.cat(outs, dim=-1).reshape(B, H1, W1, -1)


def pool_fmap_pyramid(fmap2: torch.Tensor,
                      num_levels: int) -> List[torch.Tensor]:
    """Pooled target features ``(B, H_l, W_l, C)`` per level; an odd
    trailing row/col is dropped, so a level may be empty."""
    levels = [fmap2]
    cur = fmap2
    for _ in range(num_levels - 1):
        B, H, W, C = cur.shape
        H2, W2 = H // 2, W // 2
        cur = cur[:, :H2 * 2, :W2 * 2].reshape(B, H2, 2, W2, 2, C)
        cur = cur.sum(dim=(2, 4)) * 0.25
        levels.append(cur)
    return levels


def chunked_corr_lookup(fmap1: torch.Tensor,
                        fmap2_pyramid: Sequence[torch.Tensor],
                        coords: torch.Tensor, radius: int,
                        block_size: int = 256,
                        precision: str = "highest") -> torch.Tensor:
    """On-demand blockwise correlation lookup.

    For each block of ``block_size`` query pixels: correlate against each
    pooled ``f2`` level, sample the window, discard the rows.

    Args:
      fmap1: ``(B, H1, W1, C)`` query features.
      fmap2_pyramid: from :func:`pool_fmap_pyramid`.
      coords: ``(B, H1, W1, 2)`` level-0 centers, ``(x, y)`` last.

    Returns:
      ``(B, H1, W1, levels * (2r+1)^2)`` fp32.
    """
    B, H1, W1, C = fmap1.shape
    N = H1 * W1
    scale = 1.0 / math.sqrt(C)
    f1 = fmap1.reshape(B, N, C).float()
    c = coords.reshape(B, N, 2).float()
    f2_flat = [f2.float().reshape(B, f2.shape[1] * f2.shape[2], C)
               .transpose(1, 2) for f2 in fmap2_pyramid]
    blocks = []
    for n0 in range(0, N, block_size):
        f1_b, c_b = f1[:, n0:n0 + block_size], c[:, n0:n0 + block_size]
        outs = []
        for lvl, (f2, f2t) in enumerate(zip(fmap2_pyramid, f2_flat)):
            _, Hl, Wl, _ = f2.shape
            rows = matmul(f1_b, f2t, precision) * scale  # (B, bs, Hl*Wl)
            outs.append(_sample_windows(
                rows.reshape(B, f1_b.shape[1], Hl, Wl), c_b / (2.0 ** lvl),
                radius, precision))
        blocks.append(torch.cat(outs, dim=-1))
    return torch.cat(blocks, dim=1).reshape(B, H1, W1, -1)
