"""Cost-model observability: FLOPs/bytes accounting, MFU and roofline
classification per program (the port's copy of ``raft_tpu/obs/cost.py``).

Three pieces, as in the JAX package:

- **Normalization** (:data:`PEAK_SPECS`, :class:`ProgramCost`): a
  per-device-kind peak table (dense bf16 TFLOP/s + memory GB/s) turning
  (flops, bytes, seconds) into MFU, memory bandwidth utilization,
  arithmetic intensity and a compute- vs memory-bound verdict.  The
  H100 rows are NVIDIA's data-sheet figures; the CPU's peaks are
  *unknown*, so CPU MFU is ``None``, never a made-up number.
- **Extraction** (:func:`counting`): there is no compiled executable to
  ask, so the port counts the work of one real call while it runs: the
  first call of a train-step key, which runs eagerly anyway
  (``utils/graphs.GraphCache``).  FLOPs come from
  ``torch.utils.flop_counter.FlopCounterMode``; bytes from a dispatch
  mode that adds up every aten operator's operand and output bytes, an
  *unfused upper bound* (each operator reads its inputs from memory and
  writes its outputs back; a fused kernel moves less).  The CUDA kernels
  launched through ctypes are invisible to both: where the JAX package
  has a hand-derived formula (the fused GRU gates, the fused lookup +
  convc1) their wrappers add it through :func:`note_analytic`; every
  other hand-written kernel counts zero, as XLA counts a Pallas custom
  call on a TPU.  Such a cost's ``source`` is ``"counted"``.  Under a
  mesh the ranks' collectives run outside the count (:func:`uncounted`):
  a rank counts its own forward and backward, so ``flops_per_pair`` is
  the same at any world size.
- **Ledger** (:class:`CostBook`): ``raft_cost_*`` gauges and one
  ``cost_report`` event per program, refreshed with MFU from each
  measured call's wall time (host floats only).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Hashable, Iterator, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# per-device-kind peak specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PeakSpec:
    """Data-sheet peaks for one accelerator kind.  ``tflops`` is the
    dense bf16 rate (the compute dtype of the shipped paths);
    ``hbm_gbps`` the peak memory bandwidth.  ``None`` fields mean the
    peak is UNKNOWN: derived utilizations become ``None`` rather than a
    fabricated ratio."""

    kind: str
    tflops: Optional[float]
    hbm_gbps: Optional[float]

    @property
    def ridge(self) -> Optional[float]:
        """Roofline ridge point, flops/byte: programs with lower
        arithmetic intensity are memory-bound on this part."""
        if not self.tflops or not self.hbm_gbps:
            return None
        return self.tflops * 1e12 / (self.hbm_gbps * 1e9)


#: Peaks by normalized device kind.  The H100 rows are NVIDIA's H100
#: data sheet, dense (no sparsity) bf16 tensor-core rates at the full
#: power limit: SXM5 989.4 TFLOP/s and 3350 GB/s of HBM3, PCIe 756
#: TFLOP/s and 2000 GB/s of HBM2e.  The TPU rows are the JAX package's
#: table, kept so that a record from either package reads alike.  An
#: unknown kind degrades to unknown peaks, never to a wrong spec.
PEAK_SPECS: Dict[str, PeakSpec] = {
    "h100": PeakSpec("h100", 989.4, 3350.0),
    "h100-pcie": PeakSpec("h100-pcie", 756.0, 2000.0),
    "v5e": PeakSpec("v5e", 197.0, 819.0),
    "v4": PeakSpec("v4", 275.0, 1228.0),
    "cpu": PeakSpec("cpu", None, None),
}


def device_kind() -> str:
    """The current device's kind: ``torch.cuda.get_device_name(0)`` when a
    card is visible, else ``"cpu"``."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


def peak_spec(kind: Optional[str] = None) -> PeakSpec:
    """The :class:`PeakSpec` for a device kind (default:
    :func:`device_kind`).  Matching is normalized substring matching:
    ``NVIDIA H100 80GB HBM3`` is the SXM part, ``NVIDIA H100 PCIe`` the
    PCIe one; the H100 NVL (other peaks) stays unknown."""
    if kind is None:
        kind = device_kind()
    dk = str(kind).lower()
    if "h100" in dk:
        if "pcie" in dk:
            return PEAK_SPECS["h100-pcie"]
        if "nvl" not in dk:
            return PEAK_SPECS["h100"]
    if "v5e" in dk or "v5 lite" in dk or "v5lite" in dk:
        return PEAK_SPECS["v5e"]
    if "v4" in dk:
        return PEAK_SPECS["v4"]
    if "cpu" in dk:
        return PEAK_SPECS["cpu"]
    return PeakSpec(str(kind), None, None)


# ---------------------------------------------------------------------------
# the per-program record
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProgramCost:
    """Work accounting for ONE program.

    ``flops``/``bytes`` are per *call* on one device; ``pairs_per_call``
    is how many image pairs one call advances on this device (``None``
    for programs with no per-pair meaning).  ``source`` says where the
    numbers came from: ``counted`` (:func:`counting`), ``analytic``
    (hand-derived formula), or ``unavailable``; the JAX package's
    ``xla`` is never the port's.
    """

    program: str
    flops: float
    bytes: float
    transcendentals: float = 0.0
    pairs_per_call: Optional[float] = None
    source: str = "counted"
    device_kind: str = "unknown"
    interpret: bool = False

    @property
    def spec(self) -> PeakSpec:
        return peak_spec(self.device_kind)

    @property
    def arithmetic_intensity(self) -> Optional[float]:
        if self.bytes <= 0.0:
            return None
        return self.flops / self.bytes

    @property
    def bound_by(self) -> str:
        """Roofline verdict: ``compute`` / ``memory`` when both the
        program's intensity and the device ridge point are known,
        ``unknown`` otherwise (CPU, or a byte-less analytic entry)."""
        ai = self.arithmetic_intensity
        ridge = self.spec.ridge
        if ai is None or ridge is None:
            return "unknown"
        return "compute" if ai >= ridge else "memory"

    @property
    def flops_per_pair(self) -> Optional[float]:
        if not self.pairs_per_call:
            return None
        return self.flops / float(self.pairs_per_call)

    def achieved_tflops(self, seconds: float) -> Optional[float]:
        if seconds <= 0.0:
            return None
        return self.flops / seconds / 1e12

    def mfu(self, seconds: float) -> Optional[float]:
        """Model FLOP utilization in [0, 1] for one call taking
        ``seconds``; ``None`` when the peak is unknown (CPU)."""
        peak = self.spec.tflops
        at = self.achieved_tflops(seconds)
        if peak is None or at is None or self.interpret:
            return None
        return at / peak

    def hbm_bw_util(self, seconds: float) -> Optional[float]:
        peak = self.spec.hbm_gbps
        if peak is None or seconds <= 0.0 or self.interpret:
            return None
        return self.bytes / seconds / 1e9 / peak

    def as_record(self, seconds: Optional[float] = None) -> dict:
        """Flat JSON-ready dict (the ``cost_report`` event payload), the
        JAX package's keys."""
        spec = self.spec
        rec = {
            "program": self.program,
            "flops": self.flops,
            "bytes": self.bytes,
            "transcendentals": self.transcendentals,
            "source": self.source,
            "device_kind": self.device_kind,
            "interpret": self.interpret,
            "peak_tflops": spec.tflops,
            "peak_hbm_gbps": spec.hbm_gbps,
            "ridge_flops_per_byte": (round(spec.ridge, 2)
                                     if spec.ridge else None),
            "arithmetic_intensity": (round(self.arithmetic_intensity, 3)
                                     if self.arithmetic_intensity
                                     is not None else None),
            "bound_by": self.bound_by,
        }
        if self.pairs_per_call:
            rec["pairs_per_call"] = self.pairs_per_call
            rec["flops_per_pair"] = self.flops_per_pair
        if seconds is not None:
            rec["seconds"] = round(seconds, 6)
            at = self.achieved_tflops(seconds)
            rec["achieved_tflops"] = (round(at, 4) if at is not None
                                      else None)
            m = self.mfu(seconds)
            rec["mfu"] = round(m, 4) if m is not None else None
            bw = self.hbm_bw_util(seconds)
            rec["hbm_bw_util"] = (round(bw, 4) if bw is not None
                                  else None)
        return rec


# ---------------------------------------------------------------------------
# extraction: counting one real call
# ---------------------------------------------------------------------------

# The counters open now: a kernel wrapper's note_analytic adds to each.
# A list under a lock, not a thread-local: autograd runs a CUDA backward
# on a thread of its own.
_ACTIVE: list = []
_ACTIVE_LOCK = threading.Lock()


class Count:
    """What :func:`counting` saw: ``flops`` and ``bytes`` of the aten
    operators, ``analytic_flops`` and ``analytic_bytes`` that kernel
    wrappers noted, ``kernels`` (name -> calls noted)."""

    def __init__(self) -> None:
        self.flops = 0.0
        self.bytes = 0.0
        self.analytic_flops = 0.0
        self.analytic_bytes = 0.0
        self.kernels: Dict[str, int] = {}

    @property
    def total_flops(self) -> float:
        return self.flops + self.analytic_flops

    @property
    def total_bytes(self) -> float:
        return self.bytes + self.analytic_bytes


def counting_active() -> bool:
    """Whether a :func:`counting` window is open (the kernel wrappers skip
    their formula otherwise)."""
    return bool(_ACTIVE)


def note_analytic(kernel: str, flops: float, nbytes: float) -> None:
    """Add a hand-written kernel's analytic cost to every open count."""
    with _ACTIVE_LOCK:
        for c in _ACTIVE:
            c.analytic_flops += float(flops)
            c.analytic_bytes += float(nbytes)
            c.kernels[kernel] = c.kernels.get(kernel, 0) + 1


def _tensor_bytes(tree) -> int:
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


def _byte_mode(count: Count):
    """A dispatch mode that adds every aten operator's operand and output
    bytes to ``count.bytes`` (views move nothing and count zero)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Bytes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and func.namespace == "aten":
                n = _tensor_bytes(args) + _tensor_bytes(kwargs or {}) \
                    + _tensor_bytes(out)
                with _ACTIVE_LOCK:
                    count.bytes += n
            return out

    del torch
    return _Bytes()


@contextlib.contextmanager
def counting() -> Iterator[Count]:
    """Count the FLOPs and bytes of the work run inside the block (see the
    module docstring): ``with counting() as c: step(...)``, then
    ``c.total_flops`` / ``c.total_bytes``.  The block runs as it would
    otherwise, on the same device, with the same results."""
    from torch.utils.flop_counter import FlopCounterMode

    count = Count()
    flop_mode = FlopCounterMode(display=False)
    with _ACTIVE_LOCK:
        _ACTIVE.append(count)
    try:
        with flop_mode, _byte_mode(count):
            yield count
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE.remove(count)
        count.flops = float(flop_mode.get_total_flops())


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Run the block outside every open :func:`counting` window: the
    ranks' collectives (``parallel/mesh.py``, the step's reduction over
    ranks) are not the rank's own work, and the counting modes are not
    run around them.  With no window open (every call but a key's first,
    every capture) it only tests a list."""
    if not _ACTIVE:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        yield


def counted_cost(count: Count, *, program: str,
                 pairs_per_call: Optional[float] = None,
                 kind: Optional[str] = None) -> ProgramCost:
    """The :class:`ProgramCost` of a :func:`counting` window on the device
    of kind ``kind`` (default: :func:`device_kind`)."""
    return ProgramCost(
        program=program, flops=count.total_flops, bytes=count.total_bytes,
        pairs_per_call=pairs_per_call,
        source="counted" if count.total_flops or count.total_bytes
        else "unavailable",
        device_kind=str(kind if kind is not None else device_kind()))


# ---------------------------------------------------------------------------
# analytic formulas: the fused kernels (the JAX package's, unchanged)
# ---------------------------------------------------------------------------

# Block constants of the JAX package's Pallas kernels (ops/pallas_gru.py
# flattens to (256, 128) tiles; ops/pallas_corr.py pads queries to
# block_q and the convc1 contraction to (8, 128) tiles): the formulas
# keep them, so both packages report the same work for the same call.
_GRU_LANES = 128
_GRU_BLOCK_ROWS = 256


def _gru_padded_elems(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    rows = -(-n // _GRU_LANES)
    rows = -(-rows // _GRU_BLOCK_ROWS) * _GRU_BLOCK_ROWS
    return rows * _GRU_LANES


def analytic_gru_gate_cost(shape: Sequence[int], kind: str = "blend",
                           dtype_bytes: int = 4,
                           ) -> Tuple[float, float]:
    """``(flops, bytes)`` for one fused GRU gate call over operands of
    ``shape``, per padded element:

    - ``rh``    — ``sigmoid(r) * h``: 5 flops/elem; reads r+h, writes
      out (3 operands).
    - ``blend`` — ``(1-sz)*h + sz*tanh(q)``: 9 flops/elem; reads
      z+q+h, writes out (4 operands).
    """
    n = _gru_padded_elems(shape)
    if kind == "rh":
        return 5.0 * n, 3.0 * n * dtype_bytes
    if kind == "blend":
        return 9.0 * n, 4.0 * n * dtype_bytes
    raise ValueError(f"unknown gru gate kind {kind!r} "
                     "(expected 'rh' or 'blend')")


def analytic_lookup_encode_cost(batch: int,
                                level_hw: Sequence[Tuple[int, int]],
                                n_queries: int, radius: int,
                                features: int, block_q: int = 128,
                                pyramid_bytes: int = 4,
                                ) -> Tuple[float, float]:
    """``(flops, bytes)`` for one fused lookup -> convc1 call.

    Per level ``l`` with pooled shape ``(Hl, Wl)`` and ``k = 2r+1`` taps
    per axis, each of the ``Npad`` padded queries runs the y tap
    accumulation (``2 * k * Hl * Wl`` flops) and the x contraction
    (``2 * k * k * Wl``); the fused convc1 then contracts the
    ``kk_pad``-padded taps against ``Fpad`` features
    (``2 * kk_pad * Fpad + 2 * Fpad`` flops a query).  Bytes: every
    level's correlation block once a call (``pyramid_bytes`` per
    element), the coords, the weights once a query block, the output.
    """
    k = 2 * radius + 1
    L = max(len(level_hw), 1)
    kk = L * k * k
    kk_pad = -(-kk // 8) * 8
    fpad = -(-int(features) // 128) * 128
    npad = -(-int(n_queries) // block_q) * block_q
    nblocks = npad // block_q
    flops = 0.0
    byts = 0.0
    for hl, wl in level_hw:
        hl, wl = int(hl), int(wl)
        if hl <= 0 or wl <= 0:
            continue
        flops += npad * (2.0 * k * hl * wl + 2.0 * k * k * wl)
        byts += hl * wl * npad * float(pyramid_bytes)
    flops += npad * (2.0 * kk_pad * fpad + 2.0 * fpad)
    byts += 2 * npad * 4.0                      # coords (x, y) fp32
    byts += nblocks * kk_pad * fpad * 4.0       # weights re-read per block
    byts += npad * fpad * 4.0                   # output write
    return batch * flops, batch * byts


# ---------------------------------------------------------------------------
# cost book — the per-process ledger
# ---------------------------------------------------------------------------


class CostBook:
    """Thread-safe ledger of :class:`ProgramCost` entries keyed by program.

    ``stamp`` streams the capture out: ``raft_cost_*`` gauges into
    ``registry`` (labeled ``program=<name>``) and one ``cost_report``
    event into ``sink``.  ``observe`` attaches a measured wall time to a
    stamped program (MFU and bandwidth utilization become computable),
    refreshing the gauges and returning span-attachable attrs.
    Telemetry must never fail the workload: both swallow their own
    errors.
    """

    def __init__(self, registry=None, sink=None):
        self._lock = threading.Lock()
        self._costs: Dict[Hashable, ProgramCost] = {}
        self._registry = registry
        self._sink = sink

    def stamp(self, key: Hashable, cost: ProgramCost,
              emit: bool = True) -> ProgramCost:
        with self._lock:
            self._costs[key] = cost
        if emit:
            try:
                self._emit(cost)
            except Exception:
                pass
        return cost

    def get(self, key: Hashable) -> Optional[ProgramCost]:
        with self._lock:
            return self._costs.get(key)

    def table(self) -> Dict[Hashable, ProgramCost]:
        with self._lock:
            return dict(self._costs)

    def _emit(self, cost: ProgramCost,
              seconds: Optional[float] = None) -> None:
        if self._registry is not None:
            fpp = cost.flops_per_pair
            if fpp is not None:
                self._registry.gauge(
                    "raft_cost_flops_per_pair",
                    "FLOPs per image pair of the program (per device; "
                    "counted on its first call, with the analytic "
                    "formulas of the fused kernels)").set(
                        fpp, program=cost.program)
            if seconds is not None:
                m = cost.mfu(seconds)
                if m is not None:
                    self._registry.gauge(
                        "raft_cost_mfu",
                        "achieved / peak FLOP rate of the program's "
                        "last observed call (device-kind peak table; "
                        "absent on unknown peaks)").set(
                            m, program=cost.program)
                bw = cost.hbm_bw_util(seconds)
                if bw is not None:
                    self._registry.gauge(
                        "raft_cost_hbm_bw_util",
                        "achieved / peak memory bandwidth of the "
                        "program's last observed call (bytes an unfused "
                        "upper bound)").set(
                            bw, program=cost.program)
        if self._sink is not None and seconds is None:
            # the one-per-program capture event; observe() refreshes
            # gauges only (a per-call event would be per-step noise)
            self._sink.emit("cost_report", **cost.as_record())

    def observe(self, key: Hashable, seconds: float) -> dict:
        """Attach one measured call duration to a stamped program.
        Returns trace-span attrs (``flops``/``bytes`` always; ``mfu``
        when the peak is known), ``{}`` for an unstamped key."""
        cost = self.get(key)
        if cost is None:
            return {}
        try:
            self._emit(cost, seconds=seconds)
        except Exception:
            pass
        attrs = {"flops": cost.flops, "bytes": cost.bytes}
        m = cost.mfu(seconds)
        if m is not None:
            attrs["mfu"] = round(m, 4)
        return attrs
