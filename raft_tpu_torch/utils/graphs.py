"""Captured programs: the port's counterpart of ``jax.jit``.

The JAX package runs its test-mode forward and its train step as compiled
programs, one per static key (shapes, dtypes, ``flow_init`` present or
not).  The port captures the same units as CUDA graphs and replays them,
so a call costs one graph launch on the host instead of one launch per
operation.  :class:`GraphCache` holds the graphs of one function, keyed
like a jit cache:

- **Key.** The caller's key (everything the graph bakes in that is not a
  tensor argument: iterations, train or test mode, the cuDNN and cuBLAS
  flags, the configuration) plus each tensor argument's shape, dtype and
  device.
- **Warm-up.** The first :data:`WARMUP_CALLS` calls of a key run eagerly,
  on the device's side stream, and are real calls: their results are
  returned and their effects (an optimizer update) kept.  They do the
  lazy first-use work a capture must not contain: the kernels' build and
  load, cuBLAS and cuDNN handles and workspaces for the stream, autograd's
  device thread.
- **Capture.** The next call captures ``fn`` on the side stream into a
  private memory pool (``capture_error_mode="thread_local"``, so that the
  training input pipeline's producer thread may go on copying batches on
  its own stream), records one :class:`CaptureCounter` event, and replays.
  A failed capture raises: there is no eager fallback.  The garbage
  collector is off during the capture: a dead reference cycle can hold
  another program's graph, and destroying a graph while a stream
  captures is refused and invalidates the capture.
- **Replay.** The tensor arguments are copied into the graph's static
  input buffers, the graph replays on the current stream, and the outputs
  are returned as clones, so that a result outlives the next replay
  (metrics kept for a logging window, a ``flow_low`` fed back as the
  next call's ``flow_init``).
- **Resident arguments.**  A program that owns large state (the
  serving engine's slot state: a correlation pyramid per lane) passes
  it as ``resident`` tensors: they are neither copied in nor cloned
  out; the graph reads and writes them in place at the addresses it
  captured, so their addresses are part of the key, and the caller
  keeps them alive and in place (a reset zeroes them, it does not
  reallocate).
- **Launch counters.** A kernel wrapper adds to its ``LAUNCHES`` count in
  Python, which runs only while the graph is captured.  The capture's
  increase is taken back (nothing ran) and added again on every replay,
  so the counts are the eager counts of the same calls.

The function must not read anything back to the host, and its Python
side effects happen once, at capture: host state (a step counter) is kept
outside it.  Random draws come from the generators passed in, which are
registered with the graph so that each replay draws fresh values.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Hashable, List, Optional, Sequence

import torch

from raft_tpu_torch.ops import add_launches, launch_counts
from raft_tpu_torch.utils.profiling import CaptureCounter

# Eager calls of a key before it is captured.
WARMUP_CALLS = 1

# One side stream per device for every cache's warm-up calls and
# captures: cuBLAS keeps a workspace for each stream it has run on until
# the process ends, so a stream per cache would grow memory with every
# eval_fn or train state.
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(dev: torch.device) -> "torch.cuda.Stream":
    stream = _SIDE_STREAMS.get(dev)
    if stream is None:
        stream = _SIDE_STREAMS[dev] = torch.cuda.Stream(device=dev)
    return stream


def _flatten(tree, leaves: List):
    """Append the tensors of ``tree`` (nested tuples, lists and dicts) to
    ``leaves``; returns a function that rebuilds the tree from a list of
    the same length."""
    if isinstance(tree, torch.Tensor):
        i = len(leaves)
        leaves.append(tree)
        return lambda xs: xs[i]
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t, leaves) for t in tree]
        return lambda xs: type(tree)(p(xs) for p in parts)
    if isinstance(tree, dict):
        parts = {k: _flatten(v, leaves) for k, v in tree.items()}
        return lambda xs: {k: p(xs) for k, p in parts.items()}
    return lambda xs: tree


def cache_key(key: Hashable, args: Sequence[torch.Tensor],
              resident: Sequence[torch.Tensor] = ()) -> tuple:
    """A graph's full key: the caller's key, each argument's shape, dtype
    and device, and each resident tensor's address besides (the graph
    reads and writes it there)."""
    return (key, tuple((tuple(a.shape), a.dtype, a.device) for a in args),
            tuple((r.data_ptr(), tuple(r.shape), r.dtype, r.device)
                  for r in resident))


class CapturedProgram:
    """One CUDA graph of ``fn`` on static copies of ``args`` and on the
    ``resident`` tensors themselves."""

    def __init__(self, fn: Callable, args: Sequence[torch.Tensor],
                 generators: Sequence[torch.Generator],
                 stream: torch.cuda.Stream,
                 resident: Sequence[torch.Tensor] = ()):
        self.static_in = [a.clone() for a in args]
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        before = launch_counts()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn(*self.static_in, *resident)
        finally:
            if enabled:
                gc.enable()
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        add_launches({k: -v for k, v in self.launches.items()})
        self.static_out: List[torch.Tensor] = []
        self._rebuild = _flatten(out, self.static_out)

    def __call__(self, args: Sequence[torch.Tensor]):
        for s, a in zip(self.static_in, args):
            s.copy_(a)
        self.graph.replay()
        add_launches(self.launches)
        return self._rebuild([o.clone() for o in self.static_out])


class GraphCache:
    """The captured programs of one function, one per key (see the module
    docstring); ``counter`` holds the capture events by key (a caller's
    own :class:`CaptureCounter` may be passed in)."""

    def __init__(self, counter: Optional[CaptureCounter] = None):
        self.counter = CaptureCounter() if counter is None else counter
        self._programs: Dict[Hashable, CapturedProgram] = {}
        self._eager: Dict[Hashable, int] = {}

    def __call__(self, key: Hashable, fn: Callable,
                 args: Sequence[torch.Tensor],
                 generators: Sequence[torch.Generator] = (),
                 resident: Sequence[torch.Tensor] = (),
                 ledger_key: Optional[Hashable] = None):
        """``fn(*args, *resident)``: eagerly for the key's first calls,
        then through its graph.  Every tensor is a CUDA tensor.  The
        capture is recorded under ``ledger_key`` when one is given, else
        under the full key."""
        key = cache_key(key, args, resident)
        prog = self._programs.get(key)
        if prog is None:
            dev = (list(args) + list(resident))[0].device
            side = _side_stream(dev)
            current = torch.cuda.current_stream(dev)
            side.wait_stream(current)
            if self._eager.get(key, 0) < WARMUP_CALLS:
                self._eager[key] = self._eager.get(key, 0) + 1
                with torch.cuda.stream(side):
                    out = fn(*args, *resident)
                current.wait_stream(side)
                return out
            prog = CapturedProgram(fn, args, generators, side, resident)
            self._programs[key] = prog
            self.counter.record(key if ledger_key is None else ledger_key)
        return prog(args)

    def warming(self, key: Hashable, args: Sequence[torch.Tensor],
                resident: Sequence[torch.Tensor] = ()) -> bool:
        """Whether the next call of ``key`` on these arguments runs
        eagerly (a warm-up call, not a capture or a replay)."""
        full = cache_key(key, args, resident)
        return (full not in self._programs
                and self._eager.get(full, 0) < WARMUP_CALLS)

    def drop(self, match: Callable[[Hashable], bool]) -> int:
        """Forget the programs (and eager-call counts) whose caller key
        ``match``es; their graphs, static buffers and private pools go
        with the last reference.  Returns how many graphs went."""
        gone = [k for k in self._programs if match(k[0])]
        for k in gone:
            del self._programs[k]
        for k in [k for k in self._eager if match(k[0])]:
            del self._eager[k]
        return len(gone)
