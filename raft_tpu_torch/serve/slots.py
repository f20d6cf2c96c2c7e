"""Slot-state programs for iteration-granular continuous batching (the port
of ``raft_tpu/serve/slots.py``).

The serving engine (``serve/engine.py``) runs the forward pass as
separate programs over a persistent batch of ``S`` lanes instead of one
whole-request forward:

- ``enc`` (:func:`make_encode_fn`): the encode half
  (:meth:`RAFT.encode`) over the full slot batch, scattered into the
  lanes selected by ``admit`` (a ``(S,)`` bool mask); every other lane's
  state is kept.  Inference encoders are per-lane independent, so
  ballast in the lanes not admitted does not change the admitted lanes'
  bits.
- ``iter`` (:func:`make_iter_fn`): one GRU refinement iteration
  (:meth:`RAFT.iter_step`) over every lane, committed only where a lane
  is active.  The per-lane convergence predicate (the largest flow update
  below ``threshold``, SEA-RAFT-style early exit) and the iteration
  budget are decided in the program; a lane that retires turns inactive.
- ``up`` (:func:`make_upsample_fn`): the final upsample
  (:meth:`RAFT.upsample`) of every lane.  JAX upsamples inside its
  ``iter_step`` under a ``lax.cond`` when a lane retires; a CUDA graph
  cannot branch on data, so the host launches ``up`` after the iteration
  in which it reads a retiree (slot mode reads the lanes' status after
  every iteration anyway), and request mode launches it once after its
  last iteration.

The slot state is a dict with JAX's ten keys:

======================  ===========================  ====================
key                     shape / dtype                meaning
======================  ===========================  ====================
``active``              ``(S,) bool``                lane holds a request
``budget``              ``(S,) int32``               lane's max iterations
``converged``           ``(S,) bool``                early exit fired
``coords0``             ``(S, H/8, W/8, 2) fp32``    base grid
``coords1``             ``(S, H/8, W/8, 2) fp32``    current coordinates
``corr``                tuple of ``(S, ...)``        :meth:`RAFT.corr_state`
``delta_max``           ``(S,) fp32``                last largest update
``inp``                 ``(S, C, H/8, W/8)``         context features
``iters_done``          ``(S,) int32``               iterations consumed
``net``                 ``(S, C, H/8, W/8)``         GRU hidden state
======================  ===========================  ====================

(``net`` and ``inp`` are NCHW, the port's layout.)  JAX's programs are
pure (state in, new state out); the ``make_*_fn`` programs here write
the new state into the state (and carry) they are given, every leaf in
place.  :class:`SlotSet` keeps one ``(bucket, lanes)``'s state as
resident tensors: on the card every program is a captured CUDA graph
that reads and writes the state at its captured addresses
(``GraphCache``'s resident arguments), so an iteration never copies the
correlation state in or out.  A program's retry (``device_err``) finds
the state untouched, because the fault is raised before the program
runs.

Both serving modes drive the same programs (request mode in lockstep:
admit every lane, run exactly ``iters`` iterations with the threshold
off, upsample once), so slot mode returns request mode's bits.
``threshold`` is a runtime device scalar, as are the admit mask and
the budgets, so sweeping the threshold never captures again;
``threshold <= 0`` disables early exit (``delta_max`` is a max of norms,
hence ``>= 0``, and the predicate is a strict ``<``).

Streaming sessions add two programs over the same state and a separate
per-lane *carry* (``{"ctx", "fmap"}``, the previous frame's context and
feature map), which ``iter`` never reads:

- ``stash`` (:func:`make_stash_fn`): after a session's first (cold)
  pair is admitted through the unmodified ``enc``, stash frame 2's
  features into the lane's carry;
- ``wenc`` (:func:`make_warm_encode_fn`): admit frame N+1 with only the
  new image; ``fmap1`` and the context come from the carry, and the
  lane's previous flow (``coords1 - coords0``, kept since it retired) is
  forward-warped into the ``coords1`` init.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.config import RAFTConfig, backend_flags, entry_precision
from raft_tpu_torch.obs import cost as cost_mod
from raft_tpu_torch.ops.sampler import forward_warp_flow
from raft_tpu_torch.utils.graphs import GraphCache, _flatten
from raft_tpu_torch.utils.profiling import CaptureCounter

STATE_KEYS = ("active", "budget", "converged", "coords0", "coords1", "corr",
              "delta_max", "inp", "iters_done", "net")
CARRY_KEYS = ("ctx", "fmap")


def _lane_select(mask, new, old) -> None:
    """Write ``new`` into ``old`` in the lanes of ``mask`` (a ``(S,)``
    bool), broadcast over a ``(S, ...)`` leaf's trailing dims (leaves of
    any rank, including empty pyramid levels)."""
    m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
    torch.where(m, new, old, out=old)


def _pack_state(net, inp, coords0, coords1, corr, active, budget,
                converged, delta_max, iters_done) -> dict:
    return {"active": active, "budget": budget, "converged": converged,
            "coords0": coords0, "coords1": coords1, "corr": tuple(corr),
            "delta_max": delta_max, "inp": inp, "iters_done": iters_done,
            "net": net}


def _admit_state(admit, budgets, state, net, inp, coords0, coords1,
                 corr) -> None:
    """Admit the lanes of ``admit`` into ``state`` with fresh encode
    outputs (shared by the cold and the warm encode)."""
    for new, key in ((net, "net"), (inp, "inp"), (coords0, "coords0"),
                     (coords1, "coords1")):
        _lane_select(admit, new, state[key])
    for new, old in zip(corr, state["corr"]):
        _lane_select(admit, new, old)
    torch.logical_or(state["active"], admit, out=state["active"])
    _lane_select(admit, budgets.to(torch.int32), state["budget"])
    torch.logical_and(state["converged"], ~admit, out=state["converged"])
    state["delta_max"].masked_fill_(admit, -1.0)
    state["iters_done"].masked_fill_(admit, 0)


def _meta_model(model_cfg: RAFTConfig):
    from raft_tpu_torch.models.raft import RAFT

    with torch.device("meta"):
        return RAFT(model_cfg).eval()


def state_template(model_cfg: RAFTConfig, slots: int,
                   bucket_hw: Tuple[int, int], device="cpu") -> dict:
    """All-zeros slot state for ``slots`` lanes at bucket ``(H, W)`` on
    ``device`` (``delta_max`` -1: untouched).  Its leaves are shaped from
    the encode program run on meta tensors (JAX builds them from
    ``eval_shape``), so the correlation state's tensors cannot drift
    from what ``enc`` produces."""
    H, W = bucket_hw
    spec = torch.empty((slots, H, W, 3), device="meta")
    with torch.no_grad():
        net, inp, coords0, coords1, corr = _meta_model(model_cfg).encode(
            spec, spec)
    zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype,  # noqa: E731
                                  device=device)
    lanes = lambda dt: torch.zeros((slots,), dtype=dt,  # noqa: E731
                                   device=device)
    return _pack_state(
        zeros(net), zeros(inp), zeros(coords0), zeros(coords1),
        [zeros(c) for c in corr], lanes(torch.bool), lanes(torch.int32),
        lanes(torch.bool), torch.full((slots,), -1.0, device=device),
        lanes(torch.int32))


def carry_template(model_cfg: RAFTConfig, slots: int,
                   bucket_hw: Tuple[int, int], device="cpu") -> dict:
    """All-zeros streaming carry for ``slots`` lanes: the previous frame's
    feature map (``fmap``, fp32 NHWC) and context output (``ctx``, compute
    dtype), shaped from the stash program on meta tensors.  Kept outside
    the slot state: ``iter`` never reads it."""
    H, W = bucket_hw
    spec = torch.empty((slots, H, W, 3), device="meta")
    with torch.no_grad():
        fmap, ctx = _meta_model(model_cfg).frame_features(spec)
    return {"ctx": torch.zeros(ctx.shape, dtype=ctx.dtype, device=device),
            "fmap": torch.zeros(fmap.shape, dtype=fmap.dtype, device=device)}


def make_encode_fn(model):
    """``encode_admit(image1, image2, state, admit, budgets)``: encode
    both frames of every lane and admit the lanes of ``admit`` into
    ``state`` (with their ``budgets``)."""

    def encode_admit(image1, image2, state, admit, budgets) -> None:
        net, inp, coords0, coords1, corr = model.encode(image1, image2)
        _admit_state(admit, budgets, state, net, inp, coords0, coords1,
                     corr)

    return encode_admit


def make_stash_fn(model):
    """``stash_carry(image2, carry, admit)``: frame 2's features into the
    admitted lanes' carry.  One extra encoder pass per session (its first
    pair) buys the feature reuse of every warm frame."""

    def stash_carry(image2, carry, admit) -> None:
        fmap, ctx = model.frame_features(image2)
        _lane_select(admit, ctx, carry["ctx"])
        _lane_select(admit, fmap, carry["fmap"])

    return stash_carry


def make_warm_encode_fn(model):
    """``encode_warm(image2, carry, state, admit, budgets)``: the streaming
    admit.  For the lanes in ``admit``, frame 1 of the pair is the
    previous streamed frame, whose features come from the carry; the
    lane's previous flow is forward-warped into the ``coords1`` init, and
    the new frame's features become the carry."""

    def encode_warm(image2, carry, state, admit, budgets) -> None:
        flow_init = forward_warp_flow(state["coords1"] - state["coords0"])
        net, inp, coords0, coords1, corr, fmap2, ctx2 = model.encode_warm(
            image2, carry["fmap"], carry["ctx"], flow_init)
        # the state first: its correlation state may read the carried fmap
        _admit_state(admit, budgets, state, net, inp, coords0, coords1,
                     corr)
        _lane_select(admit, ctx2, carry["ctx"])
        _lane_select(admit, fmap2, carry["fmap"])

    return encode_warm


def make_iter_fn(model):
    """``iter_step(state, threshold)``: one iteration over the active
    lanes of ``state`` (inactive lanes keep their state bit for bit); a
    lane retires (turns inactive) when it converged or spent its
    budget."""

    def iter_step(state, threshold) -> None:
        active = state["active"]
        net, coords1 = model.iter_step(state["net"], state["coords1"],
                                       state["inp"], state["coords0"],
                                       state["corr"])
        m = active.reshape(-1, 1, 1, 1)
        coords1 = torch.where(m, coords1, state["coords1"])
        delta = coords1 - state["coords1"]
        dmax = torch.sqrt(torch.sum(delta * delta, dim=-1)).amax(dim=(1, 2))
        dmax = torch.where(active, dmax, state["delta_max"])
        iters_done = state["iters_done"] + active.to(torch.int32)
        converged = active & (dmax < threshold)
        done = active & (converged | (iters_done >= state["budget"]))
        # every new value is computed: now overwrite the state
        _lane_select(active, net, state["net"])
        for key, new in (("coords1", coords1), ("delta_max", dmax),
                         ("iters_done", iters_done),
                         ("converged", state["converged"] | converged),
                         ("active", active & ~done)):
            state[key].copy_(new)

    return iter_step


def make_upsample_fn(model):
    """``upsample(state) -> flow_up (S, H, W, 2)`` of every lane; the rows
    of the lanes that just retired are the ones a caller reads."""

    def upsample(state):
        return model.upsample(state["net"], state["coords1"]
                              - state["coords0"])

    return upsample


def _leaves(tree: dict, keys) -> List[torch.Tensor]:
    out = []
    for k in keys:
        v = tree[k]
        out.extend(v if isinstance(v, tuple) else (v,))
    return out


class SlotPrograms:
    """The slot programs of one inference model on its device, and how
    they run: eagerly on the CPU, and on the card each ``(program,
    bucket, lanes)`` as a captured graph (after the cache's one eager
    call) over the resident state of a :class:`SlotSet`, with no eager
    fallback.  ``counter`` records one event per ``(bucket, lanes,
    program)``: its capture on the card, its first run on the CPU.

    ``cost_book`` (an :class:`~raft_tpu_torch.obs.cost.CostBook`): each
    ``(bucket, lanes, program)``'s first call, eager on either device
    (the graph cache's warm-up call on the card, which a warm-start
    replay makes too), runs under :func:`~raft_tpu_torch.obs.cost.
    counting` on the thread that runs it (the engine's device worker)
    and is stamped as ``serve_<prog>_<H>x<W>_b<lanes>``.  The
    hand-written kernels are invisible to the count but where their
    wrappers add the JAX package's formula (the fused GRU gates): the
    on-demand lookup counts zero, as in the JAX package's serving
    costs."""

    def __init__(self, model, counter: Optional[CaptureCounter] = None,
                 cost_book=None):
        self.model = model
        self.device = next(model.parameters()).device
        self.counter = CaptureCounter() if counter is None else counter
        self.cost_book = cost_book
        self._graphs = (GraphCache(self.counter)
                        if self.device.type == "cuda" else None)
        self._seen = set()
        self.encode_admit = make_encode_fn(model)
        self.iter_step = make_iter_fn(model)
        self.upsample = make_upsample_fn(model)
        self.stash_carry = make_stash_fn(model)
        self.encode_warm = make_warm_encode_fn(model)

    def forget(self, bucket, lanes: int) -> None:
        """Drop the graphs of ``(bucket, lanes)`` (on the CPU, its first-run
        marks): the next set of that key captures, and is counted,
        anew."""
        key = (tuple(bucket), int(lanes))
        if self._graphs is not None:
            self._graphs.drop(lambda k: k[1][:2] == key)
        self._seen = {k for k in self._seen if k[:2] != key}

    def run(self, prog: str, bucket, lanes: int, fn, args: Sequence,
            resident: Sequence[torch.Tensor]):
        """``fn(*args, *resident)`` under ``torch.inference_mode`` and the
        entry-point precision; outputs are fresh tensors."""
        ledger = (tuple(bucket), int(lanes), prog)
        with torch.inference_mode(), entry_precision():
            key = (prog, ledger, backend_flags())
            if (self.cost_book is not None
                    and self.cost_book.get(ledger) is None
                    and (self._graphs is None
                         or self._graphs.warming(key, args, resident))):
                with cost_mod.counting() as count:
                    out = self._call(key, ledger, fn, args, resident)
                H, W = ledger[0]
                self.cost_book.stamp(ledger, cost_mod.counted_cost(
                    count, program=f"serve_{prog}_{H}x{W}_b{lanes}",
                    pairs_per_call=lanes,
                    kind="cpu" if self.device.type == "cpu" else None))
                return out
            return self._call(key, ledger, fn, args, resident)

    def _call(self, key, ledger, fn, args, resident):
        if self._graphs is not None:
            return self._graphs(key, fn, args, resident=resident,
                                ledger_key=ledger)
        if ledger not in self._seen:
            self._seen.add(ledger)
            self.counter.record(ledger)
        out = fn(*args, *resident)
        leaves: List[torch.Tensor] = []
        rebuild = _flatten(out, leaves)
        return rebuild([t.clone() for t in leaves])


class SlotSet:
    """One ``(bucket, lanes)``'s resident slot state (and, once a session
    streams, its carry) with the programs that update it in place (JAX's
    ``_Programs`` plus the state it passes in)."""

    def __init__(self, programs: SlotPrograms, bucket: Tuple[int, int],
                 lanes: int):
        self.programs = programs
        self.bucket = tuple(bucket)
        self.lanes = int(lanes)
        self.device = programs.device
        self.state = state_template(programs.model.config, lanes, bucket,
                                    self.device)
        self._n_corr = len(self.state["corr"])
        self._leaves = _leaves(self.state, STATE_KEYS)
        self.carry: Optional[Dict[str, torch.Tensor]] = None
        self.admit_all = torch.ones((lanes,), dtype=torch.bool,
                                    device=self.device)
        self.admit_none = torch.zeros_like(self.admit_all)
        # device scalars by value: a threshold crosses to the device once
        self._scalars: Dict[float, torch.Tensor] = {}

    # -- resident state -------------------------------------------------

    def _unflatten(self, leaves: Sequence[torch.Tensor]) -> dict:
        out, i = {}, 0
        for k in STATE_KEYS:
            if k == "corr":
                out[k] = tuple(leaves[i:i + self._n_corr])
                i += self._n_corr
            else:
                out[k] = leaves[i]
                i += 1
        return out

    def ensure_carry(self) -> None:
        """Allocate the zero carry (the first streamed pair)."""
        if self.carry is None:
            self.carry = carry_template(self.programs.model.config,
                                        self.lanes, self.bucket,
                                        self.device)

    def nbytes(self) -> int:
        """Bytes of the resident state and carry."""
        return sum(t.numel() * t.element_size() for t in
                   self._leaves + list((self.carry or {}).values()))

    def reset(self) -> None:
        """Zero the state (and carry) in place: the addresses the graphs
        captured stay valid."""
        with torch.inference_mode():
            for t in self._leaves:
                t.zero_()
            self.state["delta_max"].fill_(-1.0)
            for t in (self.carry or {}).values():
                t.zero_()

    def tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        """``x`` (a host array or a tensor) on the set's device."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device, dtype)

    # -- programs ---------------------------------------------------------

    def _enc(self, image1, image2, admit, budgets, *leaves):
        self.programs.encode_admit(image1, image2, self._unflatten(leaves),
                                   admit, budgets)

    def _iter(self, threshold, *leaves):
        state = self._unflatten(leaves)
        self.programs.iter_step(state, threshold)
        # (4, S): active, iters_done, converged, delta_max
        return torch.stack([state["active"].float(),
                            state["iters_done"].float(),
                            state["converged"].float(),
                            state["delta_max"]])

    def _up(self, *leaves):
        return self.programs.upsample(self._unflatten(leaves))

    def _stash(self, image2, admit, ctx, fmap):
        self.programs.stash_carry(image2, {"ctx": ctx, "fmap": fmap}, admit)

    def _wenc(self, image2, admit, budgets, ctx, fmap, *leaves):
        self.programs.encode_warm(image2, {"ctx": ctx, "fmap": fmap},
                                  self._unflatten(leaves), admit, budgets)

    def encode(self, image1, image2, admit, budgets) -> None:
        """Admit the lanes of ``admit`` (host arrays or tensors)."""
        self.programs.run(
            "enc", self.bucket, self.lanes, self._enc,
            [self.tensor(image1), self.tensor(image2),
             self.tensor(admit, torch.bool),
             self.tensor(budgets, torch.int32)], self._leaves)

    def iterate(self, threshold: float) -> torch.Tensor:
        """One iteration; returns the lanes' ``(4, S)`` fp32 status rows
        (active, iters_done, converged, delta_max) on the device."""
        thr = self._scalars.get(float(threshold))
        if thr is None:
            thr = self._scalars[float(threshold)] = self.tensor(threshold)
        return self.programs.run("iter", self.bucket, self.lanes,
                                 self._iter, [thr], self._leaves)

    def upsample(self) -> torch.Tensor:
        """``(S, H, W, 2)`` flow of every lane from its current state."""
        return self.programs.run("up", self.bucket, self.lanes, self._up,
                                 [], self._leaves)

    def stash(self, image2, admit) -> None:
        self.ensure_carry()
        self.programs.run(
            "stash", self.bucket, self.lanes, self._stash,
            [self.tensor(image2), self.tensor(admit, torch.bool)],
            [self.carry["ctx"], self.carry["fmap"]])

    def encode_warm(self, image2, admit, budgets) -> None:
        self.ensure_carry()
        self.programs.run(
            "wenc", self.bucket, self.lanes, self._wenc,
            [self.tensor(image2), self.tensor(admit, torch.bool),
             self.tensor(budgets, torch.int32)],
            [self.carry["ctx"], self.carry["fmap"], *self._leaves])

    def warm(self, programs: Sequence[str] = ("enc", "iter", "up")) -> None:
        """Run each of ``programs`` (``enc``, ``iter``, ``up``, ``stash``,
        ``wenc``) with no lane admitted, twice, which leaves the state
        (and carry) as it was: on the card the second call captures each
        program (the engine's ``warmup`` and warm-start replay)."""
        H, W = self.bucket
        zeros = np.zeros((self.lanes, H, W, 3), np.float32)
        budgets = np.zeros((self.lanes,), np.int32)
        runs = {"enc": lambda: self.encode(zeros, zeros, self.admit_none,
                                           budgets),
                "iter": lambda: self.iterate(0.0),
                "up": self.upsample,
                "stash": lambda: self.stash(zeros, self.admit_none),
                "wenc": lambda: self.encode_warm(zeros, self.admit_none,
                                                 budgets)}
        order = [p for p in ("enc", "iter", "up", "stash", "wenc")
                 if p in programs]
        unknown = set(programs) - set(runs)
        if unknown:
            raise ValueError(f"unknown slot programs {sorted(unknown)}")
        for _ in range(2):
            for p in order:
                runs[p]()


class EarlyExitRunner:
    """Offline driver of the slot programs over one fixed batch: encode,
    then iterate until every lane retires, returning each lane's flow at
    its own retirement and ``iters_used`` (the measurement arm of the
    evaluate CLI's early-exit sweep and of the early-exit tests: the
    programs the serving engine runs, no dispatcher in the way).  One
    :class:`SlotSet` per batch shape, so sweeping thresholds captures
    once per shape."""

    def __init__(self, model_cfg: RAFTConfig, device="cuda"):
        from raft_tpu_torch.evaluate import make_inference_model

        self.model = make_inference_model(model_cfg, device=device)
        self.model_cfg = self.model.config
        self.programs = SlotPrograms(self.model)
        self._sets: Dict[tuple, SlotSet] = {}
        self._loaded = None

    def run(self, state_dict, image1, image2, iters: int,
            threshold: float = 0.0, return_residuals: bool = False):
        """``(flow_up (B, H, W, 2) fp32, iters_used (B,) int32)`` numpy
        arrays for a ``/8``-aligned batch; ``threshold <= 0`` runs the
        full ``iters``.  ``return_residuals=True`` appends each lane's
        ``delta_max`` at its retirement (flow units at 1/8 resolution)."""
        if state_dict is not self._loaded:
            self.model.load_state_dict(state_dict)
            self._loaded = state_dict
        image1 = np.asarray(image1, np.float32)
        B, H, W = image1.shape[:3]
        key = ((H, W), B)
        slots = self._sets.get(key)
        if slots is None:
            slots = self._sets[key] = SlotSet(self.programs, (H, W), B)
        slots.encode(image1, image2, slots.admit_all,
                     np.full((B,), int(iters), np.int32))
        out = None
        prev_active = np.ones((B,), bool)
        iters_used = np.zeros((B,), np.int32)
        residuals = np.full((B,), -1.0, np.float32)
        for _ in range(int(iters)):
            status = slots.iterate(threshold).cpu().numpy()
            active = status[0] > 0
            newly = prev_active & ~active
            if newly.any():
                flow_np = slots.upsample().cpu().numpy()
                if out is None:
                    out = np.zeros(flow_np.shape, np.float32)
                out[newly] = flow_np[newly]
                iters_used[newly] = status[1][newly].astype(np.int32)
                residuals[newly] = status[3][newly]
            prev_active = active
            if not active.any():
                break
        assert out is not None and not prev_active.any(), \
            "lanes left active after their budget: the retire logic is broken"
        if return_residuals:
            return out, iters_used, residuals
        return out, iters_used
