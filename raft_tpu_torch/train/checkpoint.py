"""Checkpoints with auto-resume, fallback past torn steps, and background
commits (the port's copy of ``raft_tpu/train/checkpoint.py``, torch-native
instead of orbax).

Layout: one directory per step, ``<dir>/<step>/``, holding ``state.pt``
(one ``torch.save`` of plain containers: the model's ``state_dict``, the
AdamW state, ``step``, ``nonfinite_steps`` and the dropout generator's
state) and ``manifest.json`` (each file's byte size and SHA-256).  A
commit writes into ``<dir>/<step>.tmp-<pid>``, fsyncs, and renames it into
place, so a listed step is a whole one unless something truncated it
afterwards.  A run-level ``topology.json`` records which device (name and
count) and which world (``world_size``, ``mesh`` ``{"data": D, "spatial":
N}``, ``world_size = D * N``) saved each step.  The newest
``max_to_keep`` steps are kept.

Across data-parallel ranks (``mesh``) the state is the same on every
rank: rank 0 alone writes (the others' saves only record the step), and
on restore rank 0 picks the step and broadcasts it, so that a torn write
cannot split the ranks.  A checkpoint saved at one world size restores
at any other, spatially sharded or not: it holds no per-rank state, and
the loader continues the same global sample stream from its step
(``parallel/mesh.py``).

:meth:`CheckpointManager.save_async` copies the state to host memory
(every device tensor into pinned memory, one synchronize) before it
returns, so the next step may overwrite the parameters in place; a
background thread writes it, with at most ``commit_window`` commits in
flight.  A failed commit re-raises on the next call.  Each background
commit emits one ``ckpt_commit`` event (``ok`` from a cheap probe of the
written step: listed, and ``state.pt`` the size its manifest says;
``commit_latency_s``, ``queue_wait_s``) and counts into
``raft_ckpt_commits_total``; when the requesting thread was inside a
trace (``obs/trace.py``), the commit is a ``ckpt_commit`` span of that
trace, recorded on the committer thread.

:meth:`CheckpointManager.restore_latest` walks the steps from the newest
down: a torn or corrupt step (a missing file, a size or checksum
mismatch, an unreadable pickle) prints a fallback line, emits a
``ckpt_fallback`` event, counts into ``raft_ckpt_fallback_total``, and the
next one is tried; a structure mismatch (state keys or shapes that differ from the
template) raises :class:`CheckpointRestoreError` at once, as does a
directory where no step restores.  ``python -m raft_tpu_torch verify-ckpt
<dir>`` runs the same checks offline.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from raft_tpu_torch import chaos
from raft_tpu_torch.train.optim import load_optimizer_state_
from raft_tpu_torch.train.state import TrainState

TOPOLOGY_FILE = "topology.json"
STATE_FILE = "state.pt"
MANIFEST_FILE = "manifest.json"
STATE_KEYS = ("model", "optimizer", "step", "nonfinite_steps", "generator")


class CheckpointRestoreError(RuntimeError):
    """Nothing valid to resume from, or a saved state whose structure
    differs from the run's.  Deliberately fatal: restarting a long run from
    step 0, or onto a different model, is worse than stopping."""


class CheckpointCorruptError(RuntimeError):
    """One step's files are torn or corrupt (restore falls back past it)."""


def _host_copy(obj, pinned: bool):
    """``obj`` with every tensor copied to host memory (pinned when
    ``pinned``, with ``non_blocking`` device-to-host copies: the caller
    synchronizes once)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.device.type == "cpu":
            return t.clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
        host.copy_(t, non_blocking=pinned)
        return host
    if isinstance(obj, dict):
        return {k: _host_copy(v, pinned) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v, pinned) for v in obj)
    return obj


def snapshot(state: TrainState) -> Dict[str, Any]:
    """The full train state in host memory, as plain containers."""
    on_card = next(state.model.parameters()).device.type == "cuda"
    snap = _host_copy({"model": state.model.state_dict(),
                       "optimizer": state.optimizer.state_dict()},
                      pinned=on_card)
    if on_card:
        # the pinned copies are read as soon as this returns
        dev = next(state.model.parameters()).device
        torch.cuda.synchronize(dev)  # raftlint: disable=JIT103
    snap.update(step=int(state.step),
                nonfinite_steps=int(state.nonfinite_steps),
                generator=state.generator.get_state())
    return snap


def _current_topology(device: torch.device, mesh=None) -> dict:
    world = 1 if mesh is None else mesh.world
    topo = {"world_size": world,
            "mesh": ({"data": 1, "spatial": 1} if mesh is None
                     else mesh.mesh_shape())}
    if device.type == "cuda":
        return dict(topo, platform="cuda",
                    device=torch.cuda.get_device_name(device),
                    device_count=torch.cuda.device_count())
    return dict(topo, platform=device.type, device=device.type,
                device_count=1)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _shapes_differ(saved: Dict[str, Any], want: Dict[str, Any]) -> List[str]:
    """Keys and shapes of two flat tensor dicts that do not match."""
    bad = [f"missing {k}" for k in want if k not in saved]
    bad += [f"unexpected {k}" for k in saved if k not in want]
    bad += [f"{k}: {tuple(saved[k].shape)} vs {tuple(want[k].shape)}"
            for k in want if k in saved
            and (not isinstance(saved[k], torch.Tensor)
                 or saved[k].shape != want[k].shape)]
    return bad


def check_structure(saved: Dict[str, Any], template: TrainState) -> None:
    """Raise :class:`CheckpointRestoreError` unless ``saved`` fits
    ``template``: the same state keys, model keys and shapes, optimizer
    groups, moment shapes and generator state size."""
    missing = [k for k in STATE_KEYS if k not in saved]
    if missing:
        raise CheckpointRestoreError(f"saved state lacks {missing}")
    bad = _shapes_differ(saved["model"], template.model.state_dict())
    params = list(template.model.parameters())
    groups = saved["optimizer"].get("param_groups", [])
    if sum(len(g["params"]) for g in groups) != len(params):
        bad.append(f"optimizer holds {sum(len(g['params']) for g in groups)}"
                   f" parameters, the model {len(params)}")
    else:
        for i, p in enumerate(params):
            for name, t in saved["optimizer"]["state"].get(i, {}).items():
                if t.dim() and t.shape != p.shape:
                    bad.append(f"optimizer state {i}.{name}: "
                               f"{tuple(t.shape)} vs {tuple(p.shape)}")
    gen = template.generator.get_state()
    if saved["generator"].shape != gen.shape:
        bad.append(f"generator state of {saved['generator'].numel()} bytes "
                   f"vs {gen.numel()} (saved on another device type)")
    if bad:
        raise CheckpointRestoreError(
            "checkpoint structure differs from the run's state: "
            + "; ".join(bad[:8]) + (" ..." if len(bad) > 8 else ""))


def apply_state(saved: Dict[str, Any], template: TrainState) -> TrainState:
    """Load ``saved`` into ``template`` in place (after
    :func:`check_structure`): every value is copied into the tensor the
    template holds (parameters, buffers, optimizer state, the learning
    rate and the non-finite counter) and the generator's state is set, so
    the train step's captured graphs, which read and write those tensors,
    stay valid."""
    template.model.load_state_dict(saved["model"])
    load_optimizer_state_(template.optimizer, saved["optimizer"])
    template.generator.set_state(saved["generator"])
    template.step = int(saved["step"])
    template.nonfinite_steps.fill_(int(saved["nonfinite_steps"]))
    return template


_SHUTDOWN = object()


class CheckpointManager:
    """Save, verify and restore the train state under ``directory``
    (``ckpt_dir/name``).  ``commit_window`` bounds the background commits
    in flight; ``commit_s`` lists each commit's seconds (write and fsync).
    ``mesh``: the run's data-parallel ranks (rank 0 writes; restore is
    collective).  ``sink``: the :class:`raft_tpu_torch.obs.EventSink` of
    the ``ckpt_fallback`` / ``ckpt_commit`` events (default: the
    process-wide sink, a no-op unless ``RAFT_TELEMETRY_DIR`` is set)."""

    def __init__(self, directory: str, max_to_keep: int = 5,
                 commit_window: int = 2, mesh=None, sink=None):
        self._dir = os.path.abspath(directory)
        self._mesh = mesh
        self._sink = sink
        self._writer = mesh is None or mesh.rank == 0
        if self._writer:
            os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self._commit_window = max(int(commit_window), 1)
        self._commit_q: Optional[queue.Queue] = None
        self._commit_thread: Optional[threading.Thread] = None
        self._commit_err: Optional[BaseException] = None
        self._last_requested: Optional[int] = None
        self._io_lock = threading.Lock()
        self.commit_s: List[float] = []

    @property
    def directory(self) -> str:
        return self._dir

    def _events(self):
        if self._sink is not None:
            return self._sink
        from raft_tpu_torch.obs.events import default_sink

        return default_sink()

    # -- topology --------------------------------------------------------
    def _topology_path(self) -> str:
        return os.path.join(self._dir, TOPOLOGY_FILE)

    def _stamp_topology(self, step: int, topo: dict) -> None:
        ledger = self.saved_topology()
        ledger[str(int(step))] = dict(topo, time=time.time())
        tmp = self._topology_path() + f".tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(ledger, f, indent=2, sort_keys=True)
        os.replace(tmp, self._topology_path())

    def saved_topology(self, step: Optional[int] = None):
        """``{str(step): {platform, device, device_count, time}}`` for every
        stamped save (steps rotated out keep their stamps); with ``step``,
        that entry or None."""
        try:
            with open(self._topology_path()) as f:
                ledger = json.load(f)
        except (OSError, ValueError):
            ledger = {}
        if step is not None:
            return ledger.get(str(int(step)))
        return ledger

    # -- save ------------------------------------------------------------
    def _commit(self, step: int, snap: Dict[str, Any], topo: dict) -> None:
        """Write one snapshot as step ``step`` (tmp dir, fsync, rename),
        stamp its topology and drop steps beyond ``max_to_keep``."""
        t0 = time.perf_counter()
        buf = io.BytesIO()
        torch.save(snap, buf)
        blob = buf.getvalue()
        final = os.path.join(self._dir, str(int(step)))
        tmp = f"{final}.tmp-{os.getpid()}"
        with self._io_lock:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            manifest = {"step": int(step), "files": {STATE_FILE: {
                "bytes": len(blob),
                "sha256": hashlib.sha256(blob).hexdigest()}}}
            with open(os.path.join(tmp, MANIFEST_FILE), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_dir(self._dir)
            self._stamp_topology(step, topo)
            for old in self.all_steps()[:-self.max_to_keep or None]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)
        self.commit_s.append(time.perf_counter() - t0)
        if chaos.should_inject("torn_ckpt", step=int(step),
                               point="ckpt.save"):
            # after the commit, as a host dying mid-flush would leave it
            torn = chaos.tear_files(final)
            self._events().emit("chaos_torn_ckpt", step=int(step),
                                files=len(torn))

    def save(self, step: int, state: TrainState) -> None:
        """Snapshot and commit on the calling thread (the final and the
        emergency save)."""
        self.wait()
        device = next(state.model.parameters()).device
        self._last_requested = int(step)
        if self._writer:
            self._commit(step, snapshot(state),
                         _current_topology(device, self._mesh))

    def save_async(self, step: int, state: TrainState) -> None:
        """Snapshot ``state`` to host memory and hand it to the committer.
        Blocks only while ``commit_window`` commits are in flight; a
        previous commit's failure re-raises here."""
        self._raise_commit_err()
        self._last_requested = int(step)
        if not self._writer:
            return
        device = next(state.model.parameters()).device
        snap = snapshot(state)
        if self._commit_thread is None:
            self._commit_q = queue.Queue(maxsize=self._commit_window)
            self._commit_thread = threading.Thread(
                target=self._commit_loop, name="raft-ckpt-commit",
                daemon=True)
            self._commit_thread.start()
        # the caller's trace context rides along: the commit becomes a
        # ckpt_commit span of the step's trace (None when not traced)
        from raft_tpu_torch.obs import trace

        self._commit_q.put((int(step), snap,
                            _current_topology(device, self._mesh),
                            time.perf_counter(), trace.current()))

    def _commit_loop(self) -> None:
        while True:
            item = self._commit_q.get()
            try:
                if item is _SHUTDOWN:
                    return
                step, snap, topo, t_enq, ctx = item
                t0 = time.perf_counter()
                try:
                    self._commit(step, snap, topo)
                except BaseException as e:  # re-raised to the caller
                    self._commit_err = e
                    ok, err = False, f"{type(e).__name__}: {str(e)[:200]}"
                else:
                    ok, err = self._probe_commit(step)
                self._emit_commit(step, t0, t_enq, ctx, ok=ok, error=err)
            finally:
                self._commit_q.task_done()

    def _probe_commit(self, step: int):
        """``(ok, error)``: the step is listed and its ``state.pt`` has the
        size its manifest says (not a checksum: :meth:`verify` reads the
        bytes).  It reports; it never deletes."""
        d = os.path.join(self._dir, str(int(step)))
        try:
            if int(step) not in self.all_steps():
                return False, "step not listed after commit"
            with open(os.path.join(d, MANIFEST_FILE)) as f:
                want = json.load(f)["files"][STATE_FILE]["bytes"]
            got = os.path.getsize(os.path.join(d, STATE_FILE))
            if got != want:
                return False, (f"{STATE_FILE} has {got} bytes, the "
                               f"manifest says {want}")
            return True, None
        except (OSError, ValueError, KeyError, TypeError) as e:
            return False, f"{type(e).__name__}: {str(e)[:200]}"

    def _emit_commit(self, step, t0, t_enq, ctx, *, ok, error=None) -> None:
        """The ``ckpt_commit`` event, counter and trace span of one
        background commit; telemetry never fails a commit."""
        from raft_tpu_torch.obs import trace
        from raft_tpu_torch.obs.registry import default_registry

        try:
            now = time.perf_counter()
            fields = dict(ok=bool(ok),
                          commit_latency_s=round(now - t0, 6),
                          queue_wait_s=round(t0 - t_enq, 6))
            if error:
                fields["error"] = error
            self._events().emit("ckpt_commit", step=int(step), **fields)
            default_registry().counter(
                "raft_ckpt_commits_total",
                "background checkpoint commits by probe outcome").inc(
                    ok=str(bool(ok)).lower())
            if ctx:
                trace.record_span(ctx, "ckpt_commit", t0, now,
                                  status="ok" if ok else "error",
                                  step=int(step))
        except Exception:
            pass

    def _raise_commit_err(self) -> None:
        if self._commit_err is not None:
            e, self._commit_err = self._commit_err, None
            raise RuntimeError("background checkpoint commit failed") from e

    def wait(self) -> None:
        """Wait for the commits in flight; re-raise the first failure."""
        if self._commit_q is not None:
            self._commit_q.join()
        self._raise_commit_err()

    def last_requested_step(self) -> Optional[int]:
        """The newest step handed to a save, committed or not."""
        return self._last_requested

    # -- listing and reading ----------------------------------------------
    def all_steps(self) -> List[int]:
        """Committed step directories, oldest first (torn ones included:
        presence is not integrity, see :meth:`verify`)."""
        try:
            names = os.listdir(self._dir)
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_step(self, step: int) -> Dict[str, Any]:
        """The saved state of ``step`` on the CPU; raises
        :class:`CheckpointCorruptError` for a torn or corrupt step."""
        if chaos.should_inject("restore_err", step=int(step),
                               point="ckpt.restore"):
            raise chaos.InjectedCheckpointCorruption(
                f"chaos-injected restore failure at step {step}")
        d = os.path.join(self._dir, str(int(step)))
        try:
            with open(os.path.join(d, MANIFEST_FILE)) as f:
                manifest = json.load(f)
            entry = manifest["files"][STATE_FILE]
            with open(os.path.join(d, STATE_FILE), "rb") as f:
                blob = f.read()
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable ({type(e).__name__}: {e})") from e
        if len(blob) != entry["bytes"]:
            raise CheckpointCorruptError(
                f"step {step}: {STATE_FILE} has {len(blob)} bytes, the "
                f"manifest says {entry['bytes']} (torn write?)")
        if hashlib.sha256(blob).hexdigest() != entry["sha256"]:
            raise CheckpointCorruptError(
                f"step {step}: {STATE_FILE} checksum mismatch")
        try:
            saved = torch.load(io.BytesIO(blob), map_location="cpu",
                               weights_only=True)
        except Exception as e:  # any unpickling failure is corruption
            raise CheckpointCorruptError(
                f"step {step}: {STATE_FILE} does not load "
                f"({type(e).__name__}: {e})") from e
        if not isinstance(saved, dict):
            raise CheckpointCorruptError(f"step {step}: not a state dict")
        return saved

    def _walk(self, template: Optional[TrainState]):
        """``(step, saved)`` of the newest step that reads (and fits
        ``template``), printing a fallback line for each step skipped;
        None for an empty directory."""
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        failures = []
        for step in steps:
            try:
                saved = self.read_step(step)
            except (CheckpointCorruptError,
                    chaos.InjectedCheckpointCorruption) as e:
                failures.append((step, e))
                print(f"checkpoint fallback: step {step} unrestorable "
                      f"({e}); trying the next older step", flush=True)
                self._note_fallback(step, e, tried=len(failures),
                                    remaining=len(steps) - len(failures))
                continue
            if template is not None:
                check_structure(saved, template)
            if failures:
                print(f"checkpoint fallback: step(s) "
                      f"{[s for s, _ in failures]} unrestorable (torn "
                      f"write?); resumed from step {step}", flush=True)
            return step, saved
        raise CheckpointRestoreError(
            f"no restorable checkpoint in {self._dir}: all {len(steps)} "
            "step(s) failed: " + "; ".join(
                f"step {s}: {type(e).__name__}: {str(e)[:120]}"
                for s, e in failures))

    def _note_fallback(self, step: int, e: BaseException, *,
                       tried: int, remaining: int) -> None:
        from raft_tpu_torch.obs.registry import default_registry

        default_registry().counter(
            "raft_ckpt_fallback_total",
            "saved checkpoint steps skipped as unrestorable during "
            "resume").inc()
        self._events().emit("ckpt_fallback", step=int(step),
                            error=f"{type(e).__name__}: {str(e)[:200]}",
                            tried=tried, remaining_steps=remaining)

    def restore_latest(self, template: TrainState) -> Optional[TrainState]:
        """Load the newest restorable step into ``template`` (in place)
        and return it; None when nothing was saved.  Across ranks, rank 0
        walks the steps and every rank loads the one it found."""
        if self._mesh is None or self._mesh.world == 1:
            found = self._walk(template)
        else:
            found, err = None, None
            if self._mesh.rank == 0:
                try:
                    found = self._walk(template)
                except CheckpointRestoreError as e:
                    err = e
            step, msg = self._mesh.broadcast_object(
                (None if found is None else found[0],
                 None if err is None else str(err)))
            if err is not None:
                raise err
            if msg is not None:
                raise CheckpointRestoreError(f"rank 0: {msg}")
            if step is not None and found is None:
                try:
                    saved = self.read_step(step)
                except (CheckpointCorruptError,
                        chaos.InjectedCheckpointCorruption) as e:
                    raise CheckpointRestoreError(
                        f"rank {self._mesh.rank} cannot read step {step}, "
                        f"which rank 0 restores: {e}") from e
                check_structure(saved, template)
                found = (step, saved)
        if found is None:
            return None
        return apply_state(found[1], template)

    def restore_params(self, template: Optional[TrainState] = None
                       ) -> Optional[Dict[str, torch.Tensor]]:
        """The model ``state_dict`` (parameters and batch-norm statistics)
        of the newest restorable step, on the CPU: the weights that seed a
        next curriculum stage or the evaluate CLI.  None when nothing was
        saved."""
        found = self._walk(template)
        return None if found is None else found[1]["model"]

    def verify(self, step: int,
               template: Optional[TrainState] = None) -> dict:
        """``{step, ok[, error]}``: whether ``step`` reads (and fits
        ``template``).  Never raises."""
        try:
            saved = self.read_step(step)
            missing = [k for k in STATE_KEYS if k not in saved]
            if missing:
                raise CheckpointRestoreError(f"saved state lacks {missing}")
            if template is not None:
                check_structure(saved, template)
            return {"step": int(step), "ok": True}
        except Exception as e:
            return {"step": int(step), "ok": False,
                    "error": f"{type(e).__name__}: {str(e)[:300]}"}

    def verify_all(self, template: Optional[TrainState] = None
                   ) -> List[dict]:
        """:meth:`verify` of every saved step, oldest first."""
        return [self.verify(s, template) for s in self.all_steps()]

    def close(self) -> None:
        """Stop the committer after the commits in flight."""
        if self._commit_thread is not None:
            self._commit_q.put(_SHUTDOWN)
            self._commit_thread.join(timeout=600.0)
            self._commit_thread = None
