"""The port's device pipeline (``raft_tpu_torch/data/prefetch.py``), twins
of tests/test_prefetch.py on the CPU: prefetch on and off give the same
batch stream (mid-epoch resume and the resume-keyed noise included, and
equal to the JAX package's pipeline), the loader's decode window changes
only how far it runs ahead, the buffer stays bounded, close frees what it
buffered, producer errors re-raise with their type, and the interrupt
predicate unblocks a waiting consumer.  The card's pinned-memory copies
are tested in tests/test_torch_cuda.py."""

import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from raft_tpu.data.datasets import ShardedLoader as JaxShardedLoader
from raft_tpu.data.prefetch import DevicePipeline as JaxDevicePipeline
from raft_tpu.train.loop import add_image_noise as jax_add_image_noise
from raft_tpu_torch.data.datasets import FlowDataset, ShardedLoader
from raft_tpu_torch.data.prefetch import (DevicePipeline, PipelineInterrupted,
                                          host_put)
from raft_tpu_torch.train.loop import noise_prep


class _SynthDataset(FlowDataset):
    """In-memory dataset: f(index) plus a generator-dependent draw, so the
    stream checks cover the per-sample generators too."""

    def __init__(self, n=13, hw=(8, 10)):
        super().__init__()
        self.hw = hw
        self.image_list = [("a", "b")] * n
        self.loads = []

    def load(self, index, rng=None):
        self.loads.append(index)
        H, W = self.hw
        base = np.full((H, W, 3), float(index), np.float32)
        jitter = (rng.standard_normal((H, W, 3)).astype(np.float32)
                  if rng is not None else 0.0)
        return {"image1": base + jitter, "image2": base * 2.0,
                "flow": np.zeros((H, W, 2), np.float32),
                "valid": np.ones((H, W), np.float32)}


def _take(pipe, n):
    try:
        return [next(pipe) for _ in range(n)]
    finally:
        pipe.close()


def test_prefetch_on_off_identical_streams_and_resume():
    """Prefetch on and off give bit-identical streams, from a fresh start
    and from a mid-epoch resume, with the resume-keyed noise applied in
    the producer; and the same stream as the JAX package's pipeline."""
    ds = _SynthDataset(n=13)  # batch 2, drop_last: 6 steps an epoch

    def stream(depth, start_step, put_fn=None):
        loader = ShardedLoader(ds, batch_size=2, seed=7, num_workers=2)
        pipe = DevicePipeline(loader.batches_from_step(start_step),
                              prep_fn=noise_prep(7, start_step),
                              put_fn=put_fn, depth=depth)
        return _take(pipe, 8)  # crosses the epoch boundary

    def jax_stream(start_step):
        loader = JaxShardedLoader(ds, batch_size=2, seed=7, num_workers=2)
        rng = np.random.default_rng(np.random.SeedSequence([8, start_step]))
        return _take(JaxDevicePipeline(
            loader.batches_from_step(start_step),
            prep_fn=lambda b: jax_add_image_noise(rng, b), depth=2), 8)

    for start in (0, 5):
        serial = stream(0, start)
        overlapped = stream(3, start)
        tensors = stream(2, start, put_fn=host_put)
        jax = jax_stream(start)
        assert len(serial) == len(overlapped) == len(jax) == 8
        for a, b, t, j in zip(serial, overlapped, tensors, jax):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a[k], j[k])
                assert t[k].dtype == torch.float32
                np.testing.assert_array_equal(a[k], t[k].numpy())


def test_loader_prefetch_batches_stream_invariant_and_window():
    """The decode window changes how far the pool runs ahead, never the
    stream, and it bounds the loads submitted ahead of the consumer."""
    def batches(pb, ds):
        loader = ShardedLoader(ds, batch_size=2, seed=5, num_workers=2,
                               prefetch_batches=pb)
        it = loader.batches()
        out = [next(it) for _ in range(7)]
        it.close()
        return out

    a = batches(0, _SynthDataset(n=13))
    b = batches(5, _SynthDataset(n=13))
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])

    # window = 1 batch = 2 samples: after 2 batches (4 samples) at most
    # 4 + 2 loads may have been submitted
    ds = _SynthDataset(n=13)
    loader = ShardedLoader(ds, batch_size=2, seed=5, num_workers=2,
                           prefetch_batches=1)
    it = loader.batches()
    next(it), next(it)
    time.sleep(0.2)
    assert len(ds.loads) <= 2 * 2 + 1 * 2, ds.loads
    it.close()


def test_prefetch_buffer_bounded():
    """The producer never pulls more than ``depth`` batches beyond what
    the consumer has taken."""
    pulled = [0]

    def src():
        while True:
            pulled[0] += 1
            yield {"x": np.zeros((4,), np.float32)}

    depth = 3
    pipe = DevicePipeline(src(), depth=depth)
    time.sleep(0.3)
    assert pulled[0] <= depth
    for i in range(5):
        next(pipe)
        time.sleep(0.05)
        assert pulled[0] <= i + 1 + depth
    pipe.close()
    assert not pipe._thread.is_alive()


def test_prefetch_close_frees_buffered_batches():
    refs = []

    def src():
        while True:
            a = np.zeros((64,), np.float32)
            refs.append(weakref.ref(a))
            yield {"x": a}

    pipe = DevicePipeline(src(), depth=4)
    first = next(pipe)
    time.sleep(0.2)  # let the buffer fill
    thread = pipe._thread
    pipe.close()
    assert len(refs) >= 3
    del first, pipe  # the generator's frame holds the last yield
    gc.collect()
    assert sum(r() is not None for r in refs) == 0
    assert not thread.is_alive()


def test_prefetch_producer_error_propagates():
    def src():
        yield {"x": np.zeros(2, np.float32)}
        raise RuntimeError("decode failed")

    for depth in (0, 2):
        pipe = DevicePipeline(src(), depth=depth)
        next(pipe)
        with pytest.raises(RuntimeError, match="decode failed"):
            for _ in range(3):
                next(pipe)
        if depth:  # after the error the pipeline is closed
            with pytest.raises(StopIteration):
                next(pipe)
        pipe.close()

    with pytest.raises(ValueError, match="depth"):
        DevicePipeline(iter(()), depth=-1)


def test_prefetch_producer_crash_preserves_type_and_close_joins():
    class BoomError(Exception):
        pass

    boom = BoomError("mid-stream decode crash")

    def src():
        yield {"x": np.zeros((4,), np.float32)}
        yield {"x": np.ones((4,), np.float32)}
        raise boom

    pipe = DevicePipeline(src(), depth=2)
    next(pipe)
    next(pipe)
    with pytest.raises(BoomError) as ei:
        next(pipe)
    assert ei.value is boom
    with pytest.raises(StopIteration):
        next(pipe)
    t0 = time.perf_counter()
    pipe.close()
    pipe.close()  # idempotent
    assert time.perf_counter() - t0 < 5.0
    assert not pipe._thread.is_alive()


def test_interrupt_predicate_unblocks_waiting_consumer():
    """A flag set while the consumer waits on an empty buffer raises
    ``PipelineInterrupted`` within the poll interval; the pipeline then
    still delivers."""
    flag = threading.Event()
    release = threading.Event()

    def src():
        yield {"x": np.zeros((2,), np.float32)}
        release.wait(30.0)
        yield {"x": np.ones((2,), np.float32)}

    pipe = DevicePipeline(src(), depth=2, interrupt=flag.is_set,
                          interrupt_poll_s=0.02)
    assert next(pipe)["x"][0] == 0.0
    timer = threading.Timer(0.05, flag.set)
    timer.start()
    t0 = time.perf_counter()
    with pytest.raises(PipelineInterrupted):
        next(pipe)
    assert time.perf_counter() - t0 < 5.0
    timer.cancel()
    flag.clear()
    release.set()
    assert next(pipe)["x"][0] == 1.0
    pipe.close()


def test_interrupt_predicate_ignored_while_batches_buffered():
    def src():
        for i in range(3):
            yield {"x": np.full((2,), float(i), np.float32)}

    pipe = DevicePipeline(src(), depth=2, interrupt=lambda: True,
                          interrupt_poll_s=0.02)
    deadline = time.time() + 10.0
    while pipe.buffered() < 1 and time.time() < deadline:
        time.sleep(0.005)
    assert pipe.buffered() >= 1
    assert next(pipe)["x"][0] == 0.0  # delivered despite the true flag
    pipe.close()


def test_producer_err_injection_propagates_both_depths():
    """The ``producer_err`` chaos fault crashes the producer before the
    named batch; the consumer's ``next()`` re-raises it at either depth."""
    from raft_tpu_torch import chaos

    for depth in (0, 2):
        chaos.install(chaos.FaultPlan.parse("producer_err@step=2"))
        try:
            pipe = DevicePipeline(iter([{"x": np.zeros(1)}] * 5),
                                  depth=depth)
            next(pipe), next(pipe)
            with pytest.raises(chaos.InjectedProducerCrash):
                next(pipe)
            pipe.close()
        finally:
            chaos.uninstall()
