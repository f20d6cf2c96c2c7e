"""Request-mode batch fill of a closed loop, through one engine and through
a two-replica fleet's router, on the CPU at a tiny size.

The request-mode dispatcher forms a batch ``max_wait_ms`` after its first
request whether or not the engine's host thread is free, so a closed loop
keeps whatever grouping its clients fall into: a loop that once splits
into part-filled batches stays split.  Each loop prints its pairs/s and the
fill of every batch it ran (from the ``serve_batch`` events)::

    python batch_fill_probe.py --loops 3

It runs the small model at 40x56, 2 iterations, batch sizes (1, 8), 8
clients x 16 requests; it needs no GPU.
"""

import argparse
import threading
import time

import numpy as np
import torch

from raft_tpu_torch.config import RAFTConfig
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.serve import (FleetConfig, FlowRouter, InferenceEngine,
                                  ReplicaFleet, RouterConfig, ServeConfig)

SHAPE = (36, 52)


class _Sink:
    def __init__(self):
        self.records, self._lock = [], threading.Lock()

    def emit(self, event, step=None, **fields):
        with self._lock:
            self.records.append((time.perf_counter(), event, fields))


def _loop(target, pairs, clients: int, reqs: int) -> tuple:
    def client(c):
        for i in range(reqs):
            target.infer(*pairs[(c + i) % len(pairs)], timeout=600)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return clients * reqs / (time.perf_counter() - t0), t0


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--loops", type=int, default=2,
                   help="loops of each kind, alternating")
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--reqs", type=int, default=16)
    args = p.parse_args(argv)
    torch.set_num_threads(2)
    cfg = RAFTConfig.small_model()
    sd = RAFT(cfg, seed=0).state_dict()
    scfg = ServeConfig(iters=2, max_batch=8, batch_sizes=(1, 8),
                       max_wait_ms=5.0, max_queue=64)
    rng = np.random.default_rng(0)
    pairs = [tuple(rng.uniform(0, 255, SHAPE + (3,)).astype(np.float32)
                   for _ in range(2)) for _ in range(4)]
    for _ in range(args.loops):
        for kind in ("engine", "router"):
            sink = _Sink()
            if kind == "engine":
                owner = InferenceEngine(sd, cfg, scfg, sink=sink,
                                        device="cpu").start()
                owner.warmup([SHAPE])
                target = owner
            else:
                owner = ReplicaFleet(sd, cfg, scfg, FleetConfig(
                    replicas=2, warmup_shapes=(SHAPE,)), sink=sink,
                    device="cpu").start()
                target = FlowRouter(owner, RouterConfig(), sink=sink)
            try:
                pps, t0 = _loop(target, pairs, args.clients, args.reqs)
            finally:
                owner.stop()
            fills = [f["real"] for t, e, f in sink.records
                     if e == "serve_batch" and t > t0]
            counts = {n: fills.count(n) for n in sorted(set(fills))}
            print(f"{kind}: {pps:.1f} pairs/s, {len(fills)} batches, mean "
                  f"fill {np.mean(fills):.2f}, batches by fill {counts}",
                  flush=True)


if __name__ == "__main__":
    main()
