"""Serving CLI: an HTTP front end over one
:class:`raft_tpu_torch.serve.InferenceEngine`, or over a supervised
replica fleet behind a :class:`raft_tpu_torch.serve.FlowRouter` (the
port of ``raft_tpu/cli/serve.py``).

    python -m raft_tpu_torch serve --random-init --port 8080
    python -m raft_tpu_torch serve --random-init --replicas 2 \
        --hedge-timeout-s 2 --remote otherhost:8080 --autoscale 1:3

It runs on the card unless ``--device cpu``; without CUDA it raises.
The wire protocol is the JAX server's (numpy ``npz`` bodies):

- ``POST /v1/flow``: body ``np.savez(buf, image1=..., image2=...)`` with
  two matching ``(H, W, 3)`` arrays in [0, 255]; 200 with an ``npz``
  holding ``flow`` ``(H, W, 2)`` float32 at the original resolution; 429
  when the bounded queue is full, with ``Retry-After`` and a JSON body
  ``{"error", "queue_depth", "retry_after_s"}``; 400 on malformed input.
- ``POST /v1/stream/{id}``: a streaming session's next frame, body
  ``np.savez(buf, image=...)``.  The first POST of an unknown id opens
  the session (query parameters ``iters`` and ``ttl_s``) and returns
  ``frame=0``; every later one returns ``flow`` (previous frame -> this
  one), ``frame`` and ``warm``.  409 while the session has a frame in
  flight.  Needs the slot mode.
- ``DELETE /v1/stream/{id}``: close the session; JSON ``{"session",
  "frames", "pairs", "warm_pairs"}``; 404 for an unknown id.
- ``GET /v1/stats``: the engine's JSON snapshot.
- ``GET /metrics``: Prometheus text of the same registry.
- ``GET /v1/healthz`` (alias ``/healthz``): 200 ``ok`` while the engine
  accepts and its device worker makes progress; 503 with the detail
  when requests are pending and no batch has completed within the stall
  timeout.
- ``POST /debug/profile?seconds=S``: on-demand device profiling, a
  ``torch.profiler`` window (CPU and CUDA activities) of S seconds
  (clamped to [0.05, 60]; 400 when S is not a number; one at a time,
  409 while one runs), written as a Chrome trace under
  ``<telemetry_dir>/xprof/serve-<ts>/`` (a temp directory without a
  telemetry directory); returns ``{"dir", "file", "seconds"}``.  The
  window starts and stops on the device worker, between two device
  calls (never inside a capture), and trace spans recorded meanwhile
  carry its directory as their ``xprof`` attribute.

With ``--replicas N`` (N > 1), ``--remote HOST:PORT`` (repeatable) or
``--autoscale MIN:MAX``, the same endpoints front a
:class:`~raft_tpu_torch.serve.ReplicaFleet`: requests route through a
health-gated router with failover and, with ``--hedge-timeout-s``,
hedging; ``/v1/healthz`` reports the fleet's readiness (200 while any
replica serves) and ``/metrics`` aggregates every replica's registry
with a ``replica`` label on each sample.  ``--aot-dir`` is the
warm-start manifest directory (``serve/aot.py``): replica 0 writes it,
every later engine replays it before it serves.

Distributed tracing: with ``--trace-sample-rate`` > 0 (default
``$RAFT_TRACE_SAMPLE_RATE``), each ``POST /v1/flow`` opens (or, given an
``X-Raft-Trace: <trace>-<span>-<s|d>`` request header, continues) a
trace whose tree spans router placement, hedging, failover and the
device batch; the reply carries the ``X-Raft-Trace`` header, and
``scripts/trace_report.py`` rebuilds the trees from the telemetry
directory.

Every flag of the JAX CLI parses and works (:data:`UNPORTED` is empty).
SIGINT stops the server, drains the engine (or the fleet) and prints its
stats as one JSON line.
"""

from __future__ import annotations

import argparse
import io
import json
import math

# flag -> (the JAX default, the ROADMAP item that ports what it does):
# every JAX flag is ported, so the table is empty
UNPORTED: dict = {}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="raft_tpu_torch serve",
        description="RAFT online inference server (PyTorch port): shape "
                    "buckets, captured programs, dynamic and continuous "
                    "batching, streaming sessions")
    p.add_argument("--model", default=None,
                   help=".pth state dict or training run directory (as "
                        "the evaluate CLI); omit for --random-init")
    p.add_argument("--random-init", action="store_true",
                   help="serve seeded random weights (load and smoke "
                        "testing without a checkpoint)")
    p.add_argument("--small", action="store_true", help="the small model")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--iters", type=int, default=32,
                   help="refinement iterations per request")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batching", default="request",
                   choices=["request", "slot"],
                   help="request-level micro-batching, or continuous "
                        "batching at GRU-iteration granularity over "
                        "--slots persistent device lanes")
    p.add_argument("--slots", type=int, default=8,
                   help="slot mode: persistent device lanes per bucket")
    p.add_argument("--stream-ttl-s", type=float, default=60.0,
                   help="streaming sessions: evict a session (and free its "
                        "pinned lane) after this long without a frame")
    p.add_argument("--stream-warm-iters", type=int, default=None,
                   help="streaming sessions: iteration budget of "
                        "warm-started frames (default: the session's)")
    p.add_argument("--max-sessions", type=int, default=64,
                   help="open streaming sessions bound; beyond it session "
                        "opens get 429")
    p.add_argument("--early-exit-threshold", type=float, default=0.0,
                   help="slot mode: retire a request when its largest flow "
                        "update falls below this (0: always the full "
                        "budget)")
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batch size cap")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="how long a micro-batch waits to fill after its "
                        "first request")
    p.add_argument("--max-queue", type=int, default=256,
                   help="in-flight bound; beyond it requests get 429")
    p.add_argument("--stall-timeout-s", type=float, default=120.0,
                   help="readiness threshold: with requests pending and "
                        "no device batch completed for this long, "
                        "GET /v1/healthz turns 503 (0 disables)")
    p.add_argument("--buckets", default=None,
                   help="comma-separated /8-aligned HxW bucket ladder "
                        "(e.g. 440x1024,720x1280); default: the exact /8 "
                        "round-up of each request's shape")
    p.add_argument("--batch-sizes", default=None,
                   help="comma-separated request-mode batch sizes "
                        "(default: powers of two up to --max-batch)")
    p.add_argument("--warmup", default=None,
                   help="comma-separated HxW image shapes whose programs "
                        "are captured before accepting traffic")
    p.add_argument("--telemetry-dir", default=None,
                   help="write JSONL telemetry events into this "
                        "directory; default $RAFT_TELEMETRY_DIR, unset = "
                        "disabled")
    p.add_argument("--device-retries", type=int, default=1,
                   help="re-runs of a device call after a transient error "
                        "before the batch fails")
    p.add_argument("--retry-backoff-s", type=float, default=0.05,
                   help="base of the exponential retry ladder")
    p.add_argument("--chaos", default=None,
                   help="fault-injection spec, e.g. 'device_err@batch=3'; "
                        "default $RAFT_CHAOS_SPEC, unset = no injection")
    p.add_argument("--chaos-seed", type=int, default=None,
                   help="seed of probabilistic chaos rules (default "
                        "$RAFT_CHAOS_SEED or 0)")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas behind a health-gated router "
                        "with failover; 1 = a single engine, no fleet")
    p.add_argument("--remote", action="append", default=None,
                   metavar="HOST:PORT",
                   help="join a remote serving host to the fleet as a "
                        "replica behind the same router (repeatable); "
                        "implies fleet mode")
    p.add_argument("--autoscale", default=None, metavar="MIN:MAX",
                   help="autoscaling bounds on local replicas (queue "
                        "pressure grows, idle shrinks); implies fleet "
                        "mode")
    p.add_argument("--aot-dir", default=None,
                   help="warm-start manifest directory: replica 0 writes "
                        "the captured (bucket, lanes, program) keys, "
                        "every later engine captures them before it "
                        "serves; default: a fresh temp dir per fleet")
    p.add_argument("--hedge-timeout-s", type=float, default=0.0,
                   help="fleet mode: duplicate a still-unresolved request "
                        "onto a second replica after this many seconds "
                        "(0 disables)")
    p.add_argument("--trace-sample-rate", type=float, default=None,
                   help="distributed-tracing head-sample rate in [0, 1] "
                        "(0/unset = tracing off; errors, retries and "
                        "hedges are tail-kept regardless once > 0); "
                        "default $RAFT_TRACE_SAMPLE_RATE")
    p.add_argument("--quality-sample-rate", type=float, default=0.0,
                   help="fraction of retiring slot-mode requests scored "
                        "with the label-free photometric quality proxy "
                        "(quality_score events, raft_quality_* metrics, "
                        "drift detection); 0 disables")
    p.add_argument("--quality-cycle", action="store_true",
                   help="with --quality-sample-rate > 0: also run a "
                        "forward-backward cycle-consistency pass per "
                        "scored request")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def check_unported(args) -> None:
    """Stop with the ROADMAP item of a flag the port cannot honour yet."""
    for flag, (default, item) in UNPORTED.items():
        value = getattr(args, flag)
        if value != default:
            raise SystemExit(
                f"--{flag.replace('_', '-')} {value!r}: not in the PyTorch "
                f"port yet (ROADMAP {item}); leave it at its default "
                f"{default!r}")


def _parse_hw_list(spec):
    out = []
    for tok in spec.split(","):
        h, w = tok.strip().lower().split("x")
        out.append((int(h), int(w)))
    return tuple(out)


def service_device(service):
    """The device an engine, or a fleet's router, serves on."""
    fleet = getattr(service, "fleet", None)
    return getattr(fleet if fleet is not None else service, "device")


def profile_window(device, seconds: float, outdir: str) -> str:
    """One ``torch.profiler`` window of ``seconds`` over ``device``'s
    work, written as a Chrome trace into ``outdir``; returns its path.

    The profiler starts and stops on the device worker
    (``serve.engine.on_device``): both are CUDA calls, and one made from
    another thread while the worker captures a graph would fail, and the
    worker's own operators are recorded from the thread that started it.
    Trace spans recorded while it runs carry ``outdir`` as their
    ``xprof`` attribute (``obs.trace.set_active_profile``)."""
    import os
    import time

    import torch

    from raft_tpu_torch.obs import trace
    from raft_tpu_torch.serve.engine import on_device

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    on_device(device, prof.start)
    trace.set_active_profile(outdir)
    try:
        time.sleep(seconds)
    finally:
        trace.set_active_profile(None)
        on_device(device, prof.stop)
    path = os.path.join(outdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def _make_handler(engine, device):
    import threading

    from http.server import BaseHTTPRequestHandler

    from raft_tpu_torch.obs import PROMETHEUS_CONTENT_TYPE, trace
    from raft_tpu_torch.serve import QueueFullError

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # one profiler window at a time (shared by every handler thread
        # of this server)
        _profile_lock = threading.Lock()

        def log_message(self, fmt, *args):  # stats() is the signal
            pass

        def _reply(self, code, body, ctype, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code, obj, extra=()):
            self._reply(code, json.dumps(obj).encode(), "application/json",
                        extra)

        def _reply_full(self, e, extra=()):
            """The structured 429: the backoff hint as the standard
            header (delta-seconds, so rounded up) and in the body."""
            retry_s = float(getattr(e, "retry_after_s", 1.0))
            self._reply_json(
                429, {"error": str(e),
                      "queue_depth": int(getattr(e, "queue_depth", 0)),
                      "retry_after_s": retry_s},
                extra=[("Retry-After", str(max(1, math.ceil(retry_s))))]
                + list(extra))

        def do_GET(self):
            if self.path in ("/healthz", "/v1/healthz"):
                h = engine.health()
                if h["ready"]:
                    self._reply(200, b"ok", "text/plain")
                else:
                    self._reply_json(503, h)
            elif self.path == "/v1/stats":
                self._reply_json(200, engine.stats())
            elif self.path == "/metrics":
                self._reply(200, engine.metrics_text().encode(),
                            PROMETHEUS_CONTENT_TYPE)
            else:
                self._reply_json(404, {"error": f"no route {self.path}"})

        def do_DELETE(self):
            if not self.path.startswith("/v1/stream/"):
                self._reply_json(404, {"error": f"no route {self.path}"})
                return
            sid = self.path[len("/v1/stream/"):]
            try:
                summary = engine.stream_close(sid)
            except ValueError as e:
                code = 404 if "unknown session" in str(e) else 409
                self._reply_json(code, {"error": str(e)})
                return
            except Exception as e:
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply_json(200, summary)

        def _stream(self):
            import numpy as np

            from urllib.parse import parse_qs, urlparse

            u = urlparse(self.path)
            sid = u.path[len("/v1/stream/"):]
            if not sid or "/" in sid:
                self._reply_json(404, {"error": f"no route {u.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                with np.load(io.BytesIO(self.rfile.read(n))) as z:
                    image = z["image"]
                qs = parse_qs(u.query)
                iters = int(qs["iters"][0]) if "iters" in qs else None
                ttl_s = float(qs["ttl_s"][0]) if "ttl_s" in qs else None
            except Exception as e:
                self._reply_json(400, {"error": f"bad stream request: {e}"})
                return
            try:
                out = engine.stream_ingest(sid, image, iters=iters,
                                           ttl_s=ttl_s)
            except QueueFullError as e:
                self._reply_full(e)
                return
            except ValueError as e:
                code = 409 if "in flight" in str(e) else 400
                self._reply_json(code, {"error": str(e)})
                return
            except Exception as e:
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            buf = io.BytesIO()
            if out["flow"] is None:
                np.savez(buf, frame=out["frame"], warm=False)
            else:
                np.savez(buf, flow=out["flow"], frame=out["frame"],
                         warm=out["warm"])
            self._reply(200, buf.getvalue(), "application/octet-stream")

        def do_POST(self):
            import numpy as np

            if self.path.startswith("/debug/profile"):
                self._profile()
                return
            if self.path.startswith("/v1/stream/"):
                self._stream()
                return
            if self.path != "/v1/flow":
                self._reply_json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                with np.load(io.BytesIO(self.rfile.read(n))) as z:
                    im1, im2 = z["image1"], z["image2"]
            except Exception as e:
                self._reply_json(400, {"error": f"bad npz body: {e}"})
                return
            # Wire propagation: continue an upstream trace from the
            # X-Raft-Trace header (its sampling verdict wins) or open a
            # fresh root; the reply carries the header so the caller can
            # correlate.  Tracing off: the no-op singleton.
            tracer = trace.default_tracer()
            root = trace.NOOP_SPAN
            if tracer.enabled:
                up = trace.parse_header(self.headers.get(trace.HEADER))
                if up is not None:
                    root = tracer.start_trace(
                        "serve_http", trace_id=up[0], parent_id=up[1],
                        sampled=up[2], path=self.path)
                else:
                    root = tracer.start_trace("serve_http",
                                              path=self.path)
            hdr = trace.format_header(root)
            thdr = [(trace.HEADER, hdr)] if hdr else []
            try:
                with trace.use_context(root):
                    flow = engine.infer(im1, im2)
            except QueueFullError as e:
                root.end(status="full", error="QueueFullError")
                self._reply_full(e, thdr)
                return
            except ValueError as e:
                root.end(status="error", error="ValueError")
                self._reply_json(400, {"error": str(e)}, extra=thdr)
                return
            except Exception as e:
                root.end(status="error", error=type(e).__name__)
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"},
                                 extra=thdr)
                return
            root.end(status="ok")
            buf = io.BytesIO()
            np.savez(buf, flow=flow)
            self._reply(200, buf.getvalue(), "application/octet-stream",
                        extra=thdr)

        def _profile(self):
            """``POST /debug/profile?seconds=S``: one profiler window
            (:func:`profile_window`) under the sink's directory."""
            import os
            import tempfile
            import time
            from urllib.parse import parse_qs, urlparse

            qs = parse_qs(urlparse(self.path).query)
            try:
                seconds = float(qs.get("seconds", ["2"])[0])
            except ValueError:
                self._reply_json(400, {"error": "seconds must be a number"})
                return
            if not math.isfinite(seconds):
                self._reply_json(400, {"error": "seconds must be finite"})
                return
            seconds = min(max(seconds, 0.05), 60.0)
            if not Handler._profile_lock.acquire(blocking=False):
                self._reply_json(
                    409, {"error": "a profile capture is already "
                                   "running; retry when it finishes"})
                return
            try:
                from raft_tpu_torch.obs import default_sink

                sink = default_sink()
                base = sink.directory if sink.enabled else \
                    tempfile.mkdtemp(prefix="raft-xprof-")
                outdir = os.path.join(
                    base, "xprof", time.strftime("serve-%Y%m%d-%H%M%S"))
                os.makedirs(outdir, exist_ok=True)
                path = profile_window(device, seconds, outdir)
                sink.emit("xprof_capture", source="serve", dir=outdir,
                          seconds=seconds)
                self._reply_json(200, {"dir": outdir, "file": path,
                                       "seconds": seconds})
            except Exception as e:
                self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                Handler._profile_lock.release()

    return Handler


def make_server(engine, host: str, port: int):
    """A ``ThreadingHTTPServer`` on ``host:port`` (port 0 picks a free
    one) serving ``engine`` (or a fleet's router: both expose ``infer``,
    the streaming calls, ``health``, ``stats`` and ``metrics_text``),
    one handler thread per connection; the caller owns its lifecycle.
    Handler threads never touch the device: they hand requests on, and
    the profile endpoint's start and stop go to the device worker."""
    from http.server import ThreadingHTTPServer

    return ThreadingHTTPServer((host, port),
                               _make_handler(engine,
                                             service_device(engine)))


def _model_and_config(args):
    """``(state_dict, model_cfg, serve_cfg, sink)`` of parsed ``args``."""
    import os

    from raft_tpu_torch.config import RAFTConfig
    from raft_tpu_torch.evaluate import resolve_device
    from raft_tpu_torch.serve import ServeConfig

    resolve_device(args.device)
    mk = RAFTConfig.small_model if args.small else RAFTConfig.full
    model_cfg = mk(compute_dtype="bfloat16" if args.precision == "bf16"
                   else "float32")
    if args.model:
        from raft_tpu_torch.cli.evaluate import load_model_state_dict

        state_dict = load_model_state_dict(args.model, model_cfg)
    else:
        from raft_tpu_torch.models.raft import RAFT

        state_dict = RAFT(model_cfg, seed=0).state_dict()
    serve_cfg = ServeConfig(
        iters=args.iters, batching=args.batching, slots=args.slots,
        early_exit_threshold=max(args.early_exit_threshold, 0.0),
        stream_ttl_s=max(args.stream_ttl_s, 1e-3),
        stream_warm_iters=args.stream_warm_iters,
        max_sessions=max(args.max_sessions, 1),
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        buckets=_parse_hw_list(args.buckets) if args.buckets else None,
        batch_sizes=tuple(int(b) for b in args.batch_sizes.split(","))
        if args.batch_sizes else None,
        stall_timeout_s=max(args.stall_timeout_s, 0.0),
        device_retries=max(args.device_retries, 0),
        retry_backoff_s=max(args.retry_backoff_s, 0.0),
        retry_backoff_max_s=max(ServeConfig.retry_backoff_max_s,
                                args.retry_backoff_s),
        quality_sample_rate=min(max(args.quality_sample_rate, 0.0), 1.0),
        quality_cycle=args.quality_cycle,
        # a fleet passes its own manifest directory to every engine
        aot_dir=args.aot_dir)
    sink = None
    if args.telemetry_dir:
        from raft_tpu_torch.obs import EventSink

        os.environ.setdefault("RAFT_TELEMETRY_DIR", args.telemetry_dir)
        sink = EventSink(args.telemetry_dir)
    trace_rate = (args.trace_sample_rate
                  if args.trace_sample_rate is not None
                  else float(os.environ.get("RAFT_TRACE_SAMPLE_RATE",
                                            "0") or 0))
    if trace_rate > 0:
        from raft_tpu_torch.obs import trace

        trace.configure(sample_rate=trace_rate, sink=sink)
    return state_dict, model_cfg, serve_cfg, sink


def fleet_mode(args) -> bool:
    return bool(args.replicas > 1 or args.remote or args.autoscale)


def build_engine(args):
    """The single engine of parsed ``args`` (not started)."""
    from raft_tpu_torch.serve import InferenceEngine

    state_dict, model_cfg, serve_cfg, sink = _model_and_config(args)
    return InferenceEngine(state_dict, model_cfg, serve_cfg, sink=sink,
                           device=args.device)


def build_fleet(args):
    """``(fleet, sink)`` of parsed ``args`` in fleet mode: the fleet not
    started yet (``fleet.start()`` brings the replicas up) and the event
    sink its router shares."""
    from raft_tpu_torch.serve import FleetConfig, ReplicaFleet

    autoscale = (0, 0)
    if args.autoscale:
        lo, sep, hi = args.autoscale.partition(":")
        if not sep or not lo.isdigit() or not hi.isdigit():
            raise SystemExit(
                f"--autoscale {args.autoscale!r}: expected MIN:MAX")
        autoscale = (int(lo), int(hi))
    state_dict, model_cfg, serve_cfg, sink = _model_and_config(args)
    warmup = _parse_hw_list(args.warmup) if args.warmup else ()
    fleet = ReplicaFleet(
        state_dict, model_cfg, serve_cfg,
        FleetConfig(replicas=args.replicas, aot_dir=args.aot_dir,
                    warmup_shapes=warmup,
                    remote=tuple(args.remote or ()),
                    autoscale_min=autoscale[0],
                    autoscale_max=autoscale[1]),
        sink=sink, device=args.device)
    return fleet, sink


def start_service(args):
    """Build and start what ``args`` serve: ``(service, fleet)``, the
    engine and None, or the fleet's router and the fleet."""
    if not fleet_mode(args):
        engine = build_engine(args)
        engine.start()
        if args.warmup:
            shapes = _parse_hw_list(args.warmup)
            print(f"warmup: capturing {len(shapes)} shape(s)...",
                  flush=True)
            engine.warmup(shapes)
        return engine, None
    from raft_tpu_torch.serve import FlowRouter, RouterConfig

    fleet, sink = build_fleet(args)
    if args.warmup:
        print(f"fleet warmup: capturing {len(fleet.fleet_cfg.warmup_shapes)}"
              " shape(s) on replica 0, replaying its manifest on the "
              "rest...", flush=True)
    fleet.start()
    router = FlowRouter(
        fleet, RouterConfig(hedge_timeout_s=max(args.hedge_timeout_s, 0.0)),
        sink=sink)
    return router, fleet


def main(argv=None):
    args = parse_args(argv)
    check_unported(args)
    if (args.model is None) == (not args.random_init):
        raise SystemExit("exactly one of --model / --random-init required")

    import os

    from raft_tpu_torch import chaos

    if args.chaos:
        os.environ[chaos.ENV_SPEC] = args.chaos
    if args.chaos_seed is not None:
        os.environ[chaos.ENV_SEED] = str(args.chaos_seed)
    try:
        chaos.install_from_env()
    except chaos.ChaosSpecError as e:
        raise SystemExit(f"--chaos: {e}")

    service, fleet = start_service(args)
    extra = ""
    if fleet is not None:
        extra = (f", replicas={args.replicas}, aot_dir={fleet.aot_dir}"
                 + (f", remote={','.join(args.remote)}" if args.remote
                    else "")
                 + (f", autoscale={args.autoscale}" if args.autoscale
                    else ""))
    server = make_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"raft_tpu_torch serve: listening on http://{host}:{port} "
          f"(device={args.device}, batching={args.batching}, "
          f"max_batch={args.max_batch}, max_wait_ms={args.max_wait_ms}, "
          f"max_queue={args.max_queue}{extra})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        (fleet or service).stop()
        print(json.dumps(service.stats()), flush=True)


if __name__ == "__main__":
    main()
