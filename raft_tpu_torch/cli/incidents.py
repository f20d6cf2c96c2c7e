"""``python -m raft_tpu_torch incidents`` — browse forensic incident
bundles (the port of ``raft_tpu/cli/incidents.py``; host-only, and the
bundle format of both packages is one).

Reads the ``incidents/<id>/`` bundles the
:class:`~raft_tpu_torch.obs.incident.IncidentManager` wrote under the
telemetry directory (``--telemetry-dir`` or ``$RAFT_TELEMETRY_DIR``)
and answers the on-call questions without grepping N JSONL files:

- ``list`` — every incident: severity, status, open time, duration,
  trigger, correlated-signal count;
- ``show <id>`` — one incident's full record + bundle inventory
  (events window, trace trees, metric/stats snapshots);
- ``timeline <id>`` — the correlated signals in FIRST-FIRED order (in
  a cascade the earliest signal is the probable cause — it is printed
  first and flagged), then the bundled event window in time order.

``<id>`` accepts any unique prefix.  ``--json`` emits machine-readable
output for scripts.

Typical loop::

    python -m raft_tpu_torch incidents list --telemetry-dir /tmp/telem
    python -m raft_tpu_torch incidents timeline inc-2026
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch incidents",
        description="list / show / timeline over incident bundles")
    p.add_argument("action", nargs="?", default="list",
                   choices=("list", "show", "timeline"),
                   help="what to print (default: list)")
    p.add_argument("id", nargs="?", default=None,
                   help="incident id (any unique prefix; required for "
                        "show/timeline)")
    p.add_argument("--telemetry-dir", default=None,
                   help="telemetry directory holding incidents/ "
                        "(default: $RAFT_TELEMETRY_DIR)")
    p.add_argument("--json", action="store_true",
                   help="emit JSON instead of the human layout")
    return p.parse_args(argv)


def _incidents_dir(telemetry_dir: Optional[str]) -> Optional[str]:
    base = telemetry_dir or os.environ.get("RAFT_TELEMETRY_DIR")
    if not base:
        return None
    d = os.path.join(base, "incidents")
    return d if os.path.isdir(d) else None


def load_incidents(telemetry_dir: Optional[str]) -> List[dict]:
    """Every parseable ``incidents/<id>/incident.json``, oldest
    first.  A torn/unwritable bundle is skipped, never fatal."""
    d = _incidents_dir(telemetry_dir)
    if d is None:
        return []
    out = []
    for name in sorted(os.listdir(d)):
        path = os.path.join(d, name, "incident.json")
        try:
            with open(path) as f:
                inc = json.load(f)
        except (OSError, ValueError):
            continue
        inc["_bundle_dir"] = os.path.join(d, name)
        out.append(inc)
    out.sort(key=lambda i: i.get("opened_t_wall") or 0.0)
    return out


def _resolve(incidents: List[dict], ident: str) -> dict:
    hits = [i for i in incidents if i.get("id", "").startswith(ident)]
    if not hits:
        raise SystemExit(f"no incident matching {ident!r}")
    if len(hits) > 1:
        ids = ", ".join(i["id"] for i in hits)
        raise SystemExit(f"ambiguous id {ident!r}: {ids}")
    return hits[0]


def _ts(t_wall) -> str:
    if not isinstance(t_wall, (int, float)):
        return "-"
    return time.strftime("%Y-%m-%d %H:%M:%S",
                         time.localtime(t_wall))


def _cmd_list(incidents: List[dict], as_json: bool) -> int:
    if as_json:
        print(json.dumps([{k: v for k, v in i.items()
                           if k != "_bundle_dir"} for i in incidents]))
        return 0
    if not incidents:
        print("no incidents recorded")
        return 0
    hdr = (f"{'id':<36} {'sev':<8} {'status':<7} "
           f"{'opened':<19} {'dur_s':>7} {'sigs':>4}  trigger")
    print(hdr)
    print("-" * len(hdr))
    for i in incidents:
        print(f"{i.get('id', '?'):<36} {i.get('severity', '?'):<8} "
              f"{i.get('status', '?'):<7} "
              f"{_ts(i.get('opened_t_wall')):<19} "
              f"{i.get('duration_s', '-'):>7} "
              f"{len(i.get('signals', [])):>4}  "
              f"{i.get('trigger', '?')}")
    return 0


def _bundle_inventory(inc: dict) -> dict:
    inv = {}
    bdir = inc.get("_bundle_dir")
    if not bdir:
        return inv
    for name in sorted(os.listdir(bdir)):
        path = os.path.join(bdir, name)
        entry = {"bytes": os.path.getsize(path)}
        if name.endswith(".jsonl"):
            with open(path) as f:
                entry["records"] = sum(1 for _ in f)
        inv[name] = entry
    return inv


def _cmd_show(inc: dict, as_json: bool) -> int:
    inv = _bundle_inventory(inc)
    if as_json:
        rec = {k: v for k, v in inc.items() if k != "_bundle_dir"}
        print(json.dumps(dict(rec, bundle=inv)))
        return 0
    print(f"incident {inc['id']}")
    for k in ("severity", "status", "trigger", "close_reason",
              "duration_s", "events"):
        if inc.get(k) is not None:
            print(f"  {k:<13} {inc[k]}")
    print(f"  opened        {_ts(inc.get('opened_t_wall'))}")
    if inc.get("closed_t_wall"):
        print(f"  closed        {_ts(inc.get('closed_t_wall'))}")
    print(f"  signals       "
          f"{', '.join(s['event'] for s in inc.get('signals', []))}")
    print(f"  bundle        {inc.get('_bundle_dir')}")
    for name, entry in inv.items():
        recs = (f", {entry['records']} records"
                if "records" in entry else "")
        print(f"    {name:<16} {entry['bytes']} bytes{recs}")
    return 0


def _cmd_timeline(inc: dict, as_json: bool) -> int:
    signals = list(inc.get("signals", []))
    signals.sort(key=lambda s: s.get("first_t_mono") or 0.0)
    if as_json:
        print(json.dumps({"id": inc["id"],
                          "probable_cause": (signals[0]["event"]
                                             if signals else None),
                          "signals": signals}))
        return 0
    print(f"incident {inc['id']} — correlated signals, first-fired "
          f"first (earliest = probable cause):")
    t0 = signals[0].get("first_t_wall") if signals else None
    for j, s in enumerate(signals):
        dt = (s.get("first_t_wall") - t0
              if isinstance(s.get("first_t_wall"), (int, float))
              and isinstance(t0, (int, float)) else None)
        mark = "  <- probable cause" if j == 0 else ""
        off = f"+{dt:8.3f}s" if dt is not None else "        ?"
        print(f"  {off}  {s['event']:<24} x{s.get('count', 1):<5} "
              f"[{s.get('severity', '?')}]{mark}")
    events_path = os.path.join(inc.get("_bundle_dir", ""),
                               "events.jsonl")
    if os.path.exists(events_path):
        print("event window:")
        with open(events_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                dt = (rec.get("t_wall") - t0
                      if isinstance(t0, (int, float))
                      and isinstance(rec.get("t_wall"),
                                     (int, float)) else None)
                off = f"+{dt:8.3f}s" if dt is not None else "        ?"
                extra = rec.get("replica") or ""
                print(f"  {off}  {rec.get('event', '?'):<24} {extra}")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    incidents = load_incidents(args.telemetry_dir)
    try:
        if args.action == "list":
            return _cmd_list(incidents, args.json)
        if args.id is None:
            print(f"{args.action} needs an incident id "
                  "(see: incidents list)", file=sys.stderr)
            return 2
        inc = _resolve(incidents, args.id)
        if args.action == "show":
            return _cmd_show(inc, args.json)
        return _cmd_timeline(inc, args.json)
    except BrokenPipeError:
        # Downstream pager/head closed the pipe; exit quietly instead
        # of tracebacking.  Redirect stdout so interpreter shutdown's
        # implicit flush doesn't raise again.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
