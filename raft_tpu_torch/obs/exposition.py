"""Prometheus text exposition (format version 0.0.4) over a registry (the
port's copy of ``raft_tpu/obs/exposition.py``).

Counters and gauges render as themselves; histograms render as
``summary`` metrics (quantiles over the bounded reservoir window plus
lifetime ``_sum``/``_count``) — the registry keeps reservoirs, not
fixed buckets, so quantile-at-render is the honest translation.

Metric and label names are validated at registration time
(``registry._NAME_RE``), so rendering cannot produce an unparseable
line; label *values* are escaped here.
"""

from __future__ import annotations

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_QUANTILES = (0.5, 0.95, 0.99)


def _escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels(items) -> str:
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


def _fmt(v) -> str:
    f = float(v)
    if f.is_integer() and abs(f) < 2 ** 53:
        return str(int(f))
    return repr(f)


def render(registry, extra_labels=None) -> str:
    """Render ``registry``; ``extra_labels`` (``{name: value}``) are
    merged into EVERY exported sample — how the fleet router scopes each
    replica's engine registry under ``replica="rN"`` in one aggregated
    ``/metrics`` page without the engines knowing they are fleet
    members.  An extra label colliding with a sample's own label loses
    (the sample's value wins — it is more specific)."""
    import numpy as np

    extra = tuple(sorted((k, str(v))
                         for k, v in (extra_labels or {}).items()))

    def merged(key):
        have = {k for k, _ in key}
        return tuple(sorted(key + tuple(
            (k, v) for k, v in extra if k not in have)))

    registry.collect()
    lines = []
    for m in registry.metrics():
        if m.help:
            lines.append(f"# HELP {m.name} {_escape(m.help)}")
        ptype = "summary" if m.kind == "histogram" else m.kind
        lines.append(f"# TYPE {m.name} {ptype}")
        items = m.items()
        if not items:
            # Scrape-config stability: a counter/histogram that has not
            # fired yet still exports (at zero), so dashboards and
            # `rate()` queries see the series from the first scrape.  A
            # never-set gauge stays absent: unknown is not zero.
            if m.kind == "counter":
                lines.append(f"{m.name}{_labels(merged(()))} 0")
            elif m.kind == "histogram":
                lines.append(f"{m.name}_sum{_labels(merged(()))} 0")
                lines.append(f"{m.name}_count{_labels(merged(()))} 0")
            continue
        for raw_key, v in items:
            key = merged(raw_key)
            if m.kind == "histogram":
                count, total, window = v
                if window:
                    qs = np.percentile(np.asarray(window, np.float64),
                                       [q * 100 for q in _QUANTILES])
                    for q, val in zip(_QUANTILES, qs):
                        lines.append(
                            f"{m.name}"
                            f"{_labels(key + (('quantile', str(q)),))}"
                            f" {_fmt(float(val))}")
                lines.append(f"{m.name}_sum{_labels(key)} {_fmt(total)}")
                lines.append(f"{m.name}_count{_labels(key)} {_fmt(count)}")
            else:
                lines.append(f"{m.name}{_labels(key)} {_fmt(v)}")
    return "\n".join(lines) + "\n"
