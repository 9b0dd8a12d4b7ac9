"""Exporters over :class:`repro_torch.obs.Registry`: Prometheus text format,
JSONL snapshots, and a background HTTP scrape endpoint.

* :func:`render_prometheus` — the text exposition format (counters, gauges,
  and histograms with cumulative ``_bucket{le=...}`` series reconstructed
  from the log2 sub-buckets) — what ``launch/serve.py --metrics-port``
  serves at ``/metrics``.
* :func:`snapshot_line` / :func:`write_jsonl` — one JSON object per call
  (``{"ts": ..., "metrics": {...}}``), appendable to a log; the schema is
  exactly ``Registry.snapshot()`` (README §Observability documents it).
* :class:`MetricsServer` — a daemon-thread ``http.server`` serving
  ``/metrics`` (Prometheus) and ``/metrics.json`` (one snapshot object).
* :func:`dump` — the one-shot: snapshot the default registry, optionally
  append to a JSONL path, return the dict.
"""
from __future__ import annotations

import http.server
import json
import math
import threading
import time

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     Registry, _label_str, bucket_hi,
                                     default_registry)


def _fmt(v: float) -> str:
    if v != v:                                   # NaN
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def render_prometheus(reg: Registry | None = None) -> str:
    """The registry in Prometheus text exposition format (version 0.0.4)."""
    reg = reg or default_registry()
    lines: list[str] = []
    seen_header: set[str] = set()
    for m in sorted(reg.metrics(), key=lambda m: (m.name, m.labels)):
        if m.name not in seen_header:
            seen_header.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
        ls = _label_str(m.labels)
        if isinstance(m, (Counter, Gauge)):
            lines.append(f"{m.name}{ls} {_fmt(m._snapshot())}")
            continue
        assert isinstance(m, Histogram)
        snap = m._snapshot()
        cum = snap["zeros"]
        if cum:
            lines.append(_bucket_line(m.name, m.labels, 0.0, cum))
        for idx, c in snap["buckets"].items():
            cum += c
            lines.append(_bucket_line(m.name, m.labels, bucket_hi(idx), cum))
        lines.append(_bucket_line(m.name, m.labels, math.inf, snap["count"]))
        lines.append(f"{m.name}_sum{ls} {_fmt(snap['sum'])}")
        lines.append(f"{m.name}_count{ls} {snap['count']}")
    return "\n".join(lines) + "\n"


def _bucket_line(name: str, labels: tuple, le: float, cum: int) -> str:
    items = labels + (("le", _fmt(le)),)
    inner = ",".join(f'{k}="{v}"' for k, v in items)
    return f"{name}_bucket{{{inner}}} {cum}"


def snapshot_line(reg: Registry | None = None) -> str:
    """One JSONL line: ``{"ts": unix-seconds, "metrics": snapshot}``."""
    reg = reg or default_registry()
    return json.dumps({"ts": time.time(), "metrics": reg.snapshot()},
                      sort_keys=True)


def write_jsonl(path, reg: Registry | None = None) -> None:
    with open(path, "a") as f:
        f.write(snapshot_line(reg) + "\n")


def dump(reg: Registry | None = None, path=None) -> dict:
    """One-shot: the default (or given) registry's snapshot as plain data;
    with ``path``, also append it as a JSONL line."""
    reg = reg or default_registry()
    if path is not None:
        write_jsonl(path, reg)
    return reg.snapshot()


class MetricsServer:
    """Background scrape endpoint: ``/metrics`` (Prometheus text) and
    ``/metrics.json`` (one snapshot object).  Daemon thread — never blocks
    shutdown; use as a context manager or call :meth:`close`."""

    def __init__(self, registry: Registry | None = None, port: int = 0,
                 host: str = "127.0.0.1"):
        reg = registry or default_registry()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):                        # noqa: N802 (stdlib API)
                if self.path.startswith("/metrics.json"):
                    body = snapshot_line(reg).encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = render_prometheus(reg).encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):                # quiet scrape logs
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="obs-metrics-http")
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
