"""repro_torch.obs — unified metrics, per-request span tracing, and exporters.

The port's copy of ``repro.obs`` (same names, same exposition format).
The observability layer the serving stack, engine facade, kernel dispatcher
and roofline model all record into (DESIGN.md §10):

    metrics    Counter / Gauge / log2-sub-bucketed Histogram + Registry
               (disabled-by-default process registry; zero-cost when off)
    tracing    per-request Timeline (submit -> ... -> complete stage marks)
    export     Prometheus text format, JSONL snapshots, HTTP endpoint, dump()

Quick use::

    import repro_torch.obs as obs
    obs.enable()                       # flip the process-default registry on
    ...serve traffic...
    print(obs.render_prometheus())     # or obs.dump() for plain data

Pure Python, no torch dependency — importable from anywhere in the stack
without cycles or device side effects.
"""
from repro_torch.obs.export import (MetricsServer, dump,
                                    render_prometheus, snapshot_line,
                                    write_jsonl)
from repro_torch.obs.metrics import (SUBBUCKETS, Counter, Gauge,
                                     Histogram, Registry, default_registry,
                                     enable, resolve, use)
from repro_torch.obs.tracing import STAGES, Timeline, stage_durations

__all__ = [
    "SUBBUCKETS", "STAGES", "Counter", "Gauge", "Histogram", "MetricsServer",
    "Registry", "Timeline", "default_registry", "dump", "enable",
    "render_prometheus", "resolve", "snapshot_line", "stage_durations",
    "use", "write_jsonl",
]
