"""Per-request span tracing: a timeline of named stage marks per ticket.

A :class:`Timeline` is a flat append-only list of ``(stage, t_monotonic)``
marks — no nesting, no context propagation: the serving pipeline is a fixed
linear sequence (DESIGN.md §10), so the span model can be this cheap.  The
canonical stages, in pipeline order::

    submit        client called SearchServer.submit
    admit         request validated, cache missed, entering the queue
    lane_enqueue  pulled off the admission queue into the batcher's deque
    batch_form    chosen into a coalesced batch
    dispatch      batch handed to the engine (t_dispatch)
    device        engine call returned and its device values are ready
    slice         per-row host slices materialized
    complete      ticket completed (t_complete)

Timelines are only allocated when the server's registry is enabled — a
disabled server leaves ``Ticket.timeline`` None and pays nothing.  The
derived stage *durations* the registry aggregates (queue-wait, device,
slice, total) are defined in :func:`stage_durations`; the raw marks survive
on the ticket for one-off debugging and the JSONL snapshot path.
"""
from __future__ import annotations

import time

STAGES = ("submit", "admit", "lane_enqueue", "batch_form", "dispatch",
          "device", "slice", "complete")


class Timeline:
    """Append-only ``(stage, t)`` marks for one request."""

    __slots__ = ("marks",)

    def __init__(self, t0: float | None = None):
        self.marks: list[tuple[str, float]] = \
            [("submit", time.monotonic() if t0 is None else t0)]

    def mark(self, stage: str, t: float | None = None) -> None:
        self.marks.append((stage, time.monotonic() if t is None else t))

    def t(self, stage: str) -> float | None:
        """First mark time of ``stage`` (None if never reached)."""
        for s, ts in self.marks:
            if s == stage:
                return ts
        return None

    def spans(self) -> list[tuple[str, float]]:
        """Consecutive-mark durations ``[(from->to, seconds), ...]`` in the
        order the request actually moved through the pipeline."""
        out = []
        for (s0, t0), (s1, t1) in zip(self.marks, self.marks[1:]):
            out.append((f"{s0}->{s1}", t1 - t0))
        return out

    def as_dict(self) -> dict[str, float]:
        """Stage -> first-mark time (for JSONL / debugging)."""
        out: dict[str, float] = {}
        for s, ts in self.marks:
            out.setdefault(s, ts)
        return out


def stage_durations(tl: Timeline) -> dict[str, float]:
    """The aggregated stage breakdown of one completed request.

    queue_wait  submit -> dispatch (admission + coalescing; for a cache hit,
                which never dispatches, 0)
    device      dispatch -> device (the engine call, device sync included)
    slice       device -> slice (host row materialization)
    total       submit -> complete

    Missing marks drop their stage from the dict rather than guessing.
    """
    ts = tl.as_dict()
    out: dict[str, float] = {}

    def span(name, a, b):
        if a in ts and b in ts:
            out[name] = ts[b] - ts[a]

    span("queue_wait", "submit", "dispatch")
    span("device", "dispatch", "device")
    span("slice", "device", "slice")
    span("total", "submit", "complete")
    return out
