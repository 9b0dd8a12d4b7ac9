"""Dynamic micro-batching: coalesce concurrent single queries into one
batched executor call (the port's copy of ``repro.serve.batcher``).

The engine's executors are keyed per ``(B, Q)`` bucket, so the scheduler's
job is to gather whatever requests are in flight into the *largest batch the
wait budget allows* and pad it onto one of a small fixed set of shapes:

* **admission**: requests queue up with a profile (mode/strategy/measure/k/…);
* **coalescing**: once a request is at the head, the batcher waits at most
  ``max_wait_ms`` for followers (first-request deadline — a lone query never
  waits longer than that) and takes at most ``max_batch``;
* **grouping**: only requests with the *same profile AND the same work lane*
  share an executor call (the profile IS the executor configuration; the
  lane keeps predicted-heavy rows from riding along).  Mixed traffic is
  split into per-(profile, lane) batches, head-of-queue group first;
* **bucketing**: the batch dim is padded up to a power of two by repeating a
  real row (results of pad rows are dropped), and the facade pads Q the same
  way — so steady traffic reuses O(log max_batch · log max_Q) executors
  per profile, which ``SearchEngine.warmup`` constructs ahead of traffic.

**Work lanes** (DESIGN.md §8): a batched search runs until its *slowest*
row finishes, so one heavy query inside a batch of light ones taxes every
batch-mate with its full latency.  The server predicts per-query work from
the sum of query-word document frequencies (df is exactly what drives the
DR frontier and the DRB walk) and maps it to a factor-8 bucket
(:func:`work_bucket`); the batcher then only coalesces within a bucket, and
queries past the heavy threshold ride a ``cap=1`` lane — admitted, never
batched with anyone.

**Adaptive wait**: with ``adaptive_wait`` on, the batcher tracks an EWMA of
request inter-arrival gaps; when the stream is idle (expected gap beyond
``max_wait``) the wait budget collapses to 0 — a lone query on an idle
server pays dispatch latency only, while bursty traffic still coalesces.

Exactness: the port's results are bitwise equal across batch shapes (rows
are independent, pad columns masked), so coalescing/padding/lane-splitting
cannot change any row's answer (``tests/test_torch_serve.py`` pins this).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import repro_torch.obs as obs
from repro_torch.engine.facade import pow2_bucket

EWMA_ALPHA = 0.3        # inter-arrival smoothing (recent gaps dominate)


def work_bucket(work: int) -> int:
    """Factor-8 work bucket of a predicted per-query cost (e.g. the sum of
    query-word document frequencies): 0 for [0, 8), 1 for [8, 64), ...
    Factor 8 is coarse enough that steady traffic occupies a handful of
    lanes, fine enough that a bucket's slowest member costs its batch-mates
    at most ~8x their own work."""
    b, w = 0, max(int(work), 1)
    while w >= 8:
        w //= 8
        b += 1
    return b


@dataclasses.dataclass(frozen=True)
class Lane:
    """Admission lane: requests coalesce only within (profile, lane).

    ``bucket`` is the factor-8 work bucket; ``cap`` bounds the batch size
    for this lane (1 isolates predicted-heavy queries; None defers to the
    batcher's ``max_batch``)."""
    bucket: int = 0
    cap: int | None = None


DEFAULT_LANE = Lane()


@dataclasses.dataclass(frozen=True)
class QueryProfile:
    """Everything that selects an executor, besides the batch itself.

    Hashable — the batcher groups by it and the cache keys on it.  ``df_cap``
    should be pinned (``SearchEngine.suggested_df_cap``) for
    ``strategy='drb', mode='or'`` traffic so the gather width — normally
    derived per batch — stays static across mixed batches.

    ``sla``/``deadline_ms`` are *admission-time* knobs (DESIGN.md §11): the
    server resolves them into a concrete ``budget`` + ``sla`` *effective
    profile* at submit (``deadline_ms`` never reaches the engine), so two
    requests degrade into the same effective profile batch together and the
    cache can never replay a degraded answer for an exact request.
    """
    mode: str = "and"
    strategy: str = "auto"
    measure: str = "tfidf"
    k: int | None = None
    window: int | None = None
    budget: int | None = None
    beam_width: int | None = None
    df_cap: int | None = None
    mega: bool | None = None
    sla: str | None = None
    deadline_ms: float | None = None

    def search_kwargs(self) -> dict:
        # deadline_ms is deliberately absent: the serving layer folds it
        # into ``budget`` at admission; direct engine.search callers pass
        # their own deadline_ms explicitly
        return dict(mode=self.mode, strategy=self.strategy,
                    measure=self.measure, k=self.k, window=self.window,
                    budget=self.budget, beam_width=self.beam_width,
                    df_cap=self.df_cap, mega=self.mega, sla=self.sla)


@dataclasses.dataclass
class Batch:
    """One coalesced executor call: ``items`` are the real requests (any
    payload the caller tracks), ``queries`` the padded row list sent to the
    engine (``len(queries) = pow2_bucket(len(items))``)."""
    profile: QueryProfile
    items: list
    queries: list[list[int]]
    lane: Lane = DEFAULT_LANE

    @property
    def n_real(self) -> int:
        return len(self.items)


def pad_rows(rows: list[list[int]]) -> list[list[int]]:
    """Pad the batch dim to its power-of-two bucket by repeating row 0 —
    a real query, so no masking/validity special case exists; the extra
    rows' results are simply dropped."""
    return rows + [rows[0]] * (pow2_bucket(len(rows)) - len(rows))


class MicroBatcher:
    """Pulls ``(words, profile, item, t_admit[, lane])`` tuples from a source
    and yields padded per-(profile, lane) batches under the max-wait /
    max-batch policy.

    ``source(timeout)`` must return one admitted request or raise
    ``queue.Empty`` — the stdlib queue contract — so the server can hand its
    bounded admission queue straight in.  The batcher keeps requests it has
    accepted but not yet batched in an internal deque (arrival order), so
    nothing is ever dropped here; shedding happens at admission.

    Starvation bound: the batch is always formed around the *oldest* pending
    request (head of the deque), whatever its lane — a heavy ``cap=1``
    request is dispatched as soon as it reaches the head, so lane isolation
    delays it by at most the batches admitted before it, never
    indefinitely.
    """

    def __init__(self, source: Callable, *, max_batch: int = 16,
                 max_wait_ms: float = 2.0, pending_cap: int | None = None,
                 adaptive_wait: bool = False, clock=time.monotonic,
                 registry: "obs.Registry | None" = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self._source = source
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.adaptive_wait = adaptive_wait
        # bound on requests held here awaiting a same-profile batch: without
        # it, assembling a profile-A batch under a flood of profile-B traffic
        # would drain the (bounded) admission queue into this (unbounded)
        # deque and the shed policy would never engage
        self.pending_cap = max(max_batch, pending_cap or 4 * max_batch)
        self._clock = clock
        self._obs = obs.resolve(registry)
        self._m_wait = self._obs.histogram(
            "repro_batch_coalesce_wait_seconds", None,
            "head-request age when its batch formed")
        self._ewma_gap: float | None = None     # smoothed inter-arrival gap
        self._last_arrival: float | None = None
        self._pending: deque = deque()  # (words, profile, item, t_admit, lane)

    def _pull(self, timeout: float) -> bool:
        import queue as _q
        try:
            r = self._source(timeout=max(0.0, timeout))
        except _q.Empty:
            return False
        if len(r) == 4:                     # lane-less producers still work
            r = (*r, DEFAULT_LANE)
        self._pending.append(r)
        if self._obs.enabled:
            tl = getattr(r[2], "timeline", None)
            if tl is not None:
                tl.mark("lane_enqueue")
        now = self._clock()
        if self._last_arrival is not None:
            gap = now - self._last_arrival
            self._ewma_gap = gap if self._ewma_gap is None else (
                EWMA_ALPHA * gap + (1.0 - EWMA_ALPHA) * self._ewma_gap)
        self._last_arrival = now
        return True

    def effective_wait(self) -> float:
        """The coalescing budget for the next batch: ``max_wait``, collapsed
        to 0 when ``adaptive_wait`` is on and the arrival stream looks idle
        (expected gap at or beyond ``max_wait`` — waiting would buy no
        batch-mates, only latency)."""
        if not self.adaptive_wait or self._ewma_gap is None:
            return self.max_wait
        return 0.0 if self._ewma_gap >= self.max_wait else self.max_wait

    def next_batch(self, poll_s: float = 0.05) -> Batch | None:
        """Block up to ``poll_s`` for traffic, then coalesce and return one
        batch — or None if the queue stayed empty (callers loop on this, so
        shutdown flags get re-checked every ``poll_s``)."""
        if not self._pending and not self._pull(poll_s):
            return None
        # head request sets the deadline: wait for followers until the head
        # has been held max_wait, or a full batch of its group is ready.
        # Requests already queued (e.g. admitted while the previous batch was
        # computing) are always drained first, without waiting — the wait
        # budget is only ever spent on traffic that hasn't arrived yet.
        head = self._pending[0]
        group = (head[1], head[4])              # (profile, lane)
        cap = min(self.max_batch, head[4].cap or self.max_batch)
        deadline = head[3] + self.effective_wait()
        # running head-group count: one scan of the leftover deque, then
        # O(1) per pull — batch assembly must stay cheap on the dispatch
        # thread, which is the path the batcher exists to protect
        n_head = sum(1 for r in self._pending if (r[1], r[4]) == group)

        def may_pull() -> bool:
            return n_head < cap and len(self._pending) < self.pending_cap

        def pull(timeout: float) -> bool:
            nonlocal n_head
            if not self._pull(timeout):
                return False
            r = self._pending[-1]
            n_head += (r[1], r[4]) == group
            return True

        while may_pull() and pull(0.0):
            pass
        while may_pull():
            remaining = deadline - self._clock()
            if remaining <= 0 or not pull(remaining):
                break
            while may_pull() and pull(0.0):
                pass
        taken, rest = [], deque()
        for r in self._pending:
            if (r[1], r[4]) == group and len(taken) < cap:
                taken.append(r)
            else:
                rest.append(r)
        self._pending = rest
        if self._obs.enabled:
            lane = group[1]
            self._obs.histogram(
                "repro_batch_size",
                {"lane": f"{lane.bucket}/{lane.cap or 'max'}"},
                "real rows per coalesced batch, by admission lane",
            ).observe(len(taken))
            self._m_wait.observe(self._clock() - taken[0][3])
            for _, _, item, _, _ in taken:
                tl = getattr(item, "timeline", None)
                if tl is not None:
                    tl.mark("batch_form")
        rows = [list(words) for words, _, _, _, _ in taken]
        return Batch(profile=group[0],
                     items=[item for _, _, item, _, _ in taken],
                     queries=pad_rows(rows), lane=group[1])
