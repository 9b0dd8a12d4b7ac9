"""Thread-based serving frontend: admission queue -> micro-batcher -> engine
-> cache, with backpressure and per-request timing (the port's copy of
``repro.serve.server``).

One dispatch thread owns the engine: every search, and so every kernel
launch of a served batch, runs on that thread, one batch at a time.
Submitters interact only with the bounded admission queue and the result
cache:

    server = SearchServer(engine, max_batch=16, max_wait_ms=2.0)
    server.warmup(example_queries)        # every bucket's executor first
    with server:
        row = server.search([w1, w2])     # blocking convenience
        t = server.submit([w1, w2])       # or async: ticket.result()

Backpressure / shed-load: the admission queue is bounded (``queue_depth``);
when it is full, ``submit`` raises :class:`ShedError` immediately instead of
queueing unbounded work — the caller (load balancer) retries elsewhere.  A
shed request costs microseconds, so an overloaded server stays responsive
for the traffic it *did* admit.

Exactness: identical to direct ``engine.search`` row-for-row (bitwise —
pinned in tests): batching only stacks rows, padding only adds dropped rows/
masked columns, and the cache only replays identical normalized requests —
under a key versioned by the engine's content tag, so replays can never
cross an :meth:`SearchServer.swap_engine` (drain -> swap -> clear).

Tail isolation (``work_buckets=True``): admission predicts per-query work
from summed word document frequencies and batches only within factor-8 work
lanes; predicted-heavy queries run alone (DESIGN.md §8).

Observability (DESIGN.md §10): every request carries a span
:class:`repro_torch.obs.Timeline` (submit -> admit -> lane_enqueue -> batch_form
-> dispatch -> device -> slice -> complete) when the server's registry is
enabled, and the server mirrors its counters plus per-stage latency
histograms (queue-wait / device / slice / total) into that registry —
``stats`` remains the dict-shaped compatibility view, now built from
defensive snapshots so no reader can observe a mid-mutation engine or cache
dict.  With the registry disabled (the default) no timeline is allocated
and every recording call is a single checked no-op.

Host copies: the engine returns tensors on its device as soon as the work
is queued.  The dispatch thread copies each result leaf to the host once
per batch, takes the batch's wall time after that copy (so the straggler
watchdog and the deadline -> budget estimator see the work, not its
launch), and slices the host arrays into rows.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.engine.config import SLA_CLASSES
from repro_torch.engine.facade import budget_bucket
from repro_torch.obs.tracing import Timeline, stage_durations
from repro_torch.runtime.fault_tolerance import StragglerWatchdog
from repro_torch.serve.batcher import (DEFAULT_LANE, Batch, Lane,
                                       MicroBatcher, QueryProfile,
                                       work_bucket)
from repro_torch.serve.cache import LRUCache

DEFAULT_PROFILE = QueryProfile()

# degradation floor (DESIGN.md §11): the smallest anytime budget degraded
# serving will shrink to — below this a search returns so little that
# shedding is more honest than serving it
MIN_BUDGET = 8


class ShedError(RuntimeError):
    """Admission queue full — request rejected without queueing (shed load)."""


class RequestTimeout(TimeoutError):
    """A waiter gave up on a ticket and *finalized* it (:meth:`Ticket.cancel`)
    — distinct from ``ShedError`` (never admitted) and from dispatch errors
    (the engine failed); load reports bucket the three separately."""


@dataclasses.dataclass
class RowResult:
    """One request's slice of a batched :class:`SearchResults` (host arrays).

    ``docs``/``scores`` are the (k,) ranked answer; ``n_found`` how many are
    real; diagnostics mirror ``SearchResults.diagnostics`` per row.

    ``certified``/``score_bound``/``sla`` are the anytime contract
    (DESIGN.md §11): certified slots provably equal the exact oracle's;
    ``score_bound`` caps the score of everything not returned.
    """
    docs: np.ndarray
    scores: np.ndarray
    n_found: int
    work: int
    k: int
    mode: str
    strategy: str
    measure: str
    pops: int | None = None
    overflowed: bool | None = None
    padded: int | None = None
    match_pos: np.ndarray | None = None
    match_len: np.ndarray | None = None
    certified: np.ndarray | None = None
    score_bound: float | None = None
    sla: str = "exact"

    def hits(self) -> list[tuple[int, float]]:
        n = self.n_found
        return [(int(d), float(s))
                for d, s in zip(self.docs[:n], self.scores[:n])]

    @property
    def n_certified(self) -> int:
        """Certified result slots (== ``n_found`` when no data: exhaustive
        paths are exact end to end)."""
        if self.certified is None:
            return self.n_found
        return int(np.sum(self.certified[:self.n_found]))


class Ticket:
    """Handle for one in-flight request: wait on :meth:`result`; timings are
    recorded by the server (``latency_s`` spans submit -> completion,
    queue wait included — the number a client actually experiences; it
    decomposes exactly into :attr:`queue_wait_s` + :attr:`service_s`).
    ``timeline`` is the span trace (None unless the server's obs registry
    is enabled)."""

    __slots__ = ("words", "profile", "t_submit", "t_dispatch", "t_done",
                 "cache_hit", "batch_size", "timeline", "degraded",
                 "_event", "_result", "_error", "_lock")

    def __init__(self, words, profile):
        self.words = words
        self.profile = profile
        self.t_submit = time.monotonic()
        self.t_dispatch = None
        self.t_done = None
        self.cache_hit = False
        self.batch_size = 0
        self.degraded = False     # admission shrank the budget under load
        self.timeline: Timeline | None = None
        self._event = threading.Event()
        self._result = None
        self._error = None
        self._lock = threading.Lock()   # guards the complete/cancel race

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self, error: Exception) -> bool:
        """Resolve this ticket with ``error`` unless it already completed —
        the loadgen's timeout path (satellite of DESIGN.md §11): a timed-out
        ticket is *finalized*, never abandoned, so a late dispatch completion
        cannot resurrect it and leak into a later measurement window.
        Returns True if this call won the race."""
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
            self.t_done = time.monotonic()
            if self.timeline is not None:
                self.timeline.mark("complete", self.t_done)
            self._event.set()
            return True

    @property
    def error(self) -> Exception | None:
        """The dispatch-time failure, if this request errored (load reports
        must not count errored tickets as served)."""
        return self._error

    def result(self, timeout: float | None = None) -> RowResult:
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def t_complete(self) -> float | None:
        """Completion time (alias of ``t_done`` — the span taxonomy's name
        for the terminal mark)."""
        return self.t_done

    @property
    def queue_wait_s(self) -> float | None:
        """Submit -> dispatch: admission backlog + coalescing wait.  0 for a
        cache hit (it never queues); None while in flight."""
        if self.t_done is None:
            return None
        if self.t_dispatch is None:
            return 0.0
        return self.t_dispatch - self.t_submit

    @property
    def service_s(self) -> float | None:
        """Dispatch -> complete: engine + host-slice time (for a cache hit,
        the full — microseconds-scale — completion time); None in flight."""
        if self.t_done is None:
            return None
        t0 = self.t_submit if self.t_dispatch is None else self.t_dispatch
        return self.t_done - t0

    def _complete(self, result=None, error=None):
        with self._lock:
            if self._event.is_set():      # lost the race to cancel()
                return
            self._result, self._error = result, error
            self.t_done = time.monotonic()
            if self.timeline is not None:
                self.timeline.mark("complete", self.t_done)
            self._event.set()


class SearchServer:
    """Ties queue -> batcher -> engine -> cache together (one dispatch
    thread); collects the serving metrics the load harness reports."""

    def __init__(self, engine, *, max_batch: int = 16, max_wait_ms: float = 2.0,
                 queue_depth: int = 256, cache_size: int = 1024,
                 work_buckets: bool = False, heavy_df: int | None = None,
                 adaptive_wait: bool = False,
                 registry: "obs.Registry | None" = None):
        """``work_buckets`` turns on df-predicted admission lanes: queries
        coalesce only within a factor-8 bucket of their summed word document
        frequency, and queries at or past ``heavy_df`` (default: twice the
        engine's document count) run at batch size 1 so they never tax
        lighter batch-mates (DESIGN.md §8).  ``adaptive_wait`` collapses the
        coalescing wait to 0 while the arrival stream is idle.  ``registry``
        is the :mod:`repro_torch.obs` registry counters/histograms/span timelines
        record into (default: the process registry, disabled unless
        ``obs.enable()``/the CLI metrics flags turned it on); the engine is
        pinned to the same registry (``engine.obs_registry``) so engine-side
        counters land next to the serving ones."""
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.engine = engine
        self.obs = obs.resolve(registry)
        if hasattr(engine, "obs_registry"):
            engine.obs_registry = self.obs       # engine records where we do
        self.cache = LRUCache(cache_size, registry=self.obs)
        self.work_buckets = work_buckets
        self._heavy_df_explicit = heavy_df is not None
        self.heavy_df = heavy_df if heavy_df is not None else \
            2 * int(getattr(engine, "n_docs", 1 << 29))
        # engine content tag versions every cache key: a swapped-in engine
        # can never satisfy a hit stored under its predecessor
        self._tag = getattr(engine, "content_tag", None)
        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        # pending_cap=queue_depth bounds admitted-but-undispatched work to
        # 2 x queue_depth (queue + batcher deque) under mixed-profile floods
        self._batcher = MicroBatcher(self._queue.get, max_batch=max_batch,
                                     max_wait_ms=max_wait_ms,
                                     pending_cap=queue_depth,
                                     adaptive_wait=adaptive_wait,
                                     registry=self.obs)
        self._thread: threading.Thread | None = None
        self._running = False
        self._draining = False       # swap in progress: shed new admissions
        self._n_inflight = 0         # admitted, not yet completed/errored
        self._lock = threading.Lock()
        # degraded serving engages when the admission backlog crosses this
        # (DESIGN.md §11): non-exact traffic gets its budget shrunk so the
        # queue drains instead of growing into the shed wall
        self._degrade_at = max(1, (3 * queue_depth) // 4)
        self._watchdog = StragglerWatchdog()     # dispatch-batch step times
        self._step = 0                           # watchdog step counter
        self.n_submitted = 0
        self.n_served = 0
        self.n_shed = 0
        self.n_degraded = 0
        self.n_stragglers = 0
        self.n_errors = 0
        self.n_swaps = 0
        self.n_overflowed = 0        # served rows whose heap latched overflow
        self.n_padded = 0            # summed pad-waste lanes of served rows
        self.batch_hist: dict[int, int] = {}     # real batch size -> count
        self.dispatch_s = 0.0                    # engine wall time, summed
        # registry mirrors of the counters above + the stage histograms
        req = "repro_server_requests_total"
        self._m_req = {o: self.obs.counter(req, {"outcome": o},
                                           "requests by terminal outcome")
                       for o in ("submitted", "served", "shed", "error",
                                 "cache_hit", "degraded")}
        self._m_straggler = self.obs.counter(
            "repro_server_straggler_batches_total", None,
            "dispatch batches the step-time watchdog flagged slow")
        self._m_swaps = self.obs.counter("repro_server_swaps_total", None,
                                         "engine hot-swaps completed")
        self._m_overflow = self.obs.counter(
            "repro_server_overflow_rows_total", None,
            "served rows whose search heap latched overflow")
        self._m_padded = self.obs.counter(
            "repro_server_padded_lanes_total", None,
            "dead beam lanes paid for by served rows (pad waste)")
        self._m_dispatch = self.obs.histogram(
            "repro_dispatch_seconds", None, "engine wall time per batch")
        self._m_stage = {s: self.obs.histogram(
            "repro_request_stage_seconds", {"stage": s},
            "per-request latency by pipeline stage")
            for s in ("queue_wait", "device", "slice", "total")}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "SearchServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="search-server-dispatch")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain everything already admitted, then stop the dispatch thread."""
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    __enter__ = start

    def __exit__(self, *exc):
        self.stop()

    def warmup(self, example_queries, profile: QueryProfile = DEFAULT_PROFILE,
               ) -> int:
        """Construct every (batch bucket, Q bucket) executor this server's
        coalescing can produce for ``profile`` (on the card the engine
        first builds every missing kernel library) — call before admitting
        traffic so no request pays for either.  Also warms the *effective*
        profile admission would resolve this one into (DESIGN.md §11: a
        ``deadline_ms`` becomes a concrete pop budget at submit).  Returns
        the number of executors constructed."""
        n = self.engine.warmup(example_queries,
                               max_batch=self._batcher.max_batch,
                               **profile.search_kwargs())
        eff, _ = self._effective(profile, None)
        if eff != profile:
            n += self.engine.warmup(example_queries,
                                    max_batch=self._batcher.max_batch,
                                    **eff.search_kwargs())
        return n

    # -- request path --------------------------------------------------------

    def _normalize(self, words, profile: QueryProfile) -> tuple[int, ...]:
        """Validate ONE query at admission.  Anything that could make
        ``engine.search`` reject a coalesced batch must be caught here — a
        poison row inside a batch would otherwise fail its innocent
        batch-mates."""
        arr = np.asarray(words, dtype=np.int64)
        if arr.ndim != 1:
            raise ValueError(f"submit takes one flat query, got shape "
                             f"{arr.shape}; submit batch rows individually "
                             "(coalescing is the server's job)")
        key = tuple(int(w) for w in arr)
        if not key:
            raise ValueError("empty query")
        V = self.engine.model.vocab_size
        bad = [w for w in key if not 1 <= w < V]
        if bad:
            raise ValueError(f"query word ids must be in [1, {V}); got {bad}")
        if profile.df_cap is not None:
            # reuse the facade's own cap formula (no drift) on the already-
            # validated ids — skipping suggested_df_cap's full re-encode
            # keeps the per-submit cost to one small fancy-index
            ranks = np.asarray(self.engine.model.rank_of_word)[list(key)]
            need = self.engine._df_cap(ranks[None, :],
                                       np.ones((1, len(key)), bool))
            if need > profile.df_cap:
                raise ValueError(
                    f"query needs df_cap {need} but this profile pins "
                    f"{profile.df_cap}; route it to a wider profile")
        return key

    def _lane_of(self, key: tuple[int, ...]) -> Lane:
        """df-predicted admission lane (DEFAULT_LANE when work bucketing is
        off or the engine exposes no df table — dummy engines still serve)."""
        if not self.work_buckets:
            return DEFAULT_LANE
        df = getattr(self.engine, "_df_np", None)
        rank_of = getattr(getattr(self.engine, "model", None),
                          "rank_of_word", None)
        if df is None or rank_of is None:
            return DEFAULT_LANE
        work = int(df[np.asarray(rank_of)[list(key)]].sum())
        heavy = work >= self.heavy_df
        return Lane(bucket=work_bucket(work), cap=1 if heavy else None)

    def _effective(self, profile: QueryProfile,
                   deadline_ms: float | None) -> tuple[QueryProfile, bool]:
        """Resolve a request's admission-time SLA into the *effective*
        profile the engine will run (DESIGN.md §11 degradation ladder):

        1. ``sla`` defaults per the engine config, auto-promoted to
           "bounded" when the request carries a budget or deadline;
        2. a deadline becomes a pop budget at the live us/pop estimate
           (min-combined with an explicit budget);
        3. under queue pressure (backlog >= 3/4 depth) non-exact traffic is
           *degraded*: sla forced to "best_effort", budget shrunk 4x (floor
           ``MIN_BUDGET``) so admitted work drains the backlog;
        4. shedding (queue physically full / draining) stays in submit —
           it is the ladder's last rung, not a profile.

        Returns ``(effective_profile, degraded)``; the effective profile has
        ``deadline_ms=None`` (already folded into ``budget``), so batcher
        grouping and cache keys see only concrete executor knobs.
        """
        dl = deadline_ms if deadline_ms is not None else profile.deadline_ms
        sla = profile.sla
        if sla is not None and sla not in SLA_CLASSES:
            raise ValueError(f"unknown sla {sla!r}; expected one of "
                             f"{SLA_CLASSES}")
        if dl is not None and float(dl) <= 0:
            raise ValueError(f"deadline_ms must be positive, got {dl}")
        anytime = profile.budget is not None or dl is not None
        if sla is None:
            cfg = getattr(self.engine, "config", None)
            sla = "bounded" if anytime else \
                getattr(cfg, "default_sla", "exact")
        if sla == "exact":
            if anytime:
                raise ValueError("sla='exact' guarantees an uninterrupted "
                                 "search — budget/deadline_ms require "
                                 "sla='bounded' or 'best_effort'")
            if profile.sla == "exact" and profile.deadline_ms is None:
                return profile, False
            return dataclasses.replace(profile, sla="exact",
                                       deadline_ms=None), False
        budget = profile.budget
        if dl is not None:
            conv = getattr(self.engine, "budget_for_deadline", None)
            if conv is not None:
                db = conv(dl)
                if db is not None:
                    budget = db if budget is None else min(int(budget), db)
        degraded = False
        if self._queue.qsize() >= self._degrade_at:
            full = 2 * int(getattr(self.engine, "n_docs", 1 << 29)) + 2
            base = full if budget is None else int(budget)
            budget = max(MIN_BUDGET, budget_bucket(max(1, base // 4)))
            if budget >= full:      # tiny corpora: the "shrunk" budget
                budget = MIN_BUDGET  # must actually cut work
            sla, degraded = "best_effort", True
        return dataclasses.replace(profile, sla=sla, budget=budget,
                                   deadline_ms=None), degraded

    def submit(self, words, profile: QueryProfile = DEFAULT_PROFILE,
               deadline_ms: float | None = None) -> Ticket:
        """Admit one query; never blocks.  Cache hits complete immediately;
        a full admission queue — or a drain in progress (:meth:`swap_engine`)
        — raises :class:`ShedError`.  ``deadline_ms`` overrides the
        profile's own; see :meth:`_effective` for the SLA ladder."""
        if self._thread is None:
            raise RuntimeError("server not started")
        key = self._normalize(words, profile)
        profile, degraded = self._effective(profile, deadline_ms)
        ticket = Ticket(key, profile)
        ticket.degraded = degraded
        if degraded:
            with self._lock:
                self.n_degraded += 1
            self._m_req["degraded"].inc()
        if self.obs.enabled:
            ticket.timeline = Timeline(ticket.t_submit)
        with self._lock:
            self.n_submitted += 1
        self._m_req["submitted"].inc()
        cached = self.cache.get((key, profile, self._tag))
        if cached is not None:
            ticket.cache_hit = True
            ticket.batch_size = 1
            ticket._complete(result=cached)
            with self._lock:
                self.n_served += 1
            self._m_req["served"].inc()
            self._m_req["cache_hit"].inc()
            self._record_stages(ticket)
            return ticket
        lane = self._lane_of(key)
        with self._lock:
            if self._draining:
                self.n_shed += 1
                self._m_req["shed"].inc()
                raise ShedError("engine swap in progress (draining); "
                                "retry shortly")
            # counted before the put so a swap can never observe 0 while an
            # admitted request is still on its way to the dispatch thread
            self._n_inflight += 1
        if ticket.timeline is not None:
            ticket.timeline.mark("admit")
        try:
            self._queue.put_nowait((key, profile, ticket, time.monotonic(),
                                    lane))
        except queue.Full:
            with self._lock:
                self._n_inflight -= 1
                self.n_shed += 1
            self._m_req["shed"].inc()
            raise ShedError(f"admission queue full "
                            f"({self._queue.maxsize} deep); retry later")
        return ticket

    def search(self, words, profile: QueryProfile = DEFAULT_PROFILE,
               timeout: float | None = 60.0,
               deadline_ms: float | None = None) -> RowResult:
        """Blocking submit -> result."""
        return self.submit(words, profile, deadline_ms=deadline_ms
                           ).result(timeout)

    def swap_engine(self, new_engine, *, drain_timeout: float = 60.0):
        """Hot-swap the engine: **drain -> swap -> clear cache**.

        New admissions shed (``ShedError``) while the drain runs; every
        request admitted *before* the swap completes against the old engine
        (its answers stay version-consistent), then the engine reference and
        cache tag flip and the result cache is cleared — tagged keys make
        the clear belt-and-braces: even a surviving entry could never match
        a key built with the new tag.  Returns the old engine.
        """
        if self._thread is None:
            raise RuntimeError("server not started")
        with self._lock:
            if self._draining:
                raise RuntimeError("another swap is already draining")
            self._draining = True
        try:
            deadline = time.monotonic() + drain_timeout
            while True:
                with self._lock:
                    if self._n_inflight == 0:
                        break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"drain did not finish in {drain_timeout}s "
                        f"({self._n_inflight} requests still in flight)")
                time.sleep(0.001)
            if hasattr(new_engine, "obs_registry"):
                new_engine.obs_registry = self.obs
            old, self.engine = self.engine, new_engine
            self._tag = getattr(new_engine, "content_tag", None)
            if not self._heavy_df_explicit:     # re-derive for the new corpus
                self.heavy_df = 2 * int(getattr(new_engine, "n_docs", 1 << 29))
            self.cache.clear()
            with self._lock:
                self.n_swaps += 1
            self._m_swaps.inc()
            return old
        finally:
            with self._lock:
                self._draining = False

    # -- dispatch thread -----------------------------------------------------

    def _run(self):
        while self._running or not self._queue.empty() \
                or self._batcher._pending:
            batch = self._batcher.next_batch()
            if batch is not None:
                self._dispatch(batch)

    def _record_stages(self, ticket: Ticket) -> None:
        """Fold one completed ticket's span timeline into the per-stage
        latency histograms (no-op when the registry is disabled)."""
        if ticket.timeline is None:
            return
        for stage, dt in stage_durations(ticket.timeline).items():
            self._m_stage[stage].observe(dt)

    def _dispatch(self, batch: Batch):
        t0 = time.monotonic()
        for t in batch.items:
            t.t_dispatch = t0
            if t.timeline is not None:
                t.timeline.mark("dispatch", t0)
        for t in batch.items:
            t.batch_size = batch.n_real
        try:
            res = self.engine.search(batch.queries,
                                     **batch.profile.search_kwargs())
        except Exception as e:                    # profile-level failure
            for t in batch.items:
                t._complete(error=e)
            self._m_req["error"].inc(batch.n_real)
            with self._lock:
                self.n_errors += batch.n_real
                self._n_inflight -= batch.n_real
            return
        # one host copy per leaf; it waits for the device, so dt covers the
        # work and not only its launch
        host = _host_leaves(res)
        t_dev = time.monotonic()
        if self.obs.enabled:
            for t in batch.items:
                if t.timeline is not None:
                    t.timeline.mark("device", t_dev)
        dt = t_dev - t0
        self._step += 1
        if self._watchdog.observe(self._step, dt):
            with self._lock:
                self.n_stragglers += 1
            self._m_straggler.inc()
        # feed the engine's deadline->budget estimator from *unbudgeted*
        # batches (a budget-cut batch would bias the pop cost optimistic)
        pops_arr = host["pops"]
        if batch.profile.budget is None and pops_arr is not None:
            note = getattr(self.engine, "note_cost", None)
            if note is not None:
                p = pops_arr.ravel()
                if len(p):
                    note(dt, float(p.mean()))
        rows = _slice_rows(res, batch.n_real, host)
        if self.obs.enabled:
            t_slice = time.monotonic()
            for t in batch.items:
                if t.timeline is not None:
                    t.timeline.mark("slice", t_slice)
        n_over = n_pad = 0
        for t, row in zip(batch.items, rows):
            self.cache.put((t.words, t.profile, self._tag), row)
            t._complete(result=row)
            self._record_stages(t)
            n_over += bool(row.overflowed)
            n_pad += row.padded or 0
        self._m_req["served"].inc(batch.n_real)
        self._m_overflow.inc(n_over)
        self._m_padded.inc(n_pad)
        self._m_dispatch.observe(dt)
        with self._lock:
            self.n_overflowed += n_over
            self.n_padded += n_pad
            self.n_served += batch.n_real
            self._n_inflight -= batch.n_real
            self.batch_hist[batch.n_real] = \
                self.batch_hist.get(batch.n_real, 0) + 1
            self.dispatch_s += dt

    # -- introspection -------------------------------------------------------

    @property
    def stats(self) -> dict:
        # Two-phase snapshot: the server's own counters come out under the
        # server lock (mutually consistent), then the engine and cache are
        # asked for *their* snapshots outside it — each is internally
        # consistent under its own lock, and taking the engine reference
        # under the server lock means a concurrent swap_engine can never
        # double-count (we read one engine's stats, whole, never a blend of
        # old and new).
        with self._lock:
            engine = self.engine
            n_batches = sum(self.batch_hist.values())
            out = {
                "submitted": self.n_submitted,
                "served": self.n_served,
                "shed": self.n_shed,
                "degraded": self.n_degraded,
                "stragglers": self.n_stragglers,
                "errors": self.n_errors,
                "swaps": self.n_swaps,
                "inflight": self._n_inflight,
                "engine_tag": self._tag,
                "overflowed": self.n_overflowed,
                "padded": self.n_padded,
                "dispatches": n_batches,
                "batch_hist": dict(sorted(self.batch_hist.items())),
                "mean_batch": sum(b * c for b, c in self.batch_hist.items())
                              / n_batches if n_batches else 0.0,
                "dispatch_s": self.dispatch_s,
            }
        out["cache"] = self.cache.stats
        estats = engine.stats          # dict-shaped for dummy engines too
        out["executors"] = estats["executors"]
        out["traces"] = sum(estats["traces"].values())
        return out


# the per-row leaves of a SearchResults (dummy engines may omit the
# diagnostics: a missing leaf reads as None)
ROW_LEAVES = ("docs", "scores", "n_found", "work", "pops", "overflowed",
              "padded", "certified", "score_bound", "match_pos", "match_len")


def _host(x) -> np.ndarray | None:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_leaves(res) -> dict[str, np.ndarray | None]:
    """Every per-row leaf of a batched result, copied to the host once."""
    return {name: _host(getattr(res, name, None)) for name in ROW_LEAVES}


def _slice_rows(res, n_real: int, host: dict | None = None
                ) -> list[RowResult]:
    """Split a batched SearchResults into per-request host rows (pad rows
    past ``n_real`` are dropped).  ``host`` is :func:`_host_leaves` of
    ``res`` when the caller already copied it."""
    h = _host_leaves(res) if host is None else host
    docs, scores, n_found, work = h["docs"], h["scores"], h["n_found"], \
        h["work"]
    pops, over, pad = h["pops"], h["overflowed"], h["padded"]
    cert, bnd, mp, ml = h["certified"], h["score_bound"], h["match_pos"], \
        h["match_len"]
    sla = getattr(res, "sla", "exact")
    return [RowResult(
        docs=docs[b], scores=scores[b], n_found=int(n_found[b]),
        work=int(work[b]), k=res.k, mode=res.mode, strategy=res.strategy,
        measure=res.measure,
        pops=None if pops is None else int(pops[b]),
        overflowed=None if over is None else bool(over[b]),
        padded=None if pad is None else int(pad[b]),
        certified=None if cert is None else cert[b],
        score_bound=None if bnd is None else float(bnd[b]),
        sla=sla,
        match_pos=None if mp is None else mp[b],
        match_len=None if ml is None else ml[b]) for b in range(n_real)]
