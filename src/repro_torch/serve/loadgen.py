"""Load generation + latency-percentile reporting for the serving subsystem
(the port's copy of ``repro.serve.loadgen``).

Two standard generator shapes (the serving-systems literature distinguishes
them because they bound different things):

* **closed loop** — ``n_workers`` clients issue back-to-back requests; this
  measures *sustainable throughput* at a fixed concurrency (the micro-batcher
  comparison in ``benchmarks/table6_serving.py`` runs this shape);
* **open loop** — requests arrive on a Poisson (or fixed-interval) schedule at
  ``target_qps`` regardless of completions; this measures the *latency
  distribution under a given offered load* including queueing, and exercises
  the shed policy when the load exceeds capacity.

Queries can be sampled straight from a (possibly snapshot-restored) engine —
no corpus needed: document frequencies live in the index and the id<->rank
maps in the model, which is all band-based sampling requires.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import wtbc
from repro_torch.serve.server import (DEFAULT_PROFILE, RequestTimeout, SearchServer,
                                ShedError)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded jittered exponential backoff for :class:`ShedError` retries.

    A shed is the server telling the client "elsewhere, or later" —
    retrying instantly would synchronize the rejected cohort into a retry
    storm, so each attempt waits ``base_ms * 2**attempt`` plus uniform
    jitter of the same magnitude (full jitter; deterministic under
    ``seed`` so load runs reproduce).  ``max_retries=0`` disables retry —
    the pre-existing behavior."""
    max_retries: int = 0
    base_ms: float = 2.0
    seed: int = 0

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        step = self.base_ms * (2.0 ** attempt) / 1e3
        return step + float(rng.uniform(0.0, step))


NO_RETRY = RetryPolicy()


def sample_queries(engine, n_queries: int, words_per_query: int = 3, *,
                   df_range: tuple[int, int] | None = None,
                   seed: int = 0) -> list[list[int]]:
    """Query word-id lists drawn from the engine's own df table (band
    sampling like ``text.corpus.sample_queries``, but corpus-free so a
    snapshot-only server can generate traffic).  ``df_range`` defaults to
    [2, 5% of docs] — the interactive band where queries are selective."""
    if engine.backend == "sharded":       # the global df, as one index's
        df = engine.sharded.global_df.cpu().numpy()
    else:
        df = engine.idx.df.cpu().numpy()
    lo, hi = df_range or (2, max(3, int(engine.n_docs) // 20))
    pool_ranks = np.flatnonzero((df >= lo) & (df <= hi))
    pool_ranks = pool_ranks[pool_ranks > 0]          # never the '$' separator
    if len(pool_ranks) < words_per_query:
        raise ValueError(f"df band [{lo}, {hi}] holds only {len(pool_ranks)} "
                         "words; widen df_range")
    word_of_rank = np.asarray(engine.model.word_of_rank)
    rng = np.random.default_rng(seed)
    return [[int(w) for w in word_of_rank[
        rng.choice(pool_ranks, words_per_query, replace=False)]]
        for _ in range(n_queries)]


def sample_ngram_queries(engine, n_queries: int, q_len: int = 3, *,
                         seed: int = 0) -> list[list[int]]:
    """Consecutive-token queries decoded straight from the compressed index
    (no corpus): random document, random offset, ``q_len`` tokens.  The
    phrase/near workload generator — independently sampled words essentially
    never co-occur, which would make a positional load test measure only the
    empty-match fast path.  The reference's draws, in its order; every
    n-gram is decoded at once (on the card one ``wtbc_decode`` launch)."""
    if engine.backend != "single":
        raise ValueError("n-gram sampling reads the single-host index "
                         "(positional modes are single-host anyway)")
    idx = engine.idx
    doc_len = idx.doc_len.cpu().numpy()
    eligible = np.flatnonzero(doc_len >= q_len)
    if not len(eligible):
        raise ValueError(f"no document holds {q_len} tokens")
    rng = np.random.default_rng(seed)
    docs, offs = [], []
    for _ in range(n_queries):
        d = int(rng.choice(eligible))
        docs.append(d)
        offs.append(int(rng.integers(0, doc_len[d] - q_len + 1)))
    d = torch.tensor(docs, dtype=torch.int32, device=idx.device)
    off = torch.tensor(offs, dtype=torch.int32, device=idx.device)
    ranks = wtbc.extract(idx, wtbc.doc_start(idx, d) + off, q_len)
    words = engine.model.word_of_rank[ranks.cpu().numpy()]
    return [[int(w) for w in row] for row in words]


def zipf_workload(queries: list, n_requests: int, *, alpha: float = 1.1,
                  seed: int = 0) -> list:
    """A request stream with Zipf-repeated queries (real query logs are
    heavily skewed — this is what makes result caches earn their keep)."""
    probs = 1.0 / np.arange(1, len(queries) + 1) ** alpha
    probs /= probs.sum()
    rng = np.random.default_rng(seed)
    return [queries[i] for i in rng.choice(len(queries), n_requests, p=probs)]


def _pcts(ms: np.ndarray) -> tuple[float, float, float]:
    if len(ms):
        return (float(np.percentile(ms, 50)), float(np.percentile(ms, 95)),
                float(np.percentile(ms, 99)))
    nan = float("nan")
    return nan, nan, nan


def stage_breakdown(server: SearchServer) -> dict | None:
    """Registry-derived per-stage latency attribution (milliseconds): the
    ``repro_request_stage_seconds`` histograms the server recorded, one entry
    per stage (queue_wait / device / slice / total), each with reconstructed
    p50/p95/p99, mean, and count.  None when the server's registry is
    disabled or no stage was recorded — callers (table6/table7, BENCH)
    emit the field only when observability was on."""
    reg = getattr(server, "obs", None)
    if reg is None or not reg.enabled:
        return None
    out = {}
    for h in reg.find("repro_request_stage_seconds"):
        stage = dict(h.labels).get("stage", "?")
        if h.n == 0:
            continue
        p = h.percentiles((50, 95, 99))
        out[stage] = {"p50_ms": p["p50"] * 1e3, "p95_ms": p["p95"] * 1e3,
                      "p99_ms": p["p99"] * 1e3, "mean_ms": h.mean * 1e3,
                      "count": h.n}
    return out or None


@dataclasses.dataclass
class LoadReport:
    """What one load-generation run measured (latencies in milliseconds).
    ``n_err`` counts requests the server answered with an error — they are
    excluded from the latency/throughput numbers, never silently blended.

    Total latency decomposes exactly per request into **queue wait**
    (submit -> dispatch: admission backlog + coalescing) and **service**
    (dispatch -> complete: engine + host slice); both percentile sets are
    reported so capacity problems (queue grows) read differently from
    kernel regressions (service grows).  ``stages`` is the finer
    registry-derived breakdown (:func:`stage_breakdown`) when the server
    ran with observability enabled, else None."""
    n_ok: int
    n_shed: int
    n_err: int
    n_timeout: int
    duration_s: float
    qps: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    mean_ms: float
    latencies_ms: np.ndarray
    server_stats: dict
    queue_p50_ms: float = float("nan")
    queue_p95_ms: float = float("nan")
    queue_p99_ms: float = float("nan")
    service_p50_ms: float = float("nan")
    service_p95_ms: float = float("nan")
    service_p99_ms: float = float("nan")
    queue_ms: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0))
    service_ms: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0))
    stages: dict | None = None
    # anytime/SLA accounting (DESIGN.md §11): degraded = admission shrank
    # the budget; certified_fraction = certified slots / found slots over
    # the served answers; retry_hist = attempts-needed -> requests (0 =
    # first try; only present when a RetryPolicy was active)
    n_degraded: int = 0
    certified_fraction: float = 1.0
    n_retried: int = 0
    retry_hist: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_latencies(cls, lats_s: list[float], n_shed: int, n_err: int,
                       duration_s: float, server: SearchServer,
                       n_timeout: int = 0, queue_s: list[float] | None = None,
                       service_s: list[float] | None = None) -> "LoadReport":
        ms = np.asarray(sorted(lats_s)) * 1e3
        p50, p95, p99 = _pcts(ms)
        q_ms = np.asarray(sorted(queue_s or [])) * 1e3
        s_ms = np.asarray(sorted(service_s or [])) * 1e3
        qp = _pcts(q_ms)
        sp = _pcts(s_ms)
        return cls(n_ok=len(ms), n_shed=n_shed, n_err=n_err,
                   n_timeout=n_timeout, duration_s=duration_s,
                   qps=len(ms) / duration_s if duration_s > 0 else 0.0,
                   p50_ms=p50, p95_ms=p95, p99_ms=p99,
                   mean_ms=float(ms.mean()) if len(ms) else float("nan"),
                   latencies_ms=ms, server_stats=server.stats,
                   queue_p50_ms=qp[0], queue_p95_ms=qp[1], queue_p99_ms=qp[2],
                   service_p50_ms=sp[0], service_p95_ms=sp[1],
                   service_p99_ms=sp[2], queue_ms=q_ms, service_ms=s_ms,
                   stages=stage_breakdown(server))

    @classmethod
    def from_tickets(cls, tickets: list, n_shed: int, duration_s: float,
                     server: SearchServer, retry_hist: dict | None = None,
                     ) -> "LoadReport":
        """Build a report from completed tickets: total latency plus the
        queue-wait/service decomposition each ticket carries.  Tickets
        finalized with :class:`RequestTimeout` count as timeouts (the
        loadgen *cancels* in-flight tickets at its deadline — none are ever
        left dangling to complete into a later window); other errors count
        as ``n_err``; still-undone tickets (a caller that skipped the cancel
        pass) also count as timeouts."""
        ok = [t for t in tickets
              if t.done() and t.error is None and t.latency_s is not None]
        timeouts = sum(1 for t in tickets if not t.done()
                       or isinstance(t.error, RequestTimeout))
        errs = sum(1 for t in tickets if t.done() and t.error is not None
                   and not isinstance(t.error, RequestTimeout))
        slots = cert = 0
        for t in ok:
            row = t._result
            n = getattr(row, "n_found", 0)
            slots += n
            nc = getattr(row, "n_certified", None)
            cert += n if nc is None else nc
        rep = cls.from_latencies(
            [t.latency_s for t in ok], n_shed, errs, duration_s, server,
            n_timeout=timeouts,
            queue_s=[t.queue_wait_s for t in ok],
            service_s=[t.service_s for t in ok])
        rep.n_degraded = sum(1 for t in tickets
                             if getattr(t, "degraded", False))
        rep.certified_fraction = cert / slots if slots else 1.0
        if retry_hist:
            rep.retry_hist = dict(sorted(retry_hist.items()))
            rep.n_retried = sum(c for a, c in retry_hist.items() if a > 0)
        return rep

    def summary(self) -> str:
        out = (f"{self.n_ok} ok / {self.n_shed} shed / {self.n_err} err in "
               f"{self.duration_s:.2f}s"
               f" | {self.qps:.0f} q/s | p50 {self.p50_ms:.1f}ms"
               f" | p95 {self.p95_ms:.1f}ms | p99 {self.p99_ms:.1f}ms")
        if self.n_degraded or self.certified_fraction < 1.0:
            out += (f" | {self.n_degraded} degraded | certified "
                    f"{self.certified_fraction:.3f}")
        if self.n_retried:
            out += f" | {self.n_retried} retried {self.retry_hist}"
        if self.n_timeout:
            out += f" | {self.n_timeout} timed out"
        if len(self.queue_ms):
            out += (f" | queue p50/p95/p99 {self.queue_p50_ms:.1f}/"
                    f"{self.queue_p95_ms:.1f}/{self.queue_p99_ms:.1f}ms"
                    f" | service p50/p95/p99 {self.service_p50_ms:.1f}/"
                    f"{self.service_p95_ms:.1f}/{self.service_p99_ms:.1f}ms")
        return out


def closed_loop(server: SearchServer, workload: list, *,
                n_workers: int = 8, profile=DEFAULT_PROFILE,
                timeout_s: float = 120.0,
                retry: RetryPolicy = NO_RETRY) -> LoadReport:
    """``n_workers`` clients drain ``workload`` back-to-back (one outstanding
    request per client — arrival rate adapts to service rate).  With a
    :class:`RetryPolicy`, a shed request is retried after jittered backoff
    up to ``retry.max_retries`` times before counting as shed; the report's
    ``retry_hist`` maps attempts-needed -> admitted requests."""
    it = iter(range(len(workload)))
    it_lock = threading.Lock()
    done_tickets: list = []          # retained for the queue/service split
    shed = [0]
    retry_hist: dict[int, int] = {}
    rngs = [np.random.default_rng(retry.seed + w) for w in range(n_workers)]

    def client(w: int):
        while True:
            with it_lock:
                i = next(it, None)
            if i is None:
                return
            tk = None
            for attempt in range(retry.max_retries + 1):
                try:
                    tk = server.submit(workload[i], profile)
                except ShedError:
                    if attempt < retry.max_retries:
                        time.sleep(retry.backoff_s(attempt, rngs[w]))
                    continue
                with it_lock:
                    retry_hist[attempt] = retry_hist.get(attempt, 0) + 1
                break
            if tk is None:          # every attempt shed
                with it_lock:
                    shed[0] += 1
                continue
            try:
                tk.result(timeout_s)
            except Exception:       # dispatch error/timeout: the ticket
                pass                # carries it; keep the worker alive
            with it_lock:
                done_tickets.append(tk)

    threads = [threading.Thread(target=client, args=(w,))
               for w in range(n_workers)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return LoadReport.from_tickets(done_tickets, shed[0],
                                   time.monotonic() - t0, server,
                                   retry_hist=retry_hist or None)


def open_loop(server: SearchServer, workload: list, *, target_qps: float,
              profile=DEFAULT_PROFILE, poisson: bool = True, seed: int = 0,
              timeout_s: float = 120.0,
              retry: RetryPolicy = NO_RETRY) -> LoadReport:
    """Submit ``workload`` on a Poisson/fixed schedule at ``target_qps`` and
    wait for completions; sheds count, they don't block the schedule.

    With a :class:`RetryPolicy`, shed requests are re-queued after jittered
    backoff as *extra* arrivals (deferred — the original schedule is never
    blocked, matching how an open-loop client fleet actually behaves).

    At the wait deadline every still-in-flight ticket is **cancelled**
    (:meth:`Ticket.cancel` with :class:`RequestTimeout`): a late engine
    completion can no longer resurrect it, so the report's timeout count is
    final and nothing leaks into a later measurement window."""
    if target_qps <= 0:
        raise ValueError(f"target_qps must be > 0, got {target_qps}")
    rng = np.random.default_rng(seed)
    gaps = (rng.exponential(1.0 / target_qps, size=len(workload)) if poisson
            else np.full(len(workload), 1.0 / target_qps))
    t0 = time.monotonic()
    # event list: (due_time_rel, query, attempt); retries merge in deferred
    schedule = [(float(at), q, 0) for q, at in zip(workload, np.cumsum(gaps))]
    schedule.sort(key=lambda e: -e[0])      # pop() takes the earliest
    tickets, shed = [], 0
    retry_hist: dict[int, int] = {}
    while schedule:
        at, q, attempt = schedule.pop()
        lag = t0 + at - time.monotonic()
        if lag > 0:
            time.sleep(lag)
        try:
            tickets.append(server.submit(q, profile))
            retry_hist[attempt] = retry_hist.get(attempt, 0) + 1
        except ShedError:
            if attempt < retry.max_retries:
                due = (time.monotonic() - t0) + retry.backoff_s(attempt, rng)
                schedule.append((due, q, attempt + 1))
                schedule.sort(key=lambda e: -e[0])
            else:
                shed += 1
    deadline = time.monotonic() + timeout_s
    for t in tickets:
        t._event.wait(max(0.0, deadline - time.monotonic()))
    for t in tickets:                # finalize stragglers: no ticket leaks
        if not t.done():
            t.cancel(RequestTimeout(
                f"open_loop gave up after {timeout_s}s"))
    duration = time.monotonic() - t0
    return LoadReport.from_tickets(
        tickets, shed, duration, server,
        retry_hist=retry_hist if retry.max_retries else None)
