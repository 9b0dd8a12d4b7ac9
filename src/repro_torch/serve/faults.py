"""Seeded fault injection for the serving stack (DESIGN.md §11; the port's
copy of ``repro.serve.faults``).

The anytime/SLA machinery exists so the server can promise "exact, degraded
— with certified bits — or shed, never a hang and never silently wrong".
This module is the harness that *proves* it under adversity.  Four injector
families, each deterministic under a seed:

* **slow-engine stalls** — :class:`FaultyEngine` sleeps before delegating a
  dispatch with probability ``p_stall``; the straggler watchdog must flag
  them and every admitted request must still terminate;
* **dispatch exceptions** — :class:`FaultyEngine` raises
  :class:`InjectedDispatchError` with probability ``p_error``; the error
  must land on the affected tickets (never swallowed, never a hang);
* **cache poisoning** — :func:`poison_cache` plants a wrong-version entry
  (a stale engine content tag); the versioned cache key must make it
  unreachable, so the poisoned answer is *never served*;
* **snapshot swap under load** — :func:`swap_under_load` hot-swaps the
  engine while an open-loop stream runs; every response must come from a
  consistent engine version and the drain must terminate.

Run the whole suite from the command line (on the card by default)::

    python -m repro_torch.serve.faults --seed 0
    python -m repro_torch.serve.faults --seed 0 --device cpu

Exit code 0 = every property held; the printed lines are the evidence.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time

import numpy as np

from repro_torch.serve.batcher import QueryProfile
from repro_torch.serve.loadgen import (LoadReport, RetryPolicy, open_loop,
                                 sample_queries)
from repro_torch.serve.server import (MIN_BUDGET, RequestTimeout, RowResult,
                                SearchServer, ShedError)


class InjectedDispatchError(RuntimeError):
    """The failure :class:`FaultyEngine` raises — typed so tests can tell an
    injected fault from a genuine bug."""


@dataclasses.dataclass
class FaultPlan:
    """What to inject, with what probability (rolled per dispatch, seeded)."""
    p_stall: float = 0.0        # sleep stall_ms before delegating
    stall_ms: float = 50.0
    p_error: float = 0.0        # raise InjectedDispatchError instead
    seed: int = 0


class FaultyEngine:
    """Engine proxy that injects :class:`FaultPlan` faults at ``search``.

    Everything else — config, model, df tables, content tag, cost model —
    delegates to the wrapped engine, so the server cannot tell it apart
    from a healthy one until a dispatch goes wrong.  Counters record what
    was actually injected (the suite asserts against them)."""

    def __init__(self, engine, plan: FaultPlan):
        self._engine = engine
        self._plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self.n_stalls = 0
        self.n_injected_errors = 0

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_engine"), name)

    def search(self, queries, **kw):
        plan = self._plan
        roll = float(self._rng.random())
        if roll < plan.p_error:
            self.n_injected_errors += 1
            raise InjectedDispatchError(
                f"injected dispatch failure (roll={roll:.3f})")
        if roll < plan.p_error + plan.p_stall:
            self.n_stalls += 1
            time.sleep(plan.stall_ms / 1e3)
        return self._engine.search(queries, **kw)


POISON_DOC = -7     # a doc id no real engine can produce


def poison_cache(server: SearchServer, words, profile: QueryProfile,
                 *, stale_tag="stale-engine-tag") -> RowResult:
    """Plant a wrong-version cache entry for ``(words, profile)``: the row a
    server with a *different* engine content tag would have cached.  The
    server's cache keys are versioned by its live tag, so the poisoned
    entry must be unreachable — :func:`check_poison_never_served` asserts
    a subsequent search returns a real answer, not this one."""
    k = profile.k or getattr(server.engine, "config", None) and \
        server.engine.config.default_k or 10
    fake = RowResult(docs=np.full(k, POISON_DOC, np.int32),
                     scores=np.zeros(k, np.float32), n_found=k, work=0,
                     k=k, mode=profile.mode, strategy="dr",
                     measure=profile.measure)
    server.cache.put((tuple(int(w) for w in words), profile, stale_tag), fake)
    return fake


def check_poison_never_served(server: SearchServer, words,
                              profile: QueryProfile) -> None:
    poison_cache(server, words, profile)
    row = server.search(words, profile, timeout=30.0)
    if row.n_found and int(row.docs[0]) == POISON_DOC:
        raise AssertionError("poisoned cache entry was served")


def swap_under_load(server: SearchServer, next_engine, workload, *,
                    profile: QueryProfile, qps: float = 300.0,
                    seed: int = 0) -> LoadReport:
    """Hot-swap ``next_engine`` in while an open-loop stream runs.  Sheds
    during the drain are expected (that is the swap contract); hangs and
    non-shed errors are not — the returned report's accounting must close
    (ok + shed + err + timeout == submitted attempts)."""
    box = {}

    def swapper():
        time.sleep(0.05)                      # let the stream establish
        box["old"] = server.swap_engine(next_engine, drain_timeout=30.0)

    th = threading.Thread(target=swapper)
    th.start()
    rep = open_loop(server, workload, target_qps=qps, profile=profile,
                    seed=seed, timeout_s=30.0)
    th.join(timeout=30.0)
    if th.is_alive():
        raise AssertionError("swap_engine hung under load")
    if "old" not in box:
        raise AssertionError("swap_engine did not complete")
    return rep


# -- the CI suite ------------------------------------------------------------

def _build(seed: int, n_docs: int = 150, device=None):
    from repro_torch.engine import SearchEngine
    from repro_torch.text import corpus
    cp = corpus.make_corpus(n_docs=n_docs, mean_doc_len=60, vocab_size=500,
                            seed=seed)
    return SearchEngine.build(cp, device=device)


def _batch_seconds(engine, queries, profile: QueryProfile) -> float:
    """Best of three wall times of one warm batch, results on the host."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        engine.search(queries, **profile.search_kwargs()).docs.cpu()
        times.append(time.perf_counter() - t0)
    return min(times)


def run_suite(seed: int = 0, verbose: bool = True,
              device=None) -> list[str]:
    """Run every fault family against a real engine on ``device`` (the card
    by default); returns the list of failures (empty = suite passed).  Each
    check prints one evidence line."""
    failures: list[str] = []

    def check(name: str, fn):
        t0 = time.monotonic()
        try:
            detail = fn() or ""
            if verbose:
                print(f"  ok  {name} ({time.monotonic()-t0:.2f}s) {detail}")
        except Exception as e:          # noqa: BLE001 — the suite must finish
            failures.append(f"{name}: {e}")
            if verbose:
                print(f"FAIL  {name}: {e}")

    engine = _build(seed, device=device)
    queries = sample_queries(engine, 40, seed=seed)
    profile = QueryProfile(mode="or", k=8)
    # a stall is a straggler only next to a healthy batch: the watchdog flags
    # batches past 3x its running mean, so the injected stall is 10x the
    # engine's own warm batch time on this device (at least 30 ms)
    engine.warmup(queries[:4], max_batch=4, **profile.search_kwargs())
    stall_ms = max(30.0, 1e4 * _batch_seconds(engine, queries[:4], profile))

    def liveness_under_stalls():
        faulty = FaultyEngine(_build(seed, device=device), FaultPlan(
            p_stall=0.3, stall_ms=stall_ms, p_error=0.15, seed=seed))
        srv = SearchServer(faulty, max_batch=4, max_wait_ms=0.5,
                           queue_depth=16)
        with srv:
            srv.warmup(queries[:4], profile)
            rep = open_loop(srv, queries * 2, target_qps=400.0,
                            profile=profile, seed=seed, timeout_s=30.0)
        total = rep.n_ok + rep.n_shed + rep.n_err + rep.n_timeout
        assert total == len(queries) * 2, \
            f"accounting leak: {total} != {len(queries) * 2}"
        assert rep.n_timeout == 0, f"{rep.n_timeout} requests hung"
        if faulty.n_injected_errors:
            assert rep.n_err > 0, "injected errors vanished silently"
        assert srv.n_stragglers > 0 or faulty.n_stalls == 0, \
            "watchdog saw no stragglers despite stalls"
        return (f"[{rep.n_ok} ok, {rep.n_err} err, {rep.n_shed} shed, "
                f"{faulty.n_stalls} stalls, {srv.n_stragglers} flagged]")

    def degraded_not_shed():
        slow = FaultyEngine(_build(seed, device=device), FaultPlan(
            p_stall=1.0, stall_ms=15.0, seed=seed))
        srv = SearchServer(slow, max_batch=2, max_wait_ms=0.0, queue_depth=8)
        with srv:
            srv.warmup(queries[:4], profile)
            rep = open_loop(srv, queries * 3, target_qps=2000.0,
                            profile=QueryProfile(mode="or", k=8,
                                                 sla="best_effort"),
                            seed=seed, timeout_s=30.0)
        assert rep.n_timeout == 0, f"{rep.n_timeout} requests hung"
        assert rep.n_degraded > 0, \
            "overload never engaged degraded serving (expected budget shrink)"
        degraded_budgets = {k.budget for k in getattr(
            srv.engine, "_executors", {})}
        assert any(b is not None and b >= MIN_BUDGET
                   for b in degraded_budgets), \
            f"no degraded executor ran (budgets: {degraded_budgets})"
        return (f"[{rep.n_ok} ok, {rep.n_degraded} degraded, "
                f"{rep.n_shed} shed, certified "
                f"{rep.certified_fraction:.2f}]")

    def poison_unreachable():
        srv = SearchServer(engine, max_batch=4, max_wait_ms=0.5,
                           queue_depth=16)
        with srv:
            for q in queries[:5]:
                check_poison_never_served(srv, q, profile)
        return "[5 poisoned keys, 0 served]"

    def swap_consistency():
        srv = SearchServer(engine, max_batch=4, max_wait_ms=0.5,
                           queue_depth=32)
        with srv:
            srv.warmup(queries[:4], profile)
            rep = swap_under_load(srv, _build(seed + 1, device=device),
                                  queries * 2,
                                  profile=profile, qps=500.0, seed=seed)
            assert srv.stats["swaps"] == 1
            total = rep.n_ok + rep.n_shed + rep.n_err + rep.n_timeout
            assert total == len(queries) * 2, "accounting leak across swap"
            assert rep.n_timeout == 0, f"{rep.n_timeout} requests hung"
            # post-swap sanity: the new engine answers, cache rebuilt
            row = srv.search(queries[0], profile, timeout=30.0)
            assert row.n_found >= 0
        return f"[swap ok, {rep.n_shed} shed during drain]"

    def timeout_finalized():
        stuck = FaultyEngine(_build(seed, device=device), FaultPlan(
            p_stall=1.0, stall_ms=300.0, seed=seed))
        srv = SearchServer(stuck, max_batch=1, max_wait_ms=0.0,
                           queue_depth=64)
        with srv:
            rep = open_loop(srv, queries[:8], target_qps=1000.0,
                            profile=profile, seed=seed, timeout_s=0.2,
                            retry=RetryPolicy(max_retries=2, seed=seed))
            assert rep.n_timeout > 0, "expected timeouts under 300ms stalls"
            # cancelled tickets must hold RequestTimeout, not dangle
        time.sleep(0.5)         # let late dispatches finish against cancels
        return f"[{rep.n_timeout} cancelled, none resurrected]"

    check("liveness-under-stalls+errors", liveness_under_stalls)
    check("degraded-not-shed", degraded_not_shed)
    check("cache-poison-unreachable", poison_unreachable)
    check("swap-under-load", swap_consistency)
    check("timeout-finalized", timeout_finalized)
    return failures


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(f"fault-injection suite (seed={args.seed}, device={args.device})")
    failures = run_suite(seed=args.seed, verbose=not args.quiet,
                         device=args.device)
    if failures:
        print(f"{len(failures)} FAILED:")
        for f in failures:
            print(f"  - {f}")
        return 1
    print("all fault-injection checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
