"""The port's fault-injection units and admission ladder
(``repro_torch.serve.faults`` / ``server``) against the reference's (CPU).

Ticket finalization races, timeout vs error accounting, the retry policy,
the SLA degradation ladder (the same effective profiles as the reference's
server on the same corpus), deadline -> budget conversion through the
server, the seeded ``FaultyEngine``, cache-poison unreachability and an
engine swap under load.  Every wait carries a timeout.
"""
import queue

import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as REngineConfig
from repro.engine import SearchEngine as RSearchEngine
from repro.serve import QueryProfile as RQueryProfile
from repro.serve import SearchServer as RSearchServer
from repro.serve.loadgen import RetryPolicy as RRetryPolicy
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.serve.batcher import QueryProfile
from repro_torch.serve.faults import (POISON_DOC, FaultPlan, FaultyEngine,
                                      InjectedDispatchError, poison_cache,
                                      swap_under_load)
from repro_torch.serve.loadgen import (LoadReport, RetryPolicy, closed_loop,
                                       sample_queries)
from repro_torch.serve.server import (MIN_BUDGET, RequestTimeout, RowResult,
                                      SearchServer, ShedError, Ticket)
from repro_torch.text import corpus

torch.set_num_threads(1)

SPEC = dict(n_docs=90, mean_doc_len=50, vocab_size=400, seed=9)
WAIT = 60.0


@pytest.fixture(scope="module")
def fault_corpus():
    return corpus.make_corpus(**SPEC)


@pytest.fixture(scope="module")
def port_engine(fault_corpus):
    return SearchEngine.build(fault_corpus, EngineConfig(block=512),
                              device="cpu")


def _row(k=4):
    return RowResult(docs=np.zeros(k, np.int32), scores=np.zeros(k, np.float32),
                     n_found=k, work=1, k=k, mode="or", strategy="dr",
                     measure="tfidf")


# -- ticket finalization ----------------------------------------------------

def test_ticket_cancel_beats_late_complete():
    t = Ticket(np.arange(3), QueryProfile(mode="or", k=4))
    assert t.cancel(RequestTimeout("deadline")) is True
    assert t.done()
    t._complete(result=_row())          # a late dispatch must not resurrect
    with pytest.raises(RequestTimeout):
        t.result(0.0)
    assert t.cancel(RequestTimeout("again")) is False


def test_ticket_complete_beats_late_cancel():
    t = Ticket(np.arange(3), QueryProfile(mode="or", k=4))
    t._complete(result=_row())
    assert t.cancel(RequestTimeout("too late")) is False
    assert t.result(0.0).n_found == 4 and t.error is None


def test_report_classifies_timeout_vs_error():
    served = Ticket(np.arange(2), QueryProfile())
    served._complete(result=_row())
    timed = Ticket(np.arange(2), QueryProfile())
    timed.cancel(RequestTimeout("gave up"))
    errored = Ticket(np.arange(2), QueryProfile())
    errored._complete(error=InjectedDispatchError("boom"))

    class _Stub:
        stats = {}
    rep = LoadReport.from_tickets([served, timed, errored], 0, 1.0, _Stub(),
                                  retry_hist={0: 2, 1: 1})
    assert (rep.n_ok, rep.n_timeout, rep.n_err) == (1, 1, 1)
    assert rep.n_retried == 1 and rep.retry_hist == {0: 2, 1: 1}


# -- retry policy -----------------------------------------------------------

def test_retry_backoff_equals_the_references():
    ours = RetryPolicy(max_retries=3, base_ms=2.0, seed=7)
    ref = RRetryPolicy(max_retries=3, base_ms=2.0, seed=7)
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for attempt in range(4):
        lo = ours.base_ms * (2 ** attempt) / 1e3
        for _ in range(16):
            got = ours.backoff_s(attempt, a)
            assert got == ref.backoff_s(attempt, b)
            assert lo <= got <= 2 * lo, (attempt, got)


def test_closed_loop_retries_sheds():
    class FlakyServer:
        stats = {}

        def __init__(self):
            self.seen = set()

        def submit(self, words, profile):
            key = int(np.asarray(words)[0])
            if key not in self.seen:
                self.seen.add(key)
                raise ShedError("transient overload")
            t = Ticket(words, profile)
            t._complete(result=_row())
            return t

    workload = [np.array([i, i + 1, i + 2]) for i in range(6)]
    rep = closed_loop(FlakyServer(), workload, n_workers=2, timeout_s=5.0,
                      retry=RetryPolicy(max_retries=2, base_ms=0.1, seed=0))
    assert rep.n_shed == 0 and rep.n_ok == 6
    assert rep.retry_hist == {1: 6} and rep.n_retried == 6


def test_closed_loop_exhausted_retries_count_as_shed():
    class AlwaysShed:
        stats = {}

        def submit(self, words, profile):
            raise ShedError("full")

    rep = closed_loop(AlwaysShed(), [np.arange(3)] * 4, n_workers=2,
                      timeout_s=5.0,
                      retry=RetryPolicy(max_retries=1, base_ms=0.1, seed=0))
    assert rep.n_shed == 4 and rep.n_ok == 0 and rep.n_retried == 0


# -- admission degradation ladder -------------------------------------------

def _fill_to_pressure(srv):
    while srv._queue.qsize() < srv._degrade_at:
        srv._queue.put_nowait(None)


def _drain(srv):
    while True:
        try:
            srv._queue.get_nowait()
        except queue.Empty:
            return


def test_effective_ladder_equals_the_references(fault_corpus):
    """Both servers, each over a fresh engine of the same corpus (cold
    us/pop estimators), resolve every rung of the ladder to the same
    effective profile."""
    ours = SearchServer(SearchEngine.build(fault_corpus, EngineConfig(
        block=512), device="cpu"), max_batch=2, max_wait_ms=0.1,
        queue_depth=8)
    ref = RSearchServer(RSearchEngine.build(fault_corpus, REngineConfig(
        block=512)), max_batch=2, max_wait_ms=0.1, queue_depth=8)
    cases = [(dict(mode="or", k=8), None), (dict(mode="or", k=8, budget=64),
                                            None),
             (dict(mode="or", k=8), 0.4), (dict(mode="or", k=8), 2.0),
             (dict(mode="or", k=8, budget=5, deadline_ms=3.0), None),
             (dict(mode="or", k=8, sla="best_effort"), 1.0)]
    fields = ("mode", "k", "budget", "sla", "deadline_ms")

    def resolve():
        out = []
        for kw, dl in cases:
            a, da = ours._effective(QueryProfile(**kw), dl)
            b, db = ref._effective(RQueryProfile(**kw), dl)
            assert da == db and [getattr(a, f) for f in fields] == \
                [getattr(b, f) for f in fields], (kw, dl)
            out.append((a, da))
        return out

    calm = resolve()
    assert not any(d for _, d in calm)
    assert calm[1][0].sla == "bounded" and calm[1][0].budget == 64
    db = ours.engine.budget_for_deadline(0.4)
    assert calm[2][0].budget == db and db & (db - 1) == 0
    _fill_to_pressure(ours)
    _fill_to_pressure(ref)
    try:
        pressed = resolve()
        eff, deg = pressed[1]
        assert deg and eff.sla == "best_effort"
        assert MIN_BUDGET <= eff.budget <= 16
        assert eff.budget < 2 * ours.engine.n_docs + 2
        exact, deg = ours._effective(QueryProfile(mode="or", k=8,
                                                  sla="exact"), None)
        assert not deg and exact.sla == "exact"
        with pytest.raises(ValueError, match="exact"):
            ours._effective(QueryProfile(mode="or", k=8, sla="exact"), 5.0)
    finally:
        _drain(ours)
        _drain(ref)


def test_deadline_converts_to_a_budget_through_the_server(fault_corpus):
    """A deadline becomes the engine's pow-4 pop budget at admission; the
    served row is the direct search at that budget, certified as such; and
    an unbudgeted dispatch feeds the us/pop estimator."""
    eng = SearchEngine.build(fault_corpus, EngineConfig(block=512),
                             device="cpu")
    q = sample_queries(eng, 6, seed=3)
    with SearchServer(eng, max_batch=1, cache_size=0) as srv:
        t = srv.submit(q[0], QueryProfile(mode="or", k=8), deadline_ms=0.4)
        row = t.result(WAIT)
        budget = eng.budget_for_deadline(0.4)
        assert t.profile.budget == budget == 4 and t.profile.sla == "bounded"
        direct = eng.search([q[0]], k=8, mode="or", budget=budget)
        np.testing.assert_array_equal(row.docs, direct.docs[0].numpy())
        np.testing.assert_array_equal(row.certified,
                                      direct.certified[0].numpy())
        assert row.sla == "bounded" and row.pops <= budget
        assert eng._us_per_pop is None          # budgeted: not fed
        srv.search(q[1], QueryProfile(mode="or", k=8), timeout=WAIT)
        assert eng._us_per_pop is not None      # unbudgeted: fed
        # the estimate moved, so the same deadline may buy another budget;
        # whichever it buys, the row equals the direct search at it
        t2 = srv.submit(q[2], QueryProfile(mode="or", k=8), deadline_ms=5.0)
        row2 = t2.result(WAIT)
        direct2 = eng.search([q[2]], k=8, mode="or",
                             budget=t2.profile.budget)
        np.testing.assert_array_equal(row2.docs, direct2.docs[0].numpy())


# -- injected faults ----------------------------------------------------------

def test_faulty_engine_is_seeded_and_transparent(port_engine):
    plan = FaultPlan(p_error=0.5, seed=3)
    a = FaultyEngine(port_engine, plan)
    b = FaultyEngine(port_engine, plan)
    assert a.n_docs == port_engine.n_docs
    q = [sample_queries(port_engine, 1, seed=0)[0]]
    outcomes = []
    for eng in (a, b):
        got = []
        for _ in range(6):
            try:
                eng.search(q, k=4, mode="or")
                got.append("ok")
            except InjectedDispatchError:
                got.append("err")
        outcomes.append(got)
    assert outcomes[0] == outcomes[1]
    assert "err" in outcomes[0] and "ok" in outcomes[0]
    assert a.n_injected_errors == b.n_injected_errors > 0


def test_dispatch_errors_land_on_tickets_and_stalls_are_flagged(port_engine):
    q = sample_queries(port_engine, 8, seed=4)
    profile = QueryProfile(mode="or", k=6)
    faulty = FaultyEngine(port_engine, FaultPlan(p_error=0.5, seed=1))
    with SearchServer(faulty, max_batch=1, cache_size=0) as srv:
        outcomes = []
        for w in q:
            try:
                srv.search(w, profile, timeout=WAIT)
                outcomes.append("ok")
            except InjectedDispatchError:
                outcomes.append("err")
    assert outcomes.count("err") == faulty.n_injected_errors > 0
    assert srv.stats["errors"] == faulty.n_injected_errors
    stalled = FaultyEngine(port_engine, FaultPlan(p_stall=1.0, stall_ms=300.0,
                                                  seed=2))
    with SearchServer(stalled, max_batch=1, cache_size=0) as srv:
        for w in q[:4]:                         # healthy batches first
            srv._watchdog.observe(0, 0.01)
            srv.search(w, profile, timeout=WAIT)
    assert srv.n_stragglers > 0 and stalled.n_stalls == 4


def test_poisoned_cache_entry_never_served(port_engine):
    profile = QueryProfile(mode="or", k=6)
    q = sample_queries(port_engine, 1, seed=1)[0]
    with SearchServer(port_engine, max_batch=2, max_wait_ms=0.1,
                      queue_depth=8) as srv:
        fake = poison_cache(srv, q, profile)
        assert int(fake.docs[0]) == POISON_DOC
        row = srv.search(q, profile, timeout=WAIT)
        assert row.n_found == 0 or int(row.docs[0]) != POISON_DOC
        row2 = srv.search(q, profile, timeout=WAIT)
        assert int(row2.docs[0]) == int(row.docs[0])


def test_swap_under_load_stays_consistent(port_engine):
    queries = sample_queries(port_engine, 12, seed=0)
    profile = QueryProfile(mode="or", k=8, mega=True)
    other = SearchEngine.build(corpus.make_corpus(**dict(SPEC, seed=10)),
                               EngineConfig(block=512), device="cpu")
    with SearchServer(port_engine, max_batch=4, max_wait_ms=0.5,
                      queue_depth=32) as srv:
        srv.warmup(queries[:4], profile)
        rep = swap_under_load(srv, other, queries * 2, profile=profile,
                              qps=300.0, seed=0)
        assert srv.stats["swaps"] == 1
        assert rep.n_ok + rep.n_shed + rep.n_err + rep.n_timeout == \
            len(queries) * 2
        assert rep.n_timeout == 0 and rep.n_err == 0
        assert srv.engine is other
        row = srv.search(queries[0], profile, timeout=WAIT)
        np.testing.assert_array_equal(
            row.docs, other.search([queries[0]],
                                   **profile.search_kwargs()).docs[0].numpy())
