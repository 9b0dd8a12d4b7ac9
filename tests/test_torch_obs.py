"""The port's observability layer (``repro_torch.obs``), its WTBC roofline
and the engine's search recording, against ``repro.obs`` (CPU).

The same registry operations run through both packages and must export the
same Prometheus text and JSON snapshots; the roofline model must give the
reference's bytes; and recording must be bitwise neutral on the port's own
engine.
"""
import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro.obs as r_obs
import repro_torch.obs as obs
from repro.analysis import roofline as r_roofline
from repro_torch.analysis import roofline
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.obs.metrics import SUBBUCKETS
from repro_torch.obs.tracing import Timeline, stage_durations
from repro_torch.serve import QueryProfile, SearchServer, loadgen
from repro_torch.serve.server import _slice_rows
from repro_torch.text import corpus

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def obs_engine():
    cp = corpus.make_corpus(n_docs=100, mean_doc_len=50, vocab_size=400,
                            seed=21)
    return SearchEngine.build(cp, EngineConfig(block=512), device="cpu")


@pytest.fixture(scope="module")
def obs_queries(obs_engine):
    return loadgen.sample_queries(obs_engine, 16, 3, seed=5)


# ---------------------------------------------------------------------------
# metrics and exporters: the same operations through both packages
# ---------------------------------------------------------------------------

def _fill(pkg):
    """One fixed sequence of registry operations through ``pkg``."""
    rng = np.random.default_rng(0)
    reg = pkg.Registry(enabled=True)
    reg.counter("repro_c_total", {"x": "1"}, "a counter").inc(3)
    reg.counter("repro_c_total", {"x": "2"}, "a counter").inc()
    reg.gauge("repro_g", None, "a gauge").set(2.5)
    h = reg.histogram("repro_h_seconds", {"stage": "s"}, "a histogram")
    h.observe_many([0.0, 0.001, 0.002, 0.5, 3.0])
    w = reg.histogram("repro_work", None, "integers")
    w.observe_many(rng.integers(1, 2 * SUBBUCKETS, 500).tolist())
    lat = reg.histogram("repro_lat", None, "lognormal")
    lat.observe_many(rng.lognormal(-5.0, 2.0, 2000).tolist())
    off = pkg.Registry(enabled=False)
    off.counter("repro_off_total").inc(7)
    return reg, off


def test_registry_exports_equal_the_references():
    ours, ours_off = _fill(obs)
    ref, ref_off = _fill(r_obs)
    assert obs.render_prometheus(ours) == r_obs.render_prometheus(ref)
    assert ours.snapshot() == ref.snapshot()
    assert ours_off.snapshot() == ref_off.snapshot() == \
        {"repro_off_total": 0}
    a = json.loads(obs.snapshot_line(ours))
    b = json.loads(r_obs.snapshot_line(ref))
    assert a["metrics"] == b["metrics"]
    for name in ("repro_work", "repro_lat"):
        h, rh = ours.find(name)[0], ref.find(name)[0]
        for q in (0, 1, 25, 50, 75, 95, 99, 100):
            assert h.quantile(q) == rh.quantile(q), (name, q)
        assert h.percentiles() == rh.percentiles()


def test_histogram_exact_for_small_integers():
    rng = np.random.default_rng(0)
    h = obs.Registry(enabled=True).histogram("work")
    vals = rng.integers(1, 2 * SUBBUCKETS, size=2000)
    h.observe_many(vals.tolist())
    for q in (1, 25, 50, 75, 95, 99):
        assert h.quantile(q) == float(
            np.percentile(vals, q, method="inverted_cdf")), q


def test_registry_guards_and_default():
    reg = obs.Registry(enabled=True)
    assert reg.counter("x", {"a": "1"}) is reg.counter("x", {"a": "1"})
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x", {"a": "1"})
    assert obs.default_registry().enabled is False
    mine = obs.Registry(enabled=True)
    with obs.use(mine):
        assert obs.default_registry() is mine
        obs.default_registry().counter("k").inc()
    assert obs.default_registry() is not mine
    assert mine.counter("k").value == 1
    # the port's registry is its own: the reference's default is untouched
    assert r_obs.default_registry() is not obs.default_registry()


def test_timeline_stage_durations_equal_the_references():
    marks = (("admit", 100.5), ("lane_enqueue", 100.6), ("batch_form", 101.0),
             ("dispatch", 101.5), ("device", 103.5), ("slice", 103.6),
             ("complete", 103.7))
    ours, ref = Timeline(100.0), r_obs.Timeline(100.0)
    for stage, t in marks:
        ours.mark(stage, t)
        ref.mark(stage, t)
    assert stage_durations(ours) == r_obs.stage_durations(ref)
    assert ours.spans() == ref.spans()
    assert obs.STAGES == r_obs.STAGES
    partial = Timeline(0.0)
    partial.mark("complete", 0.001)
    assert set(stage_durations(partial)) == {"total"}


def test_metrics_http_server_scrape():
    reg, _ = _fill(obs)
    with obs.MetricsServer(reg, port=0) as srv:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read().decode()
        assert body == obs.render_prometheus(reg)
        j = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics.json", timeout=10).read())
        assert j["metrics"]["repro_g"] == 2.5
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=10)


# ---------------------------------------------------------------------------
# the WTBC roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pops,padded,q,block", [
    (12.0, 0.0, 4, 512), (37.5, 2.25, 8, 4096), (1.0, 0.0, 1, 64)])
def test_roofline_bytes_equal_the_references(pops, padded, q, block):
    kw = dict(measured_us_per_query=250.0, pops=pops, padded=padded, q=q,
              block=block)
    cuda = roofline.wtbc_query_roofline(backend="cuda", **kw)
    cpu = roofline.wtbc_query_roofline(backend="cpu", **kw)
    for ref_backend in ("gpu", "cpu"):
        ref = r_roofline.wtbc_query_roofline(backend=ref_backend, **kw)
        assert cuda.bytes_per_query == ref.bytes_per_query
        assert cpu.bytes_per_query == ref.bytes_per_query
    assert roofline.WTBC_MEM_BW["cuda"] == 3.35e12
    assert cuda.model_us_per_query == cuda.bytes_per_query / 3.35e12 * 1e6
    assert cpu.model_us_per_query == r_roofline.wtbc_query_roofline(
        backend="cpu", **kw).model_us_per_query
    assert cuda.achieved_frac == cuda.model_us_per_query / 250.0


# ---------------------------------------------------------------------------
# the engine's recording
# ---------------------------------------------------------------------------

def test_instrumentation_is_bitwise_neutral(obs_engine, obs_queries):
    for kw in (dict(mode="or", strategy="dr"), dict(mode="or", mega=True),
               dict(mode="and", strategy="drb", measure="bm25"),
               dict(mode="phrase")):
        base = obs_engine.search(obs_queries[:4], k=6, **kw)
        reg = obs.Registry(enabled=True)
        with obs.use(reg):
            inst = obs_engine.search(obs_queries[:4], k=6, **kw)
        assert reg.find("repro_engine_searches_total"), kw
        for name in ("docs", "scores", "n_found", "work", "pops"):
            a, b = getattr(base, name), getattr(inst, name)
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b), (kw, name)


def test_engine_records_work_cost_and_roofline(obs_engine, obs_queries):
    reg = obs.Registry(enabled=True)
    saved = obs_engine._us_per_pop
    obs_engine._us_per_pop = None
    try:
        with obs.use(reg):
            res = obs_engine.search(obs_queries[:3], k=5, mode="or",
                                    strategy="dr")
        labels = {"backend": "single", "strategy": "dr", "mode": "or"}
        pops_h = reg.histogram("repro_engine_pops", labels)
        assert pops_h.n == 3
        assert pops_h.total == float(res.pops.sum())
        assert reg.histogram("repro_engine_trips", labels).n == 3
        assert reg.histogram("repro_engine_pad_lanes", labels).n == 3
        assert reg.counter("repro_engine_rows_total", labels).value == 3
        assert reg.counter("repro_engine_searches_total", labels).value == 1
        assert reg.histogram("repro_engine_dispatch_seconds", labels).n == 1
        # note_cost moved the live estimate off its cold-start default
        assert obs_engine._us_per_pop is not None
        assert reg.gauge("repro_engine_us_per_pop").value == \
            obs_engine.us_per_pop
        frac = reg.gauge("repro_roofline_achieved_frac", {"backend": "cpu"})
        assert frac.value > 0.0
        bpq = reg.gauge("repro_roofline_bytes_per_query",
                        {"backend": "cpu"}).value
        assert bpq == roofline.wtbc_query_bytes(
            pops=float(res.pops.numpy().mean()),
            padded=float(res.padded.numpy().mean()), q=4, block=512)
        # a budgeted batch does not feed the estimator
        est = obs_engine._us_per_pop
        with obs.use(reg):
            obs_engine.search(obs_queries[:3], k=5, mode="or", budget=4)
        assert obs_engine._us_per_pop == est
    finally:
        obs_engine._us_per_pop = saved


def test_engine_counts_executor_constructions():
    cp = corpus.make_corpus(n_docs=40, mean_doc_len=20, vocab_size=200,
                            seed=2)
    eng = SearchEngine.build(cp, EngineConfig(block=512), device="cpu")
    reg = obs.Registry(enabled=True)
    eng.obs_registry = reg
    q = loadgen.sample_queries(eng, 2, 2, seed=1)
    eng.search(q, k=3, mode="or")
    eng.search(q, k=3, mode="or")
    eng.search(q, k=3, mode="and", strategy="drb")
    traces = {dict(c.labels)["strategy"]: c.value
              for c in reg.find("repro_engine_traces_total")}
    assert traces == {"dr": 1, "drb": 1}
    assert sum(eng.stats["traces"].values()) == 2
    assert reg.gauge("repro_engine_executors").value == 2


def test_disabled_engine_records_nothing(obs_engine, obs_queries):
    reg = obs.Registry(enabled=False)
    with obs.use(reg):
        obs_engine.search(obs_queries[:2], k=4, mode="or")
    assert all(v == 0 or (isinstance(v, dict) and v["count"] == 0)
               for v in reg.snapshot().values())


# ---------------------------------------------------------------------------
# the server's spans and stage histograms
# ---------------------------------------------------------------------------

def _dummy_engine(delay_s: float = 0.0, padded=None):
    def search(queries, **kw):
        if delay_s:
            time.sleep(delay_s)
        B = len(queries)
        k = kw.get("k") or 3
        ns = types.SimpleNamespace(
            docs=torch.arange(k, dtype=torch.int32).repeat(B, 1),
            scores=torch.zeros((B, k)),
            n_found=torch.full((B,), k, dtype=torch.int32),
            work=torch.ones(B, dtype=torch.int32),
            pops=None, overflowed=None, match_pos=None, match_len=None,
            k=k, mode=kw.get("mode", "and"), strategy="dr", measure="tfidf")
        if padded is not None:
            ns.padded = torch.full((B,), padded, dtype=torch.int32)
        return ns
    return types.SimpleNamespace(
        search=search, model=types.SimpleNamespace(vocab_size=100),
        stats={"executors": 0, "traces": {}},
        warmup=lambda *a, **kw: 0)


def test_server_spans_and_stage_histograms_with_registry():
    reg = obs.Registry(enabled=True)
    eng = _dummy_engine(delay_s=0.002)
    with SearchServer(eng, max_batch=4, max_wait_ms=5.0, cache_size=16,
                      registry=reg) as server:
        tickets = [server.submit([1 + i % 7]) for i in range(12)]
        rows = [t.result(timeout=10.0) for t in tickets]
        hit = server.submit([1])
        hit.result(timeout=10.0)
        server_stats = server.stats
    assert all(r.n_found == 3 for r in rows)
    stages = [s for s, _ in tickets[0].timeline.marks]
    assert stages[0] == "submit" and stages[-1] == "complete"
    for s in ("admit", "lane_enqueue", "batch_form", "dispatch", "device",
              "slice"):
        assert s in stages, s
    ts = [t for _, t in tickets[0].timeline.marks]
    assert ts == sorted(ts)
    assert hit.cache_hit and hit.timeline is not None
    for t in tickets:
        assert t.queue_wait_s + t.service_s == pytest.approx(t.latency_s)
    by_stage = {dict(h.labels)["stage"]: h
                for h in reg.find("repro_request_stage_seconds")}
    assert by_stage["device"].n == 12
    assert by_stage["total"].n == 13
    served = reg.counter("repro_server_requests_total", {"outcome": "served"})
    assert served.value == 13 == server_stats["served"]
    assert reg.find("repro_cache_hits_total")[0].value == 1
    assert reg.find("repro_batch_size")
    assert reg.find("repro_dispatch_seconds")[0].n == \
        server_stats["dispatches"]


def test_server_disabled_registry_allocates_nothing():
    reg = obs.Registry(enabled=False)
    with SearchServer(_dummy_engine(), max_batch=4, cache_size=0,
                      registry=reg) as server:
        t = server.submit([3])
        t.result(timeout=10.0)
    assert t.timeline is None
    for v in reg.snapshot().values():
        assert v == 0 or (isinstance(v, dict) and v["count"] == 0)


def test_slice_rows_copies_each_leaf_once_and_threads_padded():
    """Rows come from one host copy per leaf: torch and numpy leaves slice
    alike, pad rows are dropped, missing diagnostics read as None."""
    res = types.SimpleNamespace(
        docs=torch.zeros((3, 2), dtype=torch.int32),
        scores=torch.zeros((3, 2)), n_found=torch.ones(3, dtype=torch.int32),
        work=np.ones(3, np.int32), pops=torch.tensor([4, 5, 6]),
        overflowed=torch.tensor([False, True, False]),
        padded=np.array([0, 2, 7]), match_pos=None, match_len=None,
        k=2, mode="or", strategy="dr", measure="tfidf")
    rows = _slice_rows(res, 2)
    assert [r.padded for r in rows] == [0, 2]
    assert [r.overflowed for r in rows] == [False, True]
    assert [r.pops for r in rows] == [4, 5]
    assert all(isinstance(r.docs, np.ndarray) for r in rows)
    del res.padded
    assert all(r.padded is None for r in _slice_rows(res, 2))


def test_loadreport_stage_breakdown_with_registry():
    reg = obs.Registry(enabled=True)
    with SearchServer(_dummy_engine(delay_s=0.002), max_batch=4,
                      max_wait_ms=1.0, cache_size=0, registry=reg) as server:
        rep = loadgen.open_loop(server, [[1 + i % 9] for i in range(20)],
                                target_qps=400.0, timeout_s=30.0)
    assert rep.n_ok == 20
    for s in ("queue_wait", "device", "slice", "total"):
        assert rep.stages[s]["count"] > 0 and np.isfinite(
            rep.stages[s]["p99_ms"]), s
    assert rep.stages["total"]["count"] == 20


def test_served_engine_records_into_the_servers_registry(obs_engine,
                                                         obs_queries):
    reg = obs.Registry(enabled=True)
    profile = QueryProfile(mode="or", k=5, mega=True)
    try:
        with SearchServer(obs_engine, max_batch=4, cache_size=0,
                          registry=reg) as server:
            assert obs_engine.obs_registry is reg
            for q in obs_queries[:4]:
                server.search(q, profile, timeout=60.0)
    finally:
        obs_engine.obs_registry = None           # unpin the module fixture
    rows = reg.counter("repro_engine_rows_total",
                       {"backend": "single", "strategy": "dr", "mode": "or"})
    assert rows.value >= 4
    assert reg.find("repro_roofline_achieved_frac")
