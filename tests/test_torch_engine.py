"""The port's ``SearchEngine`` against ``repro.engine.SearchEngine`` (CPU).

Number contract (ROADMAP Queue 3): the port scores by rounding each product
and adding from left to right over Q.  XLA on a CPU does the same for the
reference's row dots at B >= 2 and Q in {4, 8} in one-pop trips, so there
every leaf is bitwise equal when the reference's idf table is carried
across.  Elsewhere — B = 1, Q = 2, and the heap core's trips that pop two or
more segments (its pow2 frontier buckets S >= 2) — XLA contracts the dot
into FMAs or reorders it, and scores may differ by 1 ulp; structural leaves
are compared wherever no two scores of a row lie within 1 ulp.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from oracle import search_oracle
from repro.core import scoring as r_scoring
from repro_torch import obs
from repro_torch.core import scoring as p_scoring
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.engine.facade import DEFAULT_US_PER_POP, budget_bucket
from test_torch_index import model_arrays, reference_arrays

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def port_engine(engine):
    """The reference engine's index and idf table, carried into the port."""
    idf = np.array(r_scoring.TfIdf().idf(engine.idx))
    return SearchEngine.from_arrays(reference_arrays(engine.idx),
                                    model_arrays(engine.model),
                                    idf={"tfidf": idf},
                                    config=EngineConfig(block=512),
                                    device="cpu")


@pytest.fixture(scope="module")
def own_engine(engine_corpus):
    """The port's own build and host idf."""
    return SearchEngine.build(engine_corpus, EngineConfig(block=512),
                              device="cpu")


def _queries(engine_corpus, seed, B, L):
    df = engine_corpus.doc_freqs()
    pool = np.flatnonzero((df >= 2) & (df <= 60))
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.choice(pool, L, replace=False)))
            for _ in range(B)]


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    fin = np.isfinite(a) & np.isfinite(b)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    return int(d[fin].max()) if fin.any() else 0


def _near_tie(scores) -> bool:
    s = np.sort(np.asarray(scores, np.float32)[np.isfinite(scores)])
    if len(s) < 2:
        return False
    gaps = s[1:].view(np.int32).astype(np.int64) - s[:-1].view(np.int32).astype(np.int64)
    return bool(np.any((gaps > 0) & (gaps <= 1)))


def _compare(port, ref, *, exact: bool):
    for name in ("n_found", "overflowed", "certified"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    if ref.padded is None:
        assert port.padded is None
    if exact:
        for name in ("docs", "scores", "work", "pops", "score_bound"):
            np.testing.assert_array_equal(getattr(port, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
        if ref.padded is not None:
            np.testing.assert_array_equal(port.padded.numpy(),
                                          np.asarray(ref.padded))
        return
    assert _ulps(port.scores.numpy(), ref.scores) <= 1
    assert _ulps(port.score_bound.numpy(), ref.score_bound) <= 1
    for b in range(len(port)):
        if not _near_tie(np.asarray(ref.scores[b])):
            np.testing.assert_array_equal(port.docs[b].numpy(),
                                          np.asarray(ref.docs[b]))
            for name in ("work", "pops", "padded"):
                if getattr(ref, name) is not None:
                    assert int(getattr(port, name)[b]) == \
                        int(np.asarray(getattr(ref, name))[b]), name


# (mode, search kwargs, bitwise?) — bitwise for the one-pop cores at
# B = 4, Q = 3 -> bucket 4; within 1 ulp where the reference's trips pop
# several segments at once
MATRIX = [(mode, kw, exact)
          for mode in ("and", "or")
          for kw, exact in ((dict(beam_width=1), True),
                            (dict(beam_width=3), False),
                            (dict(beam_width=16), False),
                            (dict(mega=True), True))]
MATRIX += [("and", dict(mega=True, budget=4), True),
           ("or", dict(beam_width=1, budget=16), True)]


@pytest.mark.parametrize("mode,kw,exact", MATRIX,
                         ids=[f"{m}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for m, kw, _ in MATRIX])
def test_search_matches_reference(engine, port_engine, engine_corpus, mode,
                                  kw, exact):
    queries = _queries(engine_corpus, 500 + MATRIX.index((mode, kw, exact)),
                       4, 3)
    ref = engine.search(queries, k=8, mode=mode, **kw)
    port = port_engine.search(queries, k=8, mode=mode, **kw)
    assert (port.strategy, port.measure, port.sla, port.beam_width) == \
        (ref.strategy, ref.measure, ref.sla, ref.beam_width)
    _compare(port, ref, exact=exact)


@pytest.mark.parametrize("mode,B,L,kw", [("or", 1, 3, dict()),
                                         ("and", 4, 2, dict(mega=True))],
                         ids=["or-B1", "and-Q2-mega"])
def test_search_within_one_ulp_at_fma_shapes(engine, port_engine,
                                             engine_corpus, mode, B, L, kw):
    """B = 1 and Q = 2: XLA on a CPU contracts the reference's row dot into
    an FMA chain; scores agree within 1 ulp."""
    queries = _queries(engine_corpus, 77 + B, B, L)
    ref = engine.search(queries, k=8, mode=mode, **kw)
    port = port_engine.search(queries, k=8, mode=mode, **kw)
    _compare(port, ref, exact=False)


@pytest.mark.parametrize("mode", ["and", "or"])
def test_own_build_matches_oracle(own_engine, engine_corpus, query_batch, mode):
    """The port's own index and host idf against the numpy brute-force
    oracle: same eligible documents, same scores to float32 precision."""
    n = engine_corpus.n_docs
    res = own_engine.search(query_batch, k=n, mode=mode)
    for b, q in enumerate(query_batch):
        want = search_oracle(engine_corpus.doc_tokens, q, mode=mode,
                             vocab_size=engine_corpus.vocab_size)
        got = dict(res.hits(b))
        assert set(got) == set(want)
        for d, s in got.items():
            assert s == pytest.approx(want[d]["score"], rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
def test_host_idf_within_one_ulp_of_reference(engine, own_engine, measure):
    ref = np.asarray({"tfidf": r_scoring.TfIdf(),
                      "bm25": r_scoring.BM25()}[measure].idf(engine.idx))
    port = {"tfidf": p_scoring.TfIdf(),
            "bm25": p_scoring.BM25()}[measure].idf(own_engine.idx).numpy()
    assert _ulps(port, ref) <= 1


def test_scores_bitwise_across_batch_shapes(own_engine, engine_corpus):
    """The port's own scores do not depend on the batch shape."""
    queries = _queries(engine_corpus, 31, 4, 3)
    whole = own_engine.search(queries, k=8, mode="or")
    for b, q in enumerate(queries):
        one = own_engine.search([q], k=8, mode="or", mega=True)
        np.testing.assert_array_equal(one.scores[0].numpy(),
                                      whole.scores[b].numpy())
        np.testing.assert_array_equal(one.docs[0].numpy(),
                                      whole.docs[b].numpy())


def test_traces_flat_after_warmup(engine_corpus, query_batch):
    eng = SearchEngine.build(engine_corpus, EngineConfig(block=512),
                             device="cpu")
    w = [int(x) for x in query_batch.reshape(-1)[:6]]
    n = eng.warmup([w[:2], w[:3]], max_batch=4, k=5, mode="or")
    assert n == eng.stats["executors"] == 6          # 2 Q x 3 B buckets
    before = dict(eng.stats["traces"])
    for batch in ([w[:2]], [w[:3]] * 2, [w[:2], w[:3]], [w[:2]] * 4,
                  [w[:4], w[:3], w[:2], w[:4]]):
        eng.search(batch, k=5, mode="or")
    assert eng.stats["traces"] == before
    eng.search([w[:3]], k=7, mode="or")              # a new k: one new key
    assert eng.stats["executors"] == 7


def test_executor_cache_and_budget_normalization(port_engine, query_batch):
    before = port_engine.stats["executors"]
    exact = port_engine.search(query_batch, k=5, mode="or")
    mid = port_engine.stats["executors"]
    huge = port_engine.search(query_batch, k=5, mode="or", budget=10 ** 9)
    assert port_engine.stats["executors"] == mid <= before + 1
    np.testing.assert_array_equal(exact.docs.numpy(), huge.docs.numpy())
    assert exact.sla == "exact" and huge.sla == "bounded"
    assert int(exact.certified.sum()) == int(exact.n_found.sum())


def test_build_defaults_to_the_card(engine_corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchEngine.build(engine_corpus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SearchEngine.build(engine_corpus, device="cuda")


def test_dr_bm25_raises_the_reference_error(engine, port_engine, query_batch):
    with pytest.raises(ValueError) as want:
        engine.search(query_batch, k=5, strategy="dr", measure="bm25")
    with pytest.raises(ValueError) as got:
        port_engine.search(query_batch, k=5, strategy="dr", measure="bm25")
    assert str(got.value) == str(want.value)


def test_later_slices_raise_not_implemented(port_engine, query_batch):
    # positional search and word_positions are here now
    for kw in (dict(mode="phrase"), dict(mode="near")):
        res = port_engine.search(query_batch, k=5, **kw)
        assert res.match_pos.shape == res.docs.shape
    assert set(port_engine.word_positions(0, [1])) == {1}
    # document sharding is here now: two shards of one document are refused
    # as in the reference
    with pytest.raises(ValueError, match="zero documents"):
        SearchEngine.shard([[1, 2]], 2, device="cpu")
    # the observability registry is here now: unpinned, the engine records
    # into the live process default
    assert port_engine.obs_registry is None
    assert port_engine._obs is obs.default_registry()
    # DRB, BM25 and snippets are here now; an engine carried across without
    # its DRB bitmaps (and holding no tokens to build them) says so
    for kw in (dict(strategy="drb"), dict(measure="bm25")):
        with pytest.raises(ValueError, match="DRB bitmaps unavailable"):
            port_engine.search(query_batch, k=5, **kw)
    assert len(port_engine.snippets(port_engine.search(query_batch, k=5))) \
        == len(query_batch)


def test_input_validation(port_engine, query_batch):
    with pytest.raises(ValueError, match="mode"):
        port_engine.search(query_batch, mode="xor")
    with pytest.raises(ValueError, match="strategy"):
        port_engine.search(query_batch, strategy="fancy")
    with pytest.raises(ValueError, match="measure"):
        port_engine.search(query_batch, measure="pagerank")
    with pytest.raises(ValueError, match="word ids"):
        port_engine.search(np.zeros((2, 2), np.int64), k=3)
    with pytest.raises(ValueError, match="k must be positive"):
        port_engine.search(query_batch, k=0)
    with pytest.raises(ValueError, match="beam_width"):
        port_engine.search(query_batch, beam_width=0)
    with pytest.raises(ValueError, match="df_cap"):
        port_engine.search(query_batch, df_cap=8)
    with pytest.raises(ValueError, match="window"):
        port_engine.search(query_batch, window=3)
    with pytest.raises(ValueError, match="default_sla"):
        EngineConfig(default_sla="turbo")
    with pytest.raises(ValueError, match="block"):
        EngineConfig(block=0)
    with pytest.raises(TypeError):
        SearchEngine(config=EngineConfig(), model=None, idx=None)


def test_anytime_knobs(port_engine, query_batch):
    with pytest.raises(ValueError, match="exact"):
        port_engine.search(query_batch, k=5, sla="exact", budget=9)
    with pytest.raises(ValueError, match="exact"):
        port_engine.search(query_batch, k=5, sla="exact", deadline_ms=5.0)
    with pytest.raises(ValueError, match="sla"):
        port_engine.search(query_batch, k=5, sla="turbo")
    with pytest.raises(ValueError, match="deadline_ms"):
        port_engine.search(query_batch, k=5, deadline_ms=0.0)
    res = port_engine.search(query_batch, k=5, mode="or", budget=16,
                             sla="best_effort")
    assert res.sla == "best_effort"
    cert = res.certified.numpy()
    assert not np.any(np.diff(cert.astype(int), axis=1) > 0)   # prefixes
    eng = SearchEngine.build([np.arange(1, 40)] * 50, device="cpu")
    assert eng.us_per_pop == DEFAULT_US_PER_POP
    assert eng.budget_for_deadline(0.4) == 4         # 8 pops -> bucket 4
    eng.note_cost(1e-3, 100.0)                       # 10 us/pop
    assert eng.budget_for_deadline(0.4) == 16
    assert eng.budget_for_deadline(60_000) is None
    assert [budget_bucket(n) for n in (1, 3, 4, 15, 16, 64, 1000)] == \
        [1, 1, 4, 4, 16, 64, 256]


def test_results_views_and_ragged_queries(port_engine, query_batch):
    w0, w1 = int(query_batch[0, 0]), int(query_batch[0, 1])
    single = port_engine.search([w0], k=5, mode="or")
    ragged = port_engine.search([[w0], [w0, w1]], k=5, mode="or")
    assert len(single) == 1 and len(ragged) == 2
    np.testing.assert_array_equal(single.scores[0].numpy(),
                                  ragged.scores[0].numpy())
    hits = ragged.hits(1)
    assert len(hits) == int(ragged.n_found[1])
    assert all(isinstance(d, int) and isinstance(s, float) for d, s in hits)
    d = ragged.diagnostics
    assert {"work", "pops", "overflowed", "padded", "certified",
            "certified_fraction", "score_bound"} <= set(d)
    assert ragged.doc_ids().shape == (2, 5)


def test_content_tag_and_space_report(engine_corpus, own_engine):
    again = SearchEngine.build(engine_corpus, EngineConfig(block=512),
                               device="cpu")
    other = SearchEngine.build(engine_corpus, EngineConfig(block=1024),
                               device="cpu")
    assert own_engine.content_tag == again.content_tag != other.content_tag
    rep = own_engine.space_report()
    assert rep["total"] == sum(v for k, v in rep.items() if k != "total")
    assert rep["level_bytes"] == sum(lv.length for lv in own_engine.idx.levels)


def test_port_imports_no_jax_and_no_reference():
    """An AST walk over the port finds no import of jax or of ``repro``."""
    bad = []
    for path in sorted((SRC / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n == "jax" or n.startswith("jax.") or n == "repro" \
                        or n.startswith("repro."):
                    bad.append(f"{path.name}: {n}")
    assert not bad, bad
    chip_smoke = (SRC.parent / "chip_smoke.py").read_text()
    assert "import jax" not in chip_smoke and "from repro." not in chip_smoke


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch.engine, repro_torch.convert; "
            "print(any(m == 'jax' or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120, check=True)
    assert out.stdout.strip() == "False"
