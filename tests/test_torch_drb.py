"""The port's WTBC-DRB (tf bitmaps, and/or search, tf-idf and BM25) against
the JAX reference (CPU).

* ``drb.build_aux``: every bitmap array equals the reference's;
* ``topk_drb_and`` / ``topk_drb_or`` over (B, Q) batches, B >= 2, Q in
  {4, 8}, beam P in {1, 4}, with the reference's idf tables and ``avg_dl``
  carried across: every integer leaf (docs, n_found, iters, pops, padded,
  overflowed, certified) and the score bound bitwise; scores within the
  tolerance below;
* budgets, stopword and absent-word semantics;
* the whole slice through ``SearchEngine.from_arrays(...).search(
  strategy="drb")`` and ``snippets`` against ``repro.engine.SearchEngine``,
  and the port's own build against the numpy brute-force oracle.

**Score tolerance** (measured; ROADMAP Queue 3, R4).  The port scores by
rounding each product and adding left to right over Q (``scoring.dot_q``),
so DRB and DR scores are bitwise equal to each other on every device.  The
reference's ``jnp.sum(part * idf_w, -1)`` is, on XLA:CPU at every DRB
shape measured here, a left-to-right FMA chain; the two orders differ by at
most Q/2 ulps (measured over 4e5 random rows: 1 at Q = 2, 3 at Q = 4, 4 at
Q = 8).  For BM25 XLA also contracts ``(1 - b) + b * ratio`` into an FMA at
vectorized shapes (the bag-of-words (N,) table), which moves a word's part
by up to 2 ulps.  So: tf-idf scores within Q/2 ulps, BM25 within Q/2 + 2
ulps; bitwise only where XLA rounds each product (a single query word).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import search_oracle
from repro.core import drb as r_drb
from repro.core import scoring as r_scoring
from repro.core import wtbc as r_wtbc
from repro.engine import EngineConfig as REngineConfig
from repro.engine import SearchEngine as RSearchEngine
from repro.text import corpus as r_corpus
from repro_torch.core import drb, scoring, wtbc
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import backend
from test_torch_index import model_arrays, reference_arrays

torch.set_num_threads(1)

SPEC = dict(n_docs=300, mean_doc_len=60, vocab_size=800, seed=21)
BLOCK = 1024
MEASURES = {"tfidf": (r_scoring.TfIdf(), scoring.TfIdf()),
            "bm25": (r_scoring.BM25(), scoring.BM25())}
INT_LEAVES = ("docs", "n_found", "iters", "pops", "overflowed", "certified",
              "bound")
_BUILD = {}


def build():
    """(corpus, reference idx, model, aux, port idx, port aux), memoized."""
    if not _BUILD:
        cp = r_corpus.make_corpus(**SPEC)
        ridx, rmodel = r_wtbc.build_index(cp.doc_tokens, cp.vocab_size,
                                          block=BLOCK)
        raux = r_drb.build_aux(ridx, rmodel, cp.doc_tokens)
        pidx, _ = wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=BLOCK,
                                   device="cpu")
        paux = drb.build_aux(pidx, rmodel, cp.doc_tokens)
        _BUILD["v"] = (cp, ridx, rmodel, raux, pidx, paux)
    return _BUILD["v"]


def aux_arrays(aux) -> dict:
    """A reference ``DRBAux`` as plain numpy under its field names."""
    return {"words": np.asarray(aux.bv.words),
            "counts": np.asarray(aux.bv.counts),
            "n_bits": int(aux.bv.n_bits), "bit_off": np.asarray(aux.bit_off),
            "has_bm": np.asarray(aux.has_bm), "eps": aux.eps}


def batch(cp, rmodel, rng, B, Q, n_words, *, from_docs=True):
    """(B, Q) word ranks and mask.  ``from_docs`` draws each row's words from
    one document, so conjunctions have hits."""
    df = cp.doc_freqs()
    words = np.zeros((B, Q), np.int32)
    mask = np.zeros((B, Q), bool)
    for b in range(B):
        if from_docs:
            doc = cp.doc_tokens[rng.integers(0, cp.n_docs)]
            pool = np.unique(doc)
            pool = pool[df[pool] <= cp.n_docs // 3]
        else:
            pool = np.flatnonzero((df >= 2) & (df <= 80))
        ids = rng.choice(pool, n_words, replace=False)
        words[b, :n_words] = rmodel.rank_of_word[ids]
        mask[b, :n_words] = True
    return words, mask


def ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    if not fin.any():
        return 0
    return int(np.abs(a[fin].view(np.int32).astype(np.int64)
                      - b[fin].view(np.int32).astype(np.int64)).max())


def tolerance(measure: str, Q: int) -> int:
    return Q // 2 + (2 if measure == "bm25" else 0)


def assert_topk_close(got_docs, got_scores, want_docs, want_scores, tol):
    """Row by row: the same number of hits, each found document's score
    within ``tol`` ulps, and the same documents and order except where two
    scores of the row lie within ``tol`` ulps of each other (an order the
    two roundings may break differently)."""
    got_docs, want_docs = np.asarray(got_docs), np.asarray(want_docs)
    got_scores = np.asarray(got_scores, np.float32)
    want_scores = np.asarray(want_scores, np.float32)
    assert ulps(got_scores, want_scores) <= tol
    for b in range(got_docs.shape[0]):
        s = want_scores[b][np.isfinite(want_scores[b])]   # all >= 0
        gaps = np.diff(np.sort(s.view(np.int32).astype(np.int64)))
        if not np.any((gaps > 0) & (gaps <= 2 * tol)):
            np.testing.assert_array_equal(got_docs[b], want_docs[b])


def run_both(fn, words, mask, measure, **kw):
    """(port DRResult, reference DRResult) of one DRB search."""
    cp, ridx, rmodel, raux, pidx, paux = build()
    rm, pm = MEASURES[measure]
    ridf = np.array(rm.idf(ridx))
    ravg = jnp.sum(ridx.doc_len.astype(jnp.float32)) \
        / ridx.n_docs.astype(jnp.float32)
    rfn, pfn = {"and": (r_drb.topk_drb_and, drb.topk_drb_and),
                "or": (r_drb.topk_drb_or, drb.topk_drb_or)}[fn]
    want = jax.vmap(lambda w, m: rfn(ridx, raux, w, m, rm, idf=jnp.asarray(
        ridf), avg_dl=ravg, **kw))(jnp.asarray(words), jnp.asarray(mask))
    before = backend.launch_counts()
    got = pfn(pidx, paux, torch.from_numpy(words), torch.from_numpy(mask), pm,
              idf=torch.from_numpy(ridf),
              avg_dl=torch.tensor(np.float32(ravg)), **kw)
    assert backend.launch_counts() == before       # CPU: plain versions only
    return got, want


def compare(got, want, measure, Q, *, padded=True):
    names = INT_LEAVES + (("padded",) if padded else ())
    for n in names:
        if n == "docs":
            continue
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(want, n)),
                                      err_msg=n)
    assert_topk_close(got.docs.numpy(), got.scores.numpy(), want.docs,
                      want.scores, tolerance(measure, Q))


# ---------------------------------------------------------------------------
# the aux build
# ---------------------------------------------------------------------------

def test_build_aux_matches_reference():
    cp, ridx, rmodel, raux, pidx, paux = build()
    np.testing.assert_array_equal(np.asarray(raux.bv.words).view(np.int32),
                                  paux.bv.words.numpy())
    np.testing.assert_array_equal(np.asarray(raux.bv.counts),
                                  paux.bv.counts.numpy())
    assert int(raux.bv.n_bits) == paux.bv.n_bits
    np.testing.assert_array_equal(np.asarray(raux.bit_off),
                                  paux.bit_off.numpy())
    np.testing.assert_array_equal(np.asarray(raux.has_bm),
                                  paux.has_bm.numpy())
    assert paux.eps == raux.eps
    assert drb.space_report(paux) == r_drb.space_report(raux)
    override = np.asarray(raux.has_bm).copy()
    override[rmodel.rank_of_word[cp.doc_tokens[0][:5]]] = False
    a = r_drb.build_aux(ridx, rmodel, cp.doc_tokens, has_bm_override=override)
    b = drb.build_aux(pidx, rmodel, cp.doc_tokens, has_bm_override=override)
    np.testing.assert_array_equal(np.asarray(a.bv.words).view(np.int32),
                                  b.bv.words.numpy())
    np.testing.assert_array_equal(np.asarray(a.bit_off), b.bit_off.numpy())


def test_word_bitmap_ops_match_reference():
    cp, ridx, rmodel, raux, pidx, paux = build()
    rng = np.random.default_rng(3)
    w = np.flatnonzero(np.asarray(raux.has_bm))[:40].astype(np.int32)
    occ = drb.word_occ(paux, torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(
        occ, np.asarray(jax.vmap(lambda x: r_drb.word_occ(raux, x))(w)))
    i = (rng.integers(0, 10**6, len(w)) % (occ + 1)).astype(np.int32)
    np.testing.assert_array_equal(
        drb.word_rank1(paux, torch.from_numpy(w), torch.from_numpy(i)).numpy(),
        np.asarray(jax.vmap(lambda a, b: r_drb.word_rank1(raux, a, b))(w, i)))
    j = (1 + rng.integers(0, 10**6, len(w)) % 3).astype(np.int32)
    np.testing.assert_array_equal(
        drb.word_select1(paux, torch.from_numpy(w),
                         torch.from_numpy(j)).numpy(),
        np.asarray(jax.vmap(lambda a, b: r_drb.word_select1(raux, a, b))(w, j)))


def test_avg_doc_len_matches_reference_below_2_24_tokens():
    _, ridx, _, _, pidx, _ = build()
    ref = np.float32(jnp.sum(ridx.doc_len.astype(jnp.float32))
                     / ridx.n_docs.astype(jnp.float32))
    got = scoring.avg_doc_len(pidx.doc_len.numpy(), pidx.n_docs)
    assert got.dtype == np.float32 and got == ref


# ---------------------------------------------------------------------------
# the two searches against the reference
# ---------------------------------------------------------------------------

SWEEP = [(measure, Q, P) for measure in ("tfidf", "bm25") for Q in (4, 8)
         for P in (1, 4)]


@pytest.mark.parametrize("measure,Q,P", SWEEP)
def test_topk_drb_and_matches_reference(measure, Q, P):
    cp, _, rmodel, *_ = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(SWEEP.index(
        (measure, Q, P))), 4, Q, Q - 1)
    got, want = run_both("and", words, mask, measure, k=8, beam_width=P)
    assert int(got.n_found.sum()) > 0
    compare(got, want, measure, Q)


@pytest.mark.parametrize("measure,Q", [(m, Q) for m in ("tfidf", "bm25")
                                       for Q in (4, 8)])
def test_topk_drb_or_matches_reference(measure, Q):
    cp, _, rmodel, *_ = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(40 + Q), 3, Q,
                        Q - 1, from_docs=False)
    got, want = run_both("or", words, mask, measure, k=10, max_df_cap=128)
    assert int(got.n_found.min()) == 10
    compare(got, want, measure, Q, padded=False)


@pytest.mark.parametrize("P", [1, 4])
def test_topk_drb_and_budget_matches_reference(P):
    """An all-or-nothing budget: a stopped walk certifies nothing and
    reports bound +inf; ``pops`` counts candidate documents."""
    cp, _, rmodel, *_ = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(77), 3, 4, 1)
    got, want = run_both("and", words, mask, "tfidf", k=5, beam_width=P,
                         max_pops=3)
    compare(got, want, "tfidf", 4)
    assert np.isinf(got.bound.numpy()).all()


def test_bm25_needs_avg_dl():
    """The caller owns BM25's mean document length (the engine computes it
    once); tf-idf does not use it."""
    cp, _, rmodel, _, pidx, paux = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(6), 2, 4, 2)
    w, m = torch.from_numpy(words), torch.from_numpy(mask)
    for fn, kw in ((drb.topk_drb_and, dict(k=4)),
                   (drb.topk_drb_or, dict(k=4, max_df_cap=128))):
        with pytest.raises(ValueError, match="avg_dl"):
            fn(pidx, paux, w, m, scoring.BM25(), **kw)
        assert fn(pidx, paux, w, m, scoring.TfIdf(), **kw).docs.shape == (2, 4)


def test_single_word_scores_are_bitwise():
    """With one query word the reference rounds the one product: bitwise."""
    cp, _, rmodel, *_ = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(5), 4, 4, 1)
    for fn, kw in (("and", dict(k=6)), ("or", dict(k=6, max_df_cap=128))):
        got, want = run_both(fn, words, mask, "tfidf", **kw)
        np.testing.assert_array_equal(got.scores.numpy(),
                                      np.asarray(want.scores))
        np.testing.assert_array_equal(got.docs.numpy(), np.asarray(want.docs))


def test_stopword_and_absent_word_semantics():
    """A word without a bitmap leaves the conjunction; a word absent from
    the collection empties it; a row of masked words finds nothing."""
    cp, ridx, rmodel, raux, pidx, paux = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(9), 4, 4, 2)
    absent = np.flatnonzero(pidx.df.numpy() == 0)
    stop = np.flatnonzero(~paux.has_bm.numpy() & (pidx.df.numpy() > 0))
    if len(absent):
        words[1, 2], mask[1, 2] = absent[0], True
    if len(stop) > 1:
        words[2, 2], mask[2, 2] = stop[1], True
    mask[3] = False
    for fn, kw in (("and", dict(k=5)), ("or", dict(k=5, max_df_cap=128))):
        got, want = run_both(fn, words, mask, "tfidf", **kw)
        compare(got, want, "tfidf", 4, padded=fn == "and")
        assert int(got.n_found[3]) == 0
        if len(absent) and fn == "and":
            assert int(got.n_found[1]) == 0


# ---------------------------------------------------------------------------
# the slice through the facade
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """(reference engine, port engine carrying its arrays, port engine of
    its own build) over the DRB corpus."""
    cp, *_ = build()
    ref = RSearchEngine.build(cp, REngineConfig(block=BLOCK))
    idf = {name: np.asarray(m[0].idf(ref.idx)) for name, m in MEASURES.items()}
    port = SearchEngine.from_arrays(
        reference_arrays(ref.idx), model_arrays(ref.model), idf=idf,
        config=EngineConfig(block=BLOCK), aux=aux_arrays(ref.aux),
        avg_dl=float(np.asarray(ref._avg_doc_len())), device="cpu")
    own = SearchEngine.build(cp, EngineConfig(block=BLOCK), device="cpu")
    return cp, ref, port, own


def _queries(cp, seed, B, L, from_docs=True):
    rng = np.random.default_rng(seed)
    df = cp.doc_freqs()
    out = []
    for _ in range(B):
        if from_docs:
            pool = np.unique(cp.doc_tokens[rng.integers(0, cp.n_docs)])
            pool = pool[df[pool] <= cp.n_docs // 3]
        else:
            pool = np.flatnonzero((df >= 2) & (df <= 80))
        out.append([int(x) for x in rng.choice(pool, L, replace=False)])
    return out


ENGINE_CASES = [(measure, mode, strategy)
                for measure in ("tfidf", "bm25") for mode in ("and", "or")
                for strategy in ("drb", "auto")]


@pytest.mark.parametrize("measure,mode,strategy", ENGINE_CASES)
def test_engine_drb_matches_reference(engines, measure, mode, strategy):
    cp, ref, port, _ = engines
    queries = _queries(cp, ENGINE_CASES.index((measure, mode, strategy)), 4,
                       3, from_docs=mode == "and")
    want = ref.search(queries, k=8, mode=mode, strategy=strategy,
                      measure=measure)
    got = port.search(queries, k=8, mode=mode, strategy=strategy,
                      measure=measure)
    assert (got.strategy, got.measure, got.beam_width, got.sla) == \
        (want.strategy, want.measure, want.beam_width, want.sla)
    for n in ("n_found", "work", "pops", "certified", "score_bound"):
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(want, n)), err_msg=n)
    assert (got.padded is None) == (want.padded is None)
    assert_topk_close(got.docs.numpy(), got.scores.numpy(), want.docs,
                      want.scores, tolerance(measure, 4))


def test_engine_snippets_match_reference(engines):
    cp, ref, port, own = engines
    queries = _queries(cp, 91, 3, 2, from_docs=False)
    want_res = ref.search(queries, k=6, mode="or", strategy="drb")
    got_res = port.search(queries, k=6, mode="or", strategy="drb")
    np.testing.assert_array_equal(got_res.docs.numpy(),
                                  np.asarray(want_res.docs))
    for length in (1, 8, 200):
        want = ref.snippets(want_res, length=length)
        got = port.snippets(got_res, length=length)
        mine = own.snippets(got_res, length=length)
        assert len(got) == len(want) == len(mine)
        for g, w, m, (row) in zip(got, want, mine, range(len(got))):
            assert len(g) == len(w) == int(got_res.n_found[row])
            for a, b, c, (d, _) in zip(g, w, m, got_res.hits(row)):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(c, b)
                np.testing.assert_array_equal(
                    a, cp.doc_tokens[d][:length])
    empty = port.search([[int(np.flatnonzero(cp.doc_freqs() == 0)[0])]
                         if (cp.doc_freqs() == 0).any() else [1]], k=3,
                        mode="and", strategy="drb")
    assert len(port.snippets(empty)) == 1


@pytest.mark.parametrize("mode", ["and", "or"])
@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
def test_own_build_matches_oracle(engines, measure, mode):
    """The port's own index, host idf and avg_dl against the numpy
    brute-force oracle: the same eligible documents, scores to float32
    precision."""
    cp, _, _, own = engines
    queries = _queries(cp, 60, 3, 3, from_docs=mode == "and")
    res = own.search(queries, k=cp.n_docs, mode=mode, strategy="drb",
                     measure=measure)
    for b, q in enumerate(queries):
        want = search_oracle(cp.doc_tokens, q, mode=mode, measure=measure,
                             strategy="drb", vocab_size=cp.vocab_size)
        got = dict(res.hits(b))
        assert set(got) == set(want)
        for d, s in got.items():
            assert s == pytest.approx(want[d]["score"], rel=1e-5, abs=1e-5)


def test_drb_tfidf_equals_dr_bitwise(engines):
    """Both strategies score with ``dot_q``: DRB tf-idf returns DR's (and
    the mega core's) documents and scores bit for bit."""
    cp, _, _, own = engines
    for mode in ("and", "or"):
        queries = _queries(cp, 70, 4, 3, from_docs=mode == "and")
        a = own.search(queries, k=8, mode=mode, strategy="drb")
        b = own.search(queries, k=8, mode=mode, strategy="dr", mega=True)
        np.testing.assert_array_equal(a.docs.numpy(), b.docs.numpy())
        np.testing.assert_array_equal(a.scores.numpy(), b.scores.numpy())
        np.testing.assert_array_equal(a.n_found.numpy(), b.n_found.numpy())


def test_engine_drb_routing_and_df_cap(engines):
    cp, ref, port, own = engines
    queries = _queries(cp, 80, 2, 3, from_docs=False)
    cap = port.suggested_df_cap(queries)
    assert cap == ref.suggested_df_cap(queries)
    a = port.search(queries, k=5, mode="or", strategy="drb", df_cap=cap)
    b = port.search(queries, k=5, mode="or", strategy="drb")
    np.testing.assert_array_equal(a.docs.numpy(), b.docs.numpy())
    with pytest.raises(ValueError, match="df_cap"):
        port.search(queries, k=5, mode="or", strategy="drb", df_cap=1)
    with pytest.raises(ValueError, match="df_cap"):
        port.search(queries, k=5, mode="and", strategy="drb", df_cap=cap)
    # budgets: DRB/OR ignores them, DRB/AND honours them
    c = port.search(queries, k=5, mode="or", strategy="drb", budget=1)
    np.testing.assert_array_equal(c.docs.numpy(), b.docs.numpy())
    assert c.sla == "bounded"
    n = port.stats["executors"]
    port.search(queries, k=5, mode="or", strategy="drb", df_cap=cap,
                beam_width=7, mega=True)
    assert port.stats["executors"] == n            # normalized: same key
    no_drb = SearchEngine.build(cp, EngineConfig(block=BLOCK, with_drb=False),
                                device="cpu")
    with pytest.raises(ValueError, match="with_drb=False"):
        no_drb.search(queries, k=5, measure="bm25")
    with pytest.raises(ValueError, match="with_drb=False"):
        no_drb.aux
    assert not any(k.startswith("drb_") for k in no_drb.space_report())
    own.aux
    rep = own.space_report()
    assert rep["total"] == sum(v for k, v in rep.items() if k != "total")
    assert {"drb_bitmap_bits_bytes", "drb_bitmap_counters",
            "drb_bit_offsets"} <= set(rep)
    assert rep["drb_bitmap_bits_bytes"] == own.aux.bv.words.numel() * 4
