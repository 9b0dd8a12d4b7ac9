"""The port's positional search (``repro_torch/core/positional.py``, the
``wtbc_locate`` kernel module, the facade's ``phrase`` / ``near`` modes and
``word_positions``) against the JAX reference and ``tests/oracle.py``.

On the CPU:

* ``phrase_tables``, ``near_tables`` and ``doc_positions`` equal the
  reference's bitwise on every output, row by row, over a corpus coded with
  s = 2 stoppers (words of 1, 2 and 3 bytes, so every level's select runs)
  at blocks 64 and 4096, and equal the numpy oracle (``phrase_occurrences``,
  ``min_cover_window``); the hand-checked corpus of
  ``tests/test_positional.py`` gives its hand-written numbers;
* edge rows: a repeated query word, a masked slot, an absent word, a row
  with no valid word, a one-word phrase, a phrase across a document
  boundary, window 1, equal-width windows, k past the collection;
* ``topk_positional_batch`` (phrase and near, tf-idf and BM25, the
  reference's idf table carried across): docs, n_found, iters, match_pos
  and match_len bitwise where no two scores of a row lie within the
  tolerance, scores within Q/2 ulps (tf-idf) and Q/2 + 2 (BM25) — the DRB
  tolerance, since both score an (N, Q) table (ROADMAP Queue 3, R4/R5);
* results are bitwise equal across chunk sizes;
* the facade's ``search(mode="phrase"|"near")`` and ``word_positions``
  against ``repro.engine.SearchEngine`` and ``search_oracle``, and the
  facade's rules with the reference's error messages;
* ``wtbc.locate`` on CPU tensors is the plain walk with no launch, its
  saturation at j = 0 and occ + 1 equals the reference's, and the
  wrapper's argument checks raise.

The tests marked ``cuda`` hold ``wtbc_locate`` against its plain version on
the card (every occurrence of 1-, 2- and 3-byte words, block edges of each
level, j = 0 and occ + 1), count the engine's launches per positional
batch, and check DRB ``or`` past the old k cap (F1) and the mega core past
the old pool cap (F2) against their plain versions.  They skip without a
GPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import INT32_MAX, min_cover_window, phrase_occurrences, \
    search_oracle
from repro.core import positional as r_pos
from repro.core import scdc as r_scdc
from repro.core import scoring as r_scoring
from repro.core import wtbc as r_wtbc
from repro.engine import EngineConfig as REngineConfig
from repro.text import corpus as r_corpus
from repro_torch.core import positional, scoring, wtbc
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import backend, wtbc_locate
from test_torch_drb import assert_topk_close, tolerance
from test_torch_index import model_arrays, reference_arrays

torch.set_num_threads(1)

MEASURES = {"tfidf": (r_scoring.TfIdf(), scoring.TfIdf()),
            "bm25": (r_scoring.BM25(), scoring.BM25())}
Q = 4
_BUILDS = {}


def build(block: int, device: str = "cpu"):
    """(corpus, model, reference index or None, port index) over one small
    corpus coded with s = 2 stoppers (words of 1, 2 and 3 bytes).  The
    reference index is built on the CPU only.  Memoized."""
    key = (block, device)
    if key not in _BUILDS:
        cp = r_corpus.make_corpus(n_docs=240, mean_doc_len=40,
                                  vocab_size=1500, seed=17)
        flat = np.concatenate(cp.doc_tokens)
        model = r_scdc.fit(np.bincount(np.concatenate(
            [flat, np.zeros(cp.n_docs, np.int64)]), minlength=cp.vocab_size))
        codes, lens = r_scdc.encode_table(2, model.vocab_size)
        model = dataclasses.replace(model, s=2, c=254, codes=codes, lens=lens)
        ridx = r_wtbc.build_index_with_model(cp.doc_tokens, model,
                                             block=block) \
            if device == "cpu" else None
        pidx = wtbc.build_index_with_model(cp.doc_tokens, model, block=block,
                                           device=device)
        _BUILDS[key] = (cp, model, ridx, pidx)
    return _BUILDS[key]


def edge_batch(cp, model, seed: int = 0):
    """(B, Q) word ids and mask, row by row: a 3-word and a 2-word phrase
    of a document; a repeated word (a document's ``w w`` where the corpus
    has one); a masked middle slot between two consecutive words; a word
    that never occurs; no valid word; a one-word phrase; the last word of
    one document and the first of the next (no phrase crosses a document
    boundary); a 4-word phrase."""
    rng = np.random.default_rng(seed)
    docs = cp.doc_tokens
    occurs = np.bincount(np.concatenate(docs), minlength=cp.vocab_size)

    def run(n):
        while True:
            d = docs[rng.integers(0, len(docs))]
            if len(d) >= n:
                i = rng.integers(0, len(d) - n + 1)
                return [int(x) for x in d[i:i + n]]
    rep = next(([int(d[i]), int(d[i])] for d in docs
                for i in range(len(d) - 1) if d[i] == d[i + 1]), None)
    absent = int(np.flatnonzero(occurs[1:] == 0)[0] + 1)
    a, b = run(2)
    rows = [(run(3), None), (run(2), None),
            (rep or [a, a], None),
            ([a, 7, b], [True, False, True]),
            ([run(1)[0], absent], None),
            ([a, b], [False, False]),
            (run(1), None),
            ([int(docs[3][-1]), int(docs[4][0])], None),
            (run(4), None)]
    ids = np.ones((len(rows), Q), np.int64)
    mask = np.zeros((len(rows), Q), bool)
    for r, (w, m) in enumerate(rows):
        ids[r, :len(w)] = w
        mask[r, :len(w)] = True if m is None else m
    return ids, mask, model.rank_of_word[ids].astype(np.int32)


def ref_rows(fn, ridx, ranks, mask):
    """The reference's per-row function over a batch (vmapped, jitted)."""
    return jax.jit(jax.vmap(lambda w, m: fn(ridx, w, m)))(
        jnp.asarray(ranks), jnp.asarray(mask))


# ---------------------------------------------------------------------------
# tables against the reference and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [64, 4096])
def test_phrase_tables_match_reference_and_oracle(block):
    cp, model, ridx, pidx = build(block)
    ids, mask, ranks = edge_batch(cp, model)
    before = backend.launch_counts()
    tf, first, iters = positional.phrase_tables(
        pidx, torch.from_numpy(ranks), torch.from_numpy(mask))
    assert backend.launch_counts() == before       # CPU: plain versions only
    rtf, rfirst, riters = ref_rows(r_pos.phrase_tables, ridx, ranks, mask)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rtf))
    np.testing.assert_array_equal(first.numpy(), np.asarray(rfirst))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(riters))
    for r in range(len(ids)):
        phrase = ids[r][mask[r]]
        occ = [phrase_occurrences(d, phrase) if len(phrase) else []
               for d in cp.doc_tokens]
        np.testing.assert_array_equal(tf[r].numpy(), [len(o) for o in occ])
        np.testing.assert_array_equal(first[r].numpy(),
                                      [o[0] if o else -1 for o in occ])
    hits = (tf > 0).sum(1).tolist()
    assert all(hits[r] > 0 for r in (0, 1, 3, 6, 8))
    assert hits[4] == hits[5] == 0
    assert int(iters[5]) == 0 and int(iters[4]) == 0


@pytest.mark.parametrize("block", [64, 4096])
def test_near_tables_match_reference_and_oracle(block):
    cp, model, ridx, pidx = build(block)
    ids, mask, ranks = edge_batch(cp, model, seed=1)
    tf, win, pos, iters = positional.near_tables(
        pidx, torch.from_numpy(ranks), torch.from_numpy(mask))
    rtf, rwin, rpos, riters = ref_rows(r_pos.near_tables, ridx, ranks, mask)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(rtf))
    np.testing.assert_array_equal(win.numpy(), np.asarray(rwin))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(riters))
    occ = pidx.occ.numpy()
    for r in range(len(ids)):
        words = ids[r][mask[r]]
        want = [min_cover_window(d, words) if len(words) else (INT32_MAX, -1)
                for d in cp.doc_tokens]
        np.testing.assert_array_equal(win[r].numpy(), [w for w, _ in want])
        np.testing.assert_array_equal(pos[r].numpy(), [s for _, s in want])
        absent = any(occ[w] == 0 for w in ranks[r][mask[r]])
        assert int(iters[r]) == (0 if absent else int(
            occ[ranks[r][mask[r]]].sum()))
    assert int(iters[4]) == int(iters[5]) == 0
    assert int(tf[4].sum()) == 0                   # an absent word: no scan


def test_hand_checked_corpus():
    """``tests/test_positional.py``'s corpus and numbers."""
    docs = [np.array([1, 2, 3, 9, 1, 2, 3]), np.array([3, 2, 1, 9, 9, 9]),
            np.array([1, 9, 2, 9, 9, 3]), np.array([4, 4, 4, 4]),
            np.array([1, 2, 9, 1, 2, 3])]
    idx, model = wtbc.build_index(docs, 12, block=128, device="cpu")

    def w(ids):
        return torch.from_numpy(model.rank_of_word[np.asarray(ids)].astype(
            np.int32))[None]
    tf, first, iters = positional.phrase_tables(idx, w([1, 2, 3]),
                                                torch.ones(1, 3, dtype=bool))
    assert tf[0].tolist() == [2, 0, 0, 0, 1]
    assert first[0].tolist() == [0, -1, -1, -1, 3] and int(iters[0]) > 0
    tf, win, pos, _ = positional.near_tables(idx, w([1, 3]),
                                             torch.ones(1, 2, dtype=bool))
    # doc 0: (0, 2) and (4, 6) are both width 3; the leftmost wins
    assert win[0, :3].tolist() == [3, 3, 6] and pos[0, :3].tolist() == [0, 0, 0]
    assert int(win[0, 3]) == positional.INT32_MAX
    assert int(win[0, 4]) == 3 and int(pos[0, 4]) == 3
    assert tf[0, 0].tolist() == [2, 1, 1, 0, 2]
    assert tf[0, 1].tolist() == [2, 1, 1, 0, 1]
    tf, first, _ = positional.phrase_tables(idx, w([9]),
                                            torch.ones(1, 1, dtype=bool))
    assert tf[0].tolist() == [1, 3, 3, 0, 1]
    assert first[0].tolist() == [3, 3, 1, -1, 2]
    w9 = int(model.rank_of_word[9])
    pos = positional.doc_positions(idx, w9, torch.tensor([2, 3]), cap=4)
    assert pos.tolist() == [[1, 3, 4, -1], [-1, -1, -1, -1]]
    # one row: masked padding slots do not enter the phrase
    m = scoring.TfIdf()
    words = torch.cat([w([1, 2, 3])[0], torch.zeros(2, dtype=torch.int32)])
    mask = torch.tensor([True, True, True, False, False])
    res = positional.topk_positional(idx, words, mask, m.idf(idx), k=5,
                                     phrase=True, measure=m)
    n = int(res.n_found)
    assert res.docs.shape == (5,) and n == 2
    assert set(res.docs[:n].tolist()) == {0, 4}
    assert res.match_len[:n].tolist() == [3, 3]
    assert res.docs[0] == 0 and res.match_pos[:n].tolist() == [0, 3]


@pytest.mark.parametrize("block", [64, 4096])
def test_doc_positions_match_reference(block):
    cp, model, ridx, pidx = build(block)
    rng = np.random.default_rng(block)
    occ = pidx.occ.numpy()
    ws = np.concatenate([rng.choice(np.flatnonzero(occ > 0), 24),
                         np.flatnonzero(occ == 0)[:2]]).astype(np.int32)
    ds = rng.integers(0, pidx.n_docs, len(ws)).astype(np.int32)
    # words of the document itself, so most pairs have positions
    for i in range(0, len(ws), 2):
        ws[i] = model.rank_of_word[rng.choice(cp.doc_tokens[ds[i]])]
    for cap in (1, 3, 12):
        got = positional.doc_positions(pidx, torch.from_numpy(ws),
                                       torch.from_numpy(ds), cap=cap)
        want = jax.jit(jax.vmap(lambda w, d: r_pos.doc_positions(
            ridx, w, d, cap)))(jnp.asarray(ws), jnp.asarray(ds))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = got.numpy()
    for w, d, p in zip(ws, ds, got):
        toks = model.rank_of_word[cp.doc_tokens[d]]
        np.testing.assert_array_equal(p[p >= 0],
                                      np.flatnonzero(toks == w)[:12])
    assert (got >= 0).any(1).sum() >= len(ws) // 2


@pytest.mark.parametrize("phrase", [True, False])
def test_results_do_not_depend_on_the_chunk(phrase):
    cp, model, _, pidx = build(64)
    _, mask, ranks = edge_batch(cp, model, seed=2)
    w, m = torch.from_numpy(ranks), torch.from_numpy(mask)
    fn = positional.phrase_tables if phrase else positional.near_tables
    outs = [fn(pidx, w, m, chunk=c) for c in (1 << 20, 61, 389)]
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert torch.equal(a, b)
    res = [positional.topk_positional_batch(
        pidx, w, m, scoring.BM25().idf(pidx), k=5, phrase=phrase,
        measure=scoring.BM25(), window=6, chunk=c) for c in (97, 1 << 20)]
    for a, b in zip(*res):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# ranked top-k against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
@pytest.mark.parametrize("phrase,window", [(True, None), (False, 1),
                                           (False, 8)])
def test_topk_positional_batch_matches_reference(measure, phrase, window):
    cp, model, ridx, pidx = build(4096)
    _, mask, ranks = edge_batch(cp, model, seed=3)
    rm, pm = MEASURES[measure]
    ridf = np.array(rm.idf(ridx))
    ravg = jnp.sum(ridx.doc_len.astype(jnp.float32)) \
        / ridx.n_docs.astype(jnp.float32)
    k = 12
    want = r_pos.topk_positional_batch(
        ridx, jnp.asarray(ranks), jnp.asarray(mask), jnp.asarray(ridf), k=k,
        phrase=phrase, measure=rm, window=window, avg_dl=ravg)
    got = positional.topk_positional_batch(
        pidx, torch.from_numpy(ranks), torch.from_numpy(mask),
        torch.from_numpy(ridf), k=k, phrase=phrase, measure=pm,
        window=window, avg_dl=torch.tensor(np.float32(ravg)))
    for name in ("n_found", "iters"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    tol = tolerance(measure, Q)
    assert_topk_close(got.docs.numpy(), got.scores.numpy(), want.docs,
                      want.scores, tol)
    for b in range(len(ranks)):
        if np.array_equal(got.docs[b].numpy(), np.asarray(want.docs[b])):
            for name in ("match_pos", "match_len"):
                np.testing.assert_array_equal(
                    getattr(got, name)[b].numpy(),
                    np.asarray(getattr(want, name)[b]), name)
    assert int(got.n_found.sum()) > 0
    if measure == "tfidf" and window != 1:
        # a single valid word (the one-word phrase) is scored bitwise
        np.testing.assert_array_equal(got.scores[6].numpy(),
                                      np.asarray(want.scores[6]))


def test_k_past_the_collection_is_padded():
    cp, model, _, pidx = build(64)
    _, mask, ranks = edge_batch(cp, model, seed=4)
    pm = scoring.TfIdf()
    k = pidx.n_docs + 7
    res = positional.topk_positional_batch(
        pidx, torch.from_numpy(ranks), torch.from_numpy(mask), pm.idf(pidx),
        k=k, phrase=False, measure=pm, window=10**6)
    assert res.docs.shape == (len(ranks), k)
    n = res.n_found
    assert int(n.max()) > 0
    for b in range(len(ranks)):
        assert (res.docs[b, int(n[b]):] == -1).all()
        assert (res.match_pos[b, int(n[b]):] == -1).all()
        assert torch.isinf(res.scores[b, int(n[b]):]).all()
    with pytest.raises(ValueError, match="requires a window"):
        positional.topk_positional_batch(
            pidx, torch.from_numpy(ranks), torch.from_numpy(mask),
            pm.idf(pidx), k=3, phrase=False, measure=pm)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(engine):
    """The reference engine, and the port over its arrays and idf tables."""
    idf = {m: np.array(r.idf(engine.idx)) for m, (r, _) in MEASURES.items()}
    port = SearchEngine.from_arrays(reference_arrays(engine.idx),
                                    model_arrays(engine.model), idf=idf,
                                    config=EngineConfig(block=512),
                                    device="cpu")
    return engine, port


def doc_phrases(cp, seed, B, lens=(2, 3, 2, 1)):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        n = lens[b % len(lens)]
        d = cp.doc_tokens[rng.integers(0, cp.n_docs)]
        i = rng.integers(0, len(d) - n + 1)
        out.append([int(x) for x in d[i:i + n]])
    return out


@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
@pytest.mark.parametrize("mode,window", [("phrase", None), ("near", None),
                                         ("near", 3)])
def test_search_matches_reference_and_oracle(engines, engine_corpus, measure,
                                             mode, window):
    ref, port = engines
    q = doc_phrases(engine_corpus, 5, 4)
    kw = dict(k=8, mode=mode, measure=measure, window=window)
    want = ref.search(q, **kw)
    got = port.search(q, **kw)
    assert got.mode == mode and got.strategy == "dr" and got.beam_width == 1
    assert got.pops is None and got.certified is None
    for name in ("n_found", "work"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert_topk_close(got.docs.numpy(), got.scores.numpy(), want.docs,
                      want.scores, tolerance(measure, Q))
    assert int(got.n_found.min()) > 0
    for b in range(len(q)):
        oracle = search_oracle(engine_corpus.doc_tokens, q[b], mode=mode,
                               measure=measure,
                               window=window or port.config.default_window,
                               vocab_size=engine_corpus.vocab_size)
        hits = got.matches(b)
        if len(oracle) <= got.k:
            assert {d for d, *_ in hits} == set(oracle)
        for d, s, p, ln in hits:
            assert (p, ln) == (oracle[d]["pos"], oracle[d]["len"])
            assert s == pytest.approx(oracle[d]["score"], rel=1e-5, abs=1e-6)
        if np.array_equal(got.docs[b].numpy(), np.asarray(want.docs[b])):
            assert [h[2:] for h in hits] == [h[2:] for h in want.matches(b)]


def test_search_rules_follow_the_reference(engines, query_batch):
    ref, port = engines
    q = query_batch
    cases = [dict(mode="phrase", window=3), dict(mode="near", window=0),
             dict(mode="and", window=3), dict(mode="near", deadline_ms=5.0),
             dict(mode="phrase", strategy="drb"),
             dict(mode="near", budget=4), dict(mode="phrase", beam_width=2),
             dict(mode="near", df_cap=8)]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            ref.search(q, k=5, **kw)
        with pytest.raises(ValueError) as got:
            port.search(q, k=5, **kw)
        assert str(got.value) == str(want.value), kw
    # k past the collection is capped at n_docs, as in the reference
    res = port.search(q, k=port.n_docs + 9, mode="near", window=50)
    assert res.k == port.n_docs and res.docs.shape == (len(q), port.n_docs)
    # the mega flag is normalized off; and/or results have no matches
    res = port.search(q, k=5, mode="phrase", mega=True, measure="bm25")
    assert res.measure == "bm25" and res.match_len.shape == res.docs.shape
    with pytest.raises(ValueError, match="no match"):
        port.search(q, k=5, mode="or").matches(0)
    with pytest.raises(ValueError, match="default_window"):
        EngineConfig(default_window=0)
    assert EngineConfig().default_window == REngineConfig().default_window


def test_windows_share_one_executor(engine_corpus):
    eng = SearchEngine.build(engine_corpus, EngineConfig(block=512),
                             device="cpu")
    q = doc_phrases(engine_corpus, 6, 3, lens=(2,))
    eng.search(q, k=4, mode="near", window=2)
    before = dict(eng.stats["traces"])
    for w in (1, 5, 40, None):
        eng.search(q, k=4, mode="near", window=w)
    assert eng.stats["traces"] == before
    wide = eng.search(q, k=4, mode="near", window=10**6)
    narrow = eng.search(q, k=4, mode="near", window=1)
    assert (wide.n_found >= narrow.n_found).all()
    if all(len(set(r)) == len(r) for r in q):       # distinct words: none fit
        assert int(narrow.n_found.sum()) == 0


def test_word_positions_match_reference(engines, engine_corpus):
    ref, port = engines
    rng = np.random.default_rng(7)
    docs = rng.integers(0, port.n_docs, 6).tolist() + [port.n_docs - 1]
    for d in docs:
        toks = engine_corpus.doc_tokens[d]
        ids = [int(x) for x in rng.choice(toks, 3)] + [1, 399]
        for cap in (2, 32):
            got = port.word_positions(d, ids, cap=cap)
            for w in ids:
                np.testing.assert_array_equal(
                    got[w], np.flatnonzero(toks == w)[:cap])
            if d == docs[-1] or (d == docs[0] and cap == 2):
                want = ref.word_positions(d, ids[:1] + [399], cap=cap)
                for w in want:
                    np.testing.assert_array_equal(got[w], want[w])
    assert port.word_positions(0, []) == {}
    for args in ((port.n_docs, [1]), (-1, [1]), (0, [0]), (0, [400])):
        with pytest.raises(ValueError) as want:
            ref.word_positions(*args)
        with pytest.raises(ValueError) as got:
            port.word_positions(*args)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the locate's kernel module on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [64, 4096])
def test_locate_ref_matches_reference_with_saturation(block):
    cp, model, ridx, pidx = build(block)
    occ = pidx.occ.numpy()
    lens = pidx.cw_len.numpy()
    w = np.concatenate([np.flatnonzero((occ > 0) & (lens == L))[:20]
                        for L in (1, 2, 3)]).astype(np.int32)
    assert set(lens[w]) == {1, 2, 3}
    j = np.concatenate([np.zeros_like(w), occ[w] + 1, occ[w], np.ones_like(w),
                        occ[w] + 5]).astype(np.int32)
    w = np.tile(w, 5)
    want = np.asarray(jax.vmap(lambda a, b: r_wtbc.locate(ridx, a, b))(w, j))
    before = backend.launch_counts()
    got = wtbc.locate(pidx, torch.from_numpy(w), torch.from_numpy(j))
    assert backend.launch_counts() == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        wtbc_locate.wtbc_locate_ref(pidx, torch.from_numpy(w),
                                    torch.from_numpy(j)).numpy(), want)
    # shapes: any, with j broadcast
    two = wtbc.locate(pidx, torch.from_numpy(w[:6].reshape(2, 3)),
                      torch.tensor(1, dtype=torch.int32))
    assert two.shape == (2, 3)
    np.testing.assert_array_equal(two.reshape(-1).numpy(), want[len(w) // 5
                                  * 3:len(w) // 5 * 3 + 6])


def test_wtbc_locate_argument_checks_raise():
    _, _, _, pidx = build(64)
    w = torch.arange(1, 11, dtype=torch.int32)
    args = wtbc_locate.launch_args(pidx, w, torch.ones_like(w))
    assert len(args) == 13 + 4
    bad_block = dataclasses.replace(pidx, levels=tuple(
        dataclasses.replace(lv, block=40) for lv in pidx.levels))
    bad_cw = dataclasses.replace(pidx, cw_len=pidx.cw_len.long())
    for idx, a, b, match in (
            (pidx, w.long(), torch.ones_like(w), "contiguous int32"),
            (pidx, w, torch.ones(3, dtype=torch.int32), "of one shape"),
            (pidx, w.reshape(2, 5).t(), torch.ones(5, 2, dtype=torch.int32),
             "contiguous"),
            (bad_block, w, torch.ones_like(w), "not a multiple of 16"),
            (bad_cw, w, torch.ones_like(w), "cw_len")):
        with pytest.raises(ValueError, match=match):
            wtbc_locate.launch_args(idx, a, b)
    with pytest.raises(ValueError, match="kernel_backend"):
        wtbc.locate(pidx, w, w, kernel_backend="fast")


# ---------------------------------------------------------------------------
# on the card (skip elsewhere)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")


def delta(before, after):
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}


def level_edge_lanes(idx):
    """(word, j) lanes whose select at some level lands on a block edge or
    one either side of it: per level and byte of that level, the
    occurrences around each block edge, mapped to the words that select
    there (the words whose leaf is that level, through their base rank)."""
    out_w, out_j = [], []
    cw = idx.cw.cpu().numpy()
    lens = idx.cw_len.cpu().numpy()
    base = idx.base_rank.cpu().numpy()
    occ = idx.occ.cpu().numpy()
    for L, lv in enumerate(idx.levels):
        data = lv.data.cpu().numpy()[:lv.length]
        edges = np.arange(0, lv.length + 1, lv.block)
        near = np.unique(np.clip(np.concatenate([edges - 1, edges, edges + 1]),
                                 0, max(lv.length - 1, 0)))
        for p in near[:4096]:
            byte = data[p] if lv.length else 0
            r = int(np.count_nonzero(data[:p] == byte)) + 1   # its occurrence
            ws = np.flatnonzero((lens == L + 1) & (cw[:, L] == byte)
                                & (base[:, L] < r) & (base[:, L] + occ >= r))
            for w in ws[:1]:
                out_w.append(w)
                out_j.append(r - base[w, L])
    return (np.asarray(out_w, np.int32), np.asarray(out_j, np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 4096])
def test_wtbc_locate_kernel_matches_plain_on_card(block):
    _need_card()
    _, _, _, idx = build(block, "cuda")
    occ = idx.occ.cpu().numpy()
    lens = idx.cw_len.cpu().numpy()
    assert set(lens[occ > 0]) == {1, 2, 3}
    every_w = np.repeat(np.arange(len(occ), dtype=np.int32), occ)
    every_j = (np.arange(len(every_w)) - np.repeat(np.cumsum(occ) - occ, occ)
               + 1).astype(np.int32)
    ew, ej = level_edge_lanes(idx)
    some = np.flatnonzero(occ > 0)[:300].astype(np.int32)
    sets = [("every occurrence", every_w, every_j), ("block edges", ew, ej),
            ("j = 0 and occ + 1", np.tile(some, 2), np.concatenate(
                [np.zeros_like(some), occ[some] + 1]).astype(np.int32))]
    for name, w, j in sets:
        wt = torch.from_numpy(w).cuda()
        jt = torch.from_numpy(j).cuda()
        before = backend.launch_counts()
        got = wtbc.locate(idx, wt, jt)
        assert delta(before, backend.launch_counts()) == {"wtbc_locate": 1}
        want = wtbc.locate(idx, wt, jt, kernel_backend="ref")
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
    assert len(ew) > 0


@pytest.mark.cuda
def test_positional_on_card_equals_cpu_with_its_launches():
    _need_card()
    cp, model, _, cpu_idx = build(64)
    _, _, _, idx = build(64, "cuda")
    _, mask, ranks = edge_batch(cp, model, seed=8)
    wc, mc = torch.from_numpy(ranks), torch.from_numpy(mask)
    wg, mg = wc.cuda(), mc.cuda()
    for fn, per_pass in ((positional.phrase_tables,
                          {"wtbc_locate": 1, "wtbc_decode": 1}),
                         (positional.near_tables, {"wtbc_locate": 1})):
        want = fn(cpu_idx, wc, mc, chunk=50)
        before = backend.launch_counts()
        got = fn(idx, wg, mg, chunk=50)
        torch.cuda.synchronize()
        total = int(got[-1].sum())
        passes = -(-total // 50)
        assert delta(before, backend.launch_counts()) == {
            n: c * passes for n, c in per_pass.items()}
        ref = fn(idx, wg, mg, chunk=50, kernel_backend="ref")
        for a, b, c in zip(got, want, ref):
            assert torch.equal(a.cpu(), b) and torch.equal(a, c)
    eng = SearchEngine.build(cp, EngineConfig(block=64), device="cuda")
    q = [[int(x) for x in cp.doc_tokens[5][:2]]]
    before = backend.launch_counts()
    eng.word_positions(5, q[0] + [q[0][0]])
    assert delta(before, backend.launch_counts()) == {"wavelet_count": 1,
                                                      "wtbc_locate": 1}
    before = backend.launch_counts()
    res = eng.search(q, k=4, mode="phrase")
    assert delta(before, backend.launch_counts()) == {"wtbc_locate": 1,
                                                      "wtbc_decode": 1}
    assert int(res.n_found[0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32_769, 40_000])
def test_drb_or_past_the_old_k_cap_on_card(k):
    """F1: DRB ``or`` takes any k on the card (``min(k, n_docs)`` past
    32,768 here), every leaf bitwise equal to its plain version."""
    _need_card()
    from repro_torch.core import drb
    cp = r_corpus.make_corpus(n_docs=41_000, mean_doc_len=8, vocab_size=600,
                              seed=23)
    eng = SearchEngine.build(cp, EngineConfig(block=4096), device="cuda")
    df = cp.doc_freqs()
    top = np.argsort(-df, kind="stable")
    top = top[(top > 0) & (df[top] < cp.n_docs)]      # words with a bitmap
    words = np.stack([top[[0, 1, 2, 5]], top[[0, 7, 30, 0]]])
    ranks, mask = eng._encode_queries(words)
    wt, mt = torch.from_numpy(ranks).cuda(), torch.from_numpy(mask).cuda()
    for mname in ("tfidf", "bm25"):
        m = MEASURES[mname][1]
        kw = dict(k=k, max_df_cap=eng._df_cap(ranks, mask),
                  idf=eng._idf_table(m), avg_dl=eng._avg_doc_len())
        got = drb.topk_drb_or(eng.idx, eng.aux, wt, mt, m, **kw)
        want = drb.topk_drb_or(eng.idx, eng.aux, wt, mt, m,
                               kernel_backend="ref", **kw)
        torch.cuda.synchronize()
        for name in ("docs", "scores", "n_found", "iters", "pops",
                     "overflowed", "certified", "bound"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert int(got.n_found.max()) > 32_768


@pytest.mark.cuda
@pytest.mark.parametrize("conjunctive", [False, True])
def test_mega_core_past_the_old_pool_cap_on_card(conjunctive):
    """F2: the mega core's pool of 1.2 M slots (past one block's shared
    memory), every leaf bitwise equal to the plain loop."""
    _need_card()
    from repro_torch.core import mega
    cp = r_corpus.make_corpus(n_docs=300, mean_doc_len=30, vocab_size=400,
                              seed=29)
    eng = SearchEngine.build(cp, EngineConfig(block=512), device="cuda")
    df = cp.doc_freqs()
    pool = np.flatnonzero((df >= 3) & (df <= 60))
    rng = np.random.default_rng(1)
    q = np.stack([rng.choice(pool, 3, replace=False) for _ in range(4)])
    ranks, mask = eng._encode_queries(q)
    wt, mt = torch.from_numpy(ranks).cuda(), torch.from_numpy(mask).cuda()
    idf = eng._idf_table(MEASURES["tfidf"][1])
    for cap in (1_200_000, eng.idx.n_docs + 2):
        kw = dict(k=10, conjunctive=conjunctive, cap=cap)
        got = mega.topk_dr_mega(eng.idx, wt, mt, idf, **kw)
        want = mega.topk_dr_mega(eng.idx, wt, mt, idf, kernel_backend="ref",
                                 **kw)
        torch.cuda.synchronize()
        for name in ("docs", "scores", "n_found", "iters", "pops",
                     "overflowed", "certified", "bound"):
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                (cap, name)
    assert int(got.n_found.sum()) > 0 or conjunctive
