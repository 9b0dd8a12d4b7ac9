"""The port's document-sharded search (``repro_torch.core.distributed``,
``SearchEngine.shard``) against ``repro.core.distributed`` (CPU; the test
marked ``cuda`` runs on the card and skips elsewhere).

* Build: ``build_sharded(...).stack()`` equals the reference's stacked
  ``ShardedWTBC`` leaf for leaf (dtype, shape, bits) at 1, 2, 4 and 8
  shards, ``unstack`` round-trips.
* Search: ``distributed_topk`` on the reference's index (carried across
  with ``convert.sharded_from_reference``) and its idf tables against the
  reference's ``distributed_topk`` under the ROADMAP parity contract — at
  1 shard in this process (a 1-device mesh), at 4 shards against a
  subprocess with 4 simulated XLA devices (one per file: the device count
  locks when JAX starts).  Every method, tf-idf and BM25, a binding and a
  never-binding budget, beam widths 1 and 16.
* The port against itself: a sharded engine equals the single-index engine
  on exact searches; results are bitwise equal across batch shapes and
  shard counts; the merge's edges (ties across shards, a shard without
  hits, k past a shard's documents, one shard); the strict certification
  rule under a budget; snippets and word positions on every shard;
  phrase/near raise; ``padded`` reaches an enabled registry.
"""
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as r_dist
from repro.core import scoring as r_scoring
from repro.engine import EngineConfig as REngineConfig
from repro.engine import SearchEngine as RSearchEngine
from repro_torch import convert, obs
from repro_torch.core import distributed, ranked, scoring
from repro_torch.core.ranked import DRResult
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import backend
from repro_torch.serve import loadgen
from repro_torch.text import corpus
from test_torch_drb import assert_topk_close, tolerance, ulps
from test_torch_index import reference_arrays

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = dict(n_docs=160, mean_doc_len=50, vocab_size=500, seed=7)
BLOCK = 512
B, Q, K = 4, 4, 8
MEASURES = {"tfidf": (r_scoring.TfIdf(), scoring.TfIdf()),
            "bm25": (r_scoring.BM25(), scoring.BM25())}
# (method, measure, beam width, budget): every method, both measures on
# DRB, binding and never-binding budgets, beam widths 1 and 16
CASES = [("dr-and", "tfidf", 1, None), ("dr-or", "tfidf", 1, None),
         ("dr-or", "tfidf", 1, 8), ("dr-or", "tfidf", 1, 10 ** 6),
         ("dr-or", "tfidf", 16, None), ("drb-and", "tfidf", 1, None),
         ("drb-and", "bm25", 16, None), ("drb-and", "tfidf", 1, 2),
         ("drb-or", "tfidf", 1, None), ("drb-or", "bm25", 1, None)]
DF_CAP = 64
LEAVES = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
          "padded", "certified", "bound")


def case_id(case) -> str:
    method, measure, P, budget = case
    return f"{method}-{measure}-P{P}-budget{budget}"


@pytest.fixture(scope="module")
def cp():
    return corpus.make_corpus(**SPEC)


def query_arrays(cp, model, seed: int) -> dict:
    """(B, Q) word ranks for ``and`` (each row four words of one document,
    so conjunctions have hits) and ``or`` (four words of the df band
    [2, 40])."""
    rng = np.random.default_rng(seed)
    df = cp.doc_freqs()
    rows_and = []
    while len(rows_and) < B:
        doc = np.unique(cp.doc_tokens[rng.integers(0, cp.n_docs)])
        doc = doc[df[doc] <= cp.n_docs // 3]
        if len(doc) >= Q:
            rows_and.append(rng.choice(doc, Q, replace=False))
    pool = np.flatnonzero((df >= 2) & (df <= 40))
    rows_or = [rng.choice(pool, Q, replace=False) for _ in range(B)]
    rank = np.asarray(model.rank_of_word)
    return {"and": rank[np.stack(rows_and)].astype(np.int32),
            "or": rank[np.stack(rows_or)].astype(np.int32)}


def reference_idf(rsh, n_docs: int) -> dict:
    """The reference engine's global idf tables (``facade._idf_table``)."""
    stats = types.SimpleNamespace(df=rsh.global_df, n_docs=jnp.int32(n_docs))
    return {m: np.asarray(rm.idf(stats)) for m, (rm, _) in MEASURES.items()}


def reference_sharded_arrays(rsh) -> dict:
    """A reference ``ShardedWTBC`` as numpy under its field names."""
    aux = rsh.aux
    return {"idx": reference_arrays(rsh.idx),
            "aux": {"words": np.asarray(aux.bv.words),
                    "counts": np.asarray(aux.bv.counts),
                    "n_bits": np.asarray(aux.bv.n_bits),
                    "bit_off": np.asarray(aux.bit_off),
                    "has_bm": np.asarray(aux.has_bm), "eps": aux.eps},
            **{f: np.asarray(getattr(rsh, f)) for f in (
                "doc_base", "global_df", "global_idf", "global_avg_dl")},
            "n_shards": rsh.n_shards}


def port_topk(psh, words, case, idf):
    method, measure, P, budget = case
    mode = method.split("-")[1]
    w = torch.from_numpy(np.array(words[mode]))
    return distributed.distributed_topk(
        psh, w, torch.ones(w.shape, dtype=torch.bool), k=K, method=method,
        max_df_cap=DF_CAP, max_pops=budget, measure=MEASURES[measure][1],
        idf=torch.from_numpy(np.array(idf[measure])), beam_width=P)


def near_tie(scores, tol: int) -> bool:
    s = np.sort(np.asarray(scores, np.float32)[np.isfinite(scores)])
    gaps = np.diff(s.view(np.int32).astype(np.int64))
    return bool(np.any((gaps > 0) & (gaps <= 2 * tol)))


def assert_parity(got: DRResult, want: dict, case):
    """The ROADMAP parity contract: DR at P = 1 bitwise (B >= 2, Q = 4);
    DR at P > 1 within 1 ulp, docs and loop counters where no scores of a
    row lie within 1 ulp; DRB scores within Q/2 (tf-idf) or Q/2 + 2 (BM25)
    ulps with every integer leaf and the bound bitwise."""
    method, measure, P, _ = case
    assert (got.padded is None) == ("padded" not in want)
    for name in ("n_found", "overflowed", "certified"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name],
                                      err_msg=name)
    counters = [n for n in ("iters", "pops", "padded") if n in want]
    if method.startswith("dr-") and P == 1:
        for name in ("docs", "scores", "bound", *counters):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          want[name], err_msg=name)
        return
    tol = 1 if method.startswith("dr-") else tolerance(measure, Q)
    assert_topk_close(got.docs.numpy(), got.scores.numpy(), want["docs"],
                      want["scores"], tol)
    if method.startswith("drb"):
        np.testing.assert_array_equal(got.bound.numpy(), want["bound"])
        for name in counters:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          want[name], err_msg=name)
        return
    assert ulps(got.bound.numpy(), want["bound"]) <= 1
    for b in range(B):
        if not near_tie(want["scores"][b], 1):
            for name in counters:
                assert int(getattr(got, name)[b]) == int(want[name][b]), name


# ---------------------------------------------------------------------------
# the reference at 4 shards: one subprocess for the whole file, started with
# the first test so it runs beside the in-process ones
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from repro.core import distributed, scoring
    from repro.text import corpus

    inputs, out = sys.argv[1], sys.argv[2]
    spec = {spec!r}
    cases = {cases!r}
    cp = corpus.make_corpus(**spec)
    sh, _ = distributed.build_sharded(cp.doc_tokens, cp.vocab_size,
                                      n_shards=4, block={block})
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("shards",))
    x = np.load(inputs)
    measures = {{"tfidf": scoring.TfIdf(), "bm25": scoring.BM25()}}
    res = {{}}
    for i, (method, measure, P, budget) in enumerate(cases):
        mode = method.split("-")[1]
        w = jnp.asarray(x["words_" + mode])
        r = distributed.distributed_topk(
            sh, w, jnp.ones(w.shape, bool), k={k}, method=method, mesh=mesh,
            shard_axes="shards", max_df_cap={df_cap}, max_pops=budget,
            measure=measures[measure], idf=jnp.asarray(x["idf_" + measure]),
            beam_width=P)
        for name in {leaves!r}:
            v = getattr(r, name)
            if v is not None:
                res[f"{{i}}/{{name}}"] = np.asarray(v)
    np.savez(out, **res)
    print("OK")
""")


@pytest.fixture(scope="module")
def four_shards(cp, tmp_path_factory):
    """(port ShardedWTBC carried from the reference's 4-shard build, the
    reference's idf tables, the queries, the running reference process and
    its output path)."""
    rsh, model = r_dist.build_sharded(cp.doc_tokens, cp.vocab_size,
                                      n_shards=4, block=BLOCK)
    idf = reference_idf(rsh, cp.n_docs)
    words = query_arrays(cp, model, seed=44)
    d = tmp_path_factory.mktemp("four_shards")
    np.savez(d / "inputs.npz", words_and=words["and"], words_or=words["or"],
             idf_tfidf=idf["tfidf"], idf_bm25=idf["bm25"])
    script = REFERENCE_SCRIPT.format(spec=SPEC, cases=CASES, block=BLOCK,
                                     k=K, df_cap=DF_CAP, leaves=LEAVES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(d / "inputs.npz"),
         str(d / "ref.npz")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    psh = convert.sharded_from_reference(reference_sharded_arrays(rsh),
                                         device="cpu")
    yield psh, idf, words, proc, d / "ref.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def four_shard_reference(four_shards):
    _, _, _, proc, path = four_shards
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    return np.load(path)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _assert_leaf(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_stacked_equal(st: dict, rsh):
    ri = rsh.idx
    for L, lv in enumerate(ri.levels):
        for f in ("data", "counts", "length"):
            _assert_leaf(f"levels[{L}].{f}", st["idx"]["levels"][L][f],
                         getattr(lv, f))
        assert st["idx"]["levels"][L]["block"] == lv.block
        _assert_leaf(f"offsets[{L}]", st["idx"]["offsets"][L], ri.offsets[L])
    for f in ("cw", "cw_len", "node_off", "base_rank", "sep_pos", "df", "occ",
              "doc_len", "n", "n_docs"):
        _assert_leaf(f, st["idx"][f], getattr(ri, f))
    assert (st["idx"]["s"], st["idx"]["c"]) == (ri.s, ri.c)
    a, ra = st["aux"], rsh.aux
    _assert_leaf("bv.words", a["words"], ra.bv.words)
    _assert_leaf("bv.counts", a["counts"], ra.bv.counts)
    _assert_leaf("bv.n_bits", a["n_bits"], ra.bv.n_bits)
    _assert_leaf("bit_off", a["bit_off"], ra.bit_off)
    _assert_leaf("has_bm", a["has_bm"], ra.has_bm)
    assert a["eps"] == ra.eps
    for f in ("doc_base", "global_df", "global_idf"):
        _assert_leaf(f, st[f], getattr(rsh, f))
    assert st["n_shards"] == rsh.n_shards


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_build_sharded_matches_reference(cp, n_shards):
    rsh, rmodel = r_dist.build_sharded(cp.doc_tokens, cp.vocab_size,
                                       n_shards=n_shards, block=BLOCK)
    psh, pmodel = distributed.build_sharded(cp.doc_tokens, cp.vocab_size,
                                            n_shards=n_shards, block=BLOCK,
                                            device="cpu")
    st = psh.stack()
    _assert_stacked_equal(st, rsh)
    # the mean document length: the port's int64 sum (R7) equals the
    # reference's float64 quotient bit for bit below 2**24 tokens
    _assert_leaf("global_avg_dl", st["global_avg_dl"], rsh.global_avg_dl)
    for f in ("codes", "lens", "rank_of_word", "word_of_rank", "freqs"):
        _assert_leaf(f"model.{f}", getattr(pmodel, f), getattr(rmodel, f))
    # each shard is trimmed to its own build, and unstack(stack(x)) == x
    for s, idx in enumerate(psh.idx):
        assert idx.n_docs == int(np.asarray(rsh.idx.n_docs)[s])
        assert idx.sep_pos.shape == (idx.n_docs,)
    again = distributed.ShardedWTBC.unstack(st, device="cpu")
    st2 = again.stack()
    _assert_stacked_equal(st2, rsh)
    for a, b in zip(psh.idx, again.idx):
        for L in range(3):
            assert torch.equal(a.levels[L].data, b.levels[L].data)
            assert torch.equal(a.levels[L].counts, b.levels[L].counts)
        assert torch.equal(a.doc_len, b.doc_len)
    for a, b in zip(psh.aux, again.aux):
        assert torch.equal(a.bv.words, b.bv.words) and \
            torch.equal(a.bv.counts, b.bv.counts)


def test_build_sharded_rejects_empty_shards_and_bad_devices():
    docs = [np.array([1, 2, 3]), np.array([2, 4])]
    with pytest.raises(ValueError, match="zero documents"):
        distributed.build_sharded(docs, 8, n_shards=3, device="cpu")
    with pytest.raises(ValueError, match="2 devices for 3 shards"):
        distributed.resolve_devices(3, devices=["cpu", "cpu"])
    assert distributed.resolve_devices(3, device="cpu") == \
        [torch.device("cpu")] * 3
    # stacked arrays whose doc_base disagrees with the shards' lengths
    psh, _ = distributed.build_sharded(docs, 8, n_shards=2, device="cpu")
    st = psh.stack()
    st["doc_base"] = np.array([0, 2], np.int32)
    with pytest.raises(ValueError, match="doc_base"):
        distributed.ShardedWTBC.unstack(st, device="cpu")


# ---------------------------------------------------------------------------
# search parity against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_shard(cp, four_shards):
    """The reference's 1-shard index and a 1-device mesh, the port's copy
    of the index, the reference's idf tables and the queries."""
    rsh, model = r_dist.build_sharded(cp.doc_tokens, cp.vocab_size,
                                      n_shards=1, block=BLOCK)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("shards",))
    psh = convert.sharded_from_reference(reference_sharded_arrays(rsh),
                                         device="cpu")
    return rsh, mesh, psh, reference_idf(rsh, cp.n_docs), \
        query_arrays(cp, model, seed=11)


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_one_shard_matches_reference(one_shard, case):
    rsh, mesh, psh, idf, words = one_shard
    method, measure, P, budget = case
    mode = method.split("-")[1]
    w = jnp.asarray(words[mode])
    want = r_dist.distributed_topk(
        rsh, w, jnp.ones(w.shape, bool), k=K, method=method, mesh=mesh,
        shard_axes="shards", max_df_cap=DF_CAP, max_pops=budget,
        measure=MEASURES[measure][0], idf=jnp.asarray(idf[measure]),
        beam_width=P)
    before = backend.launch_counts()
    got = port_topk(psh, words, case, idf)
    assert backend.launch_counts() == before       # CPU: plain versions only
    assert_parity(got, {n: np.asarray(getattr(want, n)) for n in LEAVES
                        if getattr(want, n) is not None}, case)
    if budget == 8:                    # the binding budget really binds
        assert not got.certified.all()


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_four_shards_match_reference(four_shards, four_shard_reference,
                                     case):
    psh, idf, words, _, _ = four_shards
    ref = four_shard_reference
    i = CASES.index(case)
    want = {n: ref[f"{i}/{n}"] for n in LEAVES if f"{i}/{n}" in ref.files}
    assert_parity(port_topk(psh, words, case, idf), want, case)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(cp):
    cfg = EngineConfig(block=BLOCK)
    return {n: (SearchEngine.build(cp, cfg, device="cpu") if n == 0 else
                SearchEngine.shard(cp, n, cfg, device="cpu"))
            for n in (0, 1, 2, 4)}


def _rows(cp, seed, n, mode):
    if mode == "and":
        rng = np.random.default_rng(seed)
        return [list(map(int, rng.choice(np.unique(
            cp.doc_tokens[rng.integers(0, cp.n_docs)]), 3, replace=False)))
            for _ in range(n)]
    return [list(map(int, q)) for q in np.random.default_rng(seed).choice(
        np.arange(1, cp.vocab_size), (n, 3), replace=False)]


EXACT = [dict(mode="and"), dict(mode="or"), dict(mode="or", beam_width=16),
         dict(mode="and", strategy="drb"), dict(mode="or", strategy="drb"),
         dict(mode="and", measure="bm25"), dict(mode="or", measure="bm25")]


@pytest.mark.parametrize("kw", EXACT, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_sharded_engine_equals_single_engine(engines, cp, kw):
    """Four shards answer an exact search with the single index's docs,
    scores and n_found (the same global idf and mean document length)."""
    qs = _rows(cp, 3, 8, kw["mode"])
    single, sharded = engines[0], engines[4]
    assert sharded.backend == "sharded" and sharded.n_docs == cp.n_docs
    a, b = single.search(qs, k=K, **kw), sharded.search(qs, k=K, **kw)
    for leaf in ("docs", "scores", "n_found"):
        assert torch.equal(getattr(a, leaf), getattr(b, leaf)), leaf
    assert b.n_found.sum() > 0
    assert b.docs.device == sharded.device


def test_results_bitwise_across_batch_shapes_and_shard_counts(engines, cp):
    qs = _rows(cp, 5, 8, "or")
    for kw in (dict(mode="or"), dict(mode="or", measure="bm25"),
               dict(mode="and", strategy="drb")):
        full = {n: engines[n].search(qs, k=K, **kw) for n in (1, 2, 4)}
        for n, res in full.items():
            # row by row (B = 1) == the batch of 8
            for b in (0, 5):
                one = engines[n].search([qs[b]], k=K, **kw)
                for leaf in ("docs", "scores", "n_found", "certified",
                             "score_bound"):
                    assert torch.equal(getattr(one, leaf)[0],
                                       getattr(res, leaf)[b]), (n, leaf)
            # where no two scores of a row tie, every shard count agrees
            for b in range(len(qs)):
                s = res.scores[b][torch.isfinite(res.scores[b])]
                if len(torch.unique(s)) == len(s):
                    assert torch.equal(res.docs[b], full[1].docs[b])
                    assert torch.equal(res.scores[b], full[1].scores[b])


def _tied_corpus():
    """Eight documents, the last four copies of the first four: at two
    shards each score appears once in each shard."""
    base = [np.array([2, 3, 2, 5]), np.array([3, 4, 4, 6]),
            np.array([2, 6, 7, 3]), np.array([5, 3, 8, 2])]
    return [d.copy() for d in base + base]


def test_merge_ties_go_to_the_lower_global_document():
    docs = _tied_corpus()
    single = SearchEngine.build(docs, vocab_size=10, device="cpu")
    sharded = SearchEngine.shard(docs, 2, vocab_size=10, device="cpu")
    assert sharded.sharded.bases == [0, 4]
    for kw in (dict(mode="or"), dict(mode="or", strategy="drb"),
               dict(mode="and", strategy="drb", measure="bm25")):
        for k in (3, 5, 8):
            a = single.search([[2, 3]], k=k, **kw)
            b = sharded.search([[2, 3]], k=k, **kw)
            assert torch.equal(a.docs, b.docs) and \
                torch.equal(a.scores, b.scores), (kw, k)
            s, d = b.scores[0].numpy(), b.docs[0].numpy()
            tie = (s[1:] == s[:-1]) & np.isfinite(s[1:])
            assert tie.any() and np.all(d[1:][tie] > d[:-1][tie])


def test_merge_when_a_shard_has_no_hits_and_k_exceeds_a_shard():
    docs = [np.array([1, 2]), np.array([2, 3]), np.array([3, 4]),
            np.array([4, 5]), np.array([5, 6]), np.array([6, 7]),
            np.array([7, 8]), np.array([8, 9])]
    single = SearchEngine.build(docs, vocab_size=12, device="cpu")
    sharded = SearchEngine.shard(docs, 4, vocab_size=12, device="cpu")
    assert [i.n_docs for i in sharded.idx] == [2, 2, 2, 2]
    for kw in (dict(mode="or"), dict(mode="and"),
               dict(mode="or", strategy="drb"),
               dict(mode="and", strategy="drb"),
               dict(mode="or", measure="bm25")):
        # word 1 lives in shard 0 only; k = 6 exceeds every shard's 2 docs
        for q, k in (([[1]], 3), ([[1, 2]], 6), ([[2, 5, 8]], 6),
                     ([[1, 9]], 8)):
            a = single.search(q, k=k, **kw)
            b = sharded.search(q, k=k, **kw)
            for leaf in ("docs", "scores", "n_found"):
                assert torch.equal(getattr(a, leaf), getattr(b, leaf)), \
                    (kw, q, leaf)


def test_one_shard_merge_drops_nothing(engines, cp):
    """At one shard the (k+1)-wide merge has no candidate to drop: every
    leaf is the shard core's own but ``certified``, which the merge decides
    on the score alone (strictly above the bound), where the core also
    certifies a slot tied with the bound that precedes it in document
    order."""
    sh = engines[1].sharded
    qs = np.asarray(engines[1]._encode_queries(_rows(cp, 8, 4, "or"))[0])
    w = torch.from_numpy(qs)
    m = w > 0
    idf = engines[1]._idf_table(scoring.TfIdf())
    for budget in (None, 4):
        got = distributed.distributed_topk(sh, w, m, k=K, method="dr-or",
                                           max_pops=budget, idf=idf)
        own = ranked.topk_dr_batch(sh.idx[0], w, m, idf, k=K,
                                   conjunctive=False,
                                   heap_cap=2 * sh.idx[0].n_docs + 4,
                                   max_pops=budget)
        for leaf in LEAVES:
            if leaf != "certified":
                assert torch.equal(getattr(got, leaf), getattr(own, leaf)), \
                    leaf
        strict = (own.scores > own.bound[:, None]) & \
            (own.scores > -np.inf) & ~own.overflowed[:, None]
        assert torch.equal(got.certified, strict)
        assert torch.equal(got.certified, own.certified & strict)


def _result(scores, bound, *, over=False, padded=1):
    s = torch.tensor([scores], dtype=torch.float32)
    d = torch.tensor([[i if np.isfinite(x) else -1
                       for i, x in enumerate(scores)]], dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    return DRResult(d, s, (s > -np.inf).sum(1, dtype=torch.int32), one,
                    one * 3, torch.tensor([over]), one * padded,
                    torch.zeros_like(s, dtype=torch.bool),
                    torch.tensor([bound], dtype=torch.float32))


def test_merge_certifies_strictly_and_bounds_the_dropped_candidate():
    inf = float("inf")
    a = _result([5.0, 3.0, 1.0], 3.0)
    b = _result([4.0, 2.0, -inf], 2.0, padded=4)
    m = distributed.merge_topk([a, b], [0, 10], k=3, device="cpu")
    assert m.docs.tolist() == [[0, 10, 1]]
    assert m.scores.tolist() == [[5.0, 4.0, 3.0]]
    # 3.0 ties the max bound: not certified; dropped 2.0 < bound 3.0
    assert m.certified.tolist() == [[True, True, False]]
    assert m.bound.tolist() == [3.0]
    assert (m.iters.item(), m.pops.item(), m.padded.item()) == (2, 6, 5)
    # the dropped candidate raises the reported bound above the shards'
    m = distributed.merge_topk([_result([5.0, 3.0, 1.0], -inf),
                                _result([4.0, 2.0, -inf], 0.5)], [0, 10],
                               k=2, device="cpu")
    assert m.certified.tolist() == [[True, True]]
    assert m.bound.tolist() == [3.0]
    # an overflowed shard vetoes every slot; no padded on drb-or
    m = distributed.merge_topk([a, _result([4.0, -inf, -inf], -inf,
                                           over=True)], [0, 10], k=2,
                               device="cpu", has_pad=False)
    assert not m.certified.any() and m.overflowed.tolist() == [True]
    assert m.padded is None and m.n_found.tolist() == [2]


def test_budget_certifies_against_the_max_shard_bound(engines, cp):
    """Under a binding per-shard budget the merged ``certified`` and
    ``bound`` follow from the shards' own results."""
    sh = engines[4].sharded
    qs = engines[4]._encode_queries(_rows(cp, 9, 6, "or"))[0]
    w = torch.from_numpy(qs)
    m = w > 0
    idf = engines[4]._idf_table(scoring.TfIdf())
    res = engines[4].search(_rows(cp, 9, 6, "or"), k=K, mode="or", budget=6)
    shards = [ranked.topk_dr_batch(i, w, m, idf, k=K, conjunctive=False,
                                   heap_cap=engines[4]._heap_cap, max_pops=6)
              for i in sh.idx]
    bound = torch.stack([r.bound for r in shards]).amax(0)
    over = torch.stack([r.overflowed for r in shards]).any(0)
    allsc = torch.cat([r.scores for r in shards], 1)
    dropped = torch.sort(allsc, 1, descending=True).values[:, K]
    want_cert = (res.scores > bound[:, None]) & ~over[:, None] & \
        (res.scores > -np.inf)
    assert torch.equal(res.certified, want_cert)
    assert torch.equal(res.score_bound, torch.maximum(bound, dropped))
    assert not res.certified.all() and res.certified.any()
    assert torch.equal(res.pops, torch.stack([r.pops for r in shards]).sum(0))


def test_snippets_and_word_positions_on_every_shard(engines, cp):
    eng = engines[4]
    qs = _rows(cp, 12, 4, "or")
    res = eng.search(qs, k=cp.n_docs, mode="or")
    shard_of = set()
    snips = eng.snippets(res, length=6)
    bases = np.asarray(eng.sharded.bases)
    for b in range(len(qs)):
        for (d, _), words in zip(res.hits(b), snips[b]):
            np.testing.assert_array_equal(words, cp.doc_tokens[d][:6])
            shard_of.add(int(np.searchsorted(bases, d, side="right")) - 1)
    assert shard_of == {0, 1, 2, 3}
    for d in (0, int(bases[1]), int(bases[2]) + 1, cp.n_docs - 1):
        toks = cp.doc_tokens[d]
        ids = [int(w) for w in np.unique(toks)[:4]]
        got = eng.word_positions(d, ids, cap=32)
        for w in ids:
            np.testing.assert_array_equal(got[w],
                                          np.flatnonzero(toks == w)[:32])


def test_positional_modes_raise_the_references_error(engines, cp):
    ref = RSearchEngine.shard(cp, n_shards=1,
                              config=REngineConfig(block=BLOCK))
    for kw in (dict(mode="phrase"), dict(mode="near", window=4)):
        with pytest.raises(ValueError) as want:
            ref.search([[5, 6]], k=3, **kw)
        with pytest.raises(ValueError) as got:
            engines[4].search([[5, 6]], k=3, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="single-host"):
        loadgen.sample_ngram_queries(engines[4], 2, 2)


def test_padded_threads_through_the_merge_into_the_registry(engines, cp):
    """As the reference's ``test_padded_threads_sharded_path``: at one shard
    ``padded`` equals the single index's, reaches an enabled registry under
    ``backend="sharded"``, and is absent on DRB ``or``."""
    qs = loadgen.sample_queries(engines[0], 4, 2, seed=5)
    assert qs == loadgen.sample_queries(engines[1], 4, 2, seed=5)
    reg = obs.Registry(enabled=True)
    eng = engines[1]
    eng.obs_registry = reg
    try:
        res = eng.search(qs, k=5, mode="or", strategy="dr", beam_width=2)
        drb_or = eng.search(qs, k=5, mode="or", strategy="drb",
                            measure="bm25")
    finally:
        eng.obs_registry = None
    single = engines[0].search(qs, k=5, mode="or", strategy="dr",
                               beam_width=2)
    assert res.padded is not None and res.padded.shape == (4,)
    assert torch.equal(res.padded, single.padded)
    assert drb_or.padded is None
    labels = {"backend": "sharded", "strategy": "dr", "mode": "or"}
    h = reg.histogram("repro_engine_pad_lanes", labels)
    assert h.n == 4 and h.total == float(res.padded.sum())
    assert reg.counter("repro_engine_rows_total", labels).value == 4
    assert reg.counter("repro_engine_searches_total", {
        "backend": "sharded", "strategy": "drb", "mode": "or"}).value == 1


def test_sharded_engine_stats_and_budget_normalization(engines, cp):
    eng = engines[4]
    qs = _rows(cp, 2, 2, "or")
    eng.warmup(qs, max_batch=2, k=4, mode="or", mega=True)
    traces = dict(eng.stats["traces"])
    res = eng.search(qs, k=4, mode="or", mega=True)   # mega normalized off
    assert res.beam_width == 1 and eng.stats["traces"] == traces
    key = next(iter(traces))
    assert key.backend == "sharded" and key.mega is False
    # a budget that can never bind runs the exact search
    exact = eng.search(qs, k=4, mode="or")
    loose = eng.search(qs, k=4, mode="or", budget=2 * cp.n_docs + 2)
    assert torch.equal(exact.docs, loose.docs)
    assert eng.content_tag == engines[4].content_tag != engines[0].content_tag
    rep = eng.space_report()
    parts = eng.shard_space_reports()
    assert len(parts) == 4 and rep["total"] == sum(p["total"] for p in parts)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_shards_on_the_card_equal_the_cpu_and_launch_once_per_shard(cp,
                                                                    engines):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")
    card = SearchEngine.shard(cp, 4, EngineConfig(block=BLOCK))
    assert {d.type for d in card.sharded.devices} == {"cuda"}
    qs = _rows(cp, 3, 8, "and")
    for kw, kernel in ((dict(mode="and", strategy="drb"), "drb_walk"),
                       (dict(mode="or", strategy="drb"), "drb_or"),
                       (dict(mode="and", measure="bm25"), "drb_walk"),
                       (dict(mode="or", measure="bm25"), "drb_or"),
                       (dict(mode="or"), None), (dict(mode="and"), None)):
        card.warmup(qs, max_batch=8, k=K, **kw)
        before = backend.launch_counts()
        got = card.search(qs, k=K, **kw)
        torch.cuda.synchronize()
        after = backend.launch_counts()
        want = engines[4].search(qs, k=K, **kw)
        for leaf in ("docs", "scores", "n_found", "work", "pops",
                     "certified", "score_bound"):
            assert torch.equal(getattr(got, leaf).cpu(),
                               getattr(want, leaf)), (kw, leaf)
        launched = {k: after[k] - before[k] for k in after
                    if after[k] > before[k]}
        if kernel is not None:
            assert launched == {kernel: 4}, (kw, launched)
        else:
            assert set(launched) == {"wavelet_count"}, (kw, launched)
    res = card.search(qs, k=K, mode="or")
    before = backend.launch_counts()["wtbc_decode"]
    got = card.snippets(res, length=5)
    # one wtbc_decode launch per shard that holds a hit
    shards = {int(np.searchsorted(card.sharded.bases, d, side="right")) - 1
              for b in range(len(qs)) for d, _ in res.hits(b)}
    assert backend.launch_counts()["wtbc_decode"] - before == len(shards)
    want = engines[4].snippets(engines[4].search(qs, k=K, mode="or"),
                               length=5)
    for ra, rb in zip(got, want):
        assert len(ra) == len(rb)
        for a, b in zip(ra, rb):
            np.testing.assert_array_equal(a, b)
