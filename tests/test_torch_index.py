"""The port's host build and count path against the JAX reference (CPU).

* corpus tokens, document-frequency bands and sampled queries per seed;
* every ``SCDCModel`` field and every ``WTBCIndex`` / ``ByteMap`` leaf of the
  port's build equals the reference build (the conftest corpora, blocks 512
  and 4096);
* the port's plain count descent equals ``ref.wavelet_count_ref``, the
  reference's K1 kernel (TPU lowering under the Pallas interpreter) and the
  scalar ``wtbc.count_range`` walk, at random triples and at lo = hi,
  hi = n and block edges;
* document geometry and ``bytemap.rank`` edges;
* ``convert.from_reference`` carries the reference's arrays across intact;
* ``bitvec.rank1`` / ``select1``, ``bytemap.select`` / ``access`` and
  ``wtbc.locate`` / ``decode_at`` / ``extract`` / ``decode_all_np`` equal the
  reference's functions bitwise (the positional and snippet primitives), and
  ``convert.aux_from_reference`` carries the DRB bitmaps across intact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvec as r_bitvec
from repro.core import bytemap as r_bytemap
from repro.core import drb as r_drb
from repro.core import scdc as r_scdc
from repro.core import wtbc as r_wtbc
from repro.kernels import ref as r_ref
from repro.kernels import wavelet_descent as r_wd
from repro.text import corpus as r_corpus
from repro_torch import convert
from repro_torch.core import bitvec as p_bitvec
from repro_torch.core import bytemap as p_bytemap
from repro_torch.core import scdc as p_scdc
from repro_torch.core import wtbc as p_wtbc
from repro_torch.text import corpus as p_corpus

torch.set_num_threads(1)

CORPORA = {"small": dict(n_docs=120, mean_doc_len=60, vocab_size=500, seed=3),
           "engine": dict(n_docs=90, mean_doc_len=50, vocab_size=400, seed=9)}
_BUILDS = {}


def reference_arrays(idx) -> dict:
    """A reference ``WTBCIndex`` as plain numpy under its field names."""
    out = {f.name: getattr(idx, f.name) for f in dataclasses.fields(idx)}
    out["levels"] = [{f.name: np.asarray(getattr(lv, f.name))
                      for f in dataclasses.fields(lv)} for lv in idx.levels]
    out["offsets"] = [np.asarray(o) for o in idx.offsets]
    for k, v in out.items():
        if k not in ("levels", "offsets"):
            out[k] = np.asarray(v)
    return out


def model_arrays(model) -> dict:
    return {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}


def builds(name: str, block: int):
    """(reference corpus, reference (idx, model), port (idx, model)),
    memoized per corpus and block."""
    key = (name, block)
    if key not in _BUILDS:
        cp = r_corpus.make_corpus(**CORPORA[name])
        ref = r_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=block)
        port = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=block,
                                  device="cpu")
        _BUILDS[key] = (cp, ref, port)
    return _BUILDS[key]


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_corpus_tokens_bands_queries_match(name):
    a = r_corpus.make_corpus(**CORPORA[name])
    b = p_corpus.make_corpus(**CORPORA[name])
    assert a.vocab_size == b.vocab_size and a.n_docs == b.n_docs
    for x, y in zip(a.doc_tokens, b.doc_tokens):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.doc_freqs(), b.doc_freqs())
    assert r_corpus.fdoc_bands(a.n_docs) == p_corpus.fdoc_bands(b.n_docs)
    band = r_corpus.fdoc_bands(a.n_docs)["ii"]
    np.testing.assert_array_equal(
        r_corpus.sample_queries(a.doc_freqs(), band, 5, 3, seed=7),
        p_corpus.sample_queries(b.doc_freqs(), band, 5, 3, seed=7))


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_scdc_model_fields_match(name):
    cp = r_corpus.make_corpus(**CORPORA[name])
    flat = np.concatenate([np.append(d, 0) for d in cp.doc_tokens])
    freqs = np.bincount(flat, minlength=cp.vocab_size)
    a = r_scdc.fit(freqs, reserve_first=0)
    b = p_scdc.fit(freqs, reserve_first=0)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("block", [512, 4096])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_index_leaves_match(name, block):
    _, (ridx, rmodel), (pidx, pmodel) = builds(name, block)
    for f in dataclasses.fields(rmodel):
        np.testing.assert_array_equal(np.asarray(getattr(rmodel, f.name)),
                                      np.asarray(getattr(pmodel, f.name)))
    for L in range(3):
        r, p = ridx.levels[L], pidx.levels[L]
        np.testing.assert_array_equal(np.asarray(r.data), p.data.numpy())
        np.testing.assert_array_equal(np.asarray(r.counts), p.counts.numpy())
        assert int(r.length) == p.length and r.block == p.block == block
        np.testing.assert_array_equal(np.asarray(ridx.offsets[L]),
                                      pidx.offsets[L].numpy())
    for f in ("cw", "cw_len", "node_off", "base_rank", "sep_pos", "df", "occ",
              "doc_len"):
        a, b = np.asarray(getattr(ridx, f)), getattr(pidx, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (int(ridx.n), int(ridx.n_docs), ridx.s, ridx.c) == \
        (pidx.n, pidx.n_docs, pidx.s, pidx.c)


def _triples(idx, rng, M):
    """Random (word, lo, hi) triples plus the edge cases: lo = hi, hi = n,
    lo = 0 and endpoints on either side of every level-0 block edge."""
    n = int(idx.n)
    block = idx.levels[0].block
    w = rng.integers(0, idx.vocab_size, M)
    lo = rng.integers(0, n + 1, M)
    hi = np.minimum(n, lo + rng.integers(0, n + 1, M))
    edges = np.arange(0, n + 1, block)
    e = np.concatenate([edges, np.maximum(edges - 1, 0),
                        np.minimum(edges + 1, n)])
    k = len(e)
    w = np.concatenate([w, rng.integers(0, idx.vocab_size, k + 12)])
    lo = np.concatenate([lo, np.zeros(k, np.int64), np.full(4, 7),
                         rng.integers(0, n + 1, 4), np.zeros(4, np.int64)])
    hi = np.concatenate([hi, e, np.full(4, 7), np.full(4, n), np.full(4, n)])
    return w.astype(np.int32), lo.astype(np.int32), hi.astype(np.int32)


@pytest.mark.parametrize("block", [512, 4096])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_count_range_batch_matches_reference(name, block):
    _, (ridx, _), (pidx, _) = builds(name, block)
    w, lo, hi = _triples(ridx, np.random.default_rng(block), 40)
    got = p_wtbc.count_range_batch(pidx, torch.from_numpy(w),
                                   torch.from_numpy(lo),
                                   torch.from_numpy(hi)).numpy()
    jw, jlo, jhi = jnp.asarray(w), jnp.asarray(lo), jnp.asarray(hi)
    want = np.asarray(r_ref.wavelet_count_ref(
        ridx.levels, ridx.cw, ridx.cw_len, ridx.node_off, ridx.base_rank,
        jw, jlo, jhi))
    np.testing.assert_array_equal(got, want)
    k1 = np.asarray(r_wd.wavelet_descent(
        ridx.levels, ridx.cw, ridx.cw_len, ridx.node_off, ridx.base_rank,
        jw, jlo, jhi, block=block, lowering="tpu", interpret=True))
    np.testing.assert_array_equal(got, k1)
    scalar = np.asarray(jax.jit(jax.vmap(
        lambda a, b, c: r_wtbc.count_range(ridx, a, b, c)))(jw, jlo, jhi))
    np.testing.assert_array_equal(got, scalar)
    # the elementwise entry point agrees with the batch one
    np.testing.assert_array_equal(
        p_wtbc.count_range(pidx, torch.from_numpy(w[:9]),
                           torch.from_numpy(lo[:9]),
                           torch.from_numpy(hi[:9])).numpy(), got[:9])


def test_count_doc_matches_raw_tokens():
    cp, (ridx, rmodel), (pidx, _) = builds("engine", 512)
    rng = np.random.default_rng(5)
    for d in rng.integers(0, cp.n_docs, 6):
        word_ids = rng.choice(np.unique(cp.doc_tokens[d]), 3)
        ranks = torch.from_numpy(rmodel.rank_of_word[word_ids].astype(np.int32))
        tf = p_wtbc.count_doc(pidx, ranks,
                              torch.full((3,), int(d), dtype=torch.int32))
        want = [int(np.sum(cp.doc_tokens[d] == x)) for x in word_ids]
        assert tf.tolist() == want


def test_doc_geometry_matches_reference():
    _, (ridx, _), (pidx, _) = builds("small", 512)
    n_docs = int(ridx.n_docs)
    d = np.arange(0, n_docs + 1, dtype=np.int32)
    for fn in ("doc_start", "doc_end"):
        want = np.asarray(jax.vmap(
            lambda x: getattr(r_wtbc, fn)(ridx, x))(jnp.asarray(d)))
        got = getattr(p_wtbc, fn)(pidx, torch.from_numpy(d)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=fn)
    d0, d1 = d[:-1], np.minimum(d[:-1] + 7, n_docs)
    rl, rh = jax.vmap(lambda a, b: r_wtbc.segment_extent(ridx, a, b))(
        jnp.asarray(d0), jnp.asarray(d1))
    pl_, ph = p_wtbc.segment_extent(pidx, torch.from_numpy(d0),
                                    torch.from_numpy(d1))
    np.testing.assert_array_equal(pl_.numpy(), np.asarray(rl))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
    pos = np.random.default_rng(2).integers(0, int(ridx.n), 50).astype(np.int32)
    np.testing.assert_array_equal(
        p_wtbc.doc_of_pos(pidx, torch.from_numpy(pos)).numpy(),
        np.asarray(r_wtbc.doc_of_pos(ridx, jnp.asarray(pos))))


@pytest.mark.parametrize("n,block", [(100, 256), (4096, 512), (9000, 512),
                                     (0, 512)])
def test_bytemap_rank_edges(n, block):
    rng = np.random.default_rng(n + block)
    data = rng.integers(0, 6, n).astype(np.uint8)
    bm = p_bytemap.build(data, block=block, device="cpu")
    pos = np.unique(np.clip(np.concatenate(
        [np.arange(0, n + 1, block), np.arange(0, n + 1, block) - 1,
         [0, n, n + 5], rng.integers(0, n + 1, 20)]), 0, n + 5))
    byte = rng.integers(0, 6, len(pos))
    got = p_bytemap.rank(bm, torch.from_numpy(byte),
                         torch.from_numpy(pos.astype(np.int32))).numpy()
    want = [p_bytemap.rank_np(data, int(b), min(int(p), n))
            for b, p in zip(byte, pos)]
    np.testing.assert_array_equal(got, want)
    lo = np.minimum(pos, rng.integers(0, n + 1, len(pos)))
    np.testing.assert_array_equal(
        p_bytemap.count_range(bm, torch.from_numpy(byte),
                              torch.from_numpy(lo.astype(np.int32)),
                              torch.from_numpy(pos.astype(np.int32))).numpy(),
        np.asarray(want) - [p_bytemap.rank_np(data, int(b), int(p))
                            for b, p in zip(byte, lo)])


def test_from_reference_round_trips():
    _, (ridx, rmodel), _ = builds("engine", 512)
    arrays = reference_arrays(ridx)
    idx, model = convert.from_reference(arrays, model_arrays(rmodel),
                                        device="cpu")
    back = {f: getattr(idx, f) for f in ("cw", "cw_len", "node_off",
                                         "base_rank", "sep_pos", "df", "occ",
                                         "doc_len")}
    for f, t in back.items():
        np.testing.assert_array_equal(t.numpy(), arrays[f], err_msg=f)
        assert t.numpy().dtype == arrays[f].dtype, f
    for L, lv in enumerate(idx.levels):
        np.testing.assert_array_equal(lv.data.numpy(), arrays["levels"][L]["data"])
        np.testing.assert_array_equal(lv.counts.numpy(),
                                      arrays["levels"][L]["counts"])
        assert lv.length == int(arrays["levels"][L]["length"])
        np.testing.assert_array_equal(idx.offsets[L].numpy(),
                                      arrays["offsets"][L])
    assert (idx.n, idx.n_docs, idx.s, idx.c) == \
        (int(ridx.n), int(ridx.n_docs), ridx.s, ridx.c)
    for f in dataclasses.fields(rmodel):
        np.testing.assert_array_equal(getattr(model, f.name),
                                      getattr(rmodel, f.name))
    with pytest.raises(ValueError, match="idf table"):
        convert.idf_table(np.zeros(3), idx)


# ---------------------------------------------------------------------------
# select / access / locate / decode (slice 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bits,dens", [(1, 1.0), (1000, 0.3), (5000, 0.01),
                                         (40000, 0.9), (3000, 0.0)])
def test_bitvec_rank1_select1_match_reference(n_bits, dens):
    rng = np.random.default_rng(n_bits)
    sb = np.flatnonzero(rng.random(n_bits) < dens)
    rbv, pbv = r_bitvec.build(sb, n_bits), p_bitvec.build(sb, n_bits, device="cpu")
    assert pbv.n_bits == int(rbv.n_bits)
    pos = np.concatenate([rng.integers(-2, n_bits + 3, 200),
                          [0, n_bits, 1023, 1024, 1025, 2048]]).astype(np.int32)
    np.testing.assert_array_equal(
        p_bitvec.rank1(pbv, torch.from_numpy(pos)).numpy(),
        np.asarray(jax.vmap(lambda x: r_bitvec.rank1(rbv, x))(pos)))
    j = np.concatenate([rng.integers(-1, len(sb) + 3, 200),
                        [0, 1, len(sb), len(sb) + 1]]).astype(np.int32)
    got = p_bitvec.select1(pbv, torch.from_numpy(j)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(lambda x: r_bitvec.select1(rbv, x))(j)))
    np.testing.assert_array_equal(
        got, [r_bitvec.select1_np(sb, int(x), n_bits) for x in j])


@pytest.mark.parametrize("n,block", [(0, 512), (700, 512), (5000, 1024),
                                     (12000, 4096), (3000, 200)])
def test_bytemap_select_access_match_reference(n, block):
    rng = np.random.default_rng(n + block)
    data = rng.integers(0, 6, n).astype(np.uint8)
    rbm = r_bytemap.build(data, block=block)
    pbm = p_bytemap.build(data, block, device="cpu")
    b = rng.integers(0, 7, 300).astype(np.int32)
    j = np.concatenate([rng.integers(-1, n // 5 + 3, 294),
                        [0, 1, n // 6, n // 6 + 1, 10**6, -5]]).astype(np.int32)
    got = p_bytemap.select(pbm, torch.from_numpy(b), torch.from_numpy(j)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(
        lambda x, y: r_bytemap.select(rbm, x, y))(b, j)))
    np.testing.assert_array_equal(
        got, [r_bytemap.select_np(data, int(x), int(y)) for x, y in zip(b, j)])
    pos = rng.integers(-3, n + 4, 100).astype(np.int32)
    np.testing.assert_array_equal(
        p_bytemap.access(pbm, torch.from_numpy(pos)).numpy(),
        np.asarray(r_bytemap.access(rbm, jnp.asarray(pos))))


@pytest.mark.parametrize("block", [512, 4096])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_locate_decode_extract_match_reference(name, block):
    cp, (ridx, rmodel), (pidx, _) = builds(name, block)
    rng = np.random.default_rng(block + 1)
    occ = pidx.occ.numpy()
    w = rng.integers(0, pidx.vocab_size, 400)
    w = w[occ[w] > 0].astype(np.int32)
    j = (1 + rng.integers(0, 10**6, len(w)) % occ[w]).astype(np.int32)
    j[:3] = occ[w[:3]]                                    # last occurrences
    got = p_wtbc.locate(pidx, torch.from_numpy(w), torch.from_numpy(j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.vmap(
        lambda a, b: r_wtbc.locate(ridx, a, b))(w, j)))
    # the located position holds the word
    np.testing.assert_array_equal(p_wtbc.decode_at(pidx, got).numpy(), w)
    pos = np.concatenate([rng.integers(0, pidx.n, 300),
                          [0, pidx.n - 1]]).astype(np.int32)
    np.testing.assert_array_equal(
        p_wtbc.decode_at(pidx, torch.from_numpy(pos)).numpy(),
        np.asarray(jax.vmap(lambda a: r_wtbc.decode_at(ridx, a))(pos)))
    for lo in (0, 37, pidx.n - 8):
        np.testing.assert_array_equal(
            p_wtbc.extract(pidx, torch.tensor(lo), 8).numpy(),
            np.asarray(r_wtbc.extract(ridx, jnp.int32(lo), 8)))
    flat = np.concatenate([np.append(d, 0) for d in cp.doc_tokens])
    whole = p_wtbc.decode_all_np(pidx, rmodel)
    np.testing.assert_array_equal(whole, r_wtbc.decode_all_np(ridx, rmodel))
    np.testing.assert_array_equal(whole, rmodel.rank_of_word[flat])


def test_aux_from_reference_round_trips():
    cp, (ridx, rmodel), (pidx, _) = builds("engine", 512)
    raux = r_drb.build_aux(ridx, rmodel, cp.doc_tokens)
    aux = convert.aux_from_reference(
        {"words": np.asarray(raux.bv.words), "counts": np.asarray(raux.bv.counts),
         "n_bits": int(raux.bv.n_bits), "bit_off": np.asarray(raux.bit_off),
         "has_bm": np.asarray(raux.has_bm), "eps": raux.eps}, device="cpu")
    np.testing.assert_array_equal(aux.bv.words.numpy().view(np.uint32),
                                  np.asarray(raux.bv.words))
    np.testing.assert_array_equal(aux.bv.counts.numpy(),
                                  np.asarray(raux.bv.counts))
    assert aux.bv.n_bits == int(raux.bv.n_bits) and aux.eps == raux.eps
    np.testing.assert_array_equal(aux.bit_off.numpy(), np.asarray(raux.bit_off))
    assert aux.has_bm.dtype == torch.bool
    np.testing.assert_array_equal(aux.has_bm.numpy(), np.asarray(raux.has_bm))
