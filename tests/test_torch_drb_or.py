"""The DRB ``or`` query's kernel module (``repro_torch/kernels/drb_or.py``).

On the CPU:

* a plain mirror of the device bitmap select (``warp_select1``: the 32-ary
  search of the counters, then one lane per 32-bit word of the block — its
  popcount, a prefix sum over the lanes, the bit by a search over the
  popcounts of halves) against ``bitvec.select1`` and the reference's
  ``repro.core.bitvec.select1`` on random bit vectors, at j = 0, j = the
  total, past it, in the last block, across an all-zero block, and with the
  search range cut to a word's own blocks as the gather passes it;
* ``drb_or_ref`` against the reference's ``repro.core.drb.topk_drb_or`` on
  the same seeded corpus with the reference's idf and ``avg_dl`` carried
  across: documents equal, every integer leaf bitwise, tf-idf scores within
  Q/2 ulps (ROADMAP Queue 3, R4) and BM25 within Q/2 + 2 (R5); under
  tf-idf bitwise equal to the port's own mega core;
* on CPU tensors ``drb_or`` is its plain version with no launch, and the
  wrapper's argument checks raise.

The tests marked ``cuda`` hold the kernels against the plain version on
the card, every ``DRResult`` leaf bitwise: k = 1, 10, past the collection,
and past one tile's keys (the merge by ranks), a repeated word, a
stopword, a masked column, a row with no valid word, 1-, 2- and 3-byte
words at blocks 64 and 4,096, Q from 1 to 64, tf-idf and BM25, and the
engine's one ``drb_or`` launch per batch.  They skip without a GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvec as r_bitvec
from repro.core import drb as r_drb
from repro.text import corpus as r_corpus
from repro_torch.core import bitvec, drb, mega
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import backend
from repro_torch.kernels import drb_or
from test_torch_drb import (MEASURES, batch, build, compare, tolerance,
                            ulps)
from test_torch_drb_walk import lower_bound32, three_level

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the device bitmap select, mirrored
# ---------------------------------------------------------------------------

def nth_set_bit_mirror(w: int, r: int) -> int:
    """``nth_set_bit``: the r-th set bit of w by the popcounts of halves."""
    pos = 0
    for half in (16, 8, 4, 2, 1):
        c = bin(w & ((1 << half) - 1)).count("1")
        if r > c:
            r -= c
            pos += half
            w >>= half
    return pos


def select1_mirror(words: np.ndarray, counts: np.ndarray, n_bits: int,
                   j: int, blk_lo: int = 0, blk_hi: int | None = None) -> int:
    """``warp_select1``: the block by ``lower_bound32`` over the counters of
    [blk_lo, blk_hi), then the 32 words of the block as 32 lanes: their
    popcounts, an inclusive prefix sum, the first lane that reaches the
    need, and the bit inside its word."""
    n_blocks = counts.shape[0] - 1
    blk_hi = n_blocks if blk_hi is None else blk_hi
    if j < 1 or j > counts[n_blocks]:
        return n_bits
    blk = blk_lo if blk_hi - blk_lo == 1 else \
        blk_lo + lower_bound32(counts[blk_lo:blk_hi], j)[0] - 1
    need = j - int(counts[blk])
    lanes = [int(x) & 0xFFFFFFFF for x in words[blk * 32:(blk + 1) * 32]]
    incl = np.cumsum([bin(x).count("1") for x in lanes])
    t = int(np.argmax(incl >= need))
    prior = int(incl[t - 1]) if t else 0
    return (blk * 32 + t) * 32 + nth_set_bit_mirror(lanes[t], need - prior)


def random_bits(rng, n_bits: int) -> np.ndarray:
    """Sorted set bits of varied density, block 2 (bits 2048-3071) empty and
    the last bit set."""
    dens = rng.choice([0.02, 0.5, 0.97], n_bits)
    bits = np.flatnonzero(rng.random(n_bits) < dens)
    bits = bits[(bits < 2048) | (bits >= 3072)]
    return np.unique(np.append(bits, n_bits - 1))


@pytest.mark.parametrize("n_bits", [1000, 5 * 1024 + 77, 9 * 1024])
def test_select1_mirror_matches_bitvec_and_reference(n_bits):
    rng = np.random.default_rng(n_bits)
    bits = random_bits(rng, n_bits)
    bv = bitvec.build(bits, n_bits, device="cpu")
    rbv = r_bitvec.build(bits, n_bits)
    words, counts = bv.words.numpy(), bv.counts.numpy()
    total = len(bits)
    n_blocks = counts.shape[0] - 1
    last = int(counts[n_blocks - 1])      # ones before the last block
    js = np.unique(np.concatenate([
        [0, 1, total, total + 1, total + 50, last, last + 1],
        rng.integers(0, total + 2, 300)])).astype(np.int32)
    want = bitvec.select1(bv, torch.from_numpy(js)).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jax.vmap(lambda j: r_bitvec.select1(rbv, j))(
            jnp.asarray(js))))
    got = [select1_mirror(words, counts, n_bits, int(j)) for j in js]
    np.testing.assert_array_equal(got, want)
    if n_blocks > 3:                      # the empty block is skipped
        assert counts[2] == counts[3]
        j = int(counts[2]) + 1
        assert select1_mirror(words, counts, n_bits, j) >= 3072
    # the gather's cut range: the blocks of bits [off, off + occ)
    for off, occ in ((0, n_bits), (1500, 900), (n_bits - 700, 700)):
        base = int(np.count_nonzero(bits < off))
        ones = int(np.count_nonzero((bits >= off) & (bits < off + occ)))
        lo, hi = off // 1024, min((off + occ - 1) // 1024 + 1, n_blocks)
        js_w = np.arange(base + 1, base + ones + 1, max(1, ones // 40),
                         dtype=np.int32)
        want_w = bitvec.select1(bv, torch.from_numpy(js_w)).numpy()
        got_w = [select1_mirror(words, counts, n_bits, int(j), lo, hi)
                 for j in js_w]
        np.testing.assert_array_equal(got_w, want_w)


def test_nth_set_bit_mirror_every_rank():
    rng = np.random.default_rng(1)
    for w in [0xFFFFFFFF, 0x80000001, 1, 0x80000000] + \
            [int(x) for x in rng.integers(1, 2**32, 40)]:
        ones = [b for b in range(32) if w >> b & 1]
        for r, b in enumerate(ones, 1):
            assert nth_set_bit_mirror(w, r) == b


# ---------------------------------------------------------------------------
# the plain version against the reference
# ---------------------------------------------------------------------------

def ref_both(words, mask, measure, **kw):
    """(drb_or_ref's DRResult, the reference's) on the shared corpus, with
    the reference's idf table and avg_dl carried across."""
    cp, ridx, rmodel, raux, pidx, paux = build()
    rm, pm = MEASURES[measure]
    ridf = np.array(rm.idf(ridx))
    ravg = jnp.sum(ridx.doc_len.astype(jnp.float32)) \
        / ridx.n_docs.astype(jnp.float32)
    want = jax.vmap(lambda w, m: r_drb.topk_drb_or(
        ridx, raux, w, m, rm, idf=jnp.asarray(ridf), avg_dl=ravg, **kw))(
        jnp.asarray(words), jnp.asarray(mask))
    got = drb_or.drb_or_ref(pidx, paux, torch.from_numpy(words),
                            torch.from_numpy(mask), pm, k=kw["k"],
                            max_df_cap=kw["max_df_cap"],
                            idf_all=torch.from_numpy(ridf),
                            avg=torch.tensor(np.float32(ravg)))
    return got, want


@pytest.mark.parametrize("measure,Q", [(m, Q) for m in ("tfidf", "bm25")
                                       for Q in (4, 8)])
def test_drb_or_ref_matches_reference(measure, Q):
    cp, _, rmodel, *_ = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(70 + Q), 4, Q,
                        Q - 1, from_docs=False)
    words[0, Q - 1], mask[0, Q - 1] = words[0, 0], True   # a repeated word
    got, want = ref_both(words, mask, measure, k=12, max_df_cap=128)
    assert int(got.n_found.min()) > 0
    np.testing.assert_array_equal(got.docs.numpy(), np.asarray(want.docs))
    assert ulps(got.scores.numpy(), want.scores) <= tolerance(measure, Q)
    compare(got, want, measure, Q, padded=False)


def test_drb_or_ref_tfidf_equals_mega_core():
    """DRB tf-idf scores every document the DR search ranks, in the same
    order of operations: bitwise equal to the port's mega core."""
    cp, ridx, rmodel, raux, pidx, paux = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(8), 4, 4, 3,
                        from_docs=False)
    tfidf = MEASURES["tfidf"][1]
    idf = tfidf.idf(pidx)
    wt, mt = torch.from_numpy(words), torch.from_numpy(mask)
    got = drb_or.drb_or_ref(pidx, paux, wt, mt, tfidf, k=10, max_df_cap=128,
                            idf_all=idf, avg=None)
    want = mega.topk_dr_mega(pidx, wt, mt, idf, k=10, conjunctive=False,
                             cap=pidx.n_docs + 2)
    for leaf in ("docs", "scores", "n_found"):
        assert torch.equal(getattr(got, leaf), getattr(want, leaf)), leaf


def test_drb_or_on_cpu_is_the_plain_version():
    cp, ridx, rmodel, raux, pidx, paux = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(9), 3, 4, 3,
                        from_docs=False)
    bm25 = MEASURES["bm25"][1]
    kw = dict(k=7, max_df_cap=128, idf_all=bm25.idf(pidx),
              avg=torch.tensor(np.float32(5.0)))
    before = backend.launch_counts()
    got = drb_or.drb_or(pidx, paux, torch.from_numpy(words),
                        torch.from_numpy(mask), bm25, **kw)
    assert backend.launch_counts() == before
    want = drb_or.drb_or_ref(pidx, paux, torch.from_numpy(words),
                             torch.from_numpy(mask), bm25, **kw)
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_drb_or_argument_checks_raise():
    cp, ridx, rmodel, raux, pidx, paux = build()
    words, mask = batch(cp, rmodel, np.random.default_rng(2), 2, 4, 3,
                        from_docs=False)
    tfidf, bm25 = MEASURES["tfidf"][1], MEASURES["bm25"][1]
    wt, mt = torch.from_numpy(words), torch.from_numpy(mask)
    idf = tfidf.idf(pidx)
    avg = torch.tensor(np.float32(5.0))
    ok = dict(k=10, max_df_cap=64, idf_all=idf, avg=None)
    args = drb_or.launch_args(pidx, paux, wt, mt, tfidf, **ok)
    assert args[-1] == 10 and args[-10:-7] == (2, 4, 64)
    bad = [
        ((wt.long(), mt, tfidf), ok, "words must be"),
        ((wt, mt.to(torch.uint8), tfidf), ok, "wmask must be"),
        ((wt[:0], mt[:0], tfidf), ok, "needs 1 <= B"),
        ((wt, mt, tfidf), dict(ok, k=0), "k=0"),
        ((wt, mt, tfidf), dict(ok, max_df_cap=-1), "max_df_cap"),
        ((wt, mt, tfidf), dict(ok, idf_all=idf[:-1]), "idf must be"),
        ((wt, mt, tfidf), dict(ok, idf_all=idf.double()), "idf must be"),
        ((wt, mt, bm25), ok, "BM25 needs avg_dl"),
        ((wt, mt, bm25), dict(ok, avg=avg.double()), "BM25 needs avg_dl"),
        ((wt, mt, object()), ok, "no kernel scores"),
    ]
    for (w, m, meas), kw, match in bad:
        with pytest.raises(ValueError, match=match):
            drb_or.launch_args(pidx, paux, w, m, meas, **kw)
    wide = torch.zeros((1, drb_or.MAX_Q + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="Q <= 1024"):
        drb_or.launch_args(pidx, paux, wide, wide.bool(), tfidf, **ok)
    # any k >= 1: past the old 32,768 cap where the collection is larger
    import dataclasses
    with pytest.raises(ValueError, match="k=0 must be >= 1"):
        drb_or.launch_args(pidx, paux, wt, mt, tfidf, **dict(ok, k=0))
    big = dataclasses.replace(
        pidx, n_docs=50_000, sep_pos=torch.zeros(50_000, dtype=torch.int32),
        doc_len=torch.zeros(50_000, dtype=torch.int32))
    for k in (32_769, 40_000):
        args = drb_or.launch_args(big, paux, wt, mt, tfidf, **dict(ok, k=k))
        assert args[-1] == k and args[19] == 50_000
        assert drb_or.scratch_ints(2, 4, 50_000, k) == drb_or.scratch_ints(
            2, 4, 50_000, drb_or.TILE)
    aux_bad = drb.DRBAux(bitvec.BitVec(paux.bv.words.long(), paux.bv.counts,
                                       paux.bv.n_bits), paux.bit_off,
                         paux.has_bm, paux.eps)
    with pytest.raises(ValueError, match="tf bitmaps"):
        drb_or.launch_args(pidx, aux_bad, wt, mt, tfidf, **ok)
    # the scratch: table + tickets, 8 per word, the prefix, a length per
    # (row, tile), aligned, then the keys of each tile
    n_tiles = -(-300 // drb_or.TILE)
    n = 2 * 300 * 4 + 2 + 8 * 8 + 8 + 1 + 2 * n_tiles
    assert drb_or.scratch_ints(2, 4, 300, 10) == n + (n & 1) + 2 * 2 * 10
    assert drb_or.scratch_ints(1, 1, 9000, 5000) % 2 == 0


# ---------------------------------------------------------------------------
# on the card (skip elsewhere)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")


def or_rows(idx, aux, rng, B: int, Q: int, *, special=True):
    """(B, Q) word ranks and mask of words with tf bitmaps; with
    ``special``: row 0 repeats a word, row 1 masks a column, row 2 takes a
    stopword, row 3 has no valid word."""
    df = idx.df.cpu().numpy()
    has_bm = aux.has_bm.cpu().numpy()
    words = rng.choice(np.flatnonzero(has_bm & (df > 0)), (B, Q)).astype(
        np.int32)
    mask = np.ones((B, Q), bool)
    if special and Q >= 2 and B >= 4:
        words[0, 1] = words[0, 0]
        mask[1, Q - 1] = False
        stop = np.flatnonzero(~has_bm & (df > 0))
        stop = stop[stop != 0]
        words[2, 0] = stop[0]
        words[3], mask[3] = 0, False
    return words, mask


def card_both(idx, aux, words, mask, measure, *, k, cap=None):
    """(kernel DRResult, plain DRResult) on the card; the kernel run is one
    drb_or launch and no other."""
    m = MEASURES[measure][1]
    dev = idx.device
    df = idx.df.cpu().numpy()
    cap = int(df[words[mask]].max(initial=0)) + 2 if cap is None else cap
    avg = torch.tensor(np.float32(idx.doc_len.float().mean().item()),
                       device=dev)
    kw = dict(k=k, max_df_cap=cap, idf=m.idf(idx), avg_dl=avg)
    wt, mt = torch.from_numpy(words).to(dev), torch.from_numpy(mask).to(dev)
    before = backend.launch_counts()
    got = drb.topk_drb_or(idx, aux, wt, mt, m, **kw)
    after = backend.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "drb_or") for n in after}
    want = drb.topk_drb_or(idx, aux, wt, mt, m, kernel_backend="ref", **kw)
    torch.cuda.synchronize()
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    return got, want


CARD_SWEEP = [(block, Q, m) for block in (64, 4096) for Q in (1, 2, 4, 64)
              for m in ("tfidf", "bm25")]


@pytest.mark.cuda
@pytest.mark.parametrize("block,Q,measure", CARD_SWEEP)
def test_drb_or_kernel_matches_plain_on_card(block, Q, measure):
    _need_card()
    cp, model, idx, aux = three_level(block, "cuda")
    rng = np.random.default_rng(CARD_SWEEP.index((block, Q, measure)))
    words, mask = or_rows(idx, aux, rng, 8, Q)
    cw_len = idx.cw_len.cpu().numpy()
    if Q >= 4:
        assert {1, 2, 3} <= set(cw_len[words[mask]].tolist())
    for k in (1, 10):
        got, _ = card_both(idx, aux, words, mask, measure, k=k)
        assert int(got.n_found.max()) > 0
        if Q >= 2:
            assert int(got.n_found[3]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
def test_drb_or_kernel_k_past_the_collection_on_card(measure):
    """k > n_docs: every document some word occurs in, then (-inf, -1)."""
    _need_card()
    cp, model, idx, aux = three_level(512, "cuda")
    words, mask = or_rows(idx, aux, np.random.default_rng(3), 6, 4)
    got, _ = card_both(idx, aux, words, mask, measure, k=idx.n_docs + 17)
    assert int(got.n_found.max()) < idx.n_docs + 17
    assert bool((got.docs[:, idx.n_docs:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
def test_drb_or_kernel_merge_by_ranks_on_card(measure):
    """More kept keys than one tile holds (the merge places each key at its
    rank), a capped gather (max_df_cap below a word's df), and k = 1."""
    _need_card()
    cp = r_corpus.make_corpus(n_docs=9000, mean_doc_len=40, vocab_size=600,
                              seed=4)
    eng = SearchEngine.build(cp, EngineConfig(block=512), device="cuda")
    idx, aux = eng.idx, eng.aux
    df = idx.df.cpu().numpy()
    has_bm = aux.has_bm.cpu().numpy()
    common = np.flatnonzero(has_bm & (df > 2000))[:8]
    words = np.stack([np.roll(common, r)[:4] for r in range(4)]).astype(
        np.int32)
    mask = np.ones_like(words, bool)
    got, _ = card_both(idx, aux, words, mask, measure, k=3000)
    assert int(got.n_found.min()) == 3000
    card_both(idx, aux, words, mask, measure, k=1)
    card_both(idx, aux, words, mask, measure, k=10, cap=1024)


@pytest.mark.cuda
@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
def test_engine_drb_or_is_one_launch_on_card(measure):
    """``search(mode="or", strategy="drb")`` on the card: one drb_or launch
    per batch and no other, and the plain version's answer."""
    _need_card()
    cp = r_corpus.make_corpus(n_docs=300, mean_doc_len=60, vocab_size=800,
                              seed=21)
    eng = SearchEngine.build(cp, EngineConfig(block=512), device="cuda")
    rng = np.random.default_rng(6)
    queries = [[int(x) for x in rng.choice(np.unique(cp.doc_tokens[d]), 3,
                                           replace=False)]
               for d in rng.integers(0, cp.n_docs, 6)]
    eng.search(queries, k=8, mode="or", strategy="drb", measure=measure)
    before = backend.launch_counts()
    res = eng.search(queries, k=8, mode="or", strategy="drb",
                     measure=measure)
    after = backend.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "drb_or") for n in after}
    ranks, masks = eng._encode_queries(queries)
    m = eng._resolve_measure(measure)
    want = drb.topk_drb_or(
        eng.idx, eng.aux, torch.from_numpy(ranks).cuda(),
        torch.from_numpy(masks).cuda(), m, k=8,
        max_df_cap=eng.suggested_df_cap(queries), idf=eng._idf_table(m),
        avg_dl=eng._avg_doc_len(), kernel_backend="ref")
    assert torch.equal(res.docs, want.docs)
    assert torch.equal(res.scores, want.scores)
    assert int(res.n_found.min()) == 8
