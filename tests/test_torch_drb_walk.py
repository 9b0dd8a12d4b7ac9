"""The DRB ``and`` walk's kernel module (``repro_torch/kernels/drb_walk.py``).

On the CPU:

* ``drb_walk`` on CPU tensors is its plain loop (``drb_walk_ref``), every
  state array, with no kernel launch, and a trip of rows that stopped is an
  exact no-op (what the kernel's per-row loop relies on);
* the plain walk against the JAX reference's ``topk_drb_and`` on an index
  whose words have codewords of 1, 2 and 3 bytes (every level's select
  runs), tf-idf and BM25, P in {1, 3}: integer leaves bitwise, scores within
  the tolerances of ``test_torch_drb.py`` (ROADMAP Queue 3, R4);
* plain mirrors of the kernel's device searches — the 32-ary warp search
  of a counter column then the scan of one block in 512-byte warp loads
  (``warp_select``), and the same search over ``sep_pos``
  (``warp_lower_bound``) — against ``bytemap.select`` and
  ``torch.searchsorted``, at blocks 64, 512 and 4,096, with occurrences on
  the first and last byte of a block and in the zero-padded last tile.

The tests marked ``cuda`` hold the kernel against the plain loop on the
card, every ``DRResult`` leaf bitwise: P in {1, 3, 16} x Q in {1, 2, 4, 8,
64} x tf-idf / BM25, budgets, k from 1 to past the hits and past shared
memory, rows that stop at different trips, a row with an absent word and a
row of stopwords, 1-, 2- and 3-byte words at blocks 64 and 4,096, and the
engine's one launch per batch.  They skip without a GPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import drb as r_drb
from repro.core import scdc as r_scdc
from repro.core import scoring as r_scoring
from repro.core import wtbc as r_wtbc
from repro.text import corpus as r_corpus
from repro_torch.core import bytemap, drb, scoring, wtbc
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import backend
from repro_torch.kernels import drb_walk as walk

torch.set_num_threads(1)

MEASURES = {"tfidf": (r_scoring.TfIdf(), scoring.TfIdf()),
            "bm25": (r_scoring.BM25(), scoring.BM25())}
LEAVES = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
          "padded", "certified", "bound")
_BUILDS = {}


def three_level(block: int, device: str = "cpu"):
    """(corpus, model, port idx, port aux) over a corpus coded with s = 4
    stoppers, so its words have codewords of 1, 2 and 3 bytes; three
    frequent words are stored without a bitmap (stopwords).  Memoized."""
    key = (block, device)
    if key not in _BUILDS:
        cp = r_corpus.make_corpus(n_docs=300, mean_doc_len=60,
                                  vocab_size=3000, seed=7)
        flat = np.concatenate(cp.doc_tokens)
        fitted = r_scdc.fit(np.bincount(np.concatenate(
            [flat, np.zeros(cp.n_docs, np.int64)]), minlength=cp.vocab_size))
        codes, lens = r_scdc.encode_table(4, fitted.vocab_size)
        model = dataclasses.replace(fitted, s=4, c=252, codes=codes, lens=lens)
        idx = wtbc.build_index_with_model(cp.doc_tokens, model, block=block,
                                          device=device)
        has_bm = idx.df.cpu().numpy() > 0
        has_bm[[1, 2, 5]] = False
        aux = drb.build_aux(idx, model, cp.doc_tokens,
                            has_bm_override=has_bm)
        _BUILDS[key] = (cp, model, idx, aux)
    return _BUILDS[key]


def rows(cp, model, idx, aux, rng, B, Q, *, special=True):
    """(B, Q) word ranks and mask.  Each row takes up to Q words of one
    document (so conjunctions have hits), some left unmasked in the middle;
    with ``special``, row 1 holds a word absent from the collection, row 2
    only stopwords, row 3 the rarest words of a long document."""
    df = idx.df.cpu().numpy()
    has_bm = aux.has_bm.cpu().numpy()
    words = np.zeros((B, Q), np.int32)
    mask = np.zeros((B, Q), bool)
    for b in range(B):
        doc = cp.doc_tokens[rng.integers(0, cp.n_docs)]
        pool = np.unique(model.rank_of_word[doc])
        pool = pool[has_bm[pool]]
        n = min(Q, len(pool), 1 + b % 4 if Q > 1 else 1)
        if b == 0:
            n = min(Q, len(pool))
        pick = rng.choice(pool, n, replace=False)
        at = np.sort(rng.choice(Q, n, replace=False))
        words[b, at] = pick
        mask[b, at] = True
    if special and B >= 4:
        absent = np.flatnonzero(df == 0)
        words[1, 0], mask[1, 0] = absent[0], True
        words[2], mask[2] = 0, False
        stop = np.flatnonzero(~has_bm & (df > 0))
        stop = stop[stop != 0]
        words[2, :min(Q, 2)] = stop[:min(Q, 2)]
        mask[2, :min(Q, 2)] = True
        long_doc = max(range(cp.n_docs), key=lambda d: len(cp.doc_tokens[d]))
        pool = np.unique(model.rank_of_word[cp.doc_tokens[long_doc]])
        pool = pool[has_bm[pool]]
        pool = pool[np.argsort(df[pool], kind="stable")][:Q]
        words[3], mask[3] = 0, False
        words[3, :len(pool)], mask[3, :len(pool)] = pool, True
    return words, mask


def search(idx, aux, words, mask, measure: str, kernel_backend="auto", **kw):
    m = MEASURES[measure][1]
    avg = scoring.avg_doc_len(idx.doc_len.cpu().numpy(), idx.n_docs)
    dev = idx.device
    return drb.topk_drb_and(idx, aux, torch.from_numpy(words).to(dev),
                            torch.from_numpy(mask).to(dev), m,
                            idf=m.idf(idx), avg_dl=avg,
                            kernel_backend=kernel_backend, **kw)


def query_tables(idx, aux, words, mask, measure: str):
    m = MEASURES[measure][1]
    avg = scoring.avg_doc_len(idx.doc_len.cpu().numpy(), idx.n_docs)
    return drb.and_tables(idx, aux, torch.from_numpy(words).to(idx.device),
                          torch.from_numpy(mask).to(idx.device), m,
                          m.idf(idx), avg), m


# ---------------------------------------------------------------------------
# the CPU path is the plain loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
def test_topk_drb_and_cpu_is_the_plain_loop(measure):
    cp, model, idx, aux = three_level(512)
    words, mask = rows(cp, model, idx, aux, np.random.default_rng(1), 6, 4)
    qt, m = query_tables(idx, aux, words, mask, measure)
    a = walk.init_state(qt, 7)
    b = a.clone()
    before = backend.launch_counts()
    a = walk.drb_walk(idx, aux, qt, a, m, k=7, beam_width=3, max_pops=None)
    b = walk.drb_walk_ref(idx, aux, qt, b, m, k=7, beam_width=3,
                          max_pops=None)
    res = search(idx, aux, words, mask, measure, k=7, beam_width=3)
    assert backend.launch_counts() == before
    assert int(a.cands.sum()) > 0 and int(res.n_found.sum()) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(res.iters, a.it) and torch.equal(res.pops, a.cands)
    assert torch.equal(res.scores, a.top_s)


def test_trip_of_stopped_rows_is_a_no_op():
    """The kernel runs each row until it stops; the plain loop runs extra
    trips on stopped rows, which must change nothing — budgeted rows and
    finished rows alike."""
    cp, model, idx, aux = three_level(64)
    words, mask = rows(cp, model, idx, aux, np.random.default_rng(2), 6, 4)
    for measure, max_pops in (("tfidf", None), ("bm25", 2)):
        qt, m = query_tables(idx, aux, words, mask, measure)
        st = walk.drb_walk_ref(idx, aux, qt, walk.init_state(qt, 5), m, k=5,
                               beam_width=3, max_pops=max_pops)
        assert not bool(walk.live_rows(idx, qt, st, max_pops).any())
        again = walk.drb_and_trip(idx, aux, qt, st, m, k=5, beam_width=3,
                                  max_pops=max_pops, kernel_backend="auto")
        for x, y in zip(st, again):
            assert torch.equal(x, y)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isfinite(a), np.isfinite(b))
    fin = np.isfinite(a)
    if not fin.any():
        return 0
    return int(np.abs(a[fin].view(np.int32).astype(np.int64)
                      - b[fin].view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
def test_three_level_words_match_reference(measure, P):
    """Rows of 1-, 2- and 3-byte words through the plain walk against the
    reference: integer leaves bitwise, scores within Q/2 ulps (tf-idf) and
    Q/2 + 2 (BM25), documents equal where no two scores of a row are that
    close."""
    cp, model, idx, aux = three_level(64)
    ridx = r_wtbc.build_index_with_model(cp.doc_tokens, model, block=64)
    raux = r_drb.build_aux(ridx, model, cp.doc_tokens,
                           has_bm_override=aux.has_bm.numpy())
    cw_len = idx.cw_len.numpy()
    words, mask = rows(cp, model, idx, aux, np.random.default_rng(3 + P), 6,
                       4)
    assert {1, 2, 3} <= set(cw_len[words[mask]].tolist())
    rm, pm = MEASURES[measure]
    ridf = np.array(rm.idf(ridx))
    ravg = jnp.sum(ridx.doc_len.astype(jnp.float32)) \
        / ridx.n_docs.astype(jnp.float32)
    want = jax.vmap(lambda w, m: r_drb.topk_drb_and(
        ridx, raux, w, m, rm, k=6, idf=jnp.asarray(ridf), avg_dl=ravg,
        beam_width=P))(jnp.asarray(words), jnp.asarray(mask))
    got = drb.topk_drb_and(idx, aux, torch.from_numpy(words),
                           torch.from_numpy(mask), pm, k=6,
                           idf=torch.from_numpy(ridf),
                           avg_dl=torch.tensor(np.float32(ravg)),
                           beam_width=P)
    assert int(got.n_found.sum()) > 0
    for n in ("n_found", "iters", "pops", "overflowed", "padded",
              "certified", "bound"):
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(want, n)),
                                      err_msg=n)
    tol = 2 + (2 if measure == "bm25" else 0)
    assert _ulps(got.scores.numpy(), want.scores) <= tol
    for b in range(words.shape[0]):
        s = np.asarray(want.scores[b])
        s = np.sort(s[np.isfinite(s)].view(np.int32).astype(np.int64))
        if not np.any((np.diff(s) > 0) & (np.diff(s) <= 2 * tol)):
            np.testing.assert_array_equal(got.docs[b].numpy(),
                                          np.asarray(want.docs[b]))


# ---------------------------------------------------------------------------
# plain mirrors of the kernel's device searches
# ---------------------------------------------------------------------------

def lower_bound32(a: np.ndarray, target: int) -> tuple[int, int]:
    """``warp_lower_bound``: the number of a[i] < target (a non-decreasing)
    by a 32-ary search, one probe per lane a round; (answer, rounds)."""
    lo, hi, rounds = 0, len(a), 0
    lanes = np.arange(32)
    while lo < hi:
        step = (hi - lo + 31) // 32
        i = lo + lanes * step
        t = (i < hi) & (a[np.minimum(i, len(a) - 1)] < target)
        m = int(t.sum())
        assert t[:m].all()                    # a prefix of the lanes
        if m == 0:
            hi = lo
        else:
            lo, hi = lo + (m - 1) * step + 1, min(hi, lo + m * step)
        rounds += 1
    return lo, rounds


def select_mirror(data: np.ndarray, counts: np.ndarray, length: int,
                  block: int, byte: int, j: int) -> int:
    """``warp_select``: the block by ``lower_bound32`` over the byte's
    counter column, then passes of 4,096 bytes over the block's logical
    bytes: eight 512-byte chunks (one warp load each, 16 bytes a lane) whose
    sums pick the chunk, a prefix sum over its lanes' counts the lane, and
    the lane the byte."""
    n_blocks = counts.shape[0] - 1
    blk = lower_bound32(counts[:n_blocks, byte], j)[0] - 1
    if j < 1 or j > counts[n_blocks, byte]:
        return length
    need = j - int(counts[blk, byte])
    start = blk * block
    valid = min(block, length - start)
    tile = data[start:start + block]
    for b0 in range(0, valid, 4096):
        for i in range(8):
            shares = [tile[c:max(c, min(c + 16, valid))]
                      for c in b0 + 16 * (32 * i + np.arange(32))]
            cnt = np.array([int(np.count_nonzero(x == byte)) for x in shares])
            if cnt.sum() < need:
                need -= int(cnt.sum())
                continue
            incl = np.cumsum(cnt)
            t = int(np.argmax(incl >= need))
            rem = need - (incl[t] - cnt[t])
            at = np.flatnonzero(shares[t] == byte)[rem - 1]
            return start + b0 + 16 * (32 * i + t) + int(at)
    return length


@pytest.mark.parametrize("block", [64, 512, 4096])
def test_select_mirror_matches_bytemap_select(block):
    rng = np.random.default_rng(block)
    length = 5 * block + block // 2 + 3          # a zero-padded last tile
    data = rng.choice(np.array([0, 1, 7, 200], np.uint8), length,
                      p=[0.2, 0.5, 0.25, 0.05])
    edges = np.arange(0, length, block)
    data[edges] = 7                              # first byte of each block
    data[np.minimum(edges + block - 1, length - 1)] = 200   # last byte
    data[-1] = 0                                 # byte 0 at the logical end
    bm = bytemap.build(data, block, device="cpu")
    padded, counts = bm.data.numpy(), bm.counts.numpy()
    n_rounds = 0
    for byte in (0, 1, 7, 200, 9):
        total = int(counts[-1, byte])
        js = np.arange(0, total + 2)
        want = bytemap.select(bm, torch.full((len(js),), byte),
                              torch.from_numpy(js.astype(np.int32))).numpy()
        got = [select_mirror(padded, counts, length, block, byte, int(j))
               for j in js]
        np.testing.assert_array_equal(got, want, err_msg=f"byte {byte}")
        n_rounds = max(n_rounds, lower_bound32(counts[:-1, byte], total)[1])
    assert n_rounds <= 2                         # 6 blocks: one or two rounds


def test_lower_bound_mirror_matches_doc_search():
    """``warp_lower_bound`` over ``sep_pos`` is ``doc_of_pos``
    (searchsorted to the left), in at most ceil(log32(n_docs)) + 1
    rounds."""
    cp, model, idx, aux = three_level(512)
    sep = idx.sep_pos.numpy()
    rng = np.random.default_rng(4)
    pos = np.concatenate([[0, idx.n - 1, idx.n], sep, sep + 1, sep - 1,
                          rng.integers(0, idx.n, 500)])
    want = wtbc.doc_of_pos(idx, torch.from_numpy(pos.astype(np.int32)))
    got = [lower_bound32(sep, int(p)) for p in pos]
    np.testing.assert_array_equal([g[0] for g in got], want.numpy())
    assert max(g[1] for g in got) <= int(np.ceil(np.log(idx.n_docs)
                                                 / np.log(32))) + 1


def test_workspace_and_scoring_arguments():
    """The wrapper's workspace size and the scoring constants it passes:
    the host's float32 roundings of ``core/scoring.py``; only tf-idf and
    BM25 have a kernel."""
    assert walk.ws_bytes(3, 1, 10) == 4 * (60 + 6 + 6 + 40)
    assert walk.ws_bytes(64, 16, 1000) <= walk.MAX_SHARED_WS
    qt = walk.DRBQuery(*(None,) * 6, torch.tensor(np.float32(5.5)))
    bm, avg_p, omb, b, k1p1, k1 = walk.scoring_args(
        scoring.BM25(k1=1.3, b=0.7), qt.avg, torch.device("cpu"))
    assert bm == 1 and avg_p == qt.avg.data_ptr()
    assert (omb, b, k1p1, k1) == tuple(float(np.float32(x)) for x in
                                       (1.0 - 0.7, 0.7, 1.3 + 1.0, 1.3))
    assert walk.scoring_args(scoring.TfIdf(), qt.avg, None)[:2] == (0, None)
    with pytest.raises(ValueError, match="no kernel scores"):
        walk.scoring_args(object(), qt.avg, None)
    assert [walk.budget_arg(x) for x in (None, -3, -1, 0, 7)] == \
        [-1, 0, 0, 0, 7]


def test_negative_budget_stops_every_row_at_once():
    """A budget below 0 is a budget of 0 in the plain loop (no row takes a
    trip), which is what the kernel gets from ``budget_arg``."""
    cp, model, idx, aux = three_level(512)
    words, mask = rows(cp, model, idx, aux, np.random.default_rng(4), 6, 4)
    for measure in ("tfidf", "bm25"):
        neg = search(idx, aux, words, mask, measure, k=5, max_pops=-1)
        zero = search(idx, aux, words, mask, measure, k=5, max_pops=0)
        for name in LEAVES:
            assert torch.equal(getattr(neg, name), getattr(zero, name)), name
        assert int(neg.iters.max()) == 0 and int(neg.n_found.max()) == 0


# ---------------------------------------------------------------------------
# on the card (skip elsewhere)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")


def card_both(block, words, mask, measure, **kw):
    """(kernel DRResult, plain DRResult) on the card; the kernel run makes
    one drb_walk launch and no K1 or K3 launch."""
    cp, model, idx, aux = three_level(block, "cuda")
    before = backend.launch_counts()
    got = search(idx, aux, words, mask, measure, **kw)
    after = backend.launch_counts()
    assert after["drb_walk"] - before["drb_walk"] == 1
    assert after["wavelet_count"] == before["wavelet_count"]
    assert after["bitmap_rank1"] == before["bitmap_rank1"]
    want = search(idx, aux, words, mask, measure, kernel_backend="ref", **kw)
    torch.cuda.synchronize()
    for name in LEAVES:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    return got, want


CARD_SWEEP = [(P, Q, m) for P in (1, 3, 16) for Q in (1, 2, 4, 8, 64)
              for m in ("tfidf", "bm25")]


@pytest.mark.cuda
@pytest.mark.parametrize("P,Q,measure", CARD_SWEEP)
def test_drb_walk_kernel_matches_plain_on_card(P, Q, measure):
    _need_card()
    cp, model, idx, aux = three_level(512, "cuda")
    words, mask = rows(cp, model, idx, aux,
                       np.random.default_rng(CARD_SWEEP.index((P, Q, measure))),
                       8, Q, special=Q >= 2)
    got, _ = card_both(512, words, mask, measure, k=10, beam_width=P)
    assert int(got.pops.sum()) > 0
    if Q >= 2:
        assert int(got.n_found[1]) == 0 and int(got.n_found[2]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("max_pops,k,measure", [
    (1, 10, "tfidf"), (7, 10, "bm25"), (7, 1, "tfidf"), (None, 1, "bm25"),
    (None, 1000, "tfidf"), (None, 300, "bm25"), (-1, 10, "bm25")])
def test_drb_walk_kernel_budgets_and_k_on_card(max_pops, k, measure):
    """Budgets stop rows at different trips (a negative one before the
    first); k = 1, 10, past the hits (300 and 1,000 slots, -1 padded) all
    bitwise."""
    _need_card()
    cp, model, idx, aux = three_level(512, "cuda")
    words, mask = rows(cp, model, idx, aux, np.random.default_rng(k), 8, 4)
    mask[4:, 1:] = False            # single-word rows: long walks, many hits
    got, _ = card_both(512, words, mask, measure, k=k, beam_width=3,
                       max_pops=max_pops)
    if max_pops is not None:
        assert int(got.pops.max()) >= max_pops
    if k >= 300:
        assert int(got.n_found.max()) < k


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 4096])
def test_drb_walk_kernel_blocks_and_levels_on_card(block):
    """Words of 1-, 2- and 3-byte codewords, so every level's device select
    runs, at blocks 64 (many blocks per level) and 4,096."""
    _need_card()
    cp, model, idx, aux = three_level(block, "cuda")
    cw_len = idx.cw_len.cpu().numpy()
    words, mask = rows(cp, model, idx, aux, np.random.default_rng(block), 8, 4)
    assert {1, 2, 3} <= set(cw_len[words[mask]].tolist())
    for measure in ("tfidf", "bm25"):
        for P in (1, 16):
            card_both(block, words, mask, measure, k=8, beam_width=P)


@pytest.mark.cuda
def test_drb_walk_kernel_scratch_workspace_on_card():
    """A k whose top-k buffers pass the shared-memory workspace: the
    kernel's workspace goes to device scratch."""
    _need_card()
    cp, model, idx, aux = three_level(512, "cuda")
    k = 60_000
    assert walk.ws_bytes(4, 3, k) > walk.MAX_SHARED_WS
    words, mask = rows(cp, model, idx, aux, np.random.default_rng(9), 4, 4)
    mask[:, 1:] = False
    got, _ = card_both(512, words, mask, "bm25", k=k, beam_width=3)
    assert int(got.n_found.max()) > 10


@pytest.mark.cuda
@pytest.mark.parametrize("measure", ["tfidf", "bm25"])
def test_engine_drb_and_is_one_launch_on_card(measure):
    """``search(mode="and", strategy="drb")`` on the card: one drb_walk
    launch per batch, no wavelet_count or bitmap_rank1 launch, and the
    plain walk's answer."""
    _need_card()
    cp = r_corpus.make_corpus(n_docs=300, mean_doc_len=60, vocab_size=800,
                              seed=21)
    eng = SearchEngine.build(cp, EngineConfig(block=512), device="cuda")
    rng = np.random.default_rng(5)
    queries = [[int(x) for x in rng.choice(np.unique(cp.doc_tokens[d]), 2,
                                           replace=False)]
               for d in rng.integers(0, cp.n_docs, 6)]
    eng.search(queries, k=8, mode="and", strategy="drb", measure=measure)
    before = backend.launch_counts()
    res = eng.search(queries, k=8, mode="and", strategy="drb",
                     measure=measure)
    after = backend.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "drb_walk") for n in after}
    ranks, masks = eng._encode_queries(queries)
    m = eng._resolve_measure(measure)
    want = drb.topk_drb_and(
        eng.idx, eng.aux, torch.from_numpy(ranks).cuda(),
        torch.from_numpy(masks).cuda(), m, k=8, idf=eng._idf_table(m),
        avg_dl=scoring.avg_doc_len(eng.idx.doc_len.cpu().numpy(),
                                   eng.idx.n_docs),
        kernel_backend="ref")
    assert torch.equal(res.docs, want.docs)
    assert torch.equal(res.scores, want.scores)
    assert int(res.n_found.sum()) > 0
