"""The port's two kernels' plain versions against the JAX reference (CPU).

* ``wavelet_count`` (K1): the plain batched descent against the reference's
  Pallas kernel run as its own tests run it on a CPU (TPU lowering under the
  interpreter), over seeds and blocks;
* ``beam_loop`` (K2): the mega core's plain loop (``topk_dr_mega`` on CPU
  tensors) against ``repro.core.mega.topk_dr_mega(fused=None)`` — a seeded
  sweep over and/or, B in {2, 4, 8}, Q in {4, 8}, every leaf bitwise — plus
  the edge rows of the reference's fused-step tests (empty ranges and
  conjunctive misses, the undersized-pool overflow latch, a pop budget);
* the pool frontier's pops and bulk pushes against the reference heap;
* device-driven selection: CPU tensors never launch a kernel, and the index
  builders default to the card;
* the nearer-end rank identity the kernels' descent relies on, at every
  position, against the plain and the reference rank.

The kernels themselves build and run only on a GPU; the tests marked
``cuda`` compare them with their plain versions there (K1 at tile-edge
triples, K2 at caps and query widths around its shared-memory summaries)
and skip elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heap as r_heap
from repro.core import mega as r_mega
from repro.core import scoring as r_scoring
from repro.core import wtbc as r_wtbc
from repro.kernels import wavelet_descent as r_wd
from repro.text import corpus as r_corpus
from repro_torch.core import bitvec, bytemap, scoring
from repro_torch.core import heap as p_heap
from repro_torch.core import mega as p_mega
from repro_torch.core import wtbc as p_wtbc
from repro_torch.kernels import backend, beam_step, wavelet_descent

torch.set_num_threads(1)

LEAVES = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
          "certified", "bound")
_BUILDS = {}


def builds(block: int, spec=(120, 60, 500, 3)):
    """(corpus, reference idx, reference model, port idx), memoized."""
    key = (block, spec)
    if key not in _BUILDS:
        n, mean, vocab, seed = spec
        cp = r_corpus.make_corpus(n_docs=n, mean_doc_len=mean,
                                  vocab_size=vocab, seed=seed)
        ridx, rmodel = r_wtbc.build_index(cp.doc_tokens, cp.vocab_size,
                                          block=block)
        pidx, _ = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size,
                                     block=block, device="cpu")
        _BUILDS[key] = (cp, ridx, rmodel, pidx)
    return _BUILDS[key]


def assert_leaves_equal(got, want, names=LEAVES, msg=""):
    for name in names:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{name} {msg}")


# ---------------------------------------------------------------------------
# K1: wavelet_count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block", [512, 4096])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wavelet_count_plain_matches_jax_kernel(seed, block):
    _, ridx, _, pidx = builds(block)
    rng = np.random.default_rng(seed)
    n, M = pidx.n, 48
    w = rng.integers(0, pidx.vocab_size, M).astype(np.int32)
    lo = rng.integers(0, n + 1, M)
    hi = np.minimum(n, lo + rng.integers(0, 2 * block, M))
    lo[:4] = hi[:4]                               # empty ranges
    hi[4:8] = n                                   # to the end
    lo[8:12], hi[8:12] = 0, n                     # the whole collection
    lo, hi = lo.astype(np.int32), hi.astype(np.int32)
    before = backend.launch_counts()
    got = wavelet_descent.wavelet_count(
        pidx.levels, pidx.cw, pidx.cw_len, pidx.node_off, pidx.base_rank,
        torch.from_numpy(w), torch.from_numpy(lo), torch.from_numpy(hi))
    assert backend.launch_counts() == before      # CPU tensors: plain path
    want = r_wd.wavelet_descent(
        ridx.levels, ridx.cw, ridx.cw_len, ridx.node_off, ridx.base_rank,
        jnp.asarray(w), jnp.asarray(lo), jnp.asarray(hi), block=block,
        lowering="tpu", interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_selection_follows_device():
    t = torch.zeros(3)
    assert not backend.use_kernel(t, "auto")
    assert not backend.use_kernel(t, "ref")
    with pytest.raises(ValueError, match="kernel_backend"):
        backend.use_kernel(t, "tpu")
    with pytest.raises(ValueError, match="no kernel"):
        backend.use_kernel(torch.zeros(3, device="meta"), "auto")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.resolve_device(None)
    assert backend.resolve_device("cpu").type == "cpu"


def _near_rank_np(padded, counts, length, block, byte, pos):
    """The nearer-end rank of ``csrc/wtbc_descent.cuh`` (warp_rank_near) in
    numpy: p's tile counted from its start up to p, or — when p lies past
    the middle of the tile's logical bytes — from p up to the tile's last
    logical byte, subtracted from the next counter row.  Returns the ranks
    and whether each came from the back."""
    n_blocks = counts.shape[0] - 1
    blk = np.minimum(pos // block, n_blocks - 1)
    start = blk * block
    cut = pos - start
    valid = np.minimum(block, length - start)
    back = cut > valid // 2
    csum = np.concatenate([[0], np.cumsum(padded == byte)])
    suffix = csum[start + valid] - csum[start + cut]
    prefix = csum[start + cut] - csum[start]
    assert np.all(np.where(back, valid - cut, cut) <= (valid + 1) // 2)
    rank = np.where(back, counts[blk + 1, byte] - suffix,
                    counts[blk, byte] + prefix)
    return rank, back


@pytest.mark.parametrize("block,length", [
    (64, 64 * 5 + 37), (64, 64 * 6), (512, 512 * 3 + 101), (512, 512 * 4),
    (4096, 4096 * 2 + 1500), (4096, 4096 * 2), (512, 300), (64, 0)])
def test_nearer_end_rank_identity(block, length):
    """counts[blk + 1] - #(tile[cut, valid)) is the rank at every position,
    for the bytes that occur (byte 0 too, which the zero padding of the last
    tile would add if the suffix ran past the tile's logical bytes) and one
    that does not: equal to the port's plain rank and to the reference's.
    Every position covers p = length (at a block edge where length is a
    multiple of the block) and cut = valid / 2 - 1, valid / 2, valid / 2 + 1."""
    import jax
    from repro.core import bytemap as r_bytemap
    rng = np.random.default_rng(block + length)
    data = rng.integers(0, 4, length).astype(np.uint8)
    pbm = bytemap.build(data, block=block, device="cpu")
    rbm = r_bytemap.build(data, block=block)
    padded, counts = pbm.data.numpy(), pbm.counts.numpy()
    pos = np.arange(length + 1)
    r_rank = jax.jit(jax.vmap(lambda b, p: r_bytemap.rank(rbm, b, p)))
    for byte in (0, 1, 2, 3, 9):
        near, back = _near_rank_np(padded, counts, length, block, byte, pos)
        plain = bytemap.rank(pbm, torch.full((len(pos),), byte,
                                             dtype=torch.int32),
                             torch.from_numpy(pos.astype(np.int32))).numpy()
        want = np.concatenate([np.asarray(r_rank(
            jnp.full(len(c), byte, jnp.int32), jnp.asarray(c, jnp.int32)))
            for c in np.array_split(pos, max(1, len(pos) // 2048))])
        np.testing.assert_array_equal(near, plain, err_msg=f"byte {byte}")
        np.testing.assert_array_equal(near, want, err_msg=f"byte {byte}")
        np.testing.assert_array_equal(
            near, [np.count_nonzero(data[:p] == byte) for p in pos])
    if length:
        assert back.any() and (~back).any()


def test_builders_default_to_the_card():
    """Without ``device`` the index builders place their arrays on the card,
    and raise when there is none."""
    cp = r_corpus.make_corpus(n_docs=8, mean_doc_len=10, vocab_size=40, seed=0)
    data = np.arange(100, dtype=np.uint8)
    model = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=64,
                               device="cpu")[1]
    calls = (lambda: p_wtbc.build_index(cp.doc_tokens, cp.vocab_size,
                                        block=64)[0].device,
             lambda: p_wtbc.build_index_with_model(cp.doc_tokens, model,
                                                   block=64).device,
             lambda: bytemap.build(data, block=64).data.device,
             lambda: bitvec.build(np.array([1, 5]), 40).words.device)
    for call in calls:
        if torch.cuda.is_available():
            assert call().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_kernel_argument_checks():
    """What the device code assumes is checked before any launch."""
    data = np.random.default_rng(0).integers(0, 5, 700).astype(np.uint8)
    good = bytemap.build(data, block=512, device="cpu")
    bad_block = bytemap.build(data, block=200, device="cpu")
    assert wavelet_descent.level_args((good,) * 3)[-1] == 512
    with pytest.raises(ValueError, match="multiple of 16"):
        wavelet_descent.level_args((bad_block,) * 3)
    with pytest.raises(ValueError, match="block size"):
        wavelet_descent.level_args(
            (good, good, bytemap.build(data, block=1024, device="cpu")))
    _, _, _, pidx = builds(512)
    with pytest.raises(ValueError, match="cw"):
        wavelet_descent.table_args(pidx.cw.to(torch.int32), pidx.cw_len,
                                   pidx.node_off, pidx.base_rank)


# ---------------------------------------------------------------------------
# K2: beam_loop (the mega core's loop)
# ---------------------------------------------------------------------------

def _batch(cp, rmodel, rng, B, Q, n_words=3):
    df = cp.doc_freqs()
    pool = np.flatnonzero((df >= 2) & (df <= 60))
    ids = np.stack([rng.choice(pool, n_words, replace=False) for _ in range(B)])
    words = np.zeros((B, Q), np.int32)
    words[:, :n_words] = rmodel.rank_of_word[ids]
    mask = np.zeros((B, Q), bool)
    mask[:, :n_words] = True
    return words, mask


def _run_both(ridx, pidx, words, mask, *, k, conjunctive, cap, max_pops=None):
    ridf = np.array(r_scoring.TfIdf().idf(ridx))
    want = r_mega.topk_dr_mega(ridx, jnp.asarray(words), jnp.asarray(mask),
                               jnp.asarray(ridf), k=k, conjunctive=conjunctive,
                               cap=cap, max_pops=max_pops, fused=None)
    before = backend.launch_counts()
    got = p_mega.topk_dr_mega(pidx, torch.from_numpy(words),
                              torch.from_numpy(mask), torch.from_numpy(ridf),
                              k=k, conjunctive=conjunctive, cap=cap,
                              max_pops=max_pops)
    assert backend.launch_counts() == before
    return got, want


@pytest.mark.parametrize("Q", [4, 8])
@pytest.mark.parametrize("B", [2, 4, 8])
@pytest.mark.parametrize("mode", ["and", "or"])
def test_mega_plain_loop_matches_reference(mode, B, Q):
    cp, ridx, rmodel, pidx = builds(512)
    rng = np.random.default_rng(100 + 10 * B + Q + (mode == "or"))
    for case in range(2):
        words, mask = _batch(cp, rmodel, rng, B, Q, n_words=3 if case else Q - 1)
        got, want = _run_both(ridx, pidx, words, mask, k=8,
                              conjunctive=mode == "and", cap=pidx.n_docs + 2)
        assert_leaves_equal(got, want, msg=f"{mode} B={B} Q={Q} case {case}")


def test_mega_empty_range_and_conjunctive_miss():
    """Rare-word AND rows that intersect to nothing (n_found = 0) and rows
    mixing hit and miss words."""
    cp, ridx, rmodel, pidx = builds(512)
    df = cp.doc_freqs()
    ids = np.arange(1, len(df))
    rare = ids[df[ids] == 1][:3]
    commons = ids[np.argsort(-df[ids])][:2]
    assert len(rare) == 3
    rows = [list(rare), list(commons) + [rare[0]], [rare[0]] + list(commons),
            list(commons) + [rare[1]]]
    words = rmodel.rank_of_word[np.array(rows)].astype(np.int32)
    words = np.pad(words, ((0, 0), (0, 1)))
    mask = np.pad(np.ones((4, 3), bool), ((0, 0), (0, 1)))
    got, want = _run_both(ridx, pidx, words, mask, k=8, conjunctive=True,
                          cap=pidx.n_docs + 2)
    assert_leaves_equal(got, want, msg="edge rows")


def test_mega_overflow_latch_matches_reference():
    """An undersized pool drops inserts and latches per-row overflow exactly
    as the reference does (cap = 2: the root fills slot 0)."""
    spec = (12, 20, 60, 2)
    cp, ridx, rmodel, pidx = builds(512, spec)
    df = cp.doc_freqs()
    pool = np.flatnonzero(df >= 4)
    q = pool[pool >= 1][:3]
    words = np.pad(rmodel.rank_of_word[q][None], ((0, 1), (0, 1))).astype(np.int32)
    words[1, :3] = words[0, :3]
    mask = np.zeros((2, 4), bool)
    mask[:, :3] = True
    got, want = _run_both(ridx, pidx, words, mask, k=5, conjunctive=False,
                          cap=2)
    assert bool(np.asarray(want.overflowed).any())
    assert_leaves_equal(got, want, msg="overflow latch")


@pytest.mark.parametrize("mode", ["and", "or"])
def test_mega_budget_rows_match_reference(mode):
    """A pop budget stops rows independently; harvest and certification
    follow the reference's anytime epilogue."""
    cp, ridx, rmodel, pidx = builds(512)
    words, mask = _batch(cp, rmodel, np.random.default_rng(7), 4, 4)
    got, want = _run_both(ridx, pidx, words, mask, k=8,
                          conjunctive=mode == "and", cap=pidx.n_docs + 2,
                          max_pops=3)
    assert_leaves_equal(got, want, msg=f"budget {mode}")


def test_beam_loop_cpu_is_the_plain_loop():
    cp, ridx, rmodel, pidx = builds(512)
    words, mask = _batch(cp, rmodel, np.random.default_rng(3), 2, 4)
    w, m = torch.from_numpy(words), torch.from_numpy(mask)
    idf = scoring.TfIdf().idf(pidx)
    idf_w = torch.where(m, idf[w.long()], 0.0)
    kw = dict(k=6, conjunctive=False, cap=pidx.n_docs + 2,
              kernel_backend="auto")
    a = p_mega.init_state(pidx, w, m, idf_w, **kw)
    b = a.clone()
    before = backend.launch_counts()
    a = beam_step.beam_loop(pidx, a, w, m, idf_w, k=6, conjunctive=False,
                            max_pops=None)
    b = beam_step.beam_loop_ref(pidx, b, w, m, idf_w, k=6, conjunctive=False,
                                max_pops=None)
    assert backend.launch_counts() == before
    assert int(a.pops.sum()) > 0
    for x, y in zip((*a.pool, *a[1:]), (*b.pool, *b[1:])):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the pool frontier against the reference heap
# ---------------------------------------------------------------------------

def test_pool_pops_and_pushes_match_reference_heap():
    """Bulk pushes into a capacity-5 frontier (drop + overflow latch past
    capacity), then pops in the total order, ties included."""
    rng = np.random.default_rng(9)
    m = 7
    s = rng.choice([1.0, 2.0, 3.0], m).astype(np.float32)
    d0 = rng.permutation(20)[:m].astype(np.int32)
    d1 = d0 + rng.integers(1, 4, m).astype(np.int32)
    en = np.array([1, 1, 0, 1, 1, 1, 1], bool)
    tf = rng.integers(0, 9, (m, 2)).astype(np.int32)
    h = r_heap.make(5, 4)
    h = r_heap.push_many(h, jnp.asarray(s), jnp.asarray(
        np.concatenate([d0[:, None], d1[:, None], tf], 1)), jnp.asarray(en))
    rs, rp, rv, h = r_heap.pop_p(h, 6)
    pool = p_heap.make_pool(1, 5, 2, "cpu")
    p_heap.push_many(pool, torch.from_numpy(s)[None], torch.from_numpy(d0)[None],
                     torch.from_numpy(d1)[None], torch.from_numpy(tf)[None],
                     torch.from_numpy(en)[None])
    assert bool(pool.overflowed[0]) == bool(h.overflowed) is True
    ps, p0, p1, ptf, pv = p_heap.pop_p(pool, 6, torch.ones(1, dtype=torch.bool))
    np.testing.assert_array_equal(pv[0].numpy(), np.asarray(rv))
    n = int(np.asarray(rv).sum())
    np.testing.assert_array_equal(ps[0].numpy(), np.asarray(rs))
    np.testing.assert_array_equal(p0[0, :n].numpy(), np.asarray(rp)[:n, 0])
    np.testing.assert_array_equal(p1[0, :n].numpy(), np.asarray(rp)[:n, 1])
    np.testing.assert_array_equal(ptf[0, :n].numpy(), np.asarray(rp)[:n, 2:])
    assert int(pool.size[0]) == int(h.size) == 0


def test_lex_argmax_matches_reference():
    rng = np.random.default_rng(4)
    s = rng.choice([0.5, 1.0, 1.0], (6, 9)).astype(np.float32)
    d0 = rng.integers(0, 4, (6, 9)).astype(np.int32)
    d1 = rng.integers(0, 4, (6, 9)).astype(np.int32)
    valid = rng.random((6, 9)) < 0.6
    valid[0] = False                       # all-invalid row -> index 0
    want = np.asarray(r_heap.lex_argmax(jnp.asarray(s), jnp.asarray(d0),
                                        jnp.asarray(d1), jnp.asarray(valid)))
    got = p_heap.lex_argmax(torch.from_numpy(s), torch.from_numpy(d0),
                            torch.from_numpy(d1), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 0


# ---------------------------------------------------------------------------
# on the card (skip elsewhere)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")


@pytest.mark.cuda
def test_wavelet_count_kernel_matches_plain_on_card():
    _need_card()
    cp = r_corpus.make_corpus(n_docs=120, mean_doc_len=60, vocab_size=500,
                              seed=3)
    idx, _ = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=512,
                                device="cuda")
    rng = np.random.default_rng(0)
    M = 500
    w = torch.from_numpy(rng.integers(0, idx.vocab_size, M).astype(np.int32)).cuda()
    lo = rng.integers(0, idx.n + 1, M)
    hi = np.minimum(idx.n, lo + rng.integers(0, 3000, M))
    lo, hi = (torch.from_numpy(x.astype(np.int32)).cuda() for x in (lo, hi))
    args = (idx.levels, idx.cw, idx.cw_len, idx.node_off, idx.base_rank, w,
            lo, hi)
    got = wavelet_descent.wavelet_count(*args)
    want = wavelet_descent.wavelet_count(*args, kernel_backend="ref")
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["and", "or"])
def test_beam_loop_kernel_matches_plain_on_card(mode):
    _need_card()
    cp, ridx, rmodel, _ = builds(512)
    idx, _ = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=512,
                                device="cuda")
    words, mask = _batch(cp, rmodel, np.random.default_rng(1), 8, 4)
    idf = scoring.TfIdf().idf(idx)
    w, m = torch.from_numpy(words).cuda(), torch.from_numpy(mask).cuda()
    kw = dict(k=8, conjunctive=mode == "and", cap=idx.n_docs + 2)
    got = p_mega.topk_dr_mega(idx, w, m, idf, **kw)
    want = p_mega.topk_dr_mega(idx, w, m, idf, kernel_backend="ref", **kw)
    for name in LEAVES:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _block_edge_triples(idx, rng, n_words=24):
    """(words, los, his) whose endpoints land on tile edges: root positions
    at every block edge and one either side (and at n, and lo = hi), and,
    for words of two or more levels, root positions chosen by select so that
    the level-1 position is a block edge or one either side of it."""
    n, block = idx.n, idx.levels[0].block
    edges = np.arange(0, n + 1, block)
    pos0 = np.unique(np.clip(np.concatenate([edges - 1, edges, edges + 1,
                                             [n]]), 0, n))
    deep = torch.nonzero(idx.cw_len >= 2).reshape(-1).numpy()
    words = rng.choice(deep, min(n_words, len(deep)), replace=False)
    w_out, lo_out, hi_out = [], [], []
    for w in words:
        p1 = rng.permutation(pos0)
        w_out.append(np.full(len(pos0), w))
        lo_out.append(np.minimum(pos0, p1))
        hi_out.append(np.maximum(pos0, p1))
        # level 1: root endpoint x with rank0(x) - base0 = E - off1
        lv1 = idx.levels[1]
        e1 = np.arange(0, lv1.length + 1, lv1.block)
        off1 = int(idx.node_off[w, 1])
        t = np.concatenate([e1 - 1, e1, e1 + 1]) - off1
        occ = int(idx.levels[0].counts[-1, int(idx.cw[w, 0])]) - int(
            idx.base_rank[w, 0])
        t = t[(t >= 1) & (t <= occ)]
        if len(t) == 0:
            continue
        j = torch.from_numpy((t + int(idx.base_rank[w, 0])).astype(np.int32))
        x = bytemap.select(idx.levels[0], torch.full_like(j, int(idx.cw[w, 0])),
                           j).numpy() + 1
        w_out.append(np.full(len(x), w))
        lo_out.append(np.zeros(len(x), np.int64))
        hi_out.append(x)
        w_out.append(np.full(len(x), w))
        lo_out.append(x - 1)
        hi_out.append(np.full(len(x), n))
    return tuple(torch.from_numpy(np.concatenate(a).astype(np.int32))
                 for a in (w_out, lo_out, hi_out))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [64, 512])
def test_wavelet_count_kernel_block_edges_on_card(block):
    """K1 against its plain version where the nearer-end rank switches
    sides: endpoints at tile edges of levels 0 and 1, the last tile."""
    _need_card()
    cp = r_corpus.make_corpus(n_docs=200, mean_doc_len=40, vocab_size=300,
                              seed=11)
    cpu, _ = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=block,
                                device="cpu")
    idx, _ = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=block,
                                device="cuda")
    trip = [x.cuda() for x in _block_edge_triples(cpu, np.random.default_rng(5))]
    args = (idx.levels, idx.cw, idx.cw_len, idx.node_off, idx.base_rank,
            *trip)
    got = wavelet_descent.wavelet_count(*args)
    want = wavelet_descent.wavelet_count(*args, kernel_backend="ref")
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), wavelet_descent.wavelet_count(
        cpu.levels, cpu.cw, cpu.cw_len, cpu.node_off, cpu.base_rank,
        *(x.cpu() for x in trip)))


def _state_leaves(st):
    cap = st.pool.cap
    return (*(x[:, :cap] for x in st.pool[:4]), *st.pool[4:], *st[1:])


def _beam_both(idx, words, mask, *, k, conjunctive, cap, max_pops=None):
    """The kernel and the plain loop from the same initial state, on the
    index's device: every state array (the pools without their scratch
    column) bitwise."""
    dev = idx.device
    w, m = torch.from_numpy(words).to(dev), torch.from_numpy(mask).to(dev)
    idf = scoring.TfIdf().idf(idx)
    idf_w = torch.where(m, idf[w.long()], 0.0).to(torch.float32)
    st = p_mega.init_state(idx, w, m, idf_w, k=k, conjunctive=conjunctive,
                           cap=cap, kernel_backend="ref")
    kw = dict(k=k, conjunctive=conjunctive, max_pops=max_pops)
    got = beam_step.beam_loop(idx, st.clone(), w, m, idf_w, **kw)
    want = beam_step.beam_loop(idx, st.clone(), w, m, idf_w,
                               kernel_backend="ref", **kw)
    for i, (x, y) in enumerate(zip(_state_leaves(got), _state_leaves(want))):
        assert torch.equal(x, y), f"state array {i}"
    return got


# a corpus whose `or` frontiers pass 256 slots (one summary chunk)
_WIDE = (1500, 30, 2000, 5)       # docs, mean length, vocabulary, seed


def _wide_batch(Q, seed):
    """Rows of Q - 1 (at least 1) words of document frequency 100-900, and a
    last row that adds two words of one document each (a conjunctive
    miss)."""
    cp, _, rmodel, _ = builds(512, _WIDE)
    df = cp.doc_freqs()
    ids = np.arange(1, len(df))
    pool = ids[(df[ids] >= 100) & (df[ids] <= 900)]
    common = ids[np.argsort(-df[ids])][:150]
    rare = ids[df[ids] == 1]
    rng = np.random.default_rng(seed)
    nw = max(1, Q - 1)
    src = pool if nw <= len(pool) else common
    rows = [rng.choice(src, nw, replace=False) for _ in range(3)]
    rows.append(np.concatenate([rare[:2], src[:nw]])[:max(nw, min(Q, 2))])
    words = np.zeros((4, Q), np.int32)
    mask = np.zeros((4, Q), bool)
    for r, row in enumerate(rows):
        words[r, :len(row)] = rmodel.rank_of_word[row]
        mask[r, :len(row)] = True
    return cp, words, mask


def _chunk_crossed(st) -> bool:
    """Some row holds a segment past the first summary chunk."""
    return bool((st.pool.scores[:, 256:st.pool.cap] > float("-inf")).any())


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 255, 256, 257, None])
@pytest.mark.parametrize("mode", ["and", "or"])
def test_beam_loop_kernel_caps_on_card(mode, cap):
    """Caps around one summary chunk (256 slots) and n_docs + 2; the small
    ones latch overflow on `or` rows."""
    _need_card()
    cp, words, mask = _wide_batch(4, 17)
    idx, _ = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=512,
                                device="cuda")
    cap = idx.n_docs + 2 if cap is None else cap
    st = _beam_both(idx, words, mask, k=400, conjunctive=mode == "and",
                    cap=cap)
    if cap <= 257 and mode == "or":
        assert bool(st.pool.overflowed.any())


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 3, 4, 8, 64])
def test_beam_loop_kernel_queries_on_card(Q):
    """Q words per row (2·Q descent warps, past the block's 16 at Q = 64),
    and/or, with and without a pop budget; a conjunctive miss (Q >= 2);
    `or` rows whose frontier crosses a summary chunk under the budget
    (Q >= 3: one or two words keep it smaller)."""
    _need_card()
    cp, words, mask = _wide_batch(Q, Q)
    idx, _ = p_wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=512,
                                device="cuda")
    for mode in ("or", "and"):
        for budget in (None, 400):
            st = _beam_both(idx, words, mask, k=400,
                            conjunctive=mode == "and", cap=idx.n_docs + 2,
                            max_pops=budget)
            if mode == "or" and budget is not None and Q >= 3:
                assert _chunk_crossed(st)
            if mode == "and" and Q >= 2:
                assert int(st.n_out[3]) == 0          # the miss row


# ---------------------------------------------------------------------------
# the serial heap core (one query row)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["and", "or"])
def test_topk_dr_single_row_matches_reference(mode):
    """``ranked.topk_dr`` on one (Q,) row.  XLA contracts the reference's
    single-row dot into an FMA chain, so scores agree within 1 ulp; docs
    and loop counters are equal."""
    from repro.core import ranked as r_ranked
    from repro_torch.core import ranked as p_ranked
    cp, ridx, rmodel, pidx = builds(512)
    words, mask = _batch(cp, rmodel, np.random.default_rng(21), 1, 4)
    ridf = np.array(r_scoring.TfIdf().idf(ridx))
    kw = dict(k=6, conjunctive=mode == "and", heap_cap=2 * pidx.n_docs + 4)
    want = r_ranked.topk_dr(ridx, jnp.asarray(words[0]), jnp.asarray(mask[0]),
                            jnp.asarray(ridf), **kw)
    got = p_ranked.topk_dr(pidx, torch.from_numpy(words[0]),
                           torch.from_numpy(mask[0]), torch.from_numpy(ridf),
                           **kw)
    assert_leaves_equal(got, want, names=("docs", "n_found", "iters", "pops",
                                          "overflowed", "padded", "certified"))
    a, b = got.scores.numpy(), np.asarray(want.scores)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    assert np.all(np.abs(a[fin].view(np.int32).astype(np.int64)
                         - b[fin].view(np.int32).astype(np.int64)) <= 1)
