"""The heap core's routes and the ``heap_loop`` kernel module on the CPU.

* heap P = 1 (``ranked.topk_dr_batch``'s plain loop) equals the mega core
  (``mega.topk_dr_mega``, ``beam_loop``'s plain loop) on every leaf, and
  ``padded`` is 0 — the fact that lets the card run heap P = 1 on
  ``beam_loop`` — and both equal the reference's ``topk_dr_batch`` at P = 1
  bitwise (the parity contract at B >= 2, Q in {4, 8});
* ``ranked.padded_from_widths`` over the per-trip live widths the plain loop
  records equals the plain loop's in-loop ``padded`` at P = 2, 3 and 16 (the
  kernel path computes ``padded`` that way);
* CPU tensors launch no kernel;
* ``heap_loop``'s argument checks, which run before every launch;
* numpy mirrors of the kernel's block-wide pop (a radix select of the P
  best chunk summaries, then of the best slots in those chunks, sorted into
  pop order) and push placement (the enabled lanes' ranks, a scan of the
  active chunks' free counts, a binary search and a select in the chunk's
  free mask) against ``core/heap.pop_p`` and ``push_many`` on random pools.

The kernel itself runs only on a GPU:
``tests/test_torch_heap_loop_cuda.py`` holds it against the plain loop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ranked as r_ranked
from repro.core import scoring as r_scoring
from repro.core import wtbc as r_wtbc
from repro.text import corpus as r_corpus
from repro_torch.core import heap as H
from repro_torch.core import mega, ranked, wtbc
from repro_torch.kernels import backend, heap_loop

torch.set_num_threads(1)

LEAVES = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
          "certified", "bound")
_BUILDS = {}


def builds(spec=(120, 60, 500, 3)):
    """(corpus, reference idx, reference model, port idx, idf), memoized;
    the reference's idf table is carried across (parity contract)."""
    if spec not in _BUILDS:
        n, mean, vocab, seed = spec
        cp = r_corpus.make_corpus(n_docs=n, mean_doc_len=mean,
                                  vocab_size=vocab, seed=seed)
        ridx, rmodel = r_wtbc.build_index(cp.doc_tokens, cp.vocab_size,
                                          block=512)
        pidx, _ = wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=512,
                                   device="cpu")
        idf = np.array(r_scoring.TfIdf().idf(ridx))
        _BUILDS[spec] = (cp, ridx, rmodel, pidx, idf)
    return _BUILDS[spec]


def _batch(cp, rmodel, B: int, Q: int, seed: int):
    """B rows of 2..Q words of document frequency 2-60, the rest masked."""
    df = cp.doc_freqs()
    pool = np.flatnonzero((df >= 2) & (df <= 60))
    rng = np.random.default_rng(seed)
    words = np.zeros((B, Q), np.int32)
    mask = np.zeros((B, Q), bool)
    for b in range(B):
        nw = int(rng.integers(2, Q + 1))
        words[b, :nw] = rmodel.rank_of_word[rng.choice(pool, nw,
                                                       replace=False)]
        mask[b, :nw] = True
    return words, mask


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("cap", ["full", "overflow"])
@pytest.mark.parametrize("budget", [None, 3, 17])
@pytest.mark.parametrize("mode", ["and", "or"])
@pytest.mark.parametrize("B,Q", [(2, 4), (8, 4), (4, 8)])
def test_heap_p1_equals_mega_and_reference(B, Q, mode, budget, cap):
    cp, ridx, rmodel, pidx, idf = builds()
    words, mask = _batch(cp, rmodel, B, Q, seed=10 * B + Q)
    heap_cap = 2 * pidx.n_docs + 4 if cap == "full" else 6
    kw = dict(k=8, conjunctive=mode == "and", max_pops=budget)
    w, m, t_idf = (torch.from_numpy(x) for x in (words, mask, idf))
    before = backend.launch_counts()
    heap = ranked.topk_dr_batch(pidx, w, m, t_idf, heap_cap=heap_cap,
                                beam_width=1, **kw)
    pool = mega.topk_dr_mega(pidx, w, m, t_idf, cap=heap_cap, **kw)
    assert backend.launch_counts() == before
    for name in LEAVES:
        assert torch.equal(getattr(heap, name), getattr(pool, name)), name
    assert not bool(heap.padded.any())
    if cap == "overflow" and mode == "or" and budget is None:
        assert bool(heap.overflowed.any())
    want = r_ranked.topk_dr_batch(ridx, jnp.asarray(words), jnp.asarray(mask),
                                  jnp.asarray(idf), heap_cap=heap_cap,
                                  beam_width=1, **kw)
    for name in LEAVES + ("padded",):
        np.testing.assert_array_equal(getattr(heap, name).numpy(),
                                      _np(getattr(want, name)), err_msg=name)


def _plain_loop(pidx, words, mask, idf, *, P, k, conjunctive, cap,
                max_pops):
    """``topk_dr_batch``'s set-up, then the plain loop alone."""
    wm = mask.to(torch.bool)
    idf_w = torch.where(wm, idf[words.long()], 0.0).to(torch.float32)
    pool, st = ranked.init_search(pidx, words, wm, idf_w, k=k,
                                  conjunctive=conjunctive, cap=cap,
                                  kernel_backend="ref")
    return heap_loop.heap_loop_ref(pidx, pool, st, words, wm, idf_w, P=P, k=k,
                                   conjunctive=conjunctive, max_pops=max_pops)


@pytest.mark.parametrize("budget", [None, 9])
@pytest.mark.parametrize("mode", ["and", "or"])
@pytest.mark.parametrize("P", [2, 3, 16])
def test_padded_from_widths_equals_plain_loop(P, mode, budget):
    cp, ridx, rmodel, pidx, idf = builds((300, 40, 500, 4))
    words, mask = _batch(cp, rmodel, 8, 4, seed=P)
    w, m, t_idf = (torch.from_numpy(x) for x in (words, mask, idf))
    st, widths = _plain_loop(pidx, w, m, t_idf, P=P, k=20,
                             conjunctive=mode == "and",
                             cap=2 * pidx.n_docs + 4,
                             max_pops=None if budget is None else budget * P)
    assert widths.shape[1] > 0 and int(widths.max()) <= P
    # a stopped row stays stopped: each row's widths are live, then 0
    live = widths > 0
    assert torch.equal(live.sum(1, dtype=torch.int32), st.iters)
    assert torch.equal(widths.sum(1, dtype=torch.int32), st.pops)
    assert not bool((live[:, 1:] & ~live[:, :-1]).any())
    got = ranked.padded_from_widths(widths, P)
    assert torch.equal(got, st.padded)
    if P == 16:             # first trips' frontiers are narrower than P
        assert bool(got.any())
    # trailing trips with every row stopped change nothing
    pad = torch.cat([widths, torch.zeros((8, 5), dtype=torch.int32)], 1)
    assert torch.equal(ranked.padded_from_widths(pad, P), got)
    res = ranked.topk_dr_batch(pidx, w, m, t_idf, k=20,
                               conjunctive=mode == "and",
                               heap_cap=2 * pidx.n_docs + 4, beam_width=P,
                               max_pops=None if budget is None else budget * P)
    assert torch.equal(res.padded, st.padded)
    assert torch.equal(res.iters, st.iters)


def test_padded_from_widths_by_hand():
    """Trip widths (3, 1), (2, 0), (1, 0) at P = 3 (buckets 1, 2, 3): the
    batch's buckets are 3, 2, 1, so row 0 pays 0 + 0 + 0 and row 1 pays 2."""
    widths = torch.tensor([[3, 2, 1], [1, 0, 0]], dtype=torch.int32)
    assert ranked.padded_from_widths(widths, 3).tolist() == [0, 2]
    assert ranked.padded_from_widths(widths[:, :0], 3).tolist() == [0, 0]
    assert ranked.padded_from_widths(widths, 16).tolist() == [1, 3]


@pytest.mark.parametrize("P", [1, 4])
def test_cpu_tensors_launch_nothing(P):
    cp, ridx, rmodel, pidx, idf = builds()
    words, mask = _batch(cp, rmodel, 2, 4, seed=5)
    before = backend.launch_counts()
    ranked.topk_dr_batch(pidx, torch.from_numpy(words), torch.from_numpy(mask),
                         torch.from_numpy(idf), k=5, conjunctive=False,
                         heap_cap=2 * pidx.n_docs + 4, beam_width=P)
    assert backend.launch_counts() == before


def _state(B=2, Q=4, cap=50, k=5):
    pool = H.make_pool(B, cap, Q, "cpu")
    st = heap_loop.init_state(B, k, "cpu")
    words = torch.zeros((B, Q), dtype=torch.int32)
    wmask = torch.ones((B, Q), dtype=torch.bool)
    idf_w = torch.zeros((B, Q), dtype=torch.float32)
    return pool, st, words, wmask, idf_w


@pytest.mark.parametrize("case", ["ok", "dtype", "shape", "device",
                                  "mask_shape", "wide_q", "narrow_p",
                                  "wide_p", "shared_counters", "k0"])
def test_heap_loop_argument_checks(case):
    *_, pidx, _ = builds()
    pool, st, words, wmask, idf_w = _state()
    P, k = 4, 5
    if case == "dtype":
        st = st._replace(out_scores=st.out_scores.double())
    elif case == "shape":
        pool = pool._replace(tf=pool.tf[:, :, :3].contiguous())
    elif case == "device":
        idf_w = idf_w.to("meta")
    elif case == "mask_shape":
        wmask = wmask[:, :3]
    elif case == "wide_q":
        pool, st, words, wmask, idf_w = _state(Q=heap_loop.MAX_Q + 1)
    elif case == "narrow_p":
        P = 1
    elif case == "wide_p":
        P = heap_loop.MAX_P + 1
    elif case == "shared_counters":
        st = st._replace(iters=st.n_out)
    elif case == "k0":
        pool, st, words, wmask, idf_w = _state(k=0)
        k = 0
    if case == "ok":
        heap_loop.check_args(pidx, pool, st, words, wmask, idf_w, P=P, k=k)
        return
    with pytest.raises(ValueError, match="heap_loop"):
        heap_loop.check_args(pidx, pool, st, words, wmask, idf_w, P=P, k=k)


def test_trip_bound():
    assert heap_loop.trip_bound(100, None) == 204
    assert heap_loop.trip_bound(100, 64) == 64
    assert heap_loop.trip_bound(100, 10_000) == 204
    assert heap_loop.trip_bound(100, 0) == 1


# ---------------------------------------------------------------------------
# heap_loop's block-wide pop and push, mirrored in numpy
# ---------------------------------------------------------------------------

CHUNK, THREADS = 256, 512          # csrc/pool.cuh kChunk; heap_loop's block


def key4(s, d0, d1, idx):
    """``pool::key4``: (N, 4) uint64 words of the total order, compared
    lexicographically, greater first (score's order bits, ~d0, d1, ~idx)."""
    u = np.asarray(s, np.float32).copy()
    u[u == 0] = 0.0
    u = u.view(np.uint32).astype(np.uint64)
    o = np.where(u & 0x80000000, ~u & 0xffffffff, u | 0x80000000)
    m = np.uint64(0xffffffff)
    return np.stack([o, m - np.asarray(d0, np.uint64),
                     np.asarray(d1, np.uint64),
                     m - np.asarray(idx, np.uint64)], 1)


def key_ge(keys, t):
    """Lexicographic keys >= t, row by row."""
    ge = np.ones(len(keys), bool)
    decided = np.zeros(len(keys), bool)
    for i in range(4):
        gt, lt = keys[:, i] > t[i], keys[:, i] < t[i]
        ge = np.where(~decided & gt, True, np.where(~decided & lt, False, ge))
        decided |= gt | lt
    return ge


def block_select(keys, want):
    """``pool::block_select``: 8-bit digits of the 128-bit key from the top,
    stopping at a digit whose bucket is taken whole or holds at most 32
    keys (then ranked exactly); the ``want`` greatest keys are those >= the
    returned threshold (every key when there are at most ``want``)."""
    pre = [0, 0, 0, 0]
    if len(keys) <= want:
        return pre
    for j in range(16):
        wi, sh = j // 4, 24 - 8 * (j % 4)
        hm = 0 if sh == 24 else (0xffffffff << (sh + 8)) & 0xffffffff
        match = (keys[:, wi] & np.uint64(hm)) == np.uint64(pre[wi] & hm)
        for u in range(wi):
            match &= keys[:, u] == np.uint64(pre[u])
        hist = np.bincount(((keys[match, wi] >> np.uint64(sh))
                            & np.uint64(255)).astype(np.int64), minlength=256)
        suf = np.cumsum(hist[::-1])[::-1]
        b = int(np.flatnonzero((suf >= want) & (suf - hist < want))[0])
        pre[wi] |= b << sh
        want -= int(suf[b] - hist[b])
        if hist[b] == want:
            break
        if hist[b] <= 32:
            hb = (0xffffffff << sh) & 0xffffffff
            inb = (keys[:, wi] & np.uint64(hb)) == np.uint64(pre[wi])
            for u in range(wi):
                inb &= keys[:, u] == np.uint64(pre[u])
            assert inb.sum() == hist[b]
            small = keys[inb][np.lexsort(keys[inb].T[::-1])[::-1]]
            return [int(x) for x in small[want - 1]]
    return pre


def pop_mirror(s, d0, d1, cap, hw, nv):
    """The kernel's pop of one row: the nv best chunk summaries over the
    active chunks, then the nv best live slots of those chunks at or above
    their threshold, in pop order.  Returns the slots."""
    n_chunks = -(-cap // CHUNK)
    active = min(n_chunks, (hw + 1) // CHUNK + 1)
    live = np.flatnonzero(s[:min(cap, active * CHUNK)] > -np.inf)
    keys = key4(s[live], d0[live], d1[live], live)
    best = {}                                   # chunk -> its best key
    for i, key in zip(live, keys):
        c = i // CHUNK
        if c not in best or key_ge(key[None], best[c])[0]:
            best[c] = key
    chunks = np.array(sorted(best))
    ck = np.array([best[c] for c in chunks], np.uint64).reshape(-1, 4)
    kc = block_select(ck, nv)
    sel = set(chunks[key_ge(ck, kc)].tolist())
    assert len(sel) <= nv
    cand = np.isin(live // CHUNK, list(sel))
    cand &= key_ge(keys, kc)
    ks = block_select(keys[cand], nv)
    chosen = cand & key_ge(keys, ks)
    assert chosen.sum() == nv
    order = np.lexsort(keys[chosen].T[::-1])[::-1]        # greatest first
    return live[chosen][order]


def push_mirror(free, cap, hw, n_push):
    """The kernel's placement of n_push enabled pushes: a scan of the
    active chunks' free counts in runs of ``per`` chunks a thread, a binary
    search of each rank r over the runs' offsets, a select in the chunk's
    mask; past the active chunks every slot is free.  Returns each push's
    slot, -1 when dropped."""
    n_chunks = -(-cap // CHUNK)
    active = min(n_chunks, (hw + 1) // CHUNK + 1)
    mask = np.zeros(n_chunks * CHUNK, bool)
    mask[:cap] = free[:cap]
    fc = mask.reshape(n_chunks, CHUNK).sum(1)
    per = -(-active // THREADS)
    runs = [fc[min(t * per, active):min(t * per + per, active)].sum()
            for t in range(THREADS)]
    toff = np.concatenate([[0], np.cumsum(runs)[:-1]])
    n_free = int(np.sum(runs))
    out = []
    for r in range(n_push):
        if r < n_free:
            t = int(np.searchsorted(toff, r, side="right")) - 1
            rr = r - int(toff[t])
            c = t * per
            while rr >= fc[c]:
                rr -= fc[c]
                c += 1
            out.append(c * CHUNK + int(np.flatnonzero(
                mask[c * CHUNK:(c + 1) * CHUNK])[rr]))
        else:
            slot = active * CHUNK + r - n_free
            out.append(slot if slot < cap else -1)
    return out


def _random_pool(rng, cap, Q, fill, hw, n_scores):
    """One row's pool: slots below hw live with probability ``fill`` (slot
    hw - 1 always), scores from ``n_scores`` values (ties), short
    segments."""
    pool = H.make_pool(1, cap, Q, "cpu")
    live = rng.random(hw) < fill
    live[hw - 1] = True
    idx = np.flatnonzero(live)
    pool.scores[0, idx] = torch.from_numpy(
        rng.integers(0, n_scores, len(idx)).astype(np.float32) * 0.25)
    d0 = rng.integers(0, 4 * n_scores, len(idx))
    pool.d0[0, idx] = torch.from_numpy(d0.astype(np.int32))
    pool.d1[0, idx] = torch.from_numpy(
        (d0 + rng.integers(1, 5, len(idx))).astype(np.int32))
    pool.tf[0, idx] = torch.from_numpy(
        rng.integers(0, 9, (len(idx), Q)).astype(np.int32))
    pool.size[0] = len(idx)
    return pool


@pytest.mark.parametrize("case", ["holes", "ties", "dense", "full",
                                  "wide"])
@pytest.mark.parametrize("P", [2, 3, 16, 64])
def test_block_pop_and_push_mirror_match_pop_p_and_push_many(P, case):
    """The mirror of heap_loop's pop (chunks, then slots, by radix select)
    pops what ``core/heap.pop_p`` pops, in its order; the mirror of its
    placement (rank scan, free-count scan, select in the mask) puts the
    r-th enabled push where ``push_many`` puts it, and drops the same
    ones.  Pools with holes below the high-water mark, many equal scores,
    a nearly full and a full pool (the pushes overflow), and one past 512
    chunks (two chunks a thread in the scan)."""
    rng = np.random.default_rng(P * 31 + len(case))
    Q = 3
    cap, fill, hw, n_scores = {
        "holes": (3000, 0.3, 2900, 40), "ties": (2000, 0.6, 1500, 3),
        "dense": (1100, 0.97, 1100, 20), "full": (700, 1.0, 700, 50),
        "wide": (140_000, 0.02, 139_000, 30)}[case]
    pool = _random_pool(rng, cap, Q, fill, hw, n_scores)
    s0, a0, b0 = (x[0].numpy().copy() for x in pool[:3])
    nv = min(int(pool.size[0]), P)
    want_slots = pop_mirror(s0, a0, b0, cap, hw, nv)
    ps, pd0, pd1, _, valid = H.pop_p(pool, P, torch.ones(1, dtype=torch.bool))
    assert int(valid.sum()) == nv
    np.testing.assert_array_equal(ps[0, :nv].numpy(), s0[want_slots])
    np.testing.assert_array_equal(pd0[0, :nv].numpy(), a0[want_slots])
    np.testing.assert_array_equal(pd1[0, :nv].numpy(), b0[want_slots])
    freed = (s0 > -np.inf) & (pool.scores[0].numpy() == -np.inf)
    assert sorted(np.flatnonzero(freed)) == sorted(want_slots)
    # 3·P push lanes, some disabled; the r-th enabled one
    m = 3 * P
    enable = torch.from_numpy(rng.random((1, m)) < 0.8)
    ks = torch.from_numpy(rng.integers(1, 99, (1, m)).astype(np.float32))
    kd = torch.from_numpy(rng.integers(0, 10**6, (1, m)).astype(np.int32))
    free = pool.scores[0].numpy() == -np.inf
    slots = push_mirror(free, cap, hw, int(enable.sum()))
    H.push_many(pool, ks, kd, kd + 1, torch.zeros((1, m, Q), dtype=torch.int32),
                enable)
    lanes = np.flatnonzero(enable[0].numpy())
    for r, lane in enumerate(lanes):
        if slots[r] < 0:
            continue
        assert pool.d0[0, slots[r]] == kd[0, lane], (r, slots[r])
        assert pool.scores[0, slots[r]] == ks[0, lane]
    assert bool(pool.overflowed[0]) == (min(slots, default=0) < 0)
    if case == "full":
        assert bool(pool.overflowed[0])
    landed = [x for x in slots if x >= 0]
    assert landed == sorted(landed)
    assert int(pool.size[0]) == int((s0 > -np.inf).sum()) - nv + len(landed)
