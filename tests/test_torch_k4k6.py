"""K4 ``segment_tf`` and K6 ``scored_topk`` as redesigned for the H100.

On the CPU:

* a numpy mirror of the K4 kernel (``csrc/segment_tf.cu``): blocks of 384
  bounds sharing their edge bound, groups of one tile, the nearer-end
  extents, the chunks read and skipped, per-window prefixes — against the
  plain ``segment_tf_ref`` and a direct count, at bounds on tile edges, at
  ``valid // 2`` and ``valid // 2 + 1``, on the last short tile, equal
  bounds, unsorted bounds and blocks of 64 to 8,192 bytes;
* ``segment_tf_ref`` at those edge bounds and at D = 0 against the
  reference's ``segment_tf`` in interpret mode and a direct count;
* K6's ``launch_plan`` (stage sizes, the odd stride, slices, the grid, the
  shared memory, the small-k / large-k choice) against what the kernel
  assumes, and a numpy mirror of the whole kernel (each warp's rows, its
  register or buffered list, the block merge, the partials and the last
  block's merge) against ``scored_topk_ref`` bitwise, with ties across
  blocks, masks, k = 1, 32, 33 and k past a warp's rows.

The tests marked ``cuda`` hold both kernels against their plain versions on
the card, bitwise; they skip without a GPU.
"""
import bisect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bytemap as r_bytemap
from repro.kernels import segment_tf as r_segment_tf
from repro_torch.core import bytemap, wtbc
from repro_torch.kernels import backend, ops, ref, topk_score
from repro_torch.text import corpus as tcorpus

torch.set_num_threads(1)
I32_MAX = 2**31 - 1


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")


# ---------------------------------------------------------------------------
# K4: segment_tf
# ---------------------------------------------------------------------------

K4_BOUNDS, K4_WINDOW = 384, 4096      # csrc/segment_tf.cu: kBounds, kWindow


def k4_mirror(data_padded, counts, length, block, byte, bounds):
    """The kernel's arithmetic in numpy: (D,) tf and the bytes it reads."""
    n_blocks = counts.shape[0] - 1
    D = len(bounds) - 1
    out = np.zeros(D, np.int64)
    read = 0
    for d0 in range(0, D, K4_BOUNDS - 1):
        nb = min(K4_BOUNDS, D + 1 - d0)
        pos = np.clip(bounds[d0:d0 + nb].astype(np.int64), 0, length)
        tile = np.minimum(pos // block, n_blocks - 1)
        first = [0] + [i for i in range(1, nb) if tile[i] != tile[i - 1]]
        rank = np.zeros(nb, np.int64)
        for g, i0 in enumerate(first):
            i1 = first[g + 1] if g + 1 < len(first) else nb
            blk = int(tile[i0])
            start = blk * block
            valid = min(block, length - start)
            half = valid // 2
            cuts = pos[i0:i1] - start
            back_m = cuts > half
            front = int(cuts[~back_m].max(initial=0))
            back = int(cuts[back_m].min(initial=valid))
            eq = data_padded[start:start + block] == byte
            cx = {}
            carry = 0
            for s in range(0, valid, K4_WINDOW):
                c = s + 16 * np.arange(K4_WINDOW // 16)
                need = (c < valid) & ((c < front) | (c + 16 > back))
                read += 16 * int(need.sum())
                n = np.array([eq[a:min(a + 16, valid)].sum() if nd else 0
                              for a, nd in zip(c, need)])
                pre = np.concatenate([[0], np.cumsum(n)[:-1]])
                for i, x in enumerate(cuts):
                    if s <= x < s + K4_WINDOW:
                        j = (x - s) >> 4
                        part = eq[s + 16 * j:x].sum() if x & 15 else 0
                        cx[i] = carry + pre[j] + part
                carry += int(n.sum())
            for i, x in enumerate(cuts):
                if valid % K4_WINDOW == 0 and x == valid:
                    cx[i] = carry
                rank[i0 + i] = (counts[blk + 1, byte] - (carry - cx[i])
                                if back_m[i] else counts[blk, byte] + cx[i])
        out[d0:d0 + nb - 1] = rank[1:] - rank[:-1]
    return out, read


def edge_bounds(rng, n, block, m):
    """Sorted bounds with 0, n, tile edges, the halves of tiles (valid // 2
    and valid // 2 + 1, the side switch), the last short tile and repeats."""
    b = [0, 0, n, n, 1]
    for s in range(0, n, block):
        valid = min(block, n - s)
        b += [s, s + 1, max(s - 1, 0), s + valid // 2, s + valid // 2 + 1,
              s + valid - 1]
    b += list(rng.integers(0, n + 1, m))
    return np.sort(np.clip(b, 0, n)).astype(np.int32)


def k4_level(n, block, seed, alphabet=6):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, alphabet, n).astype(np.uint8)
    return data, bytemap.build(data, block=block, device="cpu"), rng


@pytest.mark.parametrize("n,block", [(5000, 64), (20000, 1024), (30000, 4096),
                                     (4096 * 3, 4096), (50000, 8192),
                                     (12288 + 40, 8192), (0, 256)])
def test_k4_mirror_matches_plain_at_edge_bounds(n, block):
    data, bm, rng = k4_level(n, block, n + block)
    bounds = edge_bounds(rng, n, block, 300)
    for byte in (0, 3):
        want = ops.segment_tf_batch(bm, byte, torch.from_numpy(bounds)).numpy()
        got, _ = k4_mirror(bm.data.numpy(), bm.counts.numpy(), n, block,
                           byte, bounds)
        direct = [(data[a:b] == byte).sum() for a, b in zip(bounds[:-1],
                                                            bounds[1:])]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, direct)


def test_k4_mirror_unsorted_and_clipped_bounds():
    """Unsorted bounds make runs of one tile the groups; bounds outside
    [0, length] clip.  The result is the plain version's."""
    data, bm, rng = k4_level(9000, 512, 3)
    bounds = rng.integers(-100, 9200, 700).astype(np.int32)
    want = ops.segment_tf_batch(bm, 2, torch.from_numpy(bounds)).numpy()
    got, _ = k4_mirror(bm.data.numpy(), bm.counts.numpy(), 9000, 512, 2,
                       bounds)
    np.testing.assert_array_equal(got, want)


def test_k4_mirror_reads_each_needed_chunk_once():
    """Dense bounds over a level read about the level once: each tile's
    nearer ends, never a chunk twice within a block of bounds."""
    data, bm, rng = k4_level(40960, 4096, 9)
    bounds = np.sort(rng.integers(0, 40961, 400)).astype(np.int32)
    _, read = k4_mirror(bm.data.numpy(), bm.counts.numpy(), 40960, 4096, 1,
                        bounds)
    assert read <= 40960 + 16 * 2 * 10 + 4096 * 4   # + tiles split by blocks


@pytest.mark.parametrize("case", ["edges", "equal", "half", "last", "empty"])
def test_segment_tf_plain_matches_reference_at_edges(case):
    n, block = 10000, 1024          # last tile 784 bytes: valid // 2 = 392
    data, bm, rng = k4_level(n, block, 17, alphabet=4)
    rbm = r_bytemap.build(data, block=block)
    bounds = {
        "edges": np.array([0, 1023, 1024, 1025, 2048, 4096, 9216, n]),
        "equal": np.array([5, 5, 5, 3000, 3000, n, n]),
        "half": np.array([0, 512, 513, 1024 + 512, 1024 + 513, 9216 + 392,
                          9216 + 393, n]),
        "last": np.array([9216, 9217, 9600, 9999, n]),
        "empty": np.array([4321]),                        # D = 0
    }[case].astype(np.int32)
    for byte in (0, 1):
        got = ops.segment_tf_batch(bm, byte, torch.from_numpy(bounds)).numpy()
        kern = np.asarray(r_segment_tf.segment_tf(
            rbm.data, rbm.counts, rbm.length, jnp.int32(byte),
            jnp.asarray(bounds), block=block, interpret=True))
        direct = [(data[a:b] == byte).sum() for a, b in zip(bounds[:-1],
                                                            bounds[1:])]
        assert got.shape == (len(bounds) - 1,)
        np.testing.assert_array_equal(got, kern)
        np.testing.assert_array_equal(got, direct)
        mirror, _ = k4_mirror(bm.data.numpy(), bm.counts.numpy(), n, block,
                              byte, bounds)
        np.testing.assert_array_equal(got, mirror)


# ---------------------------------------------------------------------------
# K6: scored_topk — the launch plan
# ---------------------------------------------------------------------------

K6_STATIC_SMEM = 2 * 4 * topk_score.WARPS * 32 + 4 * 8 + 8 * 2 * 8 + 16


@pytest.mark.parametrize("elem", [4, 2])
def test_k6_plan_stages_fit_and_cover_rows(elem):
    per = 16 // elem
    for d in (per, 2 * per, 4 * per, 128, 256, 1024, 4096, 57000 // per * per):
        for masked in (False, True):
            for k in (1, 10, 32, 33, 1024):
                pl = topk_score.launch_plan(1, 10**6, d, elem, True, k,
                                            masked, 132)
                upr = d * elem // 16
                assert pl.rs % 32 == 0 and pl.rs >= 32
                assert pl.sp % 2 == 1 and pl.sp >= pl.su
                assert pl.su * pl.nslice >= upr > pl.su * (pl.nslice - 1)
                if pl.nslice == 1:
                    assert pl.su == upr and pl.sp in (upr, upr + 1)
                else:
                    assert pl.rs == 32
                assert pl.rs * pl.sp * 16 <= topk_score.STAGE_BYTES
                assert pl.small == (k <= 32)
                assert pl.shmem + K6_STATIC_SMEM <= 227 * 1024
                assert pl.shmem % 16 == 0


def test_k6_plan_odd_stride_spreads_a_phase_over_banks():
    """Eight lanes reading rows j..j+7 at one 16-byte unit land on eight
    different 16-byte bank groups when the stride in units is odd."""
    for d in (4, 8, 64, 128, 132, 512):
        pl = topk_score.launch_plan(1, 10**5, d, 4, True, 10, False, 132)
        for u in range(3):
            groups = {((j * pl.sp + u) % 8) for j in range(8)}
            assert len(groups) == 8


def test_k6_plan_grid():
    # one block per SM over the queries; no more warps than row blocks
    pl = topk_score.launch_plan(1, 10**6, 128, 4, True, 10, False, 132)
    assert pl.gx == 132 and (pl.nslice, pl.rs, pl.su, pl.sp) == (3, 32, 11, 11)
    pl = topk_score.launch_plan(8, 86445, 4, 4, True, 10, True, 132)
    assert pl.gx == 16 and (pl.rs, pl.su, pl.sp, pl.nslice) == (352, 1, 1, 1)
    for B in (1, 3, 8, 100, 131, 132, 133, 5000):     # one wave of blocks
        pl = topk_score.launch_plan(B, 10**5, 16, 4, True, 10, False, 132)
        assert pl.gx * B <= max(132, B)
    pl = topk_score.launch_plan(3, 100, 128, 4, True, 5, False, 132)
    assert pl.gx == 1                               # C below one row block
    pl = topk_score.launch_plan(65535, 10, 4, 4, True, 3, False, 132)
    assert pl.gx == 1
    # k > 32: a block per 4 * WARPS * k rows at most
    pl = topk_score.launch_plan(1, 10**6, 128, 4, True, 1024, False, 132)
    assert pl.gx == 10**6 // (4 * topk_score.WARPS * 1024)
    pl = topk_score.launch_plan(1, 2000, 128, 4, True, 1024, False, 132)
    assert pl.gx == 1
    # rows not 16-byte aligned: 32-row blocks read from device memory
    pl = topk_score.launch_plan(2, 5000, 3, 4, False, 10, True, 132)
    assert (pl.rs, pl.shmem) == (32, 0)


# ---------------------------------------------------------------------------
# K6: the whole kernel, mirrored
# ---------------------------------------------------------------------------

def _key(s, r):
    """Sort key of (score desc, row asc)."""
    return (-s, r)


class RegListMirror:
    """k <= 32: the sorted list, a candidate inserted when it beats the
    k-th (every entry past the real ones is (-inf, INT32_MAX))."""

    def __init__(self, k):
        self.k = k
        self.e = [(-np.inf, I32_MAX)] * k

    @property
    def thr(self):
        return self.e[self.k - 1]

    def offer(self, cands):                # one round: (s, r) of ok lanes
        for s, r in cands:
            if _key(s, r) < _key(*self.thr):
                pos = sum(_key(*x) < _key(s, r) for x in self.e)
                self.e = self.e[:pos] + [(s, r)] + self.e[pos:-1]

    def flush(self):
        pass

    def entries(self):
        return [x for x in self.e if x != (-np.inf, I32_MAX)]


class BigListMirror:
    """k > 32: a sorted list of up to k, a buffer of kBuf; a full buffer is
    sorted and merged by rank placement."""

    BUF = topk_score.BUF

    def __init__(self, k):
        self.k, self.lst, self.buf = k, [], []

    @property
    def thr(self):
        return self.lst[-1] if len(self.lst) == self.k else (-np.inf, I32_MAX)

    def offer(self, cands):
        self.buf += [c for c in cands if _key(*c) < _key(*self.thr)]
        if len(self.buf) > self.BUF - 32:
            self.flush()

    def flush(self):
        if not self.buf:
            return
        buf = sorted(self.buf, key=lambda c: _key(*c))
        out = [None] * min(self.k, len(self.lst) + len(buf))
        bk = [_key(*c) for c in buf]
        lk = [_key(*c) for c in self.lst]
        for i, x in enumerate(self.lst):
            pos = i + bisect.bisect_left(bk, _key(*x))
            if pos < self.k:
                out[pos] = x
        for j, y in enumerate(buf):
            pos = j + bisect.bisect_left(lk, _key(*y))
            if pos < self.k:
                out[pos] = y
        assert None not in out
        self.lst, self.buf = out, []

    def entries(self):
        return list(self.lst)


def consume(lst, entries):
    """``consume``: rounds of 32 of a sorted list until none beats the k-th."""
    for i0 in range(0, len(entries), 32):
        rnd = entries[i0:i0 + 32]
        if not any(_key(*c) < _key(*lst.thr) for c in rnd):
            break
        lst.offer(rnd)


def k6_mirror(cands, q, k, valid, n_sm):
    """The kernel's arithmetic and merges in numpy: (B, k) scores, rows."""
    B, C, d = cands.shape
    acc = np.zeros((B, C), np.float32)
    for j in range(d):                       # left to right, each rounded
        acc = (acc + cands[..., j].astype(np.float32)
               * q[:, j, None].astype(np.float32)).astype(np.float32)
    pl = topk_score.launch_plan(B, C, d, cands.dtype.itemsize, True, k,
                                valid is not None, n_sm)
    make = RegListMirror if pl.small else BigListMirror
    W = topk_score.WARPS
    n_rb = -(-C // pl.rs)
    out_s = np.full((B, k), -np.inf, np.float32)
    out_i = np.full((B, k), I32_MAX, np.int32)

    def merge_warps(lists):
        for lst in lists:
            lst.flush()
        for lst in lists[1:]:
            if pl.small:
                lists[0].offer([c for c in lst.e])
            else:
                consume(lists[0], lst.entries())
        lists[0].flush()
        e = lists[0].entries()
        return e + [(-np.inf, I32_MAX)] * (k - len(e))

    for b in range(B):
        parts = []
        for bx in range(pl.gx):
            lists = [make(k) for _ in range(W)]
            for w in range(W):
                for rb in range(bx * W + w, n_rb, pl.gx * W):
                    for j0 in range(rb * pl.rs, min(C, (rb + 1) * pl.rs), 32):
                        rows = range(j0, min(j0 + 32, C, (rb + 1) * pl.rs))
                        lists[w].offer([
                            (float(acc[b, r]), r) for r in rows
                            if (valid is None or valid[b, r])
                            and not np.isnan(acc[b, r])])
            parts.append(merge_warps(lists))
        lists = [make(k) for _ in range(W)]
        for g in range(pl.gx):
            consume(lists[g % W], parts[g])
        for i, (s, r) in enumerate(merge_warps(lists)):
            out_s[b, i], out_i[b, i] = s, r
    return out_s, out_i


@pytest.mark.parametrize("C,d,k,masked,n_sm", [
    (700, 4, 1, False, 4),
    (5000, 4, 10, True, 4),         # several blocks, a mask
    (3000, 8, 32, False, 3),
    (3000, 8, 33, True, 2),          # the buffered list
    (900, 128, 40, False, 1),        # k past each warp's rows; slices
    (200, 4, 200, True, 1),          # k = C, most slots unfilled
])
def test_k6_mirror_matches_plain(C, d, k, masked, n_sm):
    rng = np.random.default_rng(C + d + k)
    B = 2
    cands = rng.integers(-3, 4, (B, C, d)).astype(np.float32)  # many ties
    q = rng.integers(-2, 3, (B, d)).astype(np.float32)
    valid = rng.random((B, C)) < 0.4 if masked else None
    got_s, got_i = k6_mirror(cands, q, k, valid, n_sm)
    ws, wi = ref.scored_topk_ref(
        torch.from_numpy(cands), torch.from_numpy(q), k=k,
        valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got_i, wi.numpy())
    np.testing.assert_array_equal(got_s, ws.numpy())


def test_k6_mirror_equal_scores_across_blocks():
    """Every row scores the same: the k lowest rows win, whichever blocks
    and warps hold them; an all-masked query fills no slot."""
    B, C, d, k = 2, 4000, 4, 12
    cands = np.ones((B, C, d), np.float32)
    q = np.ones((B, d), np.float32)
    valid = np.ones((B, C), bool)
    valid[0, :1500] = False
    valid[1] = False
    s, i = k6_mirror(cands, q, k, valid, 8)
    assert i[0].tolist() == list(range(1500, 1500 + k))
    assert (s[0] == 4.0).all()
    assert i[1].tolist() == [I32_MAX] * k and np.isneginf(s[1]).all()


def test_scored_topk_plain_unfilled_and_masked_rows():
    """The plain version the kernel is held to: a slot no eligible row fills
    is (-inf, 2**31 - 1); an eligible row scoring -inf still takes a slot."""
    cands = torch.tensor([[1.0], [-np.inf], [2.0], [0.5]])
    q = torch.ones(1)
    valid = torch.tensor([True, True, False, True])
    s, i = ref.scored_topk_ref(cands, q, k=4, valid=valid)
    assert i.tolist() == [0, 3, 1, I32_MAX]
    assert s[:2].tolist() == [1.0, 0.5] and np.isneginf(s[2:].numpy()).all()


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,block", [(5000, 64), (30000, 4096),
                                     (4096 * 3, 4096), (50000, 8192),
                                     (12288 + 40, 8192)])
def test_segment_tf_kernel_matches_plain_at_edge_bounds(n, block):
    _need_card()
    data, _, rng = k4_level(n, block, n + block)
    bm = bytemap.build(data, block=block, device="cuda")
    sorted_b = edge_bounds(rng, n, block, 3000)
    for bounds in (sorted_b, rng.permutation(sorted_b),
                   np.repeat(sorted_b[:50], 9), sorted_b[:2]):
        b = torch.from_numpy(bounds.astype(np.int32)).cuda()
        for byte in (0, 3):
            before = backend.launch_counts()["segment_tf"]
            got = ops.segment_tf_batch(bm, byte, b)
            assert backend.launch_counts()["segment_tf"] == before + 1
            want = ops.segment_tf_batch(bm, byte, b, kernel_backend="ref")
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_segment_tf_kernel_every_document_of_a_corpus():
    """Every document bound of a 2,000-document corpus, for bytes of 1-, 2-
    and 3-byte words at the root: == plain == the count descent."""
    _need_card()
    cp = tcorpus.make_corpus(n_docs=2000, mean_doc_len=300, seed=4)
    idx, _ = wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=4096,
                              device="cuda")
    root = idx.levels[0]
    bounds = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                        idx.sep_pos + 1]).to(torch.int32)
    d_all = torch.arange(idx.n_docs, dtype=torch.int32, device="cuda")
    ones = torch.nonzero(idx.cw_len == 1).reshape(-1)
    for w in ones[:: max(1, len(ones) // 6)].tolist():
        byte = int(idx.cw[w, 0])
        got = ops.segment_tf_batch(root, byte, bounds)
        want = ops.segment_tf_batch(root, byte, bounds, kernel_backend="ref")
        assert torch.equal(got, want)
        tf = wtbc.count_doc(idx, torch.full_like(d_all, w), d_all)
        assert torch.equal(got, tf)
    for byte in range(0, 256, 37):           # first bytes of longer words
        got = ops.segment_tf_batch(root, byte, bounds)
        assert torch.equal(got, ops.segment_tf_batch(root, byte, bounds,
                                                     kernel_backend="ref"))


def _k6_case(C, d, dtype, seed, B=None, ties=False):
    g = torch.Generator().manual_seed(seed)
    shape = (C, d) if B is None else (B, C, d)
    if ties:
        cands = torch.randint(-2, 3, shape, generator=g).float()
    else:
        cands = torch.randn(shape, generator=g)
    q = torch.randn(shape[:-2] + (d,), generator=g)
    return cands.to(dtype).cuda(), q.cuda()


def _k6_same(cands, q, k, valid=None, tile=1024):
    before = backend.launch_counts()["scored_topk"]
    s, i = ops.scored_topk(cands, q, k=k, tile=tile, valid=valid)
    assert backend.launch_counts()["scored_topk"] == before + 1
    ws, wi = ops.scored_topk(cands, q, k=k, tile=tile, valid=valid,
                             kernel_backend="ref")
    assert torch.equal(i, wi)
    assert torch.equal(s, ws)


@pytest.mark.cuda
@pytest.mark.parametrize("C,k", [(100, 1), (100, 32), (300, 33),
                                 (20037, 1), (20037, 10), (20037, 32),
                                 (20037, 33), (20037, 1024), (200003, 10)])
def test_scored_topk_kernel_shapes_and_k(C, k):
    """C below one stage, C not a multiple of a row block, k = 1, 32 (the
    register list), 33 and the tile (the buffered list)."""
    _need_card()
    cands, q = _k6_case(C, 128, torch.float32, C + k)
    _k6_same(cands, q, k)
    cands, q = _k6_case(C, 4, torch.float32, C + k + 1)
    _k6_same(cands, q, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("d", [3, 5, 8, 128, 1000])
def test_scored_topk_kernel_dtypes_and_widths(dtype, d):
    """f16 / bf16 read as float32; rows that are not 16-byte aligned (read
    from device memory) and rows wider than a stage (sliced)."""
    _need_card()
    cands, q = _k6_case(30011, d, dtype, d)
    _k6_same(cands, q, 10)
    _k6_same(cands, q, 40)


@pytest.mark.cuda
def test_scored_topk_kernel_ties_across_blocks_and_masks():
    """Equal scores in different persistent blocks go to the lower rows; an
    all-masked query fills no slot; a mask that leaves fewer rows than k."""
    _need_card()
    B, C, d = 8, 86445, 4
    cands, q = _k6_case(C, d, torch.float32, 7, B=B, ties=True)
    g = torch.Generator().manual_seed(8)
    valid = (torch.rand((B, C), generator=g) < 0.05).cuda()
    valid[1] = False
    valid[2] = False
    valid[2, [5, 40000, 86444]] = True
    for k in (10, 33):
        _k6_same(cands, q, k, valid)
    s, i = ops.scored_topk(cands, q, k=10, valid=valid)
    assert i[1].tolist() == [I32_MAX] * 10
    assert sorted(i[2, :3].tolist()) == [5, 40000, 86444]
    ones = torch.ones((300000, 4), device="cuda")
    s, i = ops.scored_topk(ones, torch.ones(4, device="cuda"), k=10)
    assert i.tolist() == list(range(10)) and (s == 4.0).all()
    _k6_same(ones, torch.ones(4, device="cuda"), 50)


@pytest.mark.cuda
def test_scored_topk_kernel_merge_order_and_repeat_calls():
    """Repeated launches leave the merge tickets at zero: the same answer
    every time, across batch sizes."""
    _need_card()
    cands, q = _k6_case(50000, 16, torch.float32, 11, B=3)
    first = ops.scored_topk(cands, q, k=10)
    for _ in range(3):
        again = ops.scored_topk(cands, q, k=10)
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])
        _k6_same(cands[0], q[0], 10)
