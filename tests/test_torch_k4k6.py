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
* K6's ``staging_unit`` and ``launch_plan`` (units of 16, 8, 4 or 2 bytes,
  stage sizes, the odd stride, slices, the ring's stages, the grid, the
  shared memory, the k > 32 buffer) against what the kernel assumes, and a
  numpy mirror of the whole kernel (each warp's rows; k <= 32 its register
  list and the merges; k > 32 the block buffer behind its rising
  threshold, rows equal to it still entering, the radix select that cuts
  it back to k, the partials and the last block's merge) against
  ``scored_topk_ref`` bitwise, with ties across blocks, masks, negative
  scores, SASRec's d = 50 at k = 100, k = 1, 32, 33, k = C and k past a
  warp's rows.

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

UNITS = (16, 8, 4, 2)


def _units(row_bytes, elem):
    return [g for g in UNITS if g >= elem and row_bytes % g == 0]


def test_k6_staging_unit():
    """The largest of 16, 8, 4, 2 bytes dividing the row and the address."""
    su = topk_score.staging_unit
    assert su(512, 0, 4) == 16 and su(200, 0, 4) == 8 and su(200, 4, 4) == 4
    assert su(16, 8, 4) == 8 and su(12, 0, 4) == 4 and su(14, 0, 2) == 2
    assert su(200, 1024 + 8, 4) == 8 and su(6, 0, 2) == 2


@pytest.mark.parametrize("elem", [4, 2])
def test_k6_plan_stages_fit_and_cover_rows(elem):
    for d in (1, 3, 7, 8, 50, 64, 128, 256, 1000, 4096, 57000 // 8 * 8):
        for unit in _units(d * elem, elem):
            for masked in (False, True):
                for k in (1, 10, 32, 33, 100, 1024):
                    pl = topk_score.launch_plan(1, 10**6, d, elem, unit, k,
                                                masked, 132)
                    upr = d * elem // unit
                    assert pl.unit == unit
                    assert pl.rs % 32 == 0 and pl.rs >= 32
                    assert pl.sp % 2 == 1 and pl.sp >= pl.su
                    assert pl.su * pl.nslice >= upr > pl.su * (pl.nslice - 1)
                    if pl.nslice == 1:
                        assert pl.su == upr and pl.sp in (upr, upr + 1)
                    else:
                        assert pl.rs == 32 and pl.ns == 4
                    if pl.ns == 4:
                        assert pl.rs * pl.sp * unit <= topk_score.STAGE_BYTES
                    else:
                        assert pl.ns == 3 and pl.rs == 32
                    assert pl.small == (k <= 32)
                    if not pl.small:    # the rounds between barriers fit
                        assert pl.nc >= k + pl.every * topk_score.WARPS * pl.rs
                        assert pl.grp ** 2 >= pl.gx > (pl.grp - 1) ** 2
                        assert pl.nc >= 1 << (k - 1).bit_length()
                        assert pl.buf_in_smem == (pl.nc == topk_score.BUF_MIN)
                    assert pl.shmem + topk_score.STATIC_SMEM <= 227 * 1024
                    assert pl.shmem % 16 == 0


def test_k6_plan_odd_stride_spreads_a_phase_over_banks():
    """The lanes of one shared-memory phase (128 bytes: 8 lanes of 16-byte
    units, 16 of 8-byte, 32 of 4-byte) reading consecutive rows at one unit
    land on different bank groups when the stride in units is odd."""
    for d, elem in ((4, 4), (8, 4), (50, 4), (64, 4), (128, 4), (132, 4),
                    (512, 4), (25, 4), (7, 4), (50, 2)):
        for unit in _units(d * elem, elem):
            if unit == 2:
                continue
            pl = topk_score.launch_plan(1, 10**5, d, elem, unit, 10, False,
                                        132)
            lanes = 128 // unit
            for u in range(3):
                groups = {(j * pl.sp + u) % lanes for j in range(lanes)}
                assert len(groups) == lanes


def test_k6_plan_grid():
    # one block per SM over the queries; no more warps than row blocks
    pl = topk_score.launch_plan(1, 10**6, 128, 4, 16, 10, False, 132)
    assert pl.gx == 132 and (pl.nslice, pl.rs, pl.su, pl.sp) == (3, 32, 11, 11)
    pl = topk_score.launch_plan(8, 86445, 4, 4, 16, 10, True, 132)
    assert pl.gx == 16 and (pl.rs, pl.su, pl.sp, pl.nslice) == (352, 1, 1, 1)
    for B in (1, 3, 8, 100, 131, 132, 133, 5000):     # one wave of blocks
        pl = topk_score.launch_plan(B, 10**5, 16, 4, 16, 10, False, 132)
        assert pl.gx * B <= max(132, B)
    pl = topk_score.launch_plan(3, 100, 128, 4, 16, 5, False, 132)
    assert pl.gx == 1                               # C below one row block
    pl = topk_score.launch_plan(65535, 10, 4, 4, 16, 3, False, 132)
    assert pl.gx == 1
    # k > 32: a block per 4 * k rows at most
    pl = topk_score.launch_plan(1, 10**6, 128, 4, 16, 1024, False, 132)
    assert pl.gx == 132 and pl.buf_in_smem
    pl = topk_score.launch_plan(1, 20000, 128, 4, 16, 1024, False, 132)
    assert pl.gx == 20000 // (4 * 1024)
    pl = topk_score.launch_plan(1, 2000, 128, 4, 16, 1024, False, 132)
    assert pl.gx == 1
    # SASRec: 200-byte rows in 8-byte units, 32 rows a stage of a 3-stage
    # ring, the buffer in shared memory
    pl = topk_score.launch_plan(1, 10**6, 50, 4, 8, 100, False, 132)
    assert (pl.unit, pl.sp, pl.rs, pl.ns, pl.nslice) == (8, 25, 32, 3, 1)
    assert (pl.gx, pl.nc, pl.buf_in_smem) == (132, 4096, True)
    assert (pl.every, pl.grp) == (7, 12)      # 11 groups of 12 blocks
    # rows not 16-byte aligned are staged too: 12-byte rows in 4-byte units
    pl = topk_score.launch_plan(2, 5000, 3, 4, 4, 10, True, 132)
    assert (pl.unit, pl.sp, pl.rs, pl.ns) == (4, 3, 448, 4) and pl.shmem > 0
    # a k too large for the shared buffer takes the global one
    pl = topk_score.launch_plan(1, 10**6, 4, 4, 16, 5000, False, 132)
    assert not pl.buf_in_smem and pl.nc >= 8192


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


def _ord(s):
    """The kernel's order bits of float32 scores (-0 as +0)."""
    u = np.asarray(s, np.float32).copy()
    u[u == 0] = 0.0
    u = u.view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xffffffff, u | 0x80000000)


def skey(s, r):
    """The kernel's 64-bit key of (score desc, row asc): greater is better."""
    return (_ord(s) << np.uint64(32)) | (np.uint64(0xffffffff)
                                         - np.asarray(r, np.uint64))


def radix_threshold(keys, want):
    """``keep_k``'s select: 8-bit digits from the top, stopping at the first
    digit whose bucket is taken whole; the ``want`` greatest keys are those
    >= the returned prefix."""
    pre = 0
    for sh in range(56, -8, -8):
        hm = 0 if sh == 56 else (~0 << (sh + 8)) & (2**64 - 1)
        match = (keys & np.uint64(hm)) == np.uint64(pre & hm)
        hist = np.bincount(((keys[match] >> np.uint64(sh)) & np.uint64(255))
                           .astype(np.int64), minlength=256)
        suf = np.cumsum(hist[::-1])[::-1]
        b = int(np.flatnonzero((suf >= want) & (suf - hist < want))[0])
        pre |= b << sh
        want -= int(suf[b] - hist[b])
        if hist[b] == want:
            break
    return pre


class BlockBuffer:
    """k > 32: the block's candidate buffer behind a rising threshold; when
    it could overflow, the k best are kept (``keep_k``) and the threshold
    becomes their least score."""

    def __init__(self, k, cap):
        self.k, self.cap = k, cap
        self.s, self.r = [], []
        self.thr = np.float32(-np.inf)
        self.kept = 0                       # keep_k calls

    def append(self, s, r, ok=True):
        if ok and s >= self.thr:            # NaN never passes
            self.s.append(s)
            self.r.append(r)
            assert len(self.s) <= self.cap

    def keep_k(self):
        self.kept += 1
        keys = skey(self.s, self.r)
        pre = radix_threshold(keys, self.k)
        keep = keys >= np.uint64(pre)
        assert keep.sum() == self.k
        self.s = [x for x, m in zip(self.s, keep) if m]
        self.r = [x for x, m in zip(self.r, keep) if m]
        self.thr = max(self.thr, np.float32(min(self.s)))


def as_part(buf, k):
    """``write_part``: the buffer's entries padded to k, and its threshold
    (-inf below k entries)."""
    n = len(buf.s)
    return ([(buf.s[i], buf.r[i]) if i < n else (-np.inf, I32_MAX)
             for i in range(k)], buf.thr if n >= k else np.float32(-np.inf))


def merge_parts(parts, k, cap):
    """``merge_parts``: the partials streamed through a buffer of ``cap``
    behind the largest of their thresholds, k kept."""
    buf = BlockBuffer(k, cap)
    buf.thr = max(t for _, t in parts)
    entries = [e for p, _ in parts for e in p]
    room = cap - k
    for e0 in range(0, len(entries), room):
        if len(buf.s) > k:
            buf.keep_k()
        for sc, r in entries[e0:e0 + room]:
            buf.append(sc, r, r != I32_MAX)
    if len(buf.s) > k:
        buf.keep_k()
    return buf


def k6_mirror(cands, q, k, valid, n_sm, unit=None, stats=None):
    """The kernel's arithmetic and merges in numpy: (B, k) scores, rows."""
    B, C, d = cands.shape
    acc = np.zeros((B, C), np.float32)
    for j in range(d):                       # left to right, each rounded
        acc = (acc + cands[..., j].astype(np.float32)
               * q[:, j, None].astype(np.float32)).astype(np.float32)
    elem = cands.dtype.itemsize
    unit = unit or topk_score.staging_unit(d * elem, 0, elem)
    pl = topk_score.launch_plan(B, C, d, elem, unit, k, valid is not None,
                                n_sm)
    W = topk_score.WARPS
    n_rb = -(-C // pl.rs)
    out_s = np.full((B, k), -np.inf, np.float32)
    out_i = np.full((B, k), I32_MAX, np.int32)

    def rows_of(bx, w, it):
        rb = bx * W + w + it * pl.gx * W
        for j0 in range(rb * pl.rs, min(C, (rb + 1) * pl.rs), 32):
            yield range(j0, min(j0 + 32, C, (rb + 1) * pl.rs))

    def eligible(b, r):
        return (valid is None or valid[b, r]) and not np.isnan(acc[b, r])

    for b in range(B):
        if pl.small:                         # register lists, as before
            parts = []
            for bx in range(pl.gx):
                lists = [RegListMirror(k) for _ in range(W)]
                for w in range(W):
                    for it in range(-(-n_rb // (pl.gx * W))):
                        for rows in rows_of(bx, w, it):
                            lists[w].offer([(float(acc[b, r]), r)
                                            for r in rows if eligible(b, r)])
                for lst in lists[1:]:
                    lists[0].offer(list(lst.e))
                parts.append(lists[0].e)
            lst = RegListMirror(k)
            for part in parts:
                lst.offer(part)
            for i, (sc, r) in enumerate(lst.e):
                out_s[b, i], out_i[b, i] = sc, r
            continue
        parts = []                           # (entries, threshold)
        for bx in range(pl.gx):
            buf = BlockBuffer(k, pl.nc)
            for it in range(-(-n_rb // (pl.gx * W))):   # warps in step
                for w in range(W):
                    for rows in rows_of(bx, w, it):
                        for r in rows:
                            buf.append(acc[b, r], r, eligible(b, r))
                if it % pl.every == pl.every - 1 and \
                        len(buf.s) > pl.nc - pl.every * W * pl.rs:
                    buf.keep_k()
            if len(buf.s) > k:
                buf.keep_k()
            parts.append(as_part(buf, k))
            if stats is not None:
                stats.append(buf.kept)
        # the last block of each group, then the last of those: the stage
        # memory as one large buffer
        cap = max(pl.nc, pl.shmem // 8)
        groups = [merge_parts(parts[g:g + pl.grp], k, cap)
                  for g in range(0, pl.gx, pl.grp)]
        buf = merge_parts([as_part(x, k) for x in groups], k, cap) \
            if len(groups) > 1 else groups[0]
        order = sorted(zip(buf.s, buf.r), key=lambda c: _key(*c))
        for i, (sc, r) in enumerate(order):
            out_s[b, i], out_i[b, i] = sc, r
    return out_s, out_i


@pytest.mark.parametrize("C,d,k,masked,n_sm,unit", [
    (700, 4, 1, False, 4, None),
    (5000, 4, 10, True, 4, None),      # several blocks, a mask
    (3000, 8, 32, False, 3, None),
    (3000, 8, 33, True, 2, None),      # the block buffer
    (900, 128, 40, False, 1, None),    # k past each warp's rows; slices
    (200, 4, 200, True, 1, None),      # k = C, most slots unfilled
    (6000, 50, 100, False, 1, None),   # SASRec's rows: 8-byte units, one
    (6000, 50, 100, True, 1, 4),       # block's buffer cut back to k
    (9000, 50, 100, False, 5, None),   # several blocks' partials
    (40000, 50, 40, True, 30, None),   # partials merged in groups
    (300, 50, 300, False, 2, None),    # k = C
    (5000, 7, 64, True, 3, 4),         # 28-byte rows in 4-byte units
])
def test_k6_mirror_matches_plain(C, d, k, masked, n_sm, unit):
    rng = np.random.default_rng(C + d + k)
    B = 2
    cands = rng.integers(-3, 4, (B, C, d)).astype(np.float32)  # many ties
    q = rng.integers(-2, 3, (B, d)).astype(np.float32)
    valid = rng.random((B, C)) < 0.4 if masked else None
    got_s, got_i = k6_mirror(cands, q, k, valid, n_sm, unit)
    ws, wi = ref.scored_topk_ref(
        torch.from_numpy(cands), torch.from_numpy(q), k=k,
        valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got_i, wi.numpy())
    np.testing.assert_array_equal(got_s, ws.numpy())


@pytest.mark.parametrize("k", [12, 100])
def test_k6_mirror_equal_scores_across_blocks(k):
    """Every row scores the same: the k lowest rows win, whichever blocks
    and warps hold them (k = 100: every row passes the threshold, and the
    select goes down to the rows' bits); an all-masked query fills no
    slot."""
    B, C, d = 2, 8000, 4
    cands = np.ones((B, C, d), np.float32)
    q = np.ones((B, d), np.float32)
    valid = np.ones((B, C), bool)
    valid[0, :1500] = False
    valid[1] = False
    s, i = k6_mirror(cands, q, k, valid, 8)
    assert i[0].tolist() == list(range(1500, 1500 + k))
    assert (s[0] == 4.0).all()
    assert i[1].tolist() == [I32_MAX] * k and np.isneginf(s[1]).all()


@pytest.mark.parametrize("masked", [False, True])
def test_k6_mirror_negative_scores_and_selection(masked):
    """Real-valued rows of d = 50 whose scores are all negative: one
    block's buffer is cut back to its k best more than once (the threshold
    rises), and the result equals the plain version bitwise."""
    rng = np.random.default_rng(5)
    B, C, d, k = 1, 12000, 50, 100
    cands = rng.standard_normal((B, C, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    cands -= (3.0 * np.sign(q))[:, None, :]
    valid = rng.random((B, C)) < 0.7 if masked else None
    stats = []
    got_s, got_i = k6_mirror(cands, q, k, valid, 1, stats=stats)
    ws, wi = ref.scored_topk_ref(
        torch.from_numpy(cands), torch.from_numpy(q), k=k,
        valid=None if valid is None else torch.from_numpy(valid))
    assert (ws.numpy() < 0).all()
    assert stats[0] >= 2
    np.testing.assert_array_equal(got_i, wi.numpy())
    np.testing.assert_array_equal(got_s, ws.numpy())


def test_k6_radix_threshold_keeps_exactly_the_best():
    """The select's threshold keeps exactly the k greatest keys, on keys
    that share long prefixes (equal scores: only the rows differ) and on
    spread ones."""
    rng = np.random.default_rng(3)
    for scores in (np.full(3000, 2.5, np.float32),
                   rng.integers(-2, 3, 3000).astype(np.float32),
                   rng.standard_normal(3000).astype(np.float32)):
        rows = rng.permutation(10**6)[:3000]
        keys = skey(scores, rows)
        for k in (1, 33, 100, 2999):
            pre = radix_threshold(keys, k)
            kept = np.sort(keys[keys >= np.uint64(pre)])
            np.testing.assert_array_equal(kept, np.sort(keys)[-k:])


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
@pytest.mark.parametrize("k", [10, 100, 1024])
def test_scored_topk_kernel_sasrec_shape(k):
    """SASRec's retrieval shape, C = 10^6 rows of d = 50 (200 bytes: staged
    in 8-byte units, copied as 16-byte pieces of a contiguous span), at its
    k = 100, at k = 10 (register lists) and k = 1,024; the same rows one
    element off a 16-byte boundary (4-byte units)."""
    _need_card()
    cands, q = _k6_case(10**6, 50, torch.float32, 50 + k)
    _k6_same(cands, q, k)
    flat = torch.cat([torch.zeros(1, device="cuda"), cands.reshape(-1)])
    _k6_same(flat[1:].view(10**6, 50), q, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_scored_topk_kernel_two_byte_units(dtype):
    """Odd d in 2-byte elements: 2-byte units, which cp.async cannot move
    (staged by plain loads), at k = 10 and k = 100 with a mask."""
    _need_card()
    cands, q = _k6_case(70001, 7, dtype, 17)
    g = torch.Generator().manual_seed(18)
    valid = (torch.rand(70001, generator=g) < 0.5).cuda()
    for k in (10, 100):
        _k6_same(cands, q, k)
        _k6_same(cands, q, k, valid)


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
