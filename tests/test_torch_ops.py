"""The port's K3, K4, K5 and K6 plain versions against the JAX reference (CPU).

* ``byte_rank`` (K5), ``bitmap_rank1`` (K3) and ``segment_tf`` (K4): the
  port's wrappers on CPU tensors (their plain versions) against the
  reference's Pallas kernels run under the interpreter (``interpret=True``,
  as ``tests/test_kernels.py`` runs them), against its ``ref.py`` oracles and
  against numpy counts — bitwise, at random positions and at 0, the end and
  block edges;
* the plain popcount against ``jax.lax.population_count`` on words with the
  top bit set;
* ``scored_topk`` (K6): scores within rtol 2e-5 / atol 1e-5 and indices
  equal against the reference's kernel and oracle (the reference's own
  tolerance: its oracle's ``@`` and the port's left-to-right sum round
  differently), over float32 / float16 and a C that is not a multiple of the
  tile; ties go to the lower row; and the reference kernel's padding fault
  (zero-scored padding rows displace a last tile of negative real rows),
  which the port does not share;
* the ``ops`` entry points dispatch by device and never launch on the CPU.

The tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card and skip elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvec as r_bitvec
from repro.core import bytemap as r_bytemap
from repro.kernels import bitmap_rank as r_bitmap_rank
from repro.kernels import byte_rank as r_byte_rank
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels import segment_tf as r_segment_tf
from repro.kernels import topk_score as r_topk_score
from repro_torch.core import bitvec, bytemap
from repro_torch.kernels import backend, ops, ref

torch.set_num_threads(1)


def edge_positions(rng, n, block, m):
    """m positions in [0, n] with 0, n and every block edge near them."""
    edges = [0, n, 1, max(n - 1, 0)]
    for e in range(block, n + 1, block):
        edges += [e - 1, e, min(e + 1, n)]
    pos = np.concatenate([edges, rng.integers(0, n + 1, m)])
    return np.clip(pos, 0, n).astype(np.int32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")


# ---------------------------------------------------------------------------
# K5: byte_rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,block", [(100, 256), (3000, 512), (9000, 1024),
                                     (9000, 4096), (0, 512)])
def test_byte_rank_plain_matches_reference_kernel(n, block):
    rng = np.random.default_rng(n + block)
    data = rng.integers(0, 12, n).astype(np.uint8)
    rbm = r_bytemap.build(data, block=block)
    pbm = bytemap.build(data, block=block, device="cpu")
    pos = edge_positions(rng, n, block, 40)
    byt = rng.integers(0, 13, len(pos)).astype(np.int32)
    before = backend.launch_counts()
    got = ops.rank_batch(pbm, torch.from_numpy(byt),
                         torch.from_numpy(pos)).numpy()
    assert backend.launch_counts() == before
    kern = np.asarray(r_byte_rank.byte_rank(
        rbm.data, rbm.counts, rbm.length, jnp.asarray(byt), jnp.asarray(pos),
        block=block, interpret=True))
    oracle = np.asarray(r_ref.byte_rank_ref(
        rbm.data, rbm.counts, rbm.length, jnp.asarray(byt), jnp.asarray(pos),
        block=block))
    direct = [r_bytemap.rank_np(data, int(b), int(p)) for b, p in zip(byt, pos)]
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_array_equal(
        got, np.asarray(r_ops.rank_batch(rbm, jnp.asarray(byt),
                                         jnp.asarray(pos))))


# ---------------------------------------------------------------------------
# K3: bitmap_rank1
# ---------------------------------------------------------------------------

def test_popcount_matches_jax_with_top_bit_set():
    rng = np.random.default_rng(7)
    words = rng.integers(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    words[:8] = [0, 1, 2**31, 2**32 - 1, 2**31 + 1, 0x80008000, 0xAAAAAAAA,
                 0x55555555]
    got = ref.popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    want = np.asarray(jax.lax.population_count(jnp.asarray(words)))
    np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("n_bits,dens", [(1, 1.0), (100, 0.3), (1024, 0.5),
                                         (5000, 0.9), (70000, 0.05),
                                         (3000, 0.0)])
def test_bitmap_rank1_plain_matches_reference_kernel(n_bits, dens):
    rng = np.random.default_rng(n_bits)
    set_bits = np.flatnonzero(rng.random(n_bits) < dens)
    rbv = r_bitvec.build(set_bits, n_bits)
    pbv = bitvec.build(set_bits, n_bits, device="cpu")
    np.testing.assert_array_equal(np.asarray(rbv.words).view(np.int32),
                                  pbv.words.numpy())
    np.testing.assert_array_equal(np.asarray(rbv.counts), pbv.counts.numpy())
    pos = edge_positions(rng, n_bits, 1024, 40)
    got = ops.bitmap_rank1_batch(pbv, torch.from_numpy(pos)).numpy()
    kern = np.asarray(r_bitmap_rank.bitmap_rank1(
        rbv.words, rbv.counts, rbv.n_bits, jnp.asarray(pos), interpret=True))
    oracle = np.asarray(r_ref.bitmap_rank1_ref(rbv.words, rbv.counts,
                                               rbv.n_bits, jnp.asarray(pos)))
    direct = [r_bitvec.rank1_np(set_bits, int(p)) for p in pos]
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, direct)


# ---------------------------------------------------------------------------
# K4: segment_tf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("byte", [0, 7, 15])
def test_segment_tf_plain_matches_reference_kernel(byte):
    rng = np.random.default_rng(5 + byte)
    n = 20000
    data = rng.integers(0, 16, n).astype(np.uint8)
    rbm = r_bytemap.build(data, block=1024)
    pbm = bytemap.build(data, block=1024, device="cpu")
    bounds = np.sort(np.concatenate([
        rng.choice(n + 1, size=40, replace=False), [0, n, 1024, 2048, 2047]])
    ).astype(np.int32)
    got = ops.segment_tf_batch(pbm, byte, torch.from_numpy(bounds)).numpy()
    kern = np.asarray(r_segment_tf.segment_tf(
        rbm.data, rbm.counts, rbm.length, jnp.int32(byte),
        jnp.asarray(bounds), block=1024, interpret=True))
    oracle = np.asarray(r_ops.segment_tf_batch(rbm, jnp.int32(byte),
                                               jnp.asarray(bounds)))
    direct = [(data[a:b] == byte).sum() for a, b in zip(bounds[:-1],
                                                        bounds[1:])]
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, direct)


# ---------------------------------------------------------------------------
# K6: scored_topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,d,k,tile,dtype", [
    (1000, 128, 5, 256, np.float32),
    (5000, 128, 10, 512, np.float32),
    (3000, 128, 8, 512, np.float16),
    (1537, 128, 4, 512, np.float32),     # C not a multiple of the tile
    (1537, 64, 32, 512, np.float16),
])
def test_scored_topk_plain_matches_reference_kernel(C, d, k, tile, dtype):
    """rtol 2e-5 / atol 1e-5 on scores, indices equal: the reference's own
    tolerance (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(C + k)
    cands = rng.standard_normal((C, d)).astype(dtype)
    q = rng.standard_normal(d).astype(dtype)
    s, i = ops.scored_topk(torch.from_numpy(cands), torch.from_numpy(q), k=k,
                           tile=tile)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    for rs, ri in (r_topk_score.scored_topk(jnp.asarray(cands), jnp.asarray(q),
                                            k=k, tile=tile, interpret=True),
                   r_ref.scored_topk_ref(jnp.asarray(cands), jnp.asarray(q),
                                         k=k)):
        np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_scored_topk_ties_go_to_the_lower_row():
    cands = np.zeros((3000, 16), np.float32)
    cands[[5, 2900, 17, 1024, 700], 0] = [2.0, 2.0, 1.0, 2.0, 1.0]
    q = np.ones(16, np.float32)
    s, i = ops.scored_topk(torch.from_numpy(cands), torch.from_numpy(q), k=6,
                           tile=512)
    np.testing.assert_array_equal(i.numpy(), [5, 1024, 2900, 17, 700, 0])
    rs, ri = r_ref.scored_topk_ref(jnp.asarray(cands), jnp.asarray(q), k=6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_scored_topk_merge_order_is_total():
    """The order is (score desc, row asc) whatever rows hold the scores and
    wherever they lie (the kernel merges its blocks' partials in it)."""
    cands = torch.zeros((41, 1))
    rows = [9, 40, 7, 3, 12]
    cands[rows, 0] = torch.tensor([1.0, 3.0, 3.0, 1.0, 3.0])
    valid = torch.zeros(41, dtype=torch.bool)
    valid[rows] = True
    ts, ti = ops.scored_topk(cands, torch.ones(1), k=5, valid=valid)
    np.testing.assert_array_equal(ti.numpy(), [7, 12, 40, 3, 9])
    np.testing.assert_array_equal(ts.numpy(), [3.0, 3.0, 3.0, 1.0, 1.0])


def test_reference_kernel_padding_displaces_negative_rows():
    """A fault of the reference kernel (ROADMAP Queue 3): it scores the last
    tile's padding rows 0 and drops them only after the merge, so when that
    tile's real rows score below 0 the padding takes their partial slots and
    the kernel loses them.  Its own oracle and the port return the true
    top-k."""
    rng = np.random.default_rng(11)
    C, tile = 512 + 3, 512
    cands = (-np.abs(rng.standard_normal((C, 16))) - 1).astype(np.float32)
    cands[-3:] = -0.01                   # the best rows, in the padded tile
    q = np.ones(16, np.float32)
    _, ri_kern = r_topk_score.scored_topk(jnp.asarray(cands), jnp.asarray(q),
                                          k=4, tile=tile, interpret=True)
    _, ri_ref = r_ref.scored_topk_ref(jnp.asarray(cands), jnp.asarray(q), k=4)
    _, pi = ops.scored_topk(torch.from_numpy(cands), torch.from_numpy(q), k=4,
                            tile=tile)
    assert list(np.asarray(ri_ref)[:3]) == [512, 513, 514]
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri_ref))
    assert not set(np.asarray(ri_kern).tolist()) & {512, 513, 514}


def test_scored_topk_valid_mask_keeps_rows_out():
    """The port's extension for WTBC-DRB: rows outside ``valid`` never
    compete, and a slot no eligible row fills is (-inf, 2**31 - 1).  With
    every row valid the result is the unmasked one."""
    rng = np.random.default_rng(4)
    cands = torch.from_numpy(rng.standard_normal((700, 8)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    s, i = ops.scored_topk(cands, q, k=12, tile=256)
    s1, i1 = ops.scored_topk(cands, q, k=12, tile=256,
                             valid=torch.ones(700, dtype=torch.bool))
    assert torch.equal(s, s1) and torch.equal(i, i1)
    valid = torch.zeros(700, dtype=torch.bool)
    valid[[3, 650, 99]] = True
    s2, i2 = ops.scored_topk(cands, q, k=5, tile=256, valid=valid)
    want = sorted([3, 650, 99],
                  key=lambda r: -float(cands[r].double() @ q.double()))
    assert i2[:3].tolist() == want
    assert i2[3:].tolist() == [2**31 - 1] * 2
    assert torch.isinf(s2[3:]).all() and torch.isfinite(s2[:3]).all()


def test_scored_topk_batch_equals_each_query():
    """A (B, C, d) batch in one call: each row bitwise the port's
    one-query result, and within the reference's tolerance (rtol 2e-5 /
    atol 1e-5, indices equal) of the reference oracle on that query."""
    rng = np.random.default_rng(8)
    B, C, d = 3, 1100, 16
    cands = rng.standard_normal((B, C, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    valid = rng.random((B, C)) < 0.3
    valid[2] = False
    valid[2, [5, 900]] = True                # fewer eligible rows than k
    s, i = ops.scored_topk(torch.from_numpy(cands), torch.from_numpy(q), k=7,
                           tile=512, valid=torch.from_numpy(valid))
    assert tuple(s.shape) == tuple(i.shape) == (B, 7)
    for b in range(B):
        s1, i1 = ops.scored_topk(torch.from_numpy(cands[b]),
                                 torch.from_numpy(q[b]), k=7, tile=512,
                                 valid=torch.from_numpy(valid[b]))
        assert torch.equal(s[b], s1) and torch.equal(i[b], i1)
    assert i[2, 2:].tolist() == [2**31 - 1] * 5
    for b in range(2):
        rs, ri = r_ref.scored_topk_ref(jnp.asarray(cands[b][valid[b]]),
                                       jnp.asarray(q[b]), k=7)
        np.testing.assert_allclose(s[b].numpy(), np.asarray(rs), rtol=2e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(
            i[b].numpy(), np.flatnonzero(valid[b])[np.asarray(ri)])


def test_scored_topk_argument_checks():
    c = torch.zeros((100, 8))
    with pytest.raises(ValueError, match="k="):
        ops.scored_topk(c, torch.zeros(8), k=101)
    with pytest.raises(ValueError, match="k="):
        ops.scored_topk(torch.zeros((2000, 8)), torch.zeros(8), k=600,
                        tile=512)
    with pytest.raises(ValueError, match="tile"):
        ops.scored_topk(c, torch.zeros(8), k=3, tile=12)
    with pytest.raises(ValueError, match="query"):
        ops.scored_topk(c, torch.zeros(9), k=3)
    with pytest.raises(ValueError, match="valid"):
        ops.scored_topk(c, torch.zeros(8), k=3, valid=torch.ones(99) > 0)
    with pytest.raises(ValueError, match="query"):
        ops.scored_topk(torch.zeros((2, 100, 8)), torch.zeros((3, 8)), k=3)
    with pytest.raises(ValueError, match="valid"):
        ops.scored_topk(torch.zeros((2, 100, 8)), torch.zeros((2, 8)), k=3,
                        valid=torch.ones(100) > 0)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_byte_rank_and_segment_tf_kernels_match_plain_on_card():
    _need_card()
    rng = np.random.default_rng(0)
    n, block = 50000, 1024
    data = rng.integers(0, 20, n).astype(np.uint8)
    bm = bytemap.build(data, block=block, device="cuda")
    pos = torch.from_numpy(edge_positions(rng, n, block, 3000)).cuda()
    byt = torch.from_numpy(rng.integers(0, 21, pos.numel()).astype(
        np.int32)).cuda()
    before = backend.launch_counts()["byte_rank"]
    got = ops.rank_batch(bm, byt, pos)
    assert backend.launch_counts()["byte_rank"] == before + 1
    assert torch.equal(got, ops.rank_batch(bm, byt, pos,
                                           kernel_backend="ref"))
    bounds = torch.sort(pos).values
    for byte in (0, 7):
        got = ops.segment_tf_batch(bm, byte, bounds)
        want = ops.segment_tf_batch(bm, byte, bounds, kernel_backend="ref")
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_bitmap_rank1_kernel_matches_plain_on_card():
    _need_card()
    rng = np.random.default_rng(1)
    n_bits = 200000
    bv = bitvec.build(np.flatnonzero(rng.random(n_bits) < 0.4), n_bits,
                      device="cuda")
    pos = torch.from_numpy(edge_positions(rng, n_bits, 1024, 4000)).cuda()
    got = ops.bitmap_rank1_batch(bv, pos)
    assert torch.equal(got, ops.bitmap_rank1_batch(bv, pos,
                                                   kernel_backend="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_scored_topk_kernel_matches_plain_on_card(dtype):
    _need_card()
    g = torch.Generator().manual_seed(3)
    cands = torch.randn((20000 + 37, 128), generator=g).to(dtype).cuda()
    q = torch.randn(128, generator=g).cuda()
    s, i = ops.scored_topk(cands, q, k=10, tile=1024)
    ws, wi = ops.scored_topk(cands, q, k=10, tile=1024, kernel_backend="ref")
    assert torch.equal(s, ws) and torch.equal(i, wi)
    valid = (torch.rand(cands.shape[0], generator=g) < 0.001).cuda()
    s, i = ops.scored_topk(cands, q, k=32, tile=1024, valid=valid)
    ws, wi = ops.scored_topk(cands, q, k=32, tile=1024, valid=valid,
                             kernel_backend="ref")
    assert torch.equal(s, ws) and torch.equal(i, wi)


@pytest.mark.cuda
def test_scored_topk_batch_kernel_matches_plain_on_card():
    """The WTBC-DRB bag-of-words shape: a batch of (C, Q) per-word parts
    against (B, Q) weights with an eligibility mask, one launch."""
    _need_card()
    g = torch.Generator().manual_seed(5)
    part = torch.rand((8, 30000, 4), generator=g).cuda()
    w = torch.rand((8, 4), generator=g).cuda()
    valid = (torch.rand((8, 30000), generator=g) < 0.05).cuda()
    before = backend.launch_counts()["scored_topk"]
    s, i = ops.scored_topk(part, w, k=10, tile=1024, valid=valid)
    assert backend.launch_counts()["scored_topk"] == before + 1
    ws, wi = ops.scored_topk(part, w, k=10, tile=1024, valid=valid,
                             kernel_backend="ref")
    assert torch.equal(s, ws) and torch.equal(i, wi)
