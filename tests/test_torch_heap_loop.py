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
* ``heap_loop``'s argument checks, which run before every launch.

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
