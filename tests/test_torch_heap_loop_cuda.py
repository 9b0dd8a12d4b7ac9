"""The heap core's loop on the card against its plain loop on the card.
Card only (the ``cuda`` marker); this file does not import JAX, so it runs
wherever the port does.

``ranked.topk_dr_batch`` on CUDA tensors runs ``heap_loop`` at P >= 2 and
``beam_loop`` at P = 1 (plus one ``wavelet_count`` launch for the root tf);
with ``kernel_backend="ref"`` it runs the plain host loop.  Every result
leaf — docs, scores, n_found, iters, pops, overflowed, padded, certified,
bound — must be bitwise equal: the port's results are bitwise equal between
the CPU and the card, and the kernels score with the plain loop's rounding.
Cases: and/or, with and without a pop budget, P = 2, 16, 32 and 64 (the
block-wide pop and push code has lanes past 32 at P >= 32), caps that
overflow, `or` frontiers past one summary chunk (256 slots), a pool whose
summaries do not fit shared memory, Q from 1 to 64, and a pool with many
holes below its high-water mark (the pushes' free-slot scan).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import mega, ranked, scoring, wtbc
from repro_torch.kernels import backend, heap_loop
from repro_torch.text import corpus

LEAVES = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
          "padded", "certified", "bound")
_BUILT = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")
    return torch.device("cuda")


def _engine(card):
    """(corpus, index on the card, model, idf): 1,500 documents whose `or`
    frontiers pass one summary chunk."""
    if "wide" not in _BUILT:
        cp = corpus.make_corpus(n_docs=1500, mean_doc_len=30,
                                vocab_size=2000, seed=5)
        idx, model = wtbc.build_index(cp.doc_tokens, cp.vocab_size, block=512,
                                      device=card)
        _BUILT["wide"] = (cp, idx, model, scoring.TfIdf().idf(idx))
    return _BUILT["wide"]


def _batch(cp, model, Q: int, seed: int, card):
    """Four rows of Q words: min(Q, 5) of document frequency 100-900, the
    rest among the 64 most common; row 1's last column masked and the last
    row's last word in one document (a conjunctive miss) at Q >= 2."""
    df = cp.doc_freqs()
    ids = np.arange(1, len(df))
    mid = ids[(df[ids] >= 100) & (df[ids] <= 900)]
    common = ids[np.argsort(-df[ids])][:64]
    rare = ids[df[ids] == 1]
    rng = np.random.default_rng(seed)
    words = np.zeros((4, Q), np.int32)
    mask = np.zeros((4, Q), bool)
    for r in range(4):
        nw = min(Q, 5)
        row = list(rng.choice(mid, nw, replace=False))
        row += list(rng.choice(common, Q - nw, replace=False))
        if r == 3 and Q >= 2:
            row[-1] = rare[0]
        words[r] = model.rank_of_word[np.array(row)]
        mask[r] = True
    if Q >= 2:
        mask[1, Q - 1] = False          # a padded column
    return (torch.from_numpy(words).to(card), torch.from_numpy(mask).to(card))


def _both(idx, idf, words, mask, **kw):
    """The kernel path (launches counted) and the plain loop on the card."""
    before = backend.launch_counts()
    got = ranked.topk_dr_batch(idx, words, mask, idf, **kw)
    after = backend.launch_counts()
    want = ranked.topk_dr_batch(idx, words, mask, idf, kernel_backend="ref",
                                **kw)
    torch.cuda.synchronize()
    for name in LEAVES:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    return got, {k: v - before[k] for k, v in after.items() if v > before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, "9P"])
@pytest.mark.parametrize("P", [2, 16, 32, 64])
@pytest.mark.parametrize("mode", ["and", "or"])
def test_heap_loop_matches_plain_on_card(card, mode, P, budget):
    cp, idx, model, idf = _engine(card)
    words, mask = _batch(cp, model, 4, 11 + P, card)
    _, launches = _both(idx, idf, words, mask, k=400,
                        conjunctive=mode == "and",
                        heap_cap=2 * idx.n_docs + 4, beam_width=P,
                        max_pops=None if budget is None else 9 * P)
    assert launches == {"wavelet_count": 1, "heap_loop": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [6, 257])
@pytest.mark.parametrize("P", [2, 16])
def test_heap_loop_overflow_on_card(card, P, cap):
    cp, idx, model, idf = _engine(card)
    words, mask = _batch(cp, model, 4, 3, card)
    got, _ = _both(idx, idf, words, mask, k=400, conjunctive=False,
                   heap_cap=cap, beam_width=P)
    assert bool(got.overflowed.any())


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 3, 8, 64])
def test_heap_loop_query_widths_on_card(card, Q):
    """2·nm·Q descent tasks from a few to past the block's 16 warps many
    times over; P = 3 has the non-pow2 buckets 1, 2, 3."""
    cp, idx, model, idf = _engine(card)
    words, mask = _batch(cp, model, Q, Q, card)
    for mode in ("or", "and"):
        _both(idx, idf, words, mask, k=100, conjunctive=mode == "and",
              heap_cap=2 * idx.n_docs + 4, beam_width=3, max_pops=600)


@pytest.mark.cuda
def test_heap_loop_global_summaries_on_card(card):
    """A pool of 1.2 M slots: its chunk summaries do not fit one block's
    shared memory and go to the global scratch, with the same results."""
    cp, idx, model, idf = _engine(card)
    words, mask = _batch(cp, model, 4, 7, card)
    _both(idx, idf, words, mask, k=50, conjunctive=False, heap_cap=1_200_000,
          beam_width=16, max_pops=2000)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 16, 64])
def test_heap_loop_pool_with_holes_on_card(card, P):
    """A pool the plain loop left after 40 trips at P = 16, with every
    other live slot then freed (holes all over, below the high-water mark),
    run to the end by the kernel and by the plain loop: the pool slot for
    slot, the state and the per-trip widths bitwise."""
    from repro_torch.core import heap as H
    cp, idx, model, idf = _engine(card)
    words, mask = _batch(cp, model, 4, 13, card)
    idf_w = torch.where(mask, idf[words.long()], 0.0).to(torch.float32)
    cap = 2 * idx.n_docs + 4
    pool, st = ranked.init_search(idx, words, mask, idf_w, k=400,
                                  conjunctive=False, cap=cap,
                                  kernel_backend="ref")
    st, _ = heap_loop.heap_loop_ref(idx, pool, st, words, mask, idf_w, P=16,
                                    k=400, conjunctive=False,
                                    max_pops=16 * 40)
    live = pool.scores[:, :cap] > H.NEG_INF
    drop = live & (torch.cumsum(live.to(torch.int32), 1) % 2 == 0)
    drop &= ~(live & (torch.cumsum(live.flip(1).to(torch.int32), 1)
                      .flip(1) == 1))           # keep the high-water mark
    pool.scores[:, :cap][drop] = H.NEG_INF
    pool.size.sub_(drop.sum(1, dtype=torch.int32))
    live = pool.scores[:, :cap] > H.NEG_INF
    hw = cap - torch.argmax(live.flip(1).to(torch.int32), 1)
    holes = [int((~live[b, :hw[b]]).sum()) for b in range(4)]
    assert max(holes) >= 64, holes
    runs = []
    for kb in ("auto", "ref"):
        p = H.Pool(*(t.clone() for t in pool))
        s = heap_loop.HeapState(*(t.clone() for t in st))
        s, widths = heap_loop.heap_loop(idx, p, s, words, mask, idf_w, P=P,
                                        k=400, conjunctive=False,
                                        max_pops=None, kernel_backend=kb)
        runs.append((p, s, widths))
    (gp, gs, gw), (wp, ws, ww) = runs
    torch.cuda.synchronize()
    for a, b in zip(gp, wp):
        assert torch.equal(a[:, :cap] if a.dim() > 1 else a,
                           b[:, :cap] if b.dim() > 1 else b)
    for name in ("out_docs", "out_scores", "n_out", "iters", "pops"):
        assert torch.equal(getattr(gs, name), getattr(ws, name)), name
    T = ww.shape[1]
    assert torch.equal(gw[:, :T], ww) and not bool(gw[:, T:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 17])
@pytest.mark.parametrize("mode", ["and", "or"])
def test_p1_route_matches_plain_on_card(card, mode, budget):
    """P = 1 runs on the mega core's beam_loop over the heap's pool; padded
    is 0 as the plain loop's."""
    cp, idx, model, idf = _engine(card)
    words, mask = _batch(cp, model, 4, 21, card)
    got, launches = _both(idx, idf, words, mask, k=50,
                          conjunctive=mode == "and",
                          heap_cap=2 * idx.n_docs + 4, beam_width=1,
                          max_pops=budget)
    assert launches == {"wavelet_count": 1, "beam_loop": 1}
    assert not bool(got.padded.any())


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [257, None, 1_200_000])
def test_mega_beam_loop_matches_plain_on_card(card, cap):
    """beam_loop shares the pool machinery (``csrc/pool.cuh``) with
    heap_loop: the mega core at a cap that overflows, the exact cap and a
    pool past shared memory, and/or, against its plain loop."""
    cp, idx, model, idf = _engine(card)
    words, mask = _batch(cp, model, 4, 5, card)
    for mode in ("or", "and"):
        kw = dict(k=400, conjunctive=mode == "and",
                  cap=idx.n_docs + 2 if cap is None else cap,
                  max_pops=None if cap != 1_200_000 else 3000)
        got = mega.topk_dr_mega(idx, words, mask, idf, **kw)
        want = mega.topk_dr_mega(idx, words, mask, idf, kernel_backend="ref",
                                 **kw)
        for name in LEAVES[:6] + LEAVES[7:]:
            assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.cuda
def test_heap_loop_raises_on_card(card):
    """What the kernel does not take raises; it never falls back."""
    cp, idx, model, idf = _engine(card)
    words, mask = _batch(cp, model, 4, 1, card)
    kw = dict(k=10, conjunctive=False, heap_cap=2 * idx.n_docs + 4)
    wide = words.repeat(1, 17)[:, :heap_loop.MAX_Q + 1]
    all_on = torch.ones_like(wide, dtype=torch.bool)
    with pytest.raises(ValueError, match="Q=65"):
        ranked.topk_dr_batch(idx, wide, all_on, idf, beam_width=4, **kw)
    with pytest.raises(ValueError, match="beam width"):
        ranked.topk_dr_batch(idx, words, mask, idf,
                             beam_width=heap_loop.MAX_P + 1, **kw)
