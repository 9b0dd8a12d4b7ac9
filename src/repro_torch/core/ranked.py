"""WTBC-DR: ranked retrieval with *no extra space* (paper §3.1, Algorithm 1).

Best-first search over segments (concatenations of consecutive documents),
driven by a priority queue keyed on segment tf-idf.  The whole collection is
the initial segment; popped multi-document segments are split at the document
boundary nearest their middle; a popped single-document segment is the next
most relevant answer (tf-idf is monotone over concatenation).  Conjunctive
(AND) queries additionally discard any segment in which some query word has
tf = 0.  Segments carry their integer tf vector, so the sibling's tf is an
exact subtraction and its score is recomputed from tf.

**Frontier batching** (the reference's DESIGN.md §6): each trip pops the
``beam_width`` (= P) best segments of a row at once, computes all P×Q
left-child term frequencies with ONE batched descent
(``wtbc.count_range_batch`` — the ``wavelet_count`` kernel on the card), and
bulk-reinserts the children.  A popped singleton is emitted only if it
precedes, in the total lex order, everything still pending; the rest are
pushed back.  The order is total, so the emission sequence is the same for
every beam width.

**Where the loop runs.**  The frontier is a pool per row (``core/heap.py``).
On the card the whole search of a batch is kernels: one ``wavelet_count``
launch for the root tf, then at P = 1 one ``beam_loop`` launch (heap P = 1
pops, emits and pushes exactly what the mega core does, so it runs the mega
core's loop on the heap's pool) and at P >= 2 one ``heap_loop`` launch
(``kernels/heap_loop.py``).  On the CPU, or with ``kernel_backend="ref"``,
the plain loop ``heap_loop_ref`` runs the trips from the host, every trip
over all B rows at the full width P: rows that stopped, and pop lanes past
a row's live frontier, are masked, so their trips are exact no-ops.  The
reference sizes each trip's descent to the smallest pow2 bucket >= the
widest live frontier of the batch; the bucket changes no result, only the
pad-waste counter ``padded``, which :func:`padded_from_widths` computes
from each row's live width per trip that both loops record.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import heap as H
from repro_torch.core import wtbc
from repro_torch.core.scoring import dot_q
from repro_torch.core.wtbc import WTBCIndex
from repro_torch.kernels import backend, beam_step
from repro_torch.kernels import heap_loop as HL


class DRResult(NamedTuple):
    docs: torch.Tensor           # (B, k) int32, -1 padded, by descending score
    scores: torch.Tensor         # (B, k) float32, -inf padded
    n_found: torch.Tensor        # (B,) int32
    iters: torch.Tensor          # (B,) int32 loop trips the row was live
    pops: torch.Tensor | None = None        # (B,) int32 segments popped
    overflowed: torch.Tensor | None = None  # (B,) bool a push was dropped
    padded: torch.Tensor | None = None      # (B,) int32 dead pop lanes paid
    certified: torch.Tensor | None = None   # (B, k) bool anytime certificate
    bound: torch.Tensor | None = None       # (B,) float32 pending score bound


def padded_from_widths(widths: torch.Tensor, P: int) -> torch.Tensor:
    """The reference's pad-waste counter from the (B, T) live widths of a
    batch's trips (``min(size, P)`` of a live row, 0 once it stopped): each
    trip pays, for every live row, its bucket — the smallest pow2 bucket at
    or above the batch's widest live frontier that trip — less its width:
    ``padded[b] = sum_t [w[b,t] > 0] * (bucket(max_b w[:,t]) - w[b,t])``."""
    buckets = torch.tensor(HL.frontier_buckets(P), dtype=torch.int32,
                           device=widths.device)
    widest = widths.amax(0)
    S = buckets[(widest[:, None] > buckets[None, :-1]).sum(1)]
    return torch.where(widths > 0, S[None, :] - widths, 0).sum(
        1, dtype=torch.int32)


def anytime_finalize(s, d0, d1, out_docs, out_scores, n_out, overflowed, *,
                     k: int, harvest: bool):
    """Anytime epilogue of every row (the reference's DESIGN.md §11).

    ``s``/``d0``/``d1`` are the (B, cap) pending frontier (score -inf =
    free).  Two steps:

    1. **Harvest** (only when a budget was in play): fill the remaining
       output slots with the lex-greatest pending *singleton* segments — real
       documents with exact scores, just not proven to beat every hidden one.
    2. **Certify**: the pending bound is the lex-max key over everything
       still pending.  A slot is certified iff its key ``(score, d, d+1)``
       lex-beats that bound; ``overflowed`` vetoes certification.

    Returns ``(out_docs, out_scores, n_out, certified (B, k), bound (B,))``.
    """
    B = s.shape[0]
    row = torch.arange(B, device=s.device)
    valid = s > H.NEG_INF
    single = valid & ((d1 - d0) == 1)
    remaining = valid
    out_docs, out_scores, n_out = out_docs.clone(), out_scores.clone(), n_out.clone()
    if harvest:
        sing = single.clone()
        for _ in range(k):
            j = H.lex_argmax(s, d0, d1, sing)
            write = sing.any(1) & (n_out < k)
            at = torch.where(write, n_out, k).long()
            out_docs[row, at] = torch.where(write, d0[row, j], out_docs[row, at])
            out_scores[row, at] = torch.where(write, s[row, j], out_scores[row, at])
            sing[row, j] = sing[row, j] & ~write
            n_out = n_out + write.to(torch.int32)
        remaining = (valid & ~single) | sing
    has_rem = remaining.any(1)
    j = H.lex_argmax(s, d0, d1, remaining)
    bnd_s = torch.where(has_rem, s[row, j], H.NEG_INF)
    bnd_d0 = torch.where(has_rem, d0[row, j], H.INT32_MAX)
    bnd_d1 = torch.where(has_rem, d1[row, j], H.INT32_MIN)
    filled = (torch.arange(out_docs.shape[1], device=s.device)[None, :]
              < n_out[:, None])
    certified = filled & ~overflowed[:, None] & H.lex_gt(
        out_scores, out_docs, out_docs + 1,
        bnd_s[:, None], bnd_d0[:, None], bnd_d1[:, None])
    return out_docs, out_scores, n_out, certified[:, :k], bnd_s


def root_tf(idx: WTBCIndex, words, wmask, *, kernel_backend: str):
    """tf of every query word over the whole collection; (B, Q)."""
    B, Q = words.shape
    lo0, hi0 = wtbc.segment_extent(
        idx, torch.zeros(1, dtype=torch.int32, device=words.device),
        torch.full((1,), idx.n_docs, dtype=torch.int32, device=words.device))
    tf0 = wtbc.count_range_batch(idx, words.reshape(-1), lo0.expand(B * Q),
                                 hi0.expand(B * Q),
                                 kernel_backend=kernel_backend)
    return tf0.reshape(B, Q) * wmask


def init_search(idx: WTBCIndex, words, wmask, idf_w, *, k: int,
                conjunctive: bool, cap: int, kernel_backend: str
                ) -> tuple[H.Pool, HL.HeapState]:
    """Pools of ``cap`` slots holding each row's root segment [0, n_docs)
    when it is valid, empty outputs and zero counters."""
    B, Q = words.shape
    dev = words.device
    tf0 = root_tf(idx, words, wmask, kernel_backend=kernel_backend)
    score0 = dot_q(tf0, idf_w)
    pool = H.make_pool(B, cap, Q, dev)
    zeros = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    H.push_many(pool, score0[:, None], zeros, zeros + idx.n_docs, tf0[:, None],
                H.seg_valid(tf0, score0, wmask, conjunctive)[:, None])
    return pool, HL.init_state(B, k, dev)


def topk_dr_batch(idx: WTBCIndex, words: torch.Tensor, wmask: torch.Tensor,
                  idf: torch.Tensor, *, k: int, conjunctive: bool,
                  heap_cap: int, max_pops: int | None = None,
                  beam_width: int = 1, kernel_backend: str = "auto"
                  ) -> DRResult:
    """Algorithm 1, frontier-batched, over a batch of queries: ``words`` /
    ``wmask`` are (B, Q) word ranks / valid-word mask, ``idf`` the (V,) idf
    table.  ``heap_cap`` >= 2*n_docs + 2 makes the search exact; a smaller
    cap drops pushes and latches ``overflowed``.

    ``max_pops`` is the anytime budget: a row stops once that many segments
    have been popped (checked per trip, so with P > 1 it may overshoot by
    < P) and returns what it emitted, harvested and certified.  Every result
    leaf is the reference ``topk_dr_batch``'s at the same (B, Q)."""
    P = int(beam_width)
    wmask = wmask.to(torch.bool)
    idf_w = torch.where(wmask, idf[words.long()], 0.0).to(torch.float32)
    pool, st = init_search(idx, words, wmask, idf_w, k=k,
                           conjunctive=conjunctive, cap=heap_cap,
                           kernel_backend=kernel_backend)
    kw = dict(k=k, conjunctive=conjunctive, max_pops=max_pops,
              kernel_backend=kernel_backend)
    if P == 1 and backend.use_kernel(words, kernel_backend):
        # heap P = 1 pops, emits and pushes what the mega core does (every
        # leaf; padded is 0): its loop updates the pool and state in place
        beam_step.beam_loop(idx, beam_step.MegaState(pool, *st[:5]), words,
                            wmask, idf_w, **kw)
        padded = st.padded
    else:
        st, widths = HL.heap_loop(idx, pool, st, words, wmask, idf_w, P=P,
                                  **kw)
        padded = padded_from_widths(widths, P)
    cap = pool.cap
    out_docs, out_scores, n_out, certified, bound = anytime_finalize(
        pool.scores[:, :cap], pool.d0[:, :cap], pool.d1[:, :cap],
        st.out_docs, st.out_scores, st.n_out, pool.overflowed, k=k,
        harvest=max_pops is not None)
    return DRResult(out_docs[:, :k], out_scores[:, :k], n_out, st.iters,
                    st.pops, pool.overflowed, padded, certified, bound)


def topk_dr(idx: WTBCIndex, words, wmask, idf, **kw) -> DRResult:
    """One query row (Q,): ``topk_dr_batch`` at B = 1, leaves squeezed."""
    res = topk_dr_batch(idx, words[None], wmask[None], idf, **kw)
    return DRResult(*(None if x is None else x[0] for x in res))


def topk_bruteforce(idx: WTBCIndex, words, wmask, idf, *, k: int,
                    conjunctive: bool, kernel_backend: str = "auto",
                    chunk: int = 1 << 16) -> DRResult:
    """Score every document directly with ``count_range_batch`` — an
    O(N·Q) oracle for one query row ``words``/``wmask`` (Q,).  Ties keep the
    lower document id first, as ``lax.top_k`` does."""
    n_docs = idx.n_docs
    dev = words.device
    wmask = wmask.to(torch.bool)
    Q = words.shape[0]
    idf_w = torch.where(wmask, idf[words.long()], 0.0).to(torch.float32)
    d = torch.arange(n_docs, dtype=torch.int32, device=dev)
    lo, hi = wtbc.segment_extent(idx, d, d + 1)
    tfs = []
    step = max(1, chunk // Q)
    for s in range(0, n_docs, step):
        m = min(step, n_docs - s)
        tfs.append(wtbc.count_range_batch(
            idx, words[None, :].expand(m, Q).reshape(-1),
            lo[s:s + m, None].expand(m, Q).reshape(-1),
            hi[s:s + m, None].expand(m, Q).reshape(-1),
            kernel_backend=kernel_backend).reshape(m, Q))
    tf = torch.cat(tfs) * wmask
    s = dot_q(tf, idf_w)
    ok = H.seg_valid(tf, s, wmask, conjunctive)
    s = torch.where(ok, s, H.NEG_INF)
    order = torch.sort(s, descending=True, stable=True).indices[:k]
    top_s = s[order]
    found = top_s > H.NEG_INF
    top_d = torch.where(found, order.to(torch.int32), -1)
    n = torch.tensor(n_docs, dtype=torch.int32, device=dev)
    return DRResult(top_d, top_s, found.sum(dtype=torch.int32), n, n,
                    torch.zeros((), dtype=torch.bool, device=dev),
                    certified=found,
                    bound=torch.tensor(H.NEG_INF, device=dev))
