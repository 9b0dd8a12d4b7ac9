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

**How the port runs the loop.**  The frontier is a pool per row
(``core/heap.py``).  The trip loop is driven by the host, and every trip
computes all B rows at the full width P: rows that stopped, and pop lanes
past a row's live frontier, are masked, so their trips are exact no-ops.
That lets the host test ``any(live)`` — a device sync — only every
``_TRIPS_PER_SYNC`` trips.  The reference instead sizes each trip's descent
to the smallest pow2 bucket >= the widest live frontier of the batch; the
bucket changes no result, only the pad-waste counter ``padded``, which the
port computes from the same bucket rule on the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import heap as H
from repro_torch.core import wtbc
from repro_torch.core.scoring import dot_q
from repro_torch.core.wtbc import WTBCIndex

# host syncs of the loop-exit test: one every this many trips
_TRIPS_PER_SYNC = 16


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


def frontier_buckets(P: int) -> tuple[int, ...]:
    """Pow2 frontier-width buckets 1, 2, 4, …, capped by (and always
    including) the configured beam width P."""
    ws = []
    w = 1
    while w < P:
        ws.append(w)
        w *= 2
    ws.append(P)
    return tuple(ws)


def seg_valid(tf, score, wmask, conjunctive: bool):
    """A segment is kept when every query word occurs in it (AND) or its
    score is positive (OR).  ``tf`` (..., Q), ``wmask`` broadcastable."""
    if conjunctive:
        return torch.all((tf > 0) | ~wmask, -1) & torch.any(wmask, -1)
    return score > 0.0


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


class _State(NamedTuple):
    out_docs: torch.Tensor     # (B, k + 1) — slot k is a trash slot
    out_scores: torch.Tensor   # (B, k + 1)
    n_out: torch.Tensor        # (B,)
    iters: torch.Tensor
    pops: torch.Tensor
    padded: torch.Tensor


def live_rows(pool: H.Pool, st, k: int, max_pops: int | None):
    """Rows still searching: fewer than k answers, a non-empty frontier and
    pops left in the budget.  ``st`` has ``n_out`` and ``pops`` (B,)."""
    ok = (st.n_out < k) & (pool.size > 0)
    if max_pops is not None:
        ok = ok & (st.pops < max_pops)
    return ok


def _trip(idx, pool: H.Pool, st: _State, words, wmask, idf_w, *, P: int,
          buckets: torch.Tensor, k: int, conjunctive: bool,
          max_pops: int | None, kernel_backend: str) -> _State:
    """One beam trip of every row at width P (in place on ``pool``)."""
    B, Q = words.shape
    live = live_rows(pool, st, k, max_pops)
    # the reference's scalar bucket: smallest pow2 bucket >= the widest live
    # frontier of the batch (feeds only the pad-waste counter)
    n_live = torch.where(live, pool.size.clamp(max=P), 0).amax()
    S_b = buckets[(n_live > buckets[:-1]).sum()]

    s_p, d0, d1, tf, valid = H.pop_p(pool, P, live)
    single = valid & ((d1 - d0) == 1)
    multi = valid & ~single

    # exact-emission bound: the pending top after the pops and every popped
    # multi (whose descendants it strictly bounds) — a popped singleton that
    # lex-beats all of them is the globally next answer, ties included
    occupied = pool.scores > H.NEG_INF
    jt = H.lex_argmax(pool.scores, pool.d0, pool.d1, occupied)
    hv = occupied.any(1)
    cs = torch.cat([s_p, H.take(pool.scores, jt)[:, None]], 1)
    c0 = torch.cat([d0, H.take(pool.d0, jt)[:, None]], 1)
    c1 = torch.cat([d1, H.take(pool.d1, jt)[:, None]], 1)
    cv = torch.cat([multi, hv[:, None]], 1)
    j = H.lex_argmax(cs, c0, c1, cv)
    emit = single & (~cv.any(1, keepdim=True) | H.lex_gt(
        s_p, d0, d1, H.take(cs, j)[:, None], H.take(c0, j)[:, None],
        H.take(c1, j)[:, None]))
    slot = st.n_out[:, None] + torch.cumsum(emit.to(torch.int32), 1) - 1
    write = emit & (slot < k)
    at = torch.where(write, slot, k).long()
    out_docs = st.out_docs.scatter(1, at, torch.where(
        write, d0, st.out_docs.gather(1, at)))
    out_scores = st.out_scores.scatter(1, at, torch.where(
        write, s_p, st.out_scores.gather(1, at)))
    n_out = torch.clamp(st.n_out + emit.sum(1, dtype=torch.int32), max=k)

    # split every popped multi at the doc boundary nearest its middle; all
    # P×Q left-child tfs in ONE batched descent (masked lanes compute
    # degenerate extents and are discarded by the push enables)
    mid = torch.div(d0 + d1, 2, rounding_mode="floor").to(torch.int32)
    lo1, hi1 = wtbc.segment_extent(idx, d0, mid)
    tf1 = wtbc.count_range_batch(
        idx, words[:, None, :].expand(B, P, Q).reshape(-1),
        lo1[:, :, None].expand(B, P, Q).reshape(-1),
        hi1[:, :, None].expand(B, P, Q).reshape(-1),
        kernel_backend=kernel_backend).reshape(B, P, Q) * wmask[:, None, :]
    tf2 = tf - tf1
    idf3 = idf_w[:, None, :]
    s1, s2 = dot_q(tf1, idf3), dot_q(tf2, idf3)
    wm3 = wmask[:, None, :]
    # bulk reinsert, parent-major (left, right, unemitted single); with P=1 a
    # popped singleton is the pending maximum and always emitted, so the
    # re-push lane is dropped there
    lanes = [(s1, d0, mid, tf1, multi & seg_valid(tf1, s1, wm3, conjunctive)),
             (s2, mid, d1, tf2, multi & seg_valid(tf2, s2, wm3, conjunctive))]
    if P > 1:
        lanes.append((s_p, d0, d1, tf, single & ~emit))
    W = len(lanes)
    H.push_many(pool,
                torch.stack([x[0] for x in lanes], 2).reshape(B, P * W),
                torch.stack([x[1] for x in lanes], 2).reshape(B, P * W),
                torch.stack([x[2] for x in lanes], 2).reshape(B, P * W),
                torch.stack([x[3] for x in lanes], 2).reshape(B, P * W, Q),
                torch.stack([x[4] for x in lanes], 2).reshape(B, P * W))
    nv = valid.sum(1, dtype=torch.int32)
    live_i = live.to(torch.int32)
    return _State(out_docs, out_scores, n_out, st.iters + live_i,
                  st.pops + nv, st.padded + live_i * (S_b - nv))


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
    B, Q = words.shape
    P = int(beam_width)
    dev = words.device
    wmask = wmask.to(torch.bool)
    idf_w = torch.where(wmask, idf[words.long()], 0.0).to(torch.float32)

    tf0 = root_tf(idx, words, wmask, kernel_backend=kernel_backend)
    score0 = dot_q(tf0, idf_w)
    pool = H.make_pool(B, heap_cap, Q, dev)
    zeros = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    H.push_many(pool, score0[:, None], zeros, zeros + idx.n_docs, tf0[:, None],
                seg_valid(tf0, score0, wmask, conjunctive)[:, None])
    zb = torch.zeros(B, dtype=torch.int32, device=dev)
    st = _State(torch.full((B, k + 1), -1, dtype=torch.int32, device=dev),
                torch.full((B, k + 1), H.NEG_INF, dtype=torch.float32,
                           device=dev),
                zb, zb, zb, zb)
    buckets = torch.tensor(frontier_buckets(P), dtype=torch.int32, device=dev)
    kw = dict(P=P, buckets=buckets, k=k, conjunctive=conjunctive,
              max_pops=max_pops, kernel_backend=kernel_backend)
    while bool(live_rows(pool, st, k, max_pops).any()):
        for _ in range(_TRIPS_PER_SYNC):
            st = _trip(idx, pool, st, words, wmask, idf_w, **kw)
    cap = pool.cap
    out_docs, out_scores, n_out, certified, bound = anytime_finalize(
        pool.scores[:, :cap], pool.d0[:, :cap], pool.d1[:, :cap],
        st.out_docs, st.out_scores, st.n_out, pool.overflowed, k=k,
        harvest=max_pops is not None)
    return DRResult(out_docs[:, :k], out_scores[:, :k], n_out, st.iters,
                    st.pops, pool.overflowed, st.padded, certified, bound)


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
    ok = seg_valid(tf, s, wmask, conjunctive)
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
