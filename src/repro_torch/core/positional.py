"""Positional ranked retrieval over the WTBC: phrase and proximity queries.

The port of ``repro/core/positional.py``, at the same zero extra space:

* **phrase**: the query words must occur consecutively, in order.  The
  rarest valid word anchors the scan: each of its occurrences is located,
  the candidate start's neighbouring root positions are decoded, and a
  start whose decoded words equal the valid slots (in slot order) inside
  one document is a match.
* **near** (proximity): every valid word must occur inside a window of at
  most ``window`` tokens of one document.  Every occurrence of every valid
  slot is located and swept in text order; at each occurrence the best
  window ending there reaches back to the oldest last-seen occurrence among
  the slots (the classical minimal-cover recurrence).

**How the port runs them.**  The reference walks the occurrences of one
row with a ``while_loop`` per query.  Here a whole (B, Q) batch is batched
tensor work whose only data-dependent size, the batch's number of
occurrences, is read once per batch:

* phrase: the anchor occurrences of every row are lanes; each pass of at
  most ``chunk`` lanes is one locate (one ``wtbc_locate`` launch on the
  card) and one decode of every slot position (one ``wtbc_decode``
  launch), then a scatter-add of the phrase tf and a scatter-min of the
  first start per (row, document);
* near: the occurrences of every valid slot are located in passes of
  ``chunk`` lanes (one ``wtbc_locate`` launch each), put in (row,
  position, slot) order by one stable sort, and swept in passes of
  ``chunk``: each slot's last-seen position is a running maximum along the
  order (a ``cummax`` whose keys carry the row, so it never reaches back
  into the previous row, and which starts from the previous pass's last
  state), each (row, document) keeps the least (width, end) key by a
  scatter-min — the first of equal widths in text order, the reference's
  strict ``<`` —, and tf is a scatter-add per (row, slot, document).

Every scatter is an integer min or add, so results do not depend on
``chunk`` or on the order of the lanes: the CPU and the card agree bit for
bit.  Memory: the per-pass temporaries are O(chunk * Q); near also keeps
each located occurrence's position and its place in the order (12 bytes
an occurrence).  ``iters`` has the reference's closed form: the anchor's
occurrence count for phrase, and for near the valid slots' occurrences
(0 when a valid word is absent).

Scores use the measure's ``score`` over the (B, N, Q) tf table, so the DRB
tolerances apply against the reference (ROADMAP R4, R5); the top-k is
ordered by (score desc, document asc), ``lax.top_k``'s order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import heap as H
from repro_torch.core import scoring, wtbc
from repro_torch.core.wtbc import WTBCIndex

INT32_MAX = 2**31 - 1
_INT64_MAX = 2**63 - 1
# occurrences (lanes) per pass: bounds every temporary of a pass
CHUNK = 1 << 16


class PositionalResult(NamedTuple):
    docs: torch.Tensor       # (B, k) int32, -1 padded, descending score
    scores: torch.Tensor     # (B, k) float32, -inf padded
    n_found: torch.Tensor    # (B,) int32
    iters: torch.Tensor      # (B,) int32 — occurrences scanned (work metric)
    match_pos: torch.Tensor  # (B, k) int32 doc-relative match start, -1 padded
    match_len: torch.Tensor  # (B, k) int32 match width in tokens, -1 padded


def query_offsets(wmask: torch.Tensor) -> torch.Tensor:
    """Offset of each valid slot within the phrase (its position among the
    valid slots, in slot order), along the last axis; garbage for invalid
    slots — mask before use."""
    return torch.cumsum(wmask.to(torch.int32), -1, dtype=torch.int32) - 1


def doc_positions(idx: WTBCIndex, w, d, cap: int, *,
                  kernel_backend: str = "auto") -> torch.Tensor:
    """Doc-relative positions of word-rank ``w``'s occurrences in document
    ``d``, -1 padded to ``cap`` (``w`` and ``d`` broadcast; the result gains
    a trailing ``cap`` axis).  Per pair the two counts (before the document
    and inside it) of one batched count descent (K1 ``wavelet_count`` on the
    card), then one locate per position (one ``wtbc_locate`` launch for
    every pair)."""
    dev = idx.device
    w, d = torch.broadcast_tensors(torch.as_tensor(w, device=dev),
                                   torch.as_tensor(d, device=dev))
    shape = w.shape
    w = w.reshape(-1).to(torch.int32)
    d = d.reshape(-1).to(torch.int32)
    M = w.numel()
    lo, hi = wtbc.segment_extent(idx, d, d + 1)
    cnt = wtbc.count_range_batch(idx, torch.cat([w, w]),
                                 torch.cat([torch.zeros_like(lo), lo]),
                                 torch.cat([lo, hi]),
                                 kernel_backend=kernel_backend)
    before, tf = cnt[:M, None], cnt[M:, None]
    js = torch.arange(cap, dtype=torch.int32, device=dev)
    pos = wtbc.locate(idx, w[:, None].expand(M, cap),
                      before + torch.minimum(js, tf - 1) + 1,
                      kernel_backend=kernel_backend)
    return torch.where(js < tf, pos - lo[:, None], -1).reshape(*shape, cap)


def _lanes(counts: torch.Tensor, c0: int, c1: int):
    """Lanes [c0, c1) of segments of ``counts`` (1-D, laid end to end):
    each lane's segment and its 1-based number within it."""
    ends = torch.cumsum(counts.long(), 0)
    g = torch.arange(c0, c1, device=counts.device)
    seg = torch.searchsorted(ends, g, right=True)
    return seg, (g - (ends - counts)[seg] + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# phrase: anchor scan on the rarest word + decode adjacency check
# ---------------------------------------------------------------------------

def phrase_tables(idx: WTBCIndex, words: torch.Tensor, wmask: torch.Tensor, *,
                  chunk: int = CHUNK, kernel_backend: str = "auto"
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-document phrase term frequency and first match position of a
    (B, Q) batch.

    Returns ``(tf (B, N), first_pos (B, N), iters (B,))``: ``tf[b, d]``
    counts the occurrences in document ``d`` of the phrase formed by row
    ``b``'s valid slots (in slot order), ``first_pos[b, d]`` the doc-relative
    start of the first one (-1 when none), ``iters[b]`` the anchor's
    occurrences.  Duplicate query words need no care: adjacency is checked
    against the decoded text itself."""
    B, Q = words.shape
    dev = words.device
    N, n = idx.n_docs, idx.n
    wmask = wmask.to(torch.bool)
    offs = query_offsets(wmask)
    q_len = wmask.sum(1, dtype=torch.int32)
    occ_w = torch.where(wmask, idx.occ[words.long()], INT32_MAX)
    qstar = occ_w.argmin(1)                       # the lowest slot on ties
    row = torch.arange(B, device=dev)
    wstar = words[row, qstar].to(torch.int32)
    ostar = offs[row, qstar]
    iters = torch.where(wmask.any(1), idx.occ[wstar.long()], 0).to(
        torch.int32)
    tf = torch.zeros(B * (N + 1), dtype=torch.int32, device=dev)
    first = torch.full((B * (N + 1),), INT32_MAX, dtype=torch.int32,
                       device=dev)
    total = int(iters.sum())                      # the batch's one host read
    for c0 in range(0, total, chunk):
        b, j = _lanes(iters, c0, min(c0 + chunk, total))
        p = wtbc.locate(idx, wstar[b], j, kernel_backend=kernel_backend)
        start = p - ostar[b]
        d = wtbc.doc_of_pos(idx, p)
        lo = wtbc.doc_start(idx, d)
        inb = (start >= lo) & (start + q_len[b] <= wtbc.doc_end(idx, d))
        slot_pos = (start[:, None] + offs[b]).clamp(0, n - 1)
        dec = wtbc.decode_at(idx, slot_pos, kernel_backend=kernel_backend)
        match = inb & torch.all(~wmask[b] | (dec == words[b]), 1)
        at = b * (N + 1) + torch.where(match, torch.clamp(d, max=N), N)
        tf.index_add_(0, at, match.to(torch.int32))
        first.scatter_reduce_(0, at, torch.where(match, start - lo,
                                                 INT32_MAX), "amin")
    tf = tf.view(B, N + 1)[:, :N]
    first = first.view(B, N + 1)[:, :N]
    return tf, torch.where(tf > 0, first, -1), iters


# ---------------------------------------------------------------------------
# near: every occurrence in text order + minimal-cover sweep
# ---------------------------------------------------------------------------

def near_tables(idx: WTBCIndex, words: torch.Tensor, wmask: torch.Tensor, *,
                chunk: int = CHUNK, kernel_backend: str = "auto"
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """Per-document tf vector and minimal cover window of a (B, Q) batch.

    Returns ``(tf (B, Q, N), min_win (B, N), win_pos (B, N), iters (B,))``:
    ``min_win[b, d]`` is the width in tokens of the smallest window of
    document ``d`` holding an occurrence of every valid slot of row ``b``
    (INT32_MAX when there is none), ``win_pos[b, d]`` its doc-relative start
    (-1 when none), the leftmost of equal widths.  A row whose valid word
    does not occur scans nothing (all tf 0, ``iters`` 0)."""
    B, Q = words.shape
    dev = words.device
    N = idx.n_docs
    wmask = wmask.to(torch.bool)
    occ_w = torch.where(wmask, idx.occ[words.long()], 0)
    absent = (wmask & (occ_w == 0)).any(1)
    n_ev = torch.where(absent[:, None], 0, occ_w).reshape(-1)   # (B * Q,)
    iters = n_ev.view(B, Q).sum(1, dtype=torch.int32)
    total = int(iters.sum())                      # the batch's one host read
    flat_w = words.reshape(-1).to(torch.int32)
    # every occurrence located, segment (row, slot) by segment
    pos = torch.empty(total, dtype=torch.int32, device=dev)
    for c0 in range(0, total, chunk):
        c1 = min(c0 + chunk, total)
        seg, j = _lanes(n_ev, c0, c1)
        pos[c0:c1] = wtbc.locate(idx, flat_w[seg], j,
                                 kernel_backend=kernel_backend)
    # (row, position, slot) order: a segment lists its slot's positions
    # ascending and segments run in slot order, so a stable sort on (row,
    # position) puts a repeated word's lower slot first
    seg_all = torch.repeat_interleave(torch.arange(B * Q, device=dev),
                                      n_ev.long())
    order = torch.sort((seg_all // Q) << 31 | pos.long(), stable=True).indices
    del seg_all
    ends = torch.cumsum(n_ev.long(), 0)
    tf = torch.zeros(B * Q * (N + 1), dtype=torch.int32, device=dev)
    best = torch.full((B * (N + 1),), _INT64_MAX, dtype=torch.int64,
                      device=dev)
    qs = torch.arange(Q, device=dev)
    # the running maximum of each slot's last-seen position, encoded as
    # row * 2**32 + position + 1 (row * 2**32 alone: not seen in this row),
    # so a maximum never carries a previous row's position
    # (slots along the first axis: a scan along the last one runs in
    # parallel on the card, one along the first a thread per column)
    carry = torch.full((Q, 1), -1, dtype=torch.int64, device=dev)
    for c0 in range(0, total, chunk):
        o = order[c0:c0 + chunk]
        seg = torch.searchsorted(ends, o, right=True)
        b, q = seg // Q, seg % Q
        pm = pos[o].long()
        enc = (b << 32) + torch.where(qs[:, None] == q, pm + 1, 0)   # (Q, C)
        run = torch.cummax(torch.cat([carry, enc], 1), 1).values[:, 1:]
        carry = run[:, -1:]
        last = (run - (b << 32) - 1).t()                  # (C, Q); -1: unseen
        d = torch.clamp(wtbc.doc_of_pos(idx, pm), max=N)
        lo = wtbc.doc_start(idx, torch.clamp(d, max=N - 1)).long()
        wm = wmask[b]
        covered = torch.all(~wm | (last >= lo[:, None]), 1)
        wstart = torch.where(wm, last, INT32_MAX).amin(1)
        key = torch.where(covered, (pm - wstart + 1) << 32 | pm, _INT64_MAX)
        best.scatter_reduce_(0, b * (N + 1) + d, key, "amin")
        tf.index_add_(0, seg * (N + 1) + d,
                      torch.ones_like(d, dtype=torch.int32))
    best = best.view(B, N + 1)[:, :N]
    has = best < _INT64_MAX
    win = torch.where(has, best >> 32, INT32_MAX)
    start = (best & 0xFFFFFFFF) - win + 1
    lo = wtbc.doc_start(idx, torch.arange(N, dtype=torch.int32, device=dev))
    win_pos = torch.where(has, start - lo, -1)
    return (tf.view(B, Q, N + 1)[..., :N], win.to(torch.int32),
            win_pos.to(torch.int32), iters)


# ---------------------------------------------------------------------------
# ranked top-k entry points (mirror ranked.topk_dr / topk_dr_batch)
# ---------------------------------------------------------------------------

def topk_positional_batch(idx: WTBCIndex, words: torch.Tensor,
                          wmask: torch.Tensor, idf: torch.Tensor, *, k: int,
                          phrase: bool, measure, window=None, avg_dl=None,
                          chunk: int = CHUNK, kernel_backend: str = "auto"
                          ) -> PositionalResult:
    """Ranked positional top-k of a (B, Q) batch: ``words`` word-ranks,
    ``wmask`` the valid slots, ``idf`` (V,) the measure's idf table.

    phrase=True:  exact consecutive in-order match of the valid words; a
                  document's tf is its phrase-occurrence count and every
                  valid word is scored with it.
    phrase=False: proximity — eligible documents have a minimal cover window
                  of width <= ``window`` (required); scores use the full
                  per-document tf vector.

    ``avg_dl`` is BM25's mean document length (a float32 scalar); by
    default the exact one of ``scoring.avg_doc_len``.  Past the collection
    (``k > n_docs``) the slots are padded."""
    B, Q = words.shape
    dev = words.device
    N = idx.n_docs
    wmask = wmask.to(torch.bool)
    idf_w = torch.where(wmask, idf[words.long()], 0.0).to(torch.float32)
    if avg_dl is None:
        avg_dl = torch.tensor(scoring.avg_doc_len(
            idx.doc_len.cpu().numpy(), N), device=dev)
    kw = dict(chunk=chunk, kernel_backend=kernel_backend)
    if phrase:
        tf_p, first_pos, iters = phrase_tables(idx, words, wmask, **kw)
        tf_mat = tf_p[:, :, None] * wmask[:, None, :]              # (B, N, Q)
        eligible = tf_p > 0
        match_pos = first_pos
        match_len = wmask.sum(1, dtype=torch.int32)[:, None].expand(B, N)
    else:
        if window is None:
            raise ValueError("proximity search requires a window")
        tf_q, min_win, win_pos, iters = near_tables(idx, words, wmask, **kw)
        tf_mat = tf_q.transpose(1, 2) * wmask[:, None, :]
        eligible = min_win <= torch.as_tensor(window, device=dev)
        match_pos = win_pos
        match_len = torch.where(min_win < INT32_MAX, min_win, -1)
    scores = measure.score(tf_mat, idf_w[:, None, :], idx.doc_len, avg_dl)
    scores = torch.where(eligible, scores, H.NEG_INF)
    kk = min(k, N)
    top = torch.sort(scores, dim=1, descending=True,
                     stable=True).indices[:, :kk]
    top_s = scores.gather(1, top)
    ok = top_s > H.NEG_INF

    def pad(x, fill):
        return torch.cat([x, x.new_full((B, k - kk), fill)], 1)

    def pick(x):
        return pad(torch.where(ok, x.gather(1, top), -1).to(torch.int32), -1)
    return PositionalResult(
        docs=pad(torch.where(ok, top, -1).to(torch.int32), -1),
        scores=pad(top_s, H.NEG_INF),
        n_found=ok.sum(1, dtype=torch.int32),
        iters=iters,
        match_pos=pick(match_pos),
        match_len=pick(match_len))


def topk_positional(idx: WTBCIndex, words: torch.Tensor, wmask: torch.Tensor,
                    idf: torch.Tensor, *, k: int, phrase: bool, measure,
                    window=None, avg_dl=None, chunk: int = CHUNK,
                    kernel_backend: str = "auto") -> PositionalResult:
    """One query row (``words`` / ``wmask`` (Q,)) through
    :func:`topk_positional_batch`; (k,) / () leaves."""
    res = topk_positional_batch(idx, words[None], wmask[None], idf, k=k,
                                phrase=phrase, measure=measure, window=window,
                                avg_dl=avg_dl, chunk=chunk,
                                kernel_backend=kernel_backend)
    return PositionalResult(*(x[0] for x in res))

