"""WTBC-DRB: ranked retrieval with additional per-word tf bitmaps (paper §3.2).

For every word whose idf exceeds a threshold eps, a bitmap
``1 0^{tf1-1} 1 0^{tf2-1} ...`` encodes its document list and per-document
term frequencies (one bit per *occurrence*; a 1 marks the first occurrence in
a new document).  All bitmaps live concatenated in one packed ``BitVec`` with
a per-word offset table.

Conjunctive queries: candidate generation walks the word with the fewest
unprocessed documents (the paper's triplets ``(wID, nDocs, i)``), locates the
candidate document through the WTBC, counts every query word inside it, and
skips all cursors past the candidate.  Bag-of-words: every word's documents
are enumerated from its bitmap and aggregated by a scatter-add into a
document tf table plus one top-k.

Because DRB scores fully materialized candidates, any additive-per-word
measure works — tf-idf (paper) and BM25 (paper §5's noted extension).

**How the port runs them.**  Both searches take a whole (B, Q) batch.  The
conjunctive walk is a host loop over trips, every row at the full beam width
P in each trip; rows that finished are masked, so their extra trips are
exact no-ops and the host tests ``any(live)`` — a device sync — only every
``_TRIPS_PER_SYNC`` trips.  Per trip: one ``wavelet_count`` launch for the
B·(P·Q + Q) in-document and cursor counts, one ``bitmap_rank1`` launch for
the 2·B·Q cursor ranks.  The bag-of-words search is loop-free: one
``bitmap_rank1`` launch for the B·Q bitmap base ranks, then batched selects,
locates and a scatter-add over every row at once, and one ``scored_topk``
launch that scores every document of every row (its (n_docs, Q) per-word
parts against the row's idf weights) and keeps each row's k best.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitvec, wtbc
from repro_torch.core import heap as H
from repro_torch.core.bitvec import BitVec
from repro_torch.core.ranked import DRResult
from repro_torch.core.scoring import BM25
from repro_torch.core.wtbc import WTBCIndex
from repro_torch.kernels import ops

INT32_MAX = H.INT32_MAX
# host syncs of the conjunctive loop-exit test: one every this many trips
# (a trip is a few hundred small launches, so the card drains between
# trips anyway and a sync costs little; extra trips of finished rows cost
# a whole trip each)
_TRIPS_PER_SYNC = 4


@dataclasses.dataclass(frozen=True)
class DRBAux:
    """The paper's 'small additional bitmaps' (its measured overhead: +3%)."""
    bv: BitVec              # concatenated tf bitmaps, word-rank order
    bit_off: torch.Tensor   # (V+1,) int32
    has_bm: torch.Tensor    # (V,) bool — idf >= eps (stopwords filtered out)
    eps: float


def build_aux(idx: WTBCIndex, model, doc_tokens: list[np.ndarray],
              eps: float = 1e-6,
              has_bm_override: np.ndarray | None = None) -> DRBAux:
    """Host-side bitmap construction (the reference's arrays), placed on the
    index's device.  ``eps`` follows the paper (1e-6 leaves out only
    near-universal stopwords); ``has_bm_override`` fixes the stored word set
    from outside."""
    V = model.vocab_size
    n_docs = len(doc_tokens)
    if has_bm_override is not None:
        has_bm = np.asarray(has_bm_override, dtype=bool).copy()
    else:
        df = idx.df.cpu().numpy()
        idf = np.log(np.maximum(n_docs, 1) / np.maximum(df, 1))
        has_bm = (idf >= eps) & (df > 0)
    has_bm[wtbc.SEP_RANK] = False

    # occurrences of stored words as (word_rank, doc) pairs, sorted by word
    # then doc: the tokens are in document order, so a stable sort by word
    # keeps each word's documents ascending
    lens = np.fromiter((len(d) for d in doc_tokens), dtype=np.int64,
                       count=n_docs)
    flat = np.concatenate(doc_tokens).astype(np.int64) if n_docs \
        else np.zeros(0, np.int64)
    ranks = model.rank_of_word[flat].astype(np.int64)
    docs = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    keep = has_bm[ranks]
    ranks, docs = ranks[keep], docs[keep]
    order = np.argsort(ranks, kind="stable")
    ranks, docs = ranks[order], docs[order]

    occ_stored = np.bincount(ranks, minlength=V)
    bit_off = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(occ_stored, out=bit_off[1:])
    n_bits = int(bit_off[-1])

    # a bit position is 1 iff its (word, doc) differs from its predecessor's
    pair = ranks * n_docs + docs
    is_one = np.ones(len(pair), dtype=bool)
    is_one[1:] = pair[1:] != pair[:-1]
    dev = idx.device
    return DRBAux(
        bv=bitvec.build(np.flatnonzero(is_one), max(n_bits, 1), device=dev),
        bit_off=torch.from_numpy(bit_off.astype(np.int32)).to(dev),
        has_bm=torch.from_numpy(has_bm).to(dev),
        eps=float(eps))


def space_report(aux: DRBAux) -> dict[str, int]:
    def nbytes(t):
        return t.numel() * t.element_size()
    return {"bitmap_bits_bytes": nbytes(aux.bv.words),
            "bitmap_counters": nbytes(aux.bv.counts),
            "bit_offsets": nbytes(aux.bit_off)}


# word-relative bitmap ops ----------------------------------------------------

def word_rank1(aux: DRBAux, w: torch.Tensor, i: torch.Tensor, *,
               kernel_backend: str = "auto") -> torch.Tensor:
    """Ones among the first ``i`` bits of word ``w``'s bitmap (= documents
    fully passed), elementwise; both ranks in one ``bitmap_rank1`` launch."""
    off = aux.bit_off[w.long()]
    n = off.numel()
    r = bitvec.rank1(aux.bv, torch.cat([(off + i).reshape(-1),
                                        off.reshape(-1)]),
                     kernel_backend=kernel_backend)
    return (r[:n] - r[n:]).reshape(off.shape)


def word_select1(aux: DRBAux, w: torch.Tensor, j: torch.Tensor, *,
                 kernel_backend: str = "auto") -> torch.Tensor:
    """Bit position (word-relative) of the ``j``-th 1 in ``w``'s bitmap."""
    off = aux.bit_off[w.long()]
    base = bitvec.rank1(aux.bv, off, kernel_backend=kernel_backend)
    return bitvec.select1(aux.bv, base + j) - off


def word_occ(aux: DRBAux, w: torch.Tensor) -> torch.Tensor:
    w = w.long()
    return aux.bit_off[w + 1] - aux.bit_off[w]


def _query_tables(idx: WTBCIndex, aux: DRBAux, words, wmask, measure, idf):
    wmask = wmask.to(torch.bool)
    wl = words.long()
    valid = wmask & aux.has_bm[wl]
    idf_all = measure.idf(idx) if idf is None else idf
    idf_w = torch.where(valid, idf_all[wl], 0.0).to(torch.float32)
    return wmask, wl, valid, idf_w


def _avg_dl(idx: WTBCIndex, measure, avg_dl):
    """BM25's mean document length as a float32 scalar on the index's
    device; the caller owns it (``scoring.avg_doc_len`` of the index's
    ``doc_len``, or a value carried across)."""
    if avg_dl is None:
        if isinstance(measure, BM25):
            raise ValueError("BM25 needs avg_dl (scoring.avg_doc_len of the "
                             "index's doc_len)")
        return None
    return torch.as_tensor(avg_dl, dtype=torch.float32, device=idx.device)


def _take_k(scores, docs, k: int):
    """The k best (score, doc) pairs of each row under (score desc, doc
    asc); -inf / -1 past the candidates."""
    B, n = scores.shape
    if n < k:
        scores = torch.cat([scores, scores.new_full((B, k - n), H.NEG_INF)], 1)
        docs = torch.cat([docs, docs.new_full((B, k - n), INT32_MAX)], 1)
    o = torch.sort(docs, dim=1, stable=True).indices
    s, d = scores.gather(1, o), docs.gather(1, o)
    o = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return s.gather(1, o), d.gather(1, o)


# ---------------------------------------------------------------------------
# conjunctive (AND) — the paper's triplet walk
# ---------------------------------------------------------------------------

def topk_drb_and(idx: WTBCIndex, aux: DRBAux, words: torch.Tensor,
                 wmask: torch.Tensor, measure, *, k: int,
                 idf: torch.Tensor | None = None, avg_dl=None,
                 beam_width: int = 1, max_pops: int | None = None,
                 kernel_backend: str = "auto") -> DRResult:
    """Paper §3.2 conjunctive search over a (B, Q) batch.  Each trip verifies
    ``beam_width`` (= P) candidate documents of every row's rarest word: P
    locates, then one batched count of all P×Q in-document tfs plus the Q
    cursor-advance prefix counts.

    ``idf`` defaults to this index's own table; ``avg_dl`` (a float32
    scalar) is required under BM25 and unused under tf-idf.  A masked
    word with no bitmap (a stopword, idf < eps) is left out of the
    conjunction and the score; a masked word absent from the collection
    makes the conjunction empty.

    The walk verifies every candidate whatever P is; consecutive
    occurrences in one document count once, and the retained top-k follows
    the total order (score desc, doc asc), so results do not depend on P.
    ``max_pops`` caps the candidate documents examined per row (``pops``);
    certification is all-or-nothing: a completed walk is exact (every slot
    certified, bound -inf), a budget-stopped one certifies nothing (bound
    +inf).  Every leaf is the reference's per-row ``topk_drb_and``."""
    B, Q = words.shape
    P = int(beam_width)
    dev = words.device
    wmask, wl, valid, idf_w = _query_tables(idx, aux, words, wmask, measure,
                                            idf)
    avg = _avg_dl(idx, measure, avg_dl)
    df_w = idx.df[wl]
    absent = torch.any(wmask & (df_w == 0), 1)
    any_valid = valid.any(1)
    row = torch.arange(B, device=dev)
    lanes = torch.arange(P, dtype=torch.int32, device=dev)

    p = torch.zeros((B, Q), dtype=torch.int32, device=dev)
    nd = torch.where(valid, df_w, INT32_MAX)
    top_s = torch.full((B, k), H.NEG_INF, dtype=torch.float32, device=dev)
    top_d = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    zb = torch.zeros(B, dtype=torch.int32, device=dev)
    it, cands, padded = zb, zb.clone(), zb.clone()

    def has_work(nd_):
        return (nd_.amin(1) > 0) & any_valid & ~absent

    def live_rows(nd_, it_, cands_):
        ok = has_work(nd_) & (it_ < idx.n_docs + 1)
        if max_pops is not None:
            ok = ok & (cands_ < max_pops)
        return ok

    def trip(p, nd, top_s, top_d, it, cands, padded):
        live = live_rows(nd, it, cands)
        qstar = torch.where(valid, nd, INT32_MAX).argmin(1)
        wstar = wl[row, qstar]
        occ_star = idx.occ[wstar]
        # candidates: the next P occurrences of the rarest word (their
        # documents are non-decreasing; the first is always a fresh one
        # because cursors sit on document boundaries)
        js = p[row, qstar][:, None] + 1 + lanes                     # (B, P)
        valid_j = js <= occ_star[:, None]
        jc = torch.minimum(js, occ_star.clamp(min=1)[:, None])
        pos_j = wtbc.locate(idx, wstar[:, None].expand(B, P), jc)
        d_j = wtbc.doc_of_pos(idx, pos_j)
        prev = torch.cat([torch.full((B, 1), -1, dtype=torch.int32,
                                     device=dev), d_j[:, :-1]], 1)
        new_j = valid_j & (d_j != prev)
        lo_j, hi_j = wtbc.segment_extent(idx, d_j, d_j + 1)
        d_last = torch.where(valid_j, d_j, -1).amax(1)
        hi_last = wtbc.segment_extent(idx, d_last, d_last + 1)[1]
        # one batch: P×Q in-document tfs + Q prefix counts at the last
        # candidate's end (the cursor-skip counts)
        cnt = wtbc.count_range_batch(
            idx,
            torch.cat([wl[:, None, :].expand(B, P, Q).reshape(B, P * Q), wl],
                      1).reshape(-1),
            torch.cat([lo_j[:, :, None].expand(B, P, Q).reshape(B, P * Q),
                       torch.zeros((B, Q), dtype=torch.int32, device=dev)],
                      1).reshape(-1),
            torch.cat([hi_j[:, :, None].expand(B, P, Q).reshape(B, P * Q),
                       hi_last[:, None].expand(B, Q)], 1).reshape(-1),
            kernel_backend=kernel_backend).reshape(B, P * Q + Q)
        tf = cnt[:, :P * Q].reshape(B, P, Q) * valid[:, None, :]
        cnt_last = cnt[:, P * Q:]
        present = new_j & torch.all((tf > 0) | ~valid[:, None, :], 2) \
            & any_valid[:, None] & live[:, None]
        dl = idx.doc_len[d_j.clamp(0, idx.n_docs - 1).long()]
        score = measure.score(tf, idf_w[:, None, :], dl, avg)        # (B, P)
        top_s, top_d = _take_k(
            torch.cat([top_s, torch.where(present, score, H.NEG_INF)], 1),
            torch.cat([top_d, torch.where(present, d_j, INT32_MAX)], 1), k)
        # advance all cursors past the last candidate (the paper's triplet
        # recomputation)
        passed = word_rank1(aux, wl, cnt_last, kernel_backend=kernel_backend)
        lv = live[:, None]
        p = torch.where(lv & valid, cnt_last, p)
        nd = torch.where(lv, torch.where(valid, df_w - passed, INT32_MAX), nd)
        li = live.to(torch.int32)
        return (p, nd, top_s, top_d, it + li,
                cands + li * new_j.sum(1, dtype=torch.int32),
                padded + li * (~valid_j).sum(1, dtype=torch.int32))

    st = (p, nd, top_s, top_d, it, cands, padded)
    while bool(live_rows(st[1], st[4], st[5]).any()):
        for _ in range(_TRIPS_PER_SYNC):
            st = trip(*st)
    p, nd, top_s, top_d, it, cands, padded = st
    found = top_s > H.NEG_INF
    complete = ~has_work(nd)       # stopped because done, not budgeted
    return DRResult(torch.where(found, top_d, -1), top_s,
                    found.sum(1, dtype=torch.int32), it, cands,
                    torch.zeros(B, dtype=torch.bool, device=dev), padded,
                    certified=found & complete[:, None],
                    bound=torch.where(complete, H.NEG_INF,
                                      float("inf")).to(torch.float32))


# ---------------------------------------------------------------------------
# bag-of-words (OR) — enumerate every word's documents from its bitmap
# ---------------------------------------------------------------------------

def topk_drb_or(idx: WTBCIndex, aux: DRBAux, words: torch.Tensor,
                wmask: torch.Tensor, measure, *, k: int, max_df_cap: int,
                idf: torch.Tensor | None = None, avg_dl=None,
                kernel_backend: str = "auto") -> DRResult:
    """Paper §3.2 bag-of-words over a (B, Q) batch: per word, walk its
    1-bits (document starts), locate each document's first occurrence
    through the WTBC, read tf as the gap to the next 1, aggregate per
    document, take the top-k.

    Every row's word is a padded ``max_df_cap``-wide gather (``max_df_cap``
    must be >= the largest document frequency among the query words); the
    aggregation is one scatter-add into a (B, Q, n_docs) tf table.  The
    final step scores every document as its per-word parts (``measure.part``)
    times the idf weights, added left to right over Q, and keeps the k best
    under (score desc, doc asc) among the documents some query word occurs
    in — one ``scored_topk`` (K6) launch for the whole batch, ``k <=
    32768``.  ``idf`` / ``avg_dl`` as for :func:`topk_drb_and`.  Loop-free,
    hence always exhaustive and fully certified.  Every leaf is the
    reference's per-row ``topk_drb_or``."""
    B, Q = words.shape
    dev = words.device
    N = idx.n_docs
    cap = int(max_df_cap)
    wmask, wl, valid, idf_w = _query_tables(idx, aux, words, wmask, measure,
                                            idf)
    avg = _avg_dl(idx, measure, avg_dl)
    df_w = torch.where(valid, idx.df[wl], 0)
    occ_w = word_occ(aux, wl)
    js = torch.arange(cap, dtype=torch.int32, device=dev)
    live = (js < df_w[..., None]) & valid[..., None]                # (B,Q,cap)
    off = aux.bit_off[wl]
    base = bitvec.rank1(aux.bv, off, kernel_backend=kernel_backend)
    # one select per document; consecutive selects difference into tfs
    sels = bitvec.select1(aux.bv, base[..., None] + 1 + torch.arange(
        cap + 1, dtype=torch.int32, device=dev)) - off[..., None]
    sel = sels[..., :-1]
    tf = torch.where(js + 1 < df_w[..., None], sels[..., 1:],
                     occ_w[..., None]) - sel
    first = wtbc.locate(idx, wl[..., None].expand(B, Q, cap), sel + 1)
    d = torch.where(live, wtbc.doc_of_pos(idx, first), N)          # N: drop
    tf = torch.where(live, tf, 0)
    table = torch.zeros((B, Q, N + 1), dtype=torch.int32, device=dev)
    table.scatter_add_(2, d.long(), tf)
    tf_t = table[..., :N].transpose(1, 2)                           # (B,N,Q)
    part = measure.part(tf_t, idx.doc_len, avg).contiguous()
    hit = torch.any((tf_t * valid[:, None, :]) > 0, 2)
    kk = min(k, N)
    tile = max(1024, 1 << (kk - 1).bit_length())
    top_s, top_d = ops.scored_topk(part, idf_w, k=kk, tile=tile, valid=hit,
                                   kernel_backend=kernel_backend)
    if kk < k:                                  # fewer documents than k
        top_s = torch.cat([top_s, top_s.new_full((B, k - kk), H.NEG_INF)], 1)
        top_d = torch.cat([top_d, top_d.new_full((B, k - kk), -1)], 1)
    found = top_s > H.NEG_INF
    width = torch.full((B,), cap, dtype=torch.int32, device=dev)
    return DRResult(torch.where(found, top_d, -1), top_s,
                    found.sum(1, dtype=torch.int32), width, width.clone(),
                    torch.zeros(B, dtype=torch.bool, device=dev),
                    certified=found,
                    bound=torch.full((B,), H.NEG_INF, dtype=torch.float32,
                                     device=dev))
