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
conjunctive walk is one ``drb_walk`` launch on the card: every trip of every
row runs inside the kernel, at the full beam width P per trip, with no host
sync (``kernels/drb_walk.py``).  Its plain version, the CPU path, drives
the trips from the host: per trip one count batch for the B·(P·Q + Q)
in-document and cursor counts and one bitmap rank batch for the 2·B·Q
cursor ranks.  The bag-of-words search is loop-free and on the card one
``drb_or`` call (``kernels/drb_or.py``): a memset and three kernels — the
words' tables, one warp per live (row, word, document) to select, locate
and place its tf, then the scores of every document of every row fused
with each row's top-k and its merge — with no host sync.  Its plain
version, the CPU path, runs batched selects, locates and a scatter-add over
every row at once, then one ``scored_topk`` of the (n_docs, Q) per-word
parts against each row's idf weights.
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
from repro_torch.kernels import drb_or
from repro_torch.kernels import drb_walk as walk
from repro_torch.kernels.drb_walk import word_rank1  # noqa: F401 (public)


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


# ---------------------------------------------------------------------------
# conjunctive (AND) — the paper's triplet walk
# ---------------------------------------------------------------------------

def and_tables(idx: WTBCIndex, aux: DRBAux, words: torch.Tensor,
               wmask: torch.Tensor, measure, idf: torch.Tensor | None = None,
               avg_dl=None) -> walk.DRBQuery:
    """The (B, Q) tables the conjunctive walk runs on (``idf`` / ``avg_dl``
    as for :func:`topk_drb_and`)."""
    wmask, wl, valid, idf_w = _query_tables(idx, aux, words, wmask, measure,
                                            idf)
    df_w = idx.df[wl]
    return walk.DRBQuery(wl, valid, idf_w, df_w, valid.any(1),
                         torch.any(wmask & (df_w == 0), 1),
                         _avg_dl(idx, measure, avg_dl))


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
    qt = and_tables(idx, aux, words, wmask, measure, idf, avg_dl)
    st = walk.drb_walk(idx, aux, qt, walk.init_state(qt, k), measure, k=k,
                       beam_width=beam_width, max_pops=max_pops,
                       kernel_backend=kernel_backend)
    B = words.shape[0]
    found = st.top_s > H.NEG_INF
    complete = ~walk.has_work(qt, st.nd)   # stopped because done, not budgeted
    return DRResult(torch.where(found, st.top_d, -1), st.top_s,
                    found.sum(1, dtype=torch.int32), st.it, st.cands,
                    torch.zeros(B, dtype=torch.bool, device=words.device),
                    st.padded, certified=found & complete[:, None],
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

    Each row's word gathers at most ``max_df_cap`` documents (which must be
    >= the largest document frequency among the query words); every
    document is scored as its per-word parts (``measure.part``) times the
    idf weights, added left to right over Q, and the k best under (score
    desc, doc asc) among the documents some query word occurs in are kept.
    On the card the whole batch is one ``drb_or`` call — a memset and three
    kernels, no host sync (``kernels/drb_or.py``; ``min(k, n_docs) <=
    32768``); its plain version (a padded gather, a scatter-add, one
    ``scored_topk``) runs on the CPU and with ``kernel_backend="ref"``.
    ``idf`` / ``avg_dl`` as for :func:`topk_drb_and`.  Loop-free, hence
    always exhaustive and fully certified.  Every leaf is the reference's
    per-row ``topk_drb_or``."""
    idf_all = measure.idf(idx) if idf is None else idf
    return drb_or.drb_or(idx, aux, words, wmask, measure, k=k,
                         max_df_cap=max_df_cap, idf_all=idf_all,
                         avg=_avg_dl(idx, measure, avg_dl),
                         kernel_backend=kernel_backend)
