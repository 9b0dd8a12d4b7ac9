"""The ``drb_or`` kernels: WTBC-DRB's whole bag-of-words query on the card.

Redesigns K6 (``repro/kernels/topk_score.py``, ``_kernel``: scoring and a
per-tile top-k) on the DRB ``or`` path, where the query gathered every
word's documents in plain PyTorch around one ``bitmap_rank1`` and one
``scored_topk`` launch: ``csrc/drb_or.cu`` runs the whole query of a (B, Q)
batch as one memset and three kernels with no host sync between them — the
words' tables, one warp per live (row, word, document) for the gather (the
bitmap selects, the locate, the document search; ``csrc/wtbc_select.cuh``),
and the scoring fused with each row's top-k and its merge
(``csrc/drb_score.cuh``).  Every leaf of the result is written on the card.

The plain version stands beside it: :func:`drb_or_ref` (a padded gather, a
scatter-add, the per-word parts, one ``scored_topk``) is the CPU path and
the kernel's oracle; its bitmap ranks and top-k run their plain versions
too, so a comparison on the card holds the kernels against plain code end
to end.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitvec, wtbc
from repro_torch.core import heap as H
from repro_torch.core.ranked import DRResult
from repro_torch.kernels import backend, ops
from repro_torch.kernels.drb_walk import bitmap_args, scoring_args
from repro_torch.kernels.wavelet_descent import level_args, table_args

# documents per score block (``csrc/drb_or.cu``: kTile)
TILE = 4096
# query words of a row the score kernel keeps in shared memory
MAX_Q = 1024


def drb_or_ref(idx, aux, words: torch.Tensor, wmask: torch.Tensor, measure,
               *, k: int, max_df_cap: int, idf_all: torch.Tensor,
               avg) -> DRResult:
    """The plain version: every row's word is a padded ``max_df_cap``-wide
    gather of its documents (a select per document start; tf as the gap to
    the next), one scatter-add into a (B, Q, n_docs) tf table, the per-word
    parts, and one ``scored_topk`` of every row.  ``idf_all`` is the (V,)
    idf table, ``avg`` BM25's mean document length (a float32 scalar, or
    None under tf-idf)."""
    B, Q = words.shape
    dev = words.device
    N = idx.n_docs
    cap = int(max_df_cap)
    wmask = wmask.to(torch.bool)
    wl = words.long()
    valid = wmask & aux.has_bm[wl]
    idf_w = torch.where(valid, idf_all[wl], 0.0).to(torch.float32)
    df_w = torch.where(valid, idx.df[wl], 0)
    occ_w = aux.bit_off[wl + 1] - aux.bit_off[wl]
    js = torch.arange(cap, dtype=torch.int32, device=dev)
    live = (js < df_w[..., None]) & valid[..., None]                # (B,Q,cap)
    off = aux.bit_off[wl]
    base = bitvec.rank1(aux.bv, off, kernel_backend="ref")
    # one select per document; consecutive selects difference into tfs
    sels = bitvec.select1(aux.bv, base[..., None] + 1 + torch.arange(
        cap + 1, dtype=torch.int32, device=dev)) - off[..., None]
    sel = sels[..., :-1]
    tf = torch.where(js + 1 < df_w[..., None], sels[..., 1:],
                     occ_w[..., None]) - sel
    first = wtbc.locate(idx, wl[..., None].expand(B, Q, cap), sel + 1,
                        kernel_backend="ref")
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
                                   kernel_backend="ref")
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


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"drb_or: {what}")


def scratch_ints(B: int, Q: int, n_docs: int, k: int) -> int:
    """Ints of device scratch one query takes (``csrc/drb_or.cu``:
    ``scratch_ints``): the (B, N, Q) tf table and B tile tickets (zeroed),
    8 per (row, word), the prefix, a length per (row, tile), then each
    tile's best min(k, 4096) 64-bit keys."""
    n_tiles = -(-n_docs // TILE)
    n = B * n_docs * Q + B + 8 * B * Q + B * Q + 1 + B * n_tiles
    n += n & 1
    return n + 2 * B * n_tiles * min(k, TILE)


def launch_args(idx, aux, words: torch.Tensor, wmask: torch.Tensor, measure,
                *, k: int, max_df_cap: int, idf_all: torch.Tensor,
                avg) -> tuple:
    """The kernels' arguments up to ``k``, each checked for what the device
    code assumes (tensors on the batch's device, so the checks run on the
    CPU too): 1 <= B <= 65535 rows, 1 <= Q <= 1024 words, int32 words and a
    bool mask, ``max_df_cap >= 0``, ``k >= 1`` (any k: a tile keeps at
    most its 4,096 documents' keys), and the index's and bitmaps'
    layouts.  Raises ValueError on the first that
    fails."""
    B, Q = words.shape
    N = idx.n_docs
    cap = int(max_df_cap)
    dev = words.device
    _require(1 <= B <= 65535 and 1 <= Q <= MAX_Q,
             f"needs 1 <= B <= 65535 and 1 <= Q <= {MAX_Q} (got B={B}, "
             f"Q={Q})")
    _require(k >= 1, f"k={k} must be >= 1")
    _require(cap >= 0, f"max_df_cap={cap} must be >= 0")
    _require(N >= 1 and idx.device == dev,
             "the index must hold documents and lie on the batch's device")
    V = idx.vocab_size
    for name, t, dtype, shape in (
            ("words", words, torch.int32, (B, Q)),
            ("wmask", wmask, torch.bool, (B, Q)),
            ("idf", idf_all, torch.float32, (V,)),
            ("sep_pos", idx.sep_pos, torch.int32, (N,)),
            ("doc_len", idx.doc_len, torch.int32, (N,)),
            ("df", idx.df, torch.int32, (V,)),
            ("bit_off", aux.bit_off, torch.int32, (V + 1,)),
            ("has_bm", aux.has_bm, torch.bool, (V,))):
        _require(t.dtype == dtype and tuple(t.shape) == shape
                 and t.is_contiguous() and t.device == dev,
                 f"{name} must be a contiguous {dtype} {shape} on {dev}")
    bm25, avg_p, one_minus_b, b, k1p1, k1 = scoring_args(measure, avg, dev,
                                                         "drb_or")
    return (*level_args(idx.levels),
            *table_args(idx.cw, idx.cw_len, idx.node_off, idx.base_rank),
            idx.sep_pos.data_ptr(), idx.doc_len.data_ptr(), N,
            *bitmap_args(aux.bv, dev), aux.bit_off.data_ptr(),
            aux.has_bm.data_ptr(), idx.df.data_ptr(), idf_all.data_ptr(),
            words.data_ptr(), wmask.data_ptr(), B, Q, cap, bm25, avg_p,
            ctypes.c_float(one_minus_b), ctypes.c_float(b),
            ctypes.c_float(k1p1), ctypes.c_float(k1), k)


def drb_or(idx, aux, words: torch.Tensor, wmask: torch.Tensor, measure, *,
           k: int, max_df_cap: int, idf_all: torch.Tensor, avg,
           kernel_backend: str = "auto") -> DRResult:
    """Run the DRB ``or`` query of a (B, Q) batch (arguments as for
    :func:`drb_or_ref`).  On the card one memset and three kernels write
    every leaf with no host sync; on the CPU, or with
    ``kernel_backend="ref"``, the plain version runs.  Takes tf-idf and
    BM25; raises on what the kernels do not take (:func:`launch_args`)."""
    if not backend.use_kernel(words, kernel_backend):
        return drb_or_ref(idx, aux, words, wmask, measure, k=k,
                          max_df_cap=max_df_cap, idf_all=idf_all, avg=avg)
    args = launch_args(idx, aux, words, wmask, measure, k=k,
                       max_df_cap=max_df_cap, idf_all=idf_all, avg=avg)
    B = words.shape[0]
    dev = words.device
    n_scratch = scratch_ints(B, words.shape[1], idx.n_docs, k)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    top_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    top_d = torch.empty((B, k), dtype=torch.int32, device=dev)
    certified = torch.empty((B, k), dtype=torch.bool, device=dev)
    n_found, iters, pops = (torch.empty(B, dtype=torch.int32, device=dev)
                            for _ in range(3))
    overflowed = torch.empty(B, dtype=torch.bool, device=dev)
    bound = torch.empty(B, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        backend.DRB_OR.launch(
            *args, top_s.data_ptr(), top_d.data_ptr(), n_found.data_ptr(),
            iters.data_ptr(), pops.data_ptr(), overflowed.data_ptr(),
            certified.data_ptr(), bound.data_ptr(), scratch.data_ptr(),
            n_scratch)
    return DRResult(top_d, top_s, n_found, iters, pops, overflowed,
                    certified=certified, bound=bound)
