"""The ``drb_walk`` kernel: WTBC-DRB's whole conjunctive walk in one launch.

Redesigns K3 (``repro/kernels/bitmap_rank.py``, ``_kernel``) on the DRB
``and`` path, where the walk made one ``wavelet_count`` and one
``bitmap_rank1`` launch per trip from a host loop amid a few hundred plain
launches: ``csrc/drb_walk.cu`` runs every trip of every row inside the
kernel, one thread block per row, with the bitmap rank, the count descent
(``csrc/wtbc_descent.cuh``) and a byte select as device functions.

The plain version stands beside it: :func:`drb_and_trip` is one trip of the
paper's triplet walk over every row of a (B, Q) batch (the rarest word's
next P occurrences located, their documents counted and scored, the top-k
kept, the cursors advanced) and :func:`drb_walk_ref` drives it from the
host, testing ``any(live)`` every few trips — trips of stopped rows are
exact no-ops.  It is the CPU path and the kernel's oracle.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import bitvec, wtbc
from repro_torch.core import heap as H
from repro_torch.core.scoring import BM25, TfIdf, _f32
from repro_torch.kernels import backend
from repro_torch.kernels.bitmap_rank import WORDS_PER_BLOCK
from repro_torch.kernels.wavelet_descent import level_args, table_args

INT32_MAX = H.INT32_MAX
# host syncs of the plain loop's exit test: one every this many trips
# (a trip is a few hundred small launches, so the card drains between
# trips anyway and a sync costs little; extra trips of finished rows cost
# a whole trip each)
_TRIPS_PER_SYNC = 4
# a row's workspace goes to shared memory up to this many bytes, else to
# device scratch (an H100 block may use 227 KB)
MAX_SHARED_WS = 200 * 1024


class DRBQuery(NamedTuple):
    """The (B, Q) batch's tables, fixed for the whole walk."""
    wl: torch.Tensor          # (B, Q) int64 word ranks
    valid: torch.Tensor       # (B, Q) bool — masked and with a bitmap
    idf_w: torch.Tensor       # (B, Q) float32, 0 where not valid
    df_w: torch.Tensor        # (B, Q) int32
    any_valid: torch.Tensor   # (B,) bool
    absent: torch.Tensor      # (B,) bool — a masked word occurs nowhere
    avg: torch.Tensor | None  # float32 scalar (BM25), else None


class DRBState(NamedTuple):
    """Per-row walk state (updated in place by the kernel)."""
    p: torch.Tensor           # (B, Q) int32 occurrences passed per word
    nd: torch.Tensor          # (B, Q) int32 documents left (INT32_MAX: none)
    top_s: torch.Tensor       # (B, k) float32, (score desc, doc asc)
    top_d: torch.Tensor       # (B, k) int32
    it: torch.Tensor          # (B,) int32 trips
    cands: torch.Tensor       # (B,) int32 candidate documents examined
    padded: torch.Tensor      # (B,) int32 dead candidate lanes

    def clone(self) -> "DRBState":
        return DRBState(*(t.clone() for t in self))


def init_state(qt: DRBQuery, k: int) -> DRBState:
    B, Q = qt.valid.shape
    dev = qt.valid.device
    zb = torch.zeros(B, dtype=torch.int32, device=dev)
    return DRBState(torch.zeros((B, Q), dtype=torch.int32, device=dev),
                    torch.where(qt.valid, qt.df_w, INT32_MAX),
                    torch.full((B, k), H.NEG_INF, dtype=torch.float32,
                               device=dev),
                    torch.full((B, k), -1, dtype=torch.int32, device=dev),
                    zb, zb.clone(), zb.clone())


def has_work(qt: DRBQuery, nd: torch.Tensor) -> torch.Tensor:
    return (nd.amin(1) > 0) & qt.any_valid & ~qt.absent


def live_rows(idx, qt: DRBQuery, st: DRBState, max_pops) -> torch.Tensor:
    ok = has_work(qt, st.nd) & (st.it < idx.n_docs + 1)
    if max_pops is not None:
        ok = ok & (st.cands < max_pops)
    return ok


def word_rank1(aux, w: torch.Tensor, i: torch.Tensor, *,
               kernel_backend: str = "auto") -> torch.Tensor:
    """Ones among the first ``i`` bits of word ``w``'s bitmap (= documents
    fully passed), elementwise; both ranks in one ``bitmap_rank1`` launch."""
    off = aux.bit_off[w.long()]
    n = off.numel()
    r = bitvec.rank1(aux.bv, torch.cat([(off + i).reshape(-1),
                                        off.reshape(-1)]),
                     kernel_backend=kernel_backend)
    return (r[:n] - r[n:]).reshape(off.shape)


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


def drb_and_trip(idx, aux, qt: DRBQuery, st: DRBState, measure, *, k: int,
                 beam_width: int, max_pops: int | None,
                 kernel_backend: str) -> DRBState:
    """One trip of every row: P locates of the rarest word's next
    occurrences, one batched count of all P×Q in-document tfs plus the Q
    cursor-advance prefix counts, the scores into the top-k, the cursors
    past the last candidate."""
    p, nd, top_s, top_d, it, cands, padded = st
    wl, valid, idf_w, df_w, any_valid, _, avg = qt
    B, Q = wl.shape
    P = int(beam_width)
    dev = wl.device
    row = torch.arange(B, device=dev)
    lanes = torch.arange(P, dtype=torch.int32, device=dev)
    live = live_rows(idx, qt, st, max_pops)
    qstar = torch.where(valid, nd, INT32_MAX).argmin(1)
    wstar = wl[row, qstar]
    occ_star = idx.occ[wstar]
    # candidates: the next P occurrences of the rarest word (their
    # documents are non-decreasing; the first is always a fresh one
    # because cursors sit on document boundaries)
    js = p[row, qstar][:, None] + 1 + lanes                     # (B, P)
    valid_j = js <= occ_star[:, None]
    jc = torch.minimum(js, occ_star.clamp(min=1)[:, None])
    pos_j = wtbc.locate(idx, wstar[:, None].expand(B, P), jc,
                        kernel_backend=kernel_backend)
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
    return DRBState(p, nd, top_s, top_d, it + li,
                    cands + li * new_j.sum(1, dtype=torch.int32),
                    padded + li * (~valid_j).sum(1, dtype=torch.int32))


def drb_walk_ref(idx, aux, qt: DRBQuery, st: DRBState, measure, *, k: int,
                 beam_width: int, max_pops: int | None) -> DRBState:
    """The plain version: trips driven from the host until no row is live.
    Its counts and ranks run the plain ``wavelet_count`` and
    ``bitmap_rank1`` too, so a comparison on the card holds the kernel
    against plain code end to end."""
    while bool(live_rows(idx, qt, st, max_pops).any()):
        for _ in range(_TRIPS_PER_SYNC):
            st = drb_and_trip(idx, aux, qt, st, measure, k=k,
                              beam_width=beam_width, max_pops=max_pops,
                              kernel_backend="ref")
    return st


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"drb_walk: {what}")


def budget_arg(max_pops: int | None) -> int:
    """``max_pops`` as the kernel takes it: -1 for no budget.  A negative
    budget stops every row before its first trip, as 0 does in the plain
    loop (``cands < max_pops`` with cands >= 0), so it goes in as 0."""
    return -1 if max_pops is None else max(int(max_pops), 0)


def ws_bytes(Q: int, P: int, k: int) -> int:
    """Bytes of one row's workspace (``csrc/drb_walk.cu``: ``ws_ints``):
    per word its path (10 ints) and 10 more ints, per candidate 6, two
    endpoint ranks per (candidate, word), two top-k buffers."""
    return 4 * (Q * 20 + 6 * P + 2 * P * Q + 4 * k)


def bitmap_args(bv, dev) -> tuple:
    """(words, counts, n_blocks, n_bits) of the tf bitmaps as the DRB
    kernels take them, checked for what the device code assumes: contiguous
    int32 words of whole 32-word blocks, (n_blocks + 1,) int32 counters and
    int32 bit positions, on ``dev``."""
    def need(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"tf bitmaps: {what}")
    n_blocks = bv.counts.shape[0] - 1
    need(bv.words.dtype == torch.int32 and bv.words.is_contiguous()
         and bv.words.numel() == n_blocks * WORDS_PER_BLOCK
         and bv.words.device == dev, "the words must be contiguous int32 of "
         f"n_blocks*{WORDS_PER_BLOCK} on {dev}")
    need(bv.counts.dtype == torch.int32 and bv.counts.is_contiguous()
         and bv.counts.dim() == 1 and bv.counts.device == dev,
         "the counts must be contiguous (n_blocks+1,) int32")
    need(0 <= bv.n_bits <= n_blocks * WORDS_PER_BLOCK * 32 < 2**31,
         "n_bits must fit the words and int32 positions")
    return bv.words.data_ptr(), bv.counts.data_ptr(), n_blocks, bv.n_bits


def scoring_args(measure, avg, dev, who: str = "drb_walk") -> tuple:
    """(bm25, avg_dl pointer, 1 - b, b, k1 + 1, k1) as the DRB kernels take
    them (``csrc/drb_score.cuh``): the host's float32 constants of
    ``core/scoring.py``; ``avg`` BM25's float32 scalar on ``dev``.  Raises,
    naming ``who``, on a measure no kernel scores."""
    def need(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"{who}: {what}")
    if isinstance(measure, BM25):
        need(avg is not None and avg.dtype == torch.float32
             and avg.numel() == 1 and avg.device == dev,
             "BM25 needs avg_dl as a float32 scalar on the batch's device")
        return (1, avg.data_ptr(), _f32(1.0 - measure.b), _f32(measure.b),
                _f32(measure.k1 + 1.0), _f32(measure.k1))
    need(isinstance(measure, TfIdf), f"no kernel scores {measure!r}")
    return (0, None, 0.0, 0.0, 0.0, 0.0)


def drb_walk(idx, aux, qt: DRBQuery, st: DRBState, measure, *, k: int,
             beam_width: int = 1, max_pops: int | None = None,
             kernel_backend: str = "auto") -> DRBState:
    """Run the DRB ``and`` walk to its end for every row.  On the card one
    ``drb_walk`` launch updates ``st`` in place with no host sync; on the
    CPU, or with ``kernel_backend="ref"``, the plain version runs.  Takes
    tf-idf and BM25, any P >= 1, Q >= 1 and k; raises on what the kernel
    does not take."""
    if not backend.use_kernel(qt.valid, kernel_backend):
        return drb_walk_ref(idx, aux, qt, st, measure, k=k,
                            beam_width=beam_width, max_pops=max_pops)
    B, Q = qt.valid.shape
    P = int(beam_width)
    dev = qt.valid.device
    _require(Q >= 1 and P >= 1 and k >= 0, f"needs Q >= 1, P >= 1, k >= 0 "
             f"(got Q={Q}, P={P}, k={k})")
    _require(idx.n_docs >= 1 and idx.device == dev,
             "the index must hold documents and lie on the batch's device")
    for name, t, dtype, shape in (
            ("p", st.p, torch.int32, (B, Q)),
            ("nd", st.nd, torch.int32, (B, Q)),
            ("top_s", st.top_s, torch.float32, (B, k)),
            ("top_d", st.top_d, torch.int32, (B, k)),
            ("it", st.it, torch.int32, (B,)),
            ("cands", st.cands, torch.int32, (B,)),
            ("padded", st.padded, torch.int32, (B,)),
            ("sep_pos", idx.sep_pos, torch.int32, (idx.n_docs,)),
            ("doc_len", idx.doc_len, torch.int32, (idx.n_docs,)),
            ("occ", idx.occ, torch.int32, (idx.vocab_size,)),
            ("bit_off", aux.bit_off, torch.int32, (idx.vocab_size + 1,))):
        _require(t.dtype == dtype and tuple(t.shape) == shape
                 and t.is_contiguous() and t.device == dev,
                 f"{name} must be a contiguous {dtype} {shape} on {dev}")
    bv_args = bitmap_args(aux.bv, dev)
    lv_args = level_args(idx.levels)
    tb_args = table_args(idx.cw, idx.cw_len, idx.node_off, idx.base_rank)
    bm25, avg_p, one_minus_b, b, k1p1, k1 = scoring_args(measure, qt.avg, dev)
    words_i = qt.wl.to(torch.int32).contiguous()
    valid_i = qt.valid.to(torch.int32).contiguous()
    idf_w = qt.idf_w.to(torch.float32).contiguous()
    df_w = qt.df_w.to(torch.int32).contiguous()
    row_ok = (qt.any_valid & ~qt.absent).to(torch.int32)
    nbytes = ws_bytes(Q, P, k)
    scratch = None if nbytes <= MAX_SHARED_WS else torch.empty(
        B * nbytes // 4, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        backend.DRB_WALK.launch(
            *lv_args, *tb_args, idx.sep_pos.data_ptr(),
            idx.doc_len.data_ptr(), idx.occ.data_ptr(), idx.n, idx.n_docs,
            *bv_args, aux.bit_off.data_ptr(), words_i.data_ptr(), valid_i.data_ptr(),
            idf_w.data_ptr(), df_w.data_ptr(), row_ok.data_ptr(), Q, bm25,
            avg_p, ctypes.c_float(one_minus_b), ctypes.c_float(b),
            ctypes.c_float(k1p1), ctypes.c_float(k1), P, k,
            budget_arg(max_pops),
            st.p.data_ptr(), st.nd.data_ptr(), st.top_s.data_ptr(),
            st.top_d.data_ptr(), st.it.data_ptr(), st.cands.data_ptr(),
            st.padded.data_ptr(), nbytes,
            None if scratch is None else scratch.data_ptr(), B)
    return st
