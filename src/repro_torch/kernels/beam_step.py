"""The ``beam_loop`` kernel: the mega core's whole search loop in one launch.

Replaces the Pallas kernel of ``repro/kernels/beam_step.py`` (``_kernel``,
entry ``fused_beam_step``), which fuses one trip of ``core/mega.py``'s loop;
``csrc/beam_step.cu`` runs every trip of every row inside the kernel, one
thread block per row.  Mega rows are independent, so looping each row until
it stops gives exactly the reference's per-row pops, emissions, iters and
overflow latch.

The plain version stands beside it: :func:`mega_trip` is the reference's
loop body on the rows' :class:`repro_torch.core.heap.Pool` frontiers (one
``pop_p`` per live row, emit, split, one batched descent, a two-lane
``push_many``) and :func:`beam_loop_ref` drives it from the host, testing
``any(live)`` every few trips — trips of stopped rows are exact no-ops.  It
is the CPU path and the kernel's oracle.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import heap as H
from repro_torch.core import wtbc
from repro_torch.core.ranked import live_rows, seg_valid
from repro_torch.core.scoring import dot_q
from repro_torch.kernels import backend
from repro_torch.kernels.wavelet_descent import level_args, table_args

# host syncs of the plain loop's exit test: one every this many trips
_TRIPS_PER_SYNC = 16
# the kernel's limit on query words per row (its shared tf buffers)
MAX_Q = 64
# slots per chunk summary, and the ints of one summary (``csrc/beam_step.cu``:
# kChunk, kSummaryInts)
CHUNK = 256
SUMMARY_INTS = 14


class MegaState(NamedTuple):
    """Per-row search state of the mega core (updated in place)."""
    pool: H.Pool              # the row frontiers, (B, cap + 1) slots
    out_docs: torch.Tensor    # (B, k + 1) int32 — slot k is the trash slot
    out_scores: torch.Tensor  # (B, k + 1) float32
    n_out: torch.Tensor       # (B,) int32
    iters: torch.Tensor       # (B,) int32
    pops: torch.Tensor        # (B,) int32

    def clone(self) -> "MegaState":
        return MegaState(H.Pool(*(t.clone() for t in self.pool)),
                         *(t.clone() for t in self[1:]))


def mega_trip(idx, st: MegaState, words, wmask, idf_w, *, k: int,
              conjunctive: bool, max_pops: int | None,
              kernel_backend: str) -> MegaState:
    """One trip of every row: one pop per live row (the classical P=1 order
    — a popped singleton is the row's lex-greatest pending segment, hence
    its next answer), then the split and its two inserts."""
    B, Q = words.shape
    row = torch.arange(B, device=words.device)
    s_p, d0, d1, tf, valid = (x[:, 0] for x in H.pop_p(
        st.pool, 1, live_rows(st.pool, st, k, max_pops)))
    single = valid & ((d1 - d0) == 1)
    multi = valid & ~single
    slot = torch.where(single, st.n_out, k).long()   # live rows: n_out < k
    st.out_docs[row, slot] = torch.where(single, d0, st.out_docs[row, slot])
    st.out_scores[row, slot] = torch.where(single, s_p,
                                           st.out_scores[row, slot])

    mid = torch.div(d0 + d1, 2, rounding_mode="floor").to(torch.int32)
    lo1, hi1 = wtbc.segment_extent(idx, d0, mid)
    tf1 = wtbc.count_range_batch(
        idx, words.reshape(-1), lo1.repeat_interleave(Q),
        hi1.repeat_interleave(Q),
        kernel_backend=kernel_backend).reshape(B, Q) * wmask
    tf2 = tf - tf1
    s1, s2 = dot_q(tf1, idf_w), dot_q(tf2, idf_w)
    H.push_many(st.pool, torch.stack([s1, s2], 1), torch.stack([d0, mid], 1),
                torch.stack([mid, d1], 1), torch.stack([tf1, tf2], 1),
                torch.stack([multi & seg_valid(tf1, s1, wmask, conjunctive),
                             multi & seg_valid(tf2, s2, wmask, conjunctive)],
                            1))
    n = valid.to(torch.int32)
    return st._replace(n_out=st.n_out + single.to(torch.int32),
                       iters=st.iters + n, pops=st.pops + n)


def beam_loop_ref(idx, st: MegaState, words, wmask, idf_w, *, k: int,
                  conjunctive: bool, max_pops: int | None) -> MegaState:
    """The plain version: trips driven from the host until no row is live.
    Its descents run the plain ``wavelet_count`` too, so a comparison on the
    card holds the kernel against plain code end to end."""
    while bool(live_rows(st.pool, st, k, max_pops).any()):
        for _ in range(_TRIPS_PER_SYNC):
            st = mega_trip(idx, st, words, wmask, idf_w, k=k,
                           conjunctive=conjunctive, max_pops=max_pops,
                           kernel_backend="ref")
    return st


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"beam_loop: {what}")


def beam_loop(idx, st: MegaState, words, wmask, idf_w, *, k: int,
              conjunctive: bool, max_pops: int | None,
              kernel_backend: str = "auto") -> MegaState:
    """Run the mega search loop to its end for every row.  On the card one
    ``beam_loop`` launch updates ``st`` in place, pool size included
    (``overflowed`` is copied back from the kernel's int32 flags); on the
    CPU, or with ``kernel_backend="ref"``, the plain version runs.  The
    kernel reads the pool rows with their stride ``cap + 1`` and never
    touches the scratch column.  The kernel keeps a summary of every chunk
    of 256 slots (56 bytes each) in shared memory while a row's fit one
    block's opt-in (about 1 M slots on an H100) and past it in a global
    scratch allocated here for every call, so any ``cap`` runs, with the
    same results.
    Raises if a row hit the kernel's trip bound (2·n_docs + 4 trips, more
    than any exact search takes)."""
    if not backend.use_kernel(words, kernel_backend):
        return beam_loop_ref(idx, st, words, wmask, idf_w, k=k,
                             conjunctive=conjunctive, max_pops=max_pops)
    B, Q = words.shape
    pool = st.pool
    cap = pool.cap
    dev = words.device
    _require(1 <= Q <= MAX_Q, f"Q={Q} outside [1, {MAX_Q}]")
    for name, t, dtype, shape in (
            ("pool.scores", pool.scores, torch.float32, (B, cap + 1)),
            ("pool.d0", pool.d0, torch.int32, (B, cap + 1)),
            ("pool.d1", pool.d1, torch.int32, (B, cap + 1)),
            ("pool.tf", pool.tf, torch.int32, (B, cap + 1, Q)),
            ("pool.size", pool.size, torch.int32, (B,)),
            ("pool.overflowed", pool.overflowed, torch.bool, (B,)),
            ("out_docs", st.out_docs, torch.int32, (B, k + 1)),
            ("out_scores", st.out_scores, torch.float32, (B, k + 1)),
            ("n_out", st.n_out, torch.int32, (B,)),
            ("iters", st.iters, torch.int32, (B,)),
            ("pops", st.pops, torch.int32, (B,)),
            ("idf_w", idf_w, torch.float32, (B, Q)),
            ("sep_pos", idx.sep_pos, torch.int32, (idx.n_docs,))):
        _require(t.dtype == dtype and tuple(t.shape) == shape
                 and t.is_contiguous() and t.device == dev,
                 f"{name} must be a contiguous {dtype} {shape} on {dev}")
    _require(idx.n_docs >= 1 and idx.device == dev,
             "the index must hold documents and lie on the batch's device")
    lv_args = level_args(idx.levels)
    tb_args = table_args(idx.cw, idx.cw_len, idx.node_off, idx.base_rank)
    words_i = words.to(torch.int32).contiguous()
    wmask_i = wmask.to(torch.int32).contiguous()
    ovf = pool.overflowed.to(torch.int32)
    status = torch.zeros(B, dtype=torch.int32, device=dev)
    summaries = torch.empty(B * SUMMARY_INTS * -(-cap // CHUNK),
                            dtype=torch.int32, device=dev)
    max_trips = 2 * idx.n_docs + 4
    with torch.cuda.device(dev):
        backend.BEAM_LOOP.launch(
            *lv_args, *tb_args, idx.sep_pos.data_ptr(), idx.n, idx.n_docs,
            words_i.data_ptr(), wmask_i.data_ptr(), idf_w.data_ptr(), Q,
            pool.scores.data_ptr(), pool.d0.data_ptr(), pool.d1.data_ptr(),
            pool.tf.data_ptr(), pool.size.data_ptr(), cap,
            st.out_docs.data_ptr(), st.out_scores.data_ptr(), k,
            st.n_out.data_ptr(), st.iters.data_ptr(), st.pops.data_ptr(),
            ovf.data_ptr(), status.data_ptr(), int(conjunctive),
            -1 if max_pops is None else int(max_pops), max_trips, B,
            summaries.data_ptr())
    pool.overflowed.copy_(ovf != 0)
    if bool(status.any()):
        raise RuntimeError("beam_loop: a row exceeded the trip bound; the "
                           "frontier state is malformed")
    return st
