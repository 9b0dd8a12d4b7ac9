"""The ``heap_loop`` kernel: the heap core's whole search loop in one launch.

Replaces no TPU kernel: the reference's ``topk_dr_batch``
(``src/repro/core/ranked.py:364-427``) is one compiled ``lax.while_loop``
around K1, so on the TPU the whole search is one device program.
``csrc/heap_loop.cu`` runs every trip of every row inside one kernel, one
thread block per row, at beam width P >= 2 (P = 1 runs on ``beam_loop``:
``core/ranked.py`` routes it).  A trip pops the row's P lex-greatest
segments, emits the singletons the exact-emission rule allows, splits the
multis with one descent per (multi, word, endpoint), and pushes the
children and the unemitted singletons back into the lowest free slots.

The plain version stands beside it: :func:`heap_trip` is one trip of every
row at width P (pops, emission, one batched descent, a bulk push) and
:func:`heap_loop_ref` drives it from the host, testing ``any(live)`` every
few trips — trips of stopped rows are exact no-ops.  It is the CPU path and
the kernel's oracle.  Both record each row's live width per trip, from
which ``core/ranked.py:padded_from_widths`` computes the pad-waste counter
``padded``; the plain trip also keeps the reference's in-loop count of it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import heap as H
from repro_torch.core import wtbc
from repro_torch.core.scoring import dot_q
from repro_torch.kernels import backend
from repro_torch.kernels.beam_step import CHUNK, MAX_Q, SUMMARY_INTS
from repro_torch.kernels.wavelet_descent import level_args, table_args

# host syncs of the plain loop's exit test: one every this many trips
_TRIPS_PER_SYNC = 16
# the kernel's limit on the beam width (its shared pop and push buffers)
MAX_P = 64


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


class HeapState(NamedTuple):
    """Per-row output and counters of the heap core (the frontier is the
    :class:`repro_torch.core.heap.Pool` beside it)."""
    out_docs: torch.Tensor     # (B, k + 1) — slot k is a trash slot
    out_scores: torch.Tensor   # (B, k + 1)
    n_out: torch.Tensor        # (B,)
    iters: torch.Tensor
    pops: torch.Tensor
    padded: torch.Tensor


def init_state(B: int, k: int, device) -> HeapState:
    """Empty outputs and zero counters, each its own tensor (the kernels
    update them in place)."""
    zb = torch.zeros(B, dtype=torch.int32, device=device)
    return HeapState(torch.full((B, k + 1), -1, dtype=torch.int32,
                                device=device),
                     torch.full((B, k + 1), H.NEG_INF, dtype=torch.float32,
                                device=device),
                     zb, zb.clone(), zb.clone(), zb.clone())


def heap_trip(idx, pool: H.Pool, st: HeapState, words, wmask, idf_w, *,
              P: int, buckets: torch.Tensor, k: int, conjunctive: bool,
              max_pops: int | None, kernel_backend: str) -> HeapState:
    """One beam trip of every row at width P (in place on ``pool``)."""
    B, Q = words.shape
    live = H.live_rows(pool, st, k, max_pops)
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
    ok1 = multi & H.seg_valid(tf1, s1, wm3, conjunctive)
    ok2 = multi & H.seg_valid(tf2, s2, wm3, conjunctive)
    lanes = [(s1, d0, mid, tf1, ok1), (s2, mid, d1, tf2, ok2)]
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
    return HeapState(out_docs, out_scores, n_out, st.iters + live_i,
                     st.pops + nv, st.padded + live_i * (S_b - nv))


def heap_loop_ref(idx, pool: H.Pool, st: HeapState, words, wmask, idf_w, *,
                  P: int, k: int, conjunctive: bool, max_pops: int | None
                  ) -> tuple[HeapState, torch.Tensor]:
    """The plain version: trips driven from the host until no row is live.
    Returns the final state and the (B, trips) live widths (``min(size,
    P)`` of each row before each trip, 0 once it stopped).  Its descents
    run the plain ``wavelet_count`` too, so a comparison on the card holds
    the kernel against plain code end to end."""
    buckets = torch.tensor(frontier_buckets(P), dtype=torch.int32,
                           device=words.device)
    widths = []
    while bool(H.live_rows(pool, st, k, max_pops).any()):
        for _ in range(_TRIPS_PER_SYNC):
            live = H.live_rows(pool, st, k, max_pops)
            widths.append(torch.where(live, pool.size.clamp(max=P), 0))
            st = heap_trip(idx, pool, st, words, wmask, idf_w, P=P,
                           buckets=buckets, k=k, conjunctive=conjunctive,
                           max_pops=max_pops, kernel_backend="ref")
    B = words.shape[0]
    return st, (torch.stack(widths, 1) if widths else
                torch.zeros((B, 0), dtype=torch.int32, device=words.device))


def trip_bound(n_docs: int, max_pops: int | None) -> int:
    """The kernel's trip bound, the columns of its widths buffer: a trip
    either splits a multi (fewer than n_docs exist) or emits a document, so
    an exact search takes fewer than 2·n_docs trips; every trip pops, so a
    budgeted one takes at most ``max_pops``."""
    bound = 2 * n_docs + 4
    return bound if max_pops is None else max(1, min(bound, int(max_pops)))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"heap_loop: {what}")


def check_args(idx, pool: H.Pool, st: HeapState, words, wmask, idf_w, *,
               P: int, k: int) -> None:
    """Raise ``ValueError`` on what the kernel does not take: P outside
    [2, MAX_P], Q outside [1, MAX_Q], or a state tensor of another dtype,
    shape, layout or device than the batch's."""
    B, Q = words.shape
    cap = pool.cap
    dev = words.device
    _require(2 <= P <= MAX_P, f"beam width P={P} outside [2, {MAX_P}]")
    _require(1 <= Q <= MAX_Q, f"Q={Q} outside [1, {MAX_Q}]")
    _require(k >= 1, f"k={k} must be >= 1")
    _require(tuple(wmask.shape) == (B, Q) and wmask.device == dev,
             f"wmask must be ({B}, {Q}) on {dev}")
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
    counters = {st.n_out.data_ptr(), st.iters.data_ptr(), st.pops.data_ptr()}
    _require(len(counters) == 3, "n_out, iters and pops must not share memory")
    _require(idx.n_docs >= 1 and idx.device == dev,
             "the index must hold documents and lie on the batch's device")


def heap_loop(idx, pool: H.Pool, st: HeapState, words, wmask, idf_w, *,
              P: int, k: int, conjunctive: bool, max_pops: int | None,
              kernel_backend: str = "auto") -> tuple[HeapState, torch.Tensor]:
    """Run the heap core's search loop at beam width P to its end for every
    row; returns the final state and the (B, T) per-trip live widths.

    On the card (P >= 2) one ``heap_loop`` launch updates ``pool`` and the
    state's outputs and counters in place (``padded`` is left as it came:
    the caller computes it from the widths); the widths buffer has
    :func:`trip_bound` columns, zeroed here (4 bytes a row a trip: 5.5 MB
    at B = 8 over 86,445 documents without a budget).  The kernel keeps
    the chunk summaries in shared memory while they fit beside its 12·P·Q
    bytes of pop buffers, else in a global scratch allocated here.  Raises
    on what it does not take (:func:`check_args`) and if a row hit the trip
    bound.  On the CPU, or with ``kernel_backend="ref"``, the plain version
    runs."""
    if not backend.use_kernel(words, kernel_backend):
        return heap_loop_ref(idx, pool, st, words, wmask, idf_w, P=P, k=k,
                             conjunctive=conjunctive, max_pops=max_pops)
    check_args(idx, pool, st, words, wmask, idf_w, P=P, k=k)
    B, Q = words.shape
    cap = pool.cap
    dev = words.device
    lv_args = level_args(idx.levels)
    tb_args = table_args(idx.cw, idx.cw_len, idx.node_off, idx.base_rank)
    words_i = words.to(torch.int32).contiguous()
    wmask_i = wmask.to(torch.int32).contiguous()
    ovf = pool.overflowed.to(torch.int32)
    status = torch.zeros(B, dtype=torch.int32, device=dev)
    summaries = torch.empty(B * SUMMARY_INTS * -(-cap // CHUNK),
                            dtype=torch.int32, device=dev)
    T = trip_bound(idx.n_docs, max_pops)
    widths = torch.zeros((B, T), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        backend.HEAP_LOOP.launch(
            *lv_args, *tb_args, idx.sep_pos.data_ptr(), idx.n, idx.n_docs,
            words_i.data_ptr(), wmask_i.data_ptr(), idf_w.data_ptr(), Q, P,
            pool.scores.data_ptr(), pool.d0.data_ptr(), pool.d1.data_ptr(),
            pool.tf.data_ptr(), pool.size.data_ptr(), cap,
            st.out_docs.data_ptr(), st.out_scores.data_ptr(), k,
            st.n_out.data_ptr(), st.iters.data_ptr(), st.pops.data_ptr(),
            ovf.data_ptr(), status.data_ptr(), widths.data_ptr(),
            int(conjunctive), -1 if max_pops is None else int(max_pops), T,
            B, summaries.data_ptr())
    pool.overflowed.copy_(ovf != 0)
    if bool(status.any()):
        raise RuntimeError("heap_loop: a row exceeded the trip bound; the "
                           "frontier state is malformed")
    return st, widths
