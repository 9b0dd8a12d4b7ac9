"""Megabatch DR core: per-row best-first frontiers in dense pools.

Every row of the batch keeps its frontier in an unsorted pool of ``cap``
slots (``core/heap.py``, the heap core's frontier too); each loop trip pops
exactly one segment per live row (classical ``beam_width=1`` semantics per
row — the batch dim *is* the parallelism), splits multi-document segments
with one batched descent over all B×Q left-child counts, and re-inserts the
children into first free slots.
Because pops follow the total lex order shared with the heap core, every
row's pop/emission sequence is the one its own serial run would produce.

A pool of ``cap >= n_docs + 2`` can never overflow: the frontier of the
document-range split tree holds at most ``n_docs`` segments.  Smaller caps
drop the insert and latch ``overflowed`` per row.

On the card the whole loop — every trip of every row — is one
``beam_loop`` launch (``kernels/beam_step.py``); on the CPU, or with
``kernel_backend="ref"``, its plain version runs the trips from the host.
"""
from __future__ import annotations

import torch

from repro_torch.core import heap as H
from repro_torch.core.ranked import (DRResult, anytime_finalize, root_tf,
                                     seg_valid)
from repro_torch.core.scoring import dot_q
from repro_torch.core.wtbc import WTBCIndex
from repro_torch.kernels import beam_step


def init_state(idx: WTBCIndex, words, wmask, idf_w, *, k: int,
               conjunctive: bool, cap: int,
               kernel_backend: str) -> beam_step.MegaState:
    """Pools holding each row's root segment [0, n_docs) when it is valid,
    and empty output slots."""
    B, Q = words.shape
    dev = words.device
    tf0 = root_tf(idx, words, wmask, kernel_backend=kernel_backend)
    score0 = dot_q(tf0, idf_w)
    pool = H.make_pool(B, cap, Q, dev)
    zeros = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    H.push_many(pool, score0[:, None], zeros, zeros + idx.n_docs, tf0[:, None],
                seg_valid(tf0, score0, wmask, conjunctive)[:, None])
    zb = torch.zeros(B, dtype=torch.int32, device=dev)
    return beam_step.MegaState(
        pool=pool,
        out_docs=torch.full((B, k + 1), -1, dtype=torch.int32, device=dev),
        out_scores=torch.full((B, k + 1), H.NEG_INF, dtype=torch.float32,
                              device=dev),
        n_out=zb, iters=zb.clone(), pops=zb.clone())


def topk_dr_mega(idx: WTBCIndex, words: torch.Tensor, wmask: torch.Tensor,
                 idf: torch.Tensor, *, k: int, conjunctive: bool, cap: int,
                 max_pops: int | None = None,
                 kernel_backend: str = "auto") -> DRResult:
    """Pool-frontier Algorithm 1 over a whole batch: ``words``/``wmask`` are
    (B, Q); returns a ``DRResult`` with (B,) / (B, k) leaves, every leaf the
    reference ``topk_dr_mega``'s at the same shapes.  ``max_pops`` is the
    per-row anytime budget; rows stop independently."""
    wmask = wmask.to(torch.bool)
    idf_w = torch.where(wmask, idf[words.long()], 0.0).to(torch.float32)
    st = init_state(idx, words, wmask, idf_w, k=k, conjunctive=conjunctive,
                    cap=cap, kernel_backend=kernel_backend)
    st = beam_step.beam_loop(idx, st, words, wmask, idf_w, k=k,
                             conjunctive=conjunctive, max_pops=max_pops,
                             kernel_backend=kernel_backend)
    pool = st.pool
    out_docs, out_scores, n_out, certified, bound = anytime_finalize(
        pool.scores[:, :cap], pool.d0[:, :cap], pool.d1[:, :cap], st.out_docs,
        st.out_scores, st.n_out, pool.overflowed, k=k,
        harvest=max_pops is not None)
    return DRResult(out_docs[:, :k], out_scores[:, :k], n_out, st.iters,
                    st.pops, pool.overflowed, certified=certified, bound=bound)
