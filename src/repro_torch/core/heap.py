"""Search frontiers as dense pools under one total priority order.

Algorithm 1 is driven by a priority queue of text segments ``[d0, d1)``.  The
reference keeps a sift-based binary heap per row; the port keeps every row's
frontier in an unsorted **pool** of slots (score ``-inf`` marks a free slot)
and turns the queue operations into row-parallel tensor code:

  pop       a masked lex-argmax over the row's slots, then the slot is freed;
  push      first-free-slot inserts in array order.

**Total priority order.**  Elements are ordered by the key
``(score desc, d0 asc, d1 desc)``.  Distinct pending segments always have
distinct keys, so the order is *total*: the pop order depends only on the set
of inserted keys, never on where they sit — which is why a pool pops exactly
the sequence the reference's heap pops (DESIGN.md §8).

**Capacity.**  A push into a full frontier drops the element and latches
``overflowed``, the reference heap's rule (``heap.push``): the r-th enabled
push of a batch lands iff fewer than ``cap - size`` pushes landed before it.

The pools are updated in place (the reference's arrays are immutable; here
in-place scatters avoid copying a (B, cap, Q) frontier every trip).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = float("-inf")
INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)


def lex_gt(sa, a0, a1, sb, b0, b1):
    """Strict elementwise comparison in the total priority order
    ``(score desc, d0 asc, d1 desc)``: True where key A precedes key B."""
    return (sa > sb) | ((sa == sb) & ((a0 < b0) | ((a0 == b0) & (a1 > b1))))


def lex_argmax(s, d0, d1, valid):
    """Index (last axis) of the lex-greatest valid ``(s, d0, d1)`` entry: max
    score, then min d0 among score ties, then max d1 (first index on a full
    tie).  All-invalid rows return index 0; callers mask with
    ``valid.any()``."""
    s_ = torch.where(valid, s, NEG_INF)
    c = valid & (s_ == s_.amax(-1, keepdim=True))
    d0_ = torch.where(c, d0, INT32_MAX)
    c = c & (d0_ == d0_.amin(-1, keepdim=True))
    return torch.where(c, d1, INT32_MIN).argmax(-1)


def take(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Row-wise gather ``x[b, j[b]]`` (and the trailing dims)."""
    return x[torch.arange(x.shape[0], device=x.device), j]


class Pool(NamedTuple):
    """B row frontiers of ``cap`` slots, each slot a segment key + tf.

    Every array carries one scratch column past the ``cap`` real slots: push
    lanes that do not land write there, so a batch of pushes is one scatter
    with no colliding writes.  Its score is kept ``-inf``, so it never looks
    occupied."""
    scores: torch.Tensor      # (B, cap + 1) float32, -inf = free
    d0: torch.Tensor          # (B, cap + 1) int32
    d1: torch.Tensor          # (B, cap + 1) int32
    tf: torch.Tensor          # (B, cap + 1, Q) int32
    size: torch.Tensor        # (B,) int32 occupied slots
    overflowed: torch.Tensor  # (B,) bool — an enabled push was dropped

    @property
    def cap(self) -> int:
        return self.scores.shape[1] - 1


def make_pool(B: int, cap: int, Q: int, device) -> Pool:
    return Pool(torch.full((B, cap + 1), NEG_INF, dtype=torch.float32,
                           device=device),
                torch.zeros((B, cap + 1), dtype=torch.int32, device=device),
                torch.zeros((B, cap + 1), dtype=torch.int32, device=device),
                torch.zeros((B, cap + 1, Q), dtype=torch.int32, device=device),
                torch.zeros(B, dtype=torch.int32, device=device),
                torch.zeros(B, dtype=torch.bool, device=device))


def pop_p(pool: Pool, p: int, enable: torch.Tensor):
    """Pop up to ``p`` best segments of every row with ``enable`` set, in
    place.  Returns ``(scores (B,p), d0, d1, tf (B,p,Q), valid (B,p))``: pops
    come out in the total order as a valid prefix; pops past a row's size
    (or of a disabled row) are invalid with score -inf."""
    row = torch.arange(pool.scores.shape[0], device=pool.scores.device)
    out_s, out_0, out_1, out_tf, out_v = [], [], [], [], []
    for _ in range(p):
        occupied = pool.scores > NEG_INF
        j = lex_argmax(pool.scores, pool.d0, pool.d1, occupied)
        v = enable & occupied[row, j]
        s = pool.scores[row, j]
        out_s.append(torch.where(v, s, NEG_INF))
        out_0.append(pool.d0[row, j])
        out_1.append(pool.d1[row, j])
        out_tf.append(pool.tf[row, j])
        out_v.append(v)
        pool.scores[row, j] = torch.where(v, NEG_INF, s)
    valid = torch.stack(out_v, 1)
    pool.size.sub_(valid.sum(1, dtype=torch.int32))
    return (torch.stack(out_s, 1), torch.stack(out_0, 1),
            torch.stack(out_1, 1), torch.stack(out_tf, 1), valid)


def seg_valid(tf, score, wmask, conjunctive: bool):
    """A segment is kept when every query word occurs in it (AND) or its
    score is positive (OR).  ``tf`` (..., Q), ``wmask`` broadcastable."""
    if conjunctive:
        return torch.all((tf > 0) | ~wmask, -1) & torch.any(wmask, -1)
    return score > 0.0


def live_rows(pool: Pool, st, k: int, max_pops: int | None):
    """Rows still searching: fewer than k answers, a non-empty frontier and
    pops left in the budget.  ``st`` has ``n_out`` and ``pops`` (B,)."""
    ok = (st.n_out < k) & (pool.size > 0)
    if max_pops is not None:
        ok = ok & (st.pops < max_pops)
    return ok


def push_many(pool: Pool, s, d0, d1, tf, enable) -> None:
    """Bulk insert, in place: ``s/d0/d1/enable (B, m)``, ``tf (B, m, Q)``.

    Equal to ``m`` sequential first-free-slot pushes in array order: the
    pushes free no slot in between, so the r-th enabled push of a row takes
    the row's r-th lowest free slot, or is dropped (latching ``overflowed``)
    when the row has fewer than r+1 free slots."""
    m = enable.shape[1]
    cap = pool.cap
    lanes = torch.arange(cap + 1, dtype=torch.int32, device=s.device)
    free_at = torch.where((pool.scores == NEG_INF) & (lanes < cap), lanes, cap)
    n = min(m, cap + 1)
    first_free = torch.topk(free_at, n, dim=1, largest=False, sorted=True).values
    rank = torch.cumsum(enable.to(torch.int32), 1) - 1          # (B, m)
    slot = torch.gather(first_free, 1, rank.clamp(0, n - 1).long())
    ok = enable & (rank < n) & (slot < cap)
    pool.overflowed.logical_or_(torch.any(enable & ~ok, 1))
    at = torch.where(ok, slot, cap).long()                      # cap = scratch
    pool.scores.scatter_(1, at, s)
    pool.d0.scatter_(1, at, d0)
    pool.d1.scatter_(1, at, d1)
    pool.tf.scatter_(1, at[..., None].expand(-1, -1, tf.shape[-1]), tf)
    pool.scores[:, cap] = NEG_INF
    pool.size.add_(ok.sum(1, dtype=torch.int32))
