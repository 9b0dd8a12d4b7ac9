"""rank/count over byte sequences — the WTBC's core primitive.

The paper keeps *partial counters* per bytemap so that ``rank_b(B, i)`` runs
in microseconds at ~3% space overhead.  Layout (the reference's, unchanged):

* the byte sequence ``data`` zero-padded to ``n_blocks * block``;
* one cumulative count matrix ``counts[(n_blocks+1), 256] int32`` sampled
  every ``block`` bytes — ``counts[k, v]`` = occurrences of byte ``v`` in
  ``data[0 : k*block]``;
* the in-block residual is a masked compare-and-sum over one block.

Build is numpy on the host; queries are batched tensor code.  ``length`` and
``block`` are host integers, so no query ever waits on the device to learn a
shape.  ``rank`` goes through the ``byte_rank`` kernel on the card
(``kernels/ops.py``); ``select`` and ``access`` are plain PyTorch on every
device (the reference has no kernel for them).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import backend, ops

DEFAULT_BLOCK = 4096  # bytes per counter block

# rows of in-block scans per pass of ``select`` (bounds the (rows, block)
# compare temporary)
_SELECT_ROWS = 8192
# sub-chunk of the in-block select scan: a (rows, block) compare is reduced
# to per-sub-chunk counts, and only one sub-chunk is prefix-summed
_SUB = 512


@dataclasses.dataclass(frozen=True)
class ByteMap:
    """A byte sequence + rank acceleration counters."""

    data: torch.Tensor    # (n_blocks * block,) uint8
    counts: torch.Tensor  # (n_blocks + 1, 256) int32 cumulative
    length: int           # logical length
    block: int

    @property
    def n_blocks(self) -> int:
        return self.counts.shape[0] - 1


def build_np(data: np.ndarray, block: int = DEFAULT_BLOCK
             ) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side construction: (padded data, counts, length)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = len(data)
    n_blocks = max(1, -(-n // block))
    padded = np.zeros(n_blocks * block, dtype=np.uint8)
    padded[:n] = data
    flat_keys = (np.arange(n_blocks * block, dtype=np.int64) // block) * 256 + padded
    hist = np.bincount(flat_keys, minlength=n_blocks * 256).reshape(n_blocks, 256)
    # padding bytes are zeros; remove them so counters reflect the logical
    # sequence only
    hist[-1, 0] -= n_blocks * block - n
    counts = np.zeros((n_blocks + 1, 256), dtype=np.int64)
    np.cumsum(hist, axis=0, out=counts[1:])
    if counts.max() >= 2**31:
        raise ValueError("sequence too long for int32 counters")
    return padded, counts.astype(np.int32), n


def build(data: np.ndarray, block: int = DEFAULT_BLOCK,
          device: torch.device | str | None = None) -> ByteMap:
    """The bytemap of ``data`` on ``device``: the card by default (raising
    when none is present), "cpu" for the plain path."""
    device = backend.resolve_device(device)
    padded, counts, n = build_np(data, block)
    return ByteMap(data=torch.from_numpy(padded).to(device),
                   counts=torch.from_numpy(counts).to(device),
                   length=n, block=block)


def rank(bm: ByteMap, byte: torch.Tensor, pos: torch.Tensor, *,
         kernel_backend: str = "auto") -> torch.Tensor:
    """Occurrences of ``byte[i]`` in ``data[0:pos[i]]`` (pos clipped to
    [0, length]); same-shape int32.  One ``byte_rank`` launch on the card
    for the whole batch, its plain version on the CPU."""
    return ops.rank_batch(bm, byte, pos, kernel_backend=kernel_backend)


def count_range(bm: ByteMap, byte: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """Occurrences of ``byte`` in ``data[lo:hi]``."""
    return rank(bm, byte, hi) - rank(bm, byte, lo)


def select(bm: ByteMap, byte: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Position of the ``j[i]``-th (1-based) occurrence of ``byte[i]``;
    ``length`` where there is none; same-shape int32.

    Per query: a binary search of the byte's counter column for the last
    block with fewer than j occurrences before it (the reference's fixed
    trip count), then a scan of that block — per-512-byte counts pick the
    sub-chunk, a prefix sum over it the byte.  Batched over every query;
    plain PyTorch on every device."""
    shape = j.shape
    byte = byte.reshape(-1).long()
    j = j.reshape(-1).to(torch.int32)
    n_blocks = bm.n_blocks
    col_total = bm.counts[-1, byte]
    lo = torch.zeros_like(j)
    hi = torch.full_like(j, n_blocks - 1)
    n_iter = max(1, int(np.ceil(np.log2(max(n_blocks, 2)))) + 1)
    for _ in range(n_iter):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        right = bm.counts[mid.long(), byte] < j
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid - 1)
    need = j - bm.counts[lo.long(), byte]
    sub = _SUB if bm.block % _SUB == 0 else bm.block
    n_sub = bm.block // sub
    tiles = bm.data.view(n_blocks, n_sub, sub)
    parts = []
    for s in range(0, j.numel(), _SELECT_ROWS):
        e = s + _SELECT_ROWS
        hits = tiles[lo[s:e].long()] == byte[s:e, None, None].to(torch.uint8)
        per_sub = torch.cumsum(hits.sum(2, dtype=torch.int32), 1)
        nd = need[s:e, None]
        sub_i = (per_sub < nd).sum(1).clamp(max=n_sub - 1)
        prior = torch.where(sub_i > 0, per_sub.gather(
            1, (sub_i - 1).clamp(min=0)[:, None])[:, 0], 0)
        row = torch.arange(hits.shape[0], device=j.device)
        cums = torch.cumsum(hits[row, sub_i].to(torch.int32), 1)
        at = (cums < (nd - prior[:, None])).sum(1)
        parts.append(sub_i * sub + at)
    inblock = torch.cat(parts) if parts else j.new_zeros(0)
    pos = lo * bm.block + inblock
    ok = (j >= 1) & (j <= col_total)
    return torch.where(ok, pos, bm.length).to(torch.int32).reshape(shape)


def access(bm: ByteMap, pos: torch.Tensor) -> torch.Tensor:
    """``data[pos]`` (uint8), positions clipped into the sequence."""
    return bm.data[pos.long().clamp(0, max(bm.length - 1, 0))]


# ---------------------------------------------------------------------------
# numpy oracles
# ---------------------------------------------------------------------------

def rank_np(data: np.ndarray, byte: int, pos: int) -> int:
    return int(np.count_nonzero(data[:pos] == byte))


def select_np(data: np.ndarray, byte: int, j: int) -> int:
    occ = np.flatnonzero(data == byte)
    return int(occ[j - 1]) if 1 <= j <= len(occ) else len(data)
