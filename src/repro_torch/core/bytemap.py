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
shape.  ``select`` and ``access`` arrive with the positional slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_BLOCK = 4096  # bytes per counter block

# rows of in-block residuals computed per pass of ``rank`` (bounds the
# (rows, block) compare temporary)
_RANK_ROWS = 8192


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
          device: torch.device | str = "cpu") -> ByteMap:
    padded, counts, n = build_np(data, block)
    return ByteMap(data=torch.from_numpy(padded).to(device),
                   counts=torch.from_numpy(counts).to(device),
                   length=n, block=block)


def rank(bm: ByteMap, byte: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Occurrences of ``byte[i]`` in ``data[0:pos[i]]`` (pos clipped to
    [0, length]); same-shape int32.

    The tile index is clamped to the last block, which makes ``pos == length``
    exact at a block edge (the counter row plus one full-tile count)."""
    shape = pos.shape
    byte = byte.reshape(-1).long()
    pos = pos.reshape(-1).to(torch.int32).clamp(0, bm.length)
    blk = torch.clamp(pos // bm.block, max=bm.n_blocks - 1).long()
    base = bm.counts[blk, byte]
    tiles = bm.data.view(bm.n_blocks, bm.block)
    lane = torch.arange(bm.block, device=pos.device, dtype=torch.int32)
    cut = pos - blk.to(torch.int32) * bm.block
    parts = []
    for s in range(0, pos.numel(), _RANK_ROWS):
        e = s + _RANK_ROWS
        hit = (tiles[blk[s:e]] == byte[s:e, None].to(torch.uint8)) \
            & (lane[None, :] < cut[s:e, None])
        parts.append(hit.sum(1, dtype=torch.int32))
    intile = torch.cat(parts) if parts else cut.new_zeros(0)
    return (base + intile).reshape(shape)


def count_range(bm: ByteMap, byte: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """Occurrences of ``byte`` in ``data[lo:hi]``."""
    return rank(bm, byte, hi) - rank(bm, byte, lo)


def rank_np(data: np.ndarray, byte: int, pos: int) -> int:
    return int(np.count_nonzero(data[:pos] == byte))
