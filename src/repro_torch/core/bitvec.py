"""Packed bit vectors with rank1 / select1 (the paper's [16] Munro).

Used by WTBC-DRB for the per-word term-frequency bitmaps
(``1 0^{tf1-1} 1 0^{tf2-1} ...``).  Layout (the reference's): LSB-first bits
in 32-bit words, padded to whole blocks of ``WORDS_PER_BLOCK`` words, and a
cumulative count of ones at every block start (1024 bits per int32 counter:
3.1% of the bit data).  The words are held as int32 bit patterns, since
PyTorch's uint32 supports few operations; ``n_bits`` is a host integer.

``rank1`` goes through the ``bitmap_rank1`` kernel on the card
(``kernels/ops.py``); ``select1`` is plain PyTorch on every device (the
reference has no kernel for it).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import backend, ops, ref
from repro_torch.kernels.bitmap_rank import WORDS_PER_BLOCK


class BitVec(NamedTuple):
    words: torch.Tensor   # (n_blocks * WORDS_PER_BLOCK,) int32 bit patterns
    counts: torch.Tensor  # (n_blocks + 1,) int32 cumulative ones
    n_bits: int


def build(set_bits: np.ndarray, n_bits: int,
          device: torch.device | str | None = None) -> BitVec:
    """Host-side construction from the sorted positions of the set bits
    (the reference's words and counters), placed on ``device``: the card by
    default (raising when none is present), "cpu" for the plain path."""
    device = backend.resolve_device(device)
    n_words = max(1, -(-n_bits // 32))
    n_blocks = -(-n_words // WORDS_PER_BLOCK)
    n_words = n_blocks * WORDS_PER_BLOCK
    set_bits = np.asarray(set_bits, dtype=np.int64)
    bits = np.zeros(n_words * 32, dtype=bool)
    bits[set_bits] = True
    words = np.packbits(bits, bitorder="little").view("<i4").astype(np.int32)
    counts = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(np.bincount(set_bits // (WORDS_PER_BLOCK * 32),
                          minlength=n_blocks), out=counts[1:])
    return BitVec(words=torch.from_numpy(words).to(device),
                  counts=torch.from_numpy(counts.astype(np.int32)).to(device),
                  n_bits=int(n_bits))


def rank1(bv: BitVec, pos: torch.Tensor, *,
          kernel_backend: str = "auto") -> torch.Tensor:
    """Set bits in ``[0, pos[i])`` (pos clipped to [0, n_bits]); same-shape
    int32.  One ``bitmap_rank1`` launch on the card for the whole batch,
    its plain version on the CPU."""
    return ops.bitmap_rank1_batch(bv, pos, kernel_backend=kernel_backend)


def select1(bv: BitVec, j: torch.Tensor) -> torch.Tensor:
    """Position of the ``j[i]``-th (1-based) set bit; ``n_bits`` where there
    is none; same-shape int32.

    The block is the last one with fewer than j ones before it (a
    ``searchsorted`` over the counters, equal to the reference's binary
    search); inside it, per-word popcounts pick the word and per-bit prefix
    sums the bit.  Batched over every query."""
    shape = j.shape
    j = j.reshape(-1).to(torch.int32)
    n_blocks = bv.counts.shape[0] - 1
    total = bv.counts[-1]
    blk = (torch.searchsorted(bv.counts, j, side="left") - 1
           ).clamp(0, n_blocks - 1)
    chunk = bv.words.view(n_blocks, WORDS_PER_BLOCK)[blk]         # (M, 32)
    cum = torch.cumsum(ref.popcount32(chunk), 1)
    need = (j - bv.counts[blk])[:, None]
    word_i = (cum < need).sum(1)
    prior = torch.where(word_i > 0, cum.gather(
        1, (word_i - 1).clamp(min=0)[:, None])[:, 0], 0)
    w = chunk.gather(1, word_i.clamp(max=WORDS_PER_BLOCK - 1)[:, None]).long()
    shift = torch.arange(32, device=j.device, dtype=torch.int64)
    bit_cum = torch.cumsum((w >> shift) & 1, 1)
    bit_i = (bit_cum < (need - prior[:, None])).sum(1)
    pos = (blk * WORDS_PER_BLOCK + word_i) * 32 + bit_i
    ok = (j >= 1) & (j <= total)
    return torch.where(ok, pos, bv.n_bits).to(torch.int32).reshape(shape)


# numpy oracles ---------------------------------------------------------------

def rank1_np(set_bits: np.ndarray, pos: int) -> int:
    return int(np.count_nonzero(np.asarray(set_bits) < pos))


def select1_np(set_bits: np.ndarray, j: int, n_bits: int) -> int:
    sb = np.sort(np.asarray(set_bits))
    return int(sb[j - 1]) if 1 <= j <= len(sb) else n_bits
