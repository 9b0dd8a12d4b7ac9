"""The ``bitmap_rank1`` kernel (K3): batched rank1 over packed tf bitmaps.

Replaces the Pallas kernel ``repro/kernels/bitmap_rank.py`` (``_kernel``).
For M positions it returns the set bits among the first ``pos_q[i]`` bits of
an LSB-first bit vector of uint32 words (held as int32 bit patterns, since
PyTorch's uint32 supports few operations), with a cumulative counter every
``WORDS_PER_BLOCK`` words: one warp per query on the card, one lane per word
(``csrc/bitmap_rank.cu``); the plain version is
``kernels/ref.py:bitmap_rank1_ref``.  ``bitvec.rank1`` calls it; the DRB
searches on the card rank inside their own kernels (``drb_walk``,
``drb_or``), so it runs on their plain versions' path only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref

WORDS_PER_BLOCK = 32  # one counter per 1024 bits; one warp lane per word


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"bitmap_rank1: {what}")


def bitmap_rank1(words: torch.Tensor, counts: torch.Tensor, n_bits: int,
                 pos_q: torch.Tensor, *, kernel_backend: str = "auto"
                 ) -> torch.Tensor:
    """Set bits among the first ``pos_q[i]`` bits (clipped to [0, n_bits]);
    same-shape int32.  Kernel for tensors on the card (raising on what it
    does not take), plain version for tensors on the CPU or with
    ``kernel_backend="ref"``."""
    if not backend.use_kernel(pos_q, kernel_backend):
        return ref.bitmap_rank1_ref(words, counts, n_bits, pos_q)
    dev = pos_q.device
    n_blocks = counts.shape[0] - 1
    _require(all(t.device == dev for t in (words, counts)),
             "all inputs must lie on one CUDA device")
    _require(words.dtype == torch.int32 and words.is_contiguous()
             and words.numel() == n_blocks * WORDS_PER_BLOCK,
             f"words must be contiguous int32 of n_blocks*{WORDS_PER_BLOCK}")
    _require(counts.dtype == torch.int32 and counts.is_contiguous()
             and counts.dim() == 1, "counts must be contiguous (n_blocks+1,) "
             "int32")
    _require(0 <= n_bits <= n_blocks * WORDS_PER_BLOCK * 32 < 2**31,
             "n_bits must fit the words and int32 positions")
    p = pos_q.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty(p.numel(), dtype=torch.int32, device=dev)
    if p.numel():
        with torch.cuda.device(dev):
            backend.BITMAP_RANK1.launch(words.data_ptr(), counts.data_ptr(),
                                        n_blocks, int(n_bits), p.data_ptr(),
                                        out.data_ptr(), p.numel())
    return out.reshape(pos_q.shape)
