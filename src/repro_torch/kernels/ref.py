"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

They are the CPU path, and the oracle each CUDA kernel is held against on
the card.  The plain version of the beam loop lives beside its kernel in
``kernels/beam_step.py``, since it is built from the search core's own
pool primitives.
"""
from __future__ import annotations

import torch

from repro_torch.core import bytemap


def wavelet_count_ref(levels, cw, cw_len, node_off, base_rank,
                      words, los, his) -> torch.Tensor:
    """Batched 3-level count descent: occurrences of ``words[i]`` in root
    range ``[los[i], his[i])``; (M,) int32.

    Per level the 2·M endpoint ranks run as one vectorized batch (the
    level-to-level dependency is the only sequential part).  At each level
    an endpoint maps to ``p = clip(node_off + a, 0, length)`` and its rank is
    the counter cell plus the in-tile count, minus the word's base rank; the
    result is the rank difference at the word's leaf level."""
    words = words.long()
    M = words.shape[0]
    a = los.to(torch.int32)
    b = his.to(torch.int32)
    res = torch.zeros(M, dtype=torch.int32, device=words.device)
    wlen = cw_len[words]
    for L, lv in enumerate(levels):
        byte = cw[words, L]
        off = node_off[words, L]
        base = base_rank[words, L]
        pos = torch.cat([off + a, off + b])
        r = bytemap.rank(lv, torch.cat([byte, byte]), pos)
        ra, rb = r[:M] - base, r[M:] - base
        res = torch.where(wlen == L + 1, rb - ra, res)
        a, b = ra, rb
    return res
