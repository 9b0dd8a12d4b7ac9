"""The ``wtbc_locate`` kernel: every level of a WTBC locate in one launch.

The reference has no kernel here: its ``locate`` is plain ``jnp``
(``repro/core/wtbc.py``), one select per level from the word's leaf up.
The port's positional searches locate every occurrence of their anchor or
query words, so ``csrc/wtbc_locate.cu`` gives each (word, j) one warp that
walks all of its levels on the card (``csrc/wtbc_select.cuh``:
``warp_locate``, the DRB kernels' locate).

The plain version stands beside it: :func:`wtbc_locate_ref` walks every
lane through every level as batched tensor code (a lane whose codeword
does not reach a level keeps its position), so the batch shape never waits
on the data.  It is the CPU path and the kernel's oracle.
"""
from __future__ import annotations

import torch

from repro_torch.core import bytemap
from repro_torch.kernels import backend
from repro_torch.kernels.wavelet_descent import level_args, table_args


def wtbc_locate_ref(idx, w: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """Root position of the ``j[i]``-th (1-based) occurrence of word-rank
    ``w[i]``; same-shape int32.  Out-of-range ``j`` is not checked (as in
    the reference): each level's select saturates to its level's length,
    so callers that cannot guarantee ``1 <= j <= occ[w]`` mask the result
    themselves."""
    shape = w.shape
    w = w.reshape(-1).long()
    j = j.reshape(-1).to(torch.int32)
    pos = torch.zeros_like(j)
    wlen = idx.cw_len[w]
    for L in range(len(idx.levels) - 1, -1, -1):
        base = idx.base_rank[w, L]
        # occurrence index within this level's byte stream (1-based)
        occ_idx = torch.where(wlen == L + 1, base + j, base + pos + 1)
        p = bytemap.select(idx.levels[L], idx.cw[w, L], occ_idx) \
            - idx.node_off[w, L]
        pos = torch.where(wlen > L, p, pos)
    return pos.reshape(shape)


def launch_args(idx, w: torch.Tensor, j: torch.Tensor) -> tuple:
    """The kernel's arguments up to the lanes, each checked for what the
    device code assumes (tensors on the lanes' device, so the checks run on
    the CPU too): the levels' layout and word tables, contiguous int32
    words and occurrence numbers of one shape.  Raises ValueError on the
    first that fails.  Word ids are trusted to be in [0, V)."""
    def need(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"wtbc_locate: {what}")
    need(w.dtype == torch.int32 and j.dtype == torch.int32
         and w.is_contiguous() and j.is_contiguous() and w.shape == j.shape,
         "words and occurrence numbers must be contiguous int32 of one shape")
    need(idx.device == w.device == j.device,
         "the index must lie on the lanes' device")
    return (*level_args(idx.levels),
            *table_args(idx.cw, idx.cw_len, idx.node_off, idx.base_rank))


def wtbc_locate(idx, w: torch.Tensor, j: torch.Tensor, *,
                kernel_backend: str = "auto") -> torch.Tensor:
    """Root position of the ``j[i]``-th occurrence of word-rank ``w[i]``
    (any shape, ``j`` broadcast to ``w``); same-shape int32.  One launch
    on the card for every lane, the plain version on the CPU or with
    ``kernel_backend="ref"``; raises on what the kernel does not take
    (:func:`launch_args`)."""
    w, j = torch.broadcast_tensors(w, j)
    if not backend.use_kernel(w, kernel_backend):
        return wtbc_locate_ref(idx, w, j)
    wi = w.reshape(-1).to(torch.int32).contiguous()
    ji = j.reshape(-1).to(torch.int32).contiguous()
    args = launch_args(idx, wi, ji)
    out = torch.empty_like(wi)
    if wi.numel():
        with torch.cuda.device(wi.device):
            backend.WTBC_LOCATE.launch(*args, wi.data_ptr(), ji.data_ptr(),
                                       out.data_ptr(), wi.numel())
    return out.reshape(w.shape)
