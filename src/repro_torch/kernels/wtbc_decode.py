"""The ``wtbc_decode`` kernel: every level of a WTBC decode in one launch.

Redesigns K5 (``repro/kernels/byte_rank.py``, ``_kernel``: the rank of a
byte over one counter-accelerated bytemap) on the path that spends it,
``wtbc.decode_at`` (snippets, ``extract``), which made one ``byte_rank``
launch per level amid plain PyTorch gathers: ``csrc/wtbc_decode.cu`` gives
each position one warp that reads the node offset and the byte of every
level, ranks the byte at both node positions counted from the nearer end of
their tiles, and stops at the word's last byte.

The plain version stands beside it: :func:`decode_at_ref` descends every
position through every level as batched tensor code, its ranks run the
plain ``byte_rank`` too, so a comparison on the card holds the kernel
against plain code end to end.  It is the CPU path and the kernel's oracle.
"""
from __future__ import annotations

import torch

from repro_torch.core import bytemap
from repro_torch.kernels import backend
from repro_torch.kernels.wavelet_descent import level_args


def decode_at_ref(idx, pos: torch.Tensor) -> torch.Tensor:
    """Word-rank at root position ``pos[i]``; same-shape int32.  Per level
    one access and two ranks, the (s,c)-DC rank rebuilt arithmetically from
    the byte path; lanes whose word ended at an upper level ride along
    (their ranks are discarded), so the batch shape never depends on the
    data."""
    s, c = idx.s, idx.c
    shape = pos.shape
    p = pos.reshape(-1).to(torch.int32)
    M = p.numel()
    prefix = torch.zeros_like(p)     # node key at the current level
    x = torch.zeros_like(p)          # accumulated continuer value
    rank_val = torch.zeros_like(p)
    done = torch.zeros(M, dtype=torch.bool, device=p.device)
    base_k, width = 0, s             # first rank of the k-byte band
    for L in range(len(idx.levels)):
        lv = idx.levels[L]
        off = idx.offsets[L][prefix.long()]
        b = bytemap.access(lv, off + p).to(torch.int32)
        is_stop = b < s
        val = x * s + b + base_k
        rank_val = torch.where(is_stop & ~done, val, rank_val)
        r = bytemap.rank(lv, torch.cat([b, b]), torch.cat([off + p, off]),
                         kernel_backend="ref")
        child_rel = r[:M] - r[M:]
        p = torch.where(is_stop, p, child_rel)
        prefix = torch.where(is_stop, prefix, prefix * c + (b - s))
        x = torch.where(is_stop, x, x * c + (b - s))
        done = done | is_stop
        base_k += width
        width *= c
    return rank_val.reshape(shape)


def launch_args(idx, pos: torch.Tensor) -> tuple:
    """The kernel's arguments up to the positions, each checked for what
    the device code assumes (tensors on the positions' device, so the
    checks run on the CPU too): the levels' layout, contiguous int32 node
    offset tables of c**L + 1 entries on that device, and int32 positions.
    Raises ValueError on the first that fails."""
    def need(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"wtbc_decode: {what}")
    dev = pos.device
    need(pos.dtype == torch.int32 and pos.is_contiguous(),
         "positions must be contiguous int32")
    need(idx.device == dev, "the index must lie on the positions' device")
    need(len(idx.offsets) == 3 and idx.s >= 1 and idx.c >= 0,
         "expects 3 levels and an (s,c)-DC with s >= 1")
    for L, o in enumerate(idx.offsets):
        need(o.dtype == torch.int32 and o.is_contiguous() and o.dim() == 1
             and o.numel() == idx.c ** L + 1 and o.device == dev,
             f"offsets of level {L} must be contiguous (c**{L} + 1,) int32 "
             f"on {dev}")
    return (*level_args(idx.levels), *(o.data_ptr() for o in idx.offsets),
            idx.s, idx.c)


def wtbc_decode(idx, pos: torch.Tensor, *,
                kernel_backend: str = "auto") -> torch.Tensor:
    """Word-rank at root position ``pos[i]`` (any shape); same-shape int32.
    One launch on the card for every position, the plain version on the
    CPU or with ``kernel_backend="ref"``; raises on what the kernel does
    not take (:func:`launch_args`)."""
    if not backend.use_kernel(pos, kernel_backend):
        return decode_at_ref(idx, pos)
    p = pos.reshape(-1).to(torch.int32).contiguous()
    args = launch_args(idx, p)
    out = torch.empty_like(p)
    if p.numel():
        with torch.cuda.device(p.device):
            backend.WTBC_DECODE.launch(*args, p.data_ptr(), out.data_ptr(),
                                       p.numel())
    return out.reshape(pos.shape)
