"""The ``byte_rank`` kernel (K5): batched rank over one counter-accelerated
bytemap.

Replaces the Pallas kernel ``repro/kernels/byte_rank.py`` (``_kernel``).  For
M (byte, pos) queries it returns the occurrences of ``bytes_q[i]`` in
``data[0:pos_q[i]]``: one warp per query on the card counting from the
nearer end of the tile (``csrc/byte_rank.cu``, on the per-level rank K1
uses), the plain version ``kernels/ref.py:byte_rank_ref`` on the CPU.
``bytemap.rank`` calls it; WTBC decoding on the card runs its own kernel
(``kernels/wtbc_decode.py``), so only the plain decode ranks through it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"byte_rank: {what}")


def bytemap_args(data_padded: torch.Tensor, counts: torch.Tensor,
                 length: int, block: int) -> tuple:
    """(data, counts, n_blocks, length, block) of one bytemap level, checked
    for what the device code assumes: contiguous 16-byte-aligned uint8 tiles
    of a multiple of 16 bytes, (n_blocks + 1, 256) int32 counters, and
    int32-addressable positions."""
    def need(cond: bool, what: str) -> None:
        if not cond:
            raise ValueError(f"bytemap level: {what}")
    n_blocks = counts.shape[0] - 1
    need(block % 16 == 0, f"block {block} is not a multiple of 16")
    need(data_padded.dtype == torch.uint8 and data_padded.is_contiguous()
         and data_padded.data_ptr() % 16 == 0,
         "data must be contiguous 16-byte-aligned uint8")
    need(counts.dtype == torch.int32 and counts.is_contiguous()
         and tuple(counts.shape) == (n_blocks + 1, 256),
         "counts must be contiguous (n_blocks+1, 256) int32")
    need(data_padded.numel() == n_blocks * block < 2**31,
         "data must hold n_blocks*block < 2**31 bytes")
    return (data_padded.data_ptr(), counts.data_ptr(), n_blocks, int(length),
            block)


def byte_rank(data_padded: torch.Tensor, counts: torch.Tensor, length: int,
              bytes_q: torch.Tensor, pos_q: torch.Tensor, *, block: int,
              kernel_backend: str = "auto") -> torch.Tensor:
    """Occurrences of ``bytes_q[i]`` in ``data[0:pos_q[i]]`` (positions
    clipped to [0, length]); same-shape int32.  Launches the kernel for
    tensors on the card (raising on what it does not take), runs the plain
    version for tensors on the CPU or when ``kernel_backend="ref"``.  Bytes
    are trusted to be in [0, 256)."""
    if not backend.use_kernel(pos_q, kernel_backend):
        return ref.byte_rank_ref(data_padded, counts, length, bytes_q, pos_q,
                                 block=block)
    _require(bytes_q.shape == pos_q.shape, "bytes_q and pos_q differ in shape")
    dev = pos_q.device
    _require(all(t.device == dev for t in (data_padded, counts, bytes_q)),
             "all inputs must lie on one CUDA device")
    args = bytemap_args(data_padded, counts, length, block)
    b = bytes_q.reshape(-1).to(torch.int32).contiguous()
    p = pos_q.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty(p.numel(), dtype=torch.int32, device=dev)
    if p.numel():
        with torch.cuda.device(dev):
            backend.BYTE_RANK.launch(*args, b.data_ptr(), p.data_ptr(),
                                     out.data_ptr(), p.numel())
    return out.reshape(pos_q.shape)
