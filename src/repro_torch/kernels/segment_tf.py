"""The ``segment_tf`` kernel (K4): tf of one byte in each span of sorted
bounds.

Replaces the Pallas kernel ``repro/kernels/segment_tf.py`` (``_kernel``).
For D + 1 sorted bounds it returns ``tf[d] = rank(bounds[d+1]) -
rank(bounds[d])`` of one byte.  On the card (``csrc/segment_tf.cu``) a
thread block owns 127 spans; one warp per tile that their bounds fall in
reads the tile once, from each bound's nearer end, and ranks every bound
once, and the block differences the ranks in shared memory.
The plain version is ``kernels/ref.py:segment_tf_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.byte_rank import bytemap_args


def segment_tf(data_padded: torch.Tensor, counts: torch.Tensor, length: int,
               byte: int, bounds: torch.Tensor, *, block: int,
               kernel_backend: str = "auto") -> torch.Tensor:
    """tf of ``byte`` within each ``[bounds[d], bounds[d+1])``; bounds (D+1,)
    sorted (clipped to [0, length]) -> (D,) int32.  Kernel for tensors on
    the card, plain version for tensors on the CPU or with
    ``kernel_backend="ref"``."""
    if not backend.use_kernel(bounds, kernel_backend):
        return ref.segment_tf_ref(data_padded, counts, length, byte, bounds,
                                  block=block)
    if bounds.dim() != 1 or bounds.numel() < 1:
        raise ValueError("segment_tf: bounds must be (D+1,) with D >= 0")
    if not 0 <= int(byte) < 256:
        raise ValueError(f"segment_tf: byte {byte} outside [0, 256)")
    dev = bounds.device
    if not all(t.device == dev for t in (data_padded, counts)):
        raise ValueError("segment_tf: all inputs must lie on one CUDA device")
    args = bytemap_args(data_padded, counts, length, block)
    b = bounds.to(torch.int32).contiguous()
    D = b.numel() - 1
    out = torch.empty(D, dtype=torch.int32, device=dev)
    if D:
        with torch.cuda.device(dev):
            backend.SEGMENT_TF.launch(*args, int(byte), b.data_ptr(),
                                      out.data_ptr(), D)
    return out
