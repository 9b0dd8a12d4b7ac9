"""Public entry points of the port's kernels.  Dispatch follows the tensor's
device (``kernels/backend.py``): the CUDA kernel for tensors on the card, the
plain version for tensors on the CPU or when ``kernel_backend="ref"``."""
from __future__ import annotations

import torch

from repro_torch.kernels import wavelet_descent


def wavelet_count_batch(levels, cw, cw_len, node_off, base_rank,
                        words, los, his, *, kernel_backend: str = "auto"
                        ) -> torch.Tensor:
    """Batched fused 3-level WTBC count (the Algorithm-1 hot path); (M,)
    int32.  One ``wavelet_count`` launch on the card for the whole
    (M x levels x 2) rank workload; the plain batched descent otherwise."""
    return wavelet_descent.wavelet_count(levels, cw, cw_len, node_off,
                                         base_rank, words, los, his,
                                         kernel_backend=kernel_backend)
