"""Public entry points of the port's kernels, under the reference's names
and argument order (``repro/kernels/ops.py``).  Dispatch follows the
tensor's device (``kernels/backend.py``): the CUDA kernel for tensors on the
card, the plain version for tensors on the CPU or when
``kernel_backend="ref"``."""
from __future__ import annotations

import torch

from repro_torch.kernels import (bitmap_rank, byte_rank, segment_tf,
                                 topk_score, wavelet_descent)


def rank_batch(bm, bytes_q: torch.Tensor, pos_q: torch.Tensor, *,
               kernel_backend: str = "auto") -> torch.Tensor:
    """Batched bytemap rank over a ``ByteMap``: one ``byte_rank`` launch on
    the card for every query."""
    return byte_rank.byte_rank(bm.data, bm.counts, bm.length, bytes_q, pos_q,
                               block=bm.block, kernel_backend=kernel_backend)


def bitmap_rank1_batch(bv, pos_q: torch.Tensor, *,
                       kernel_backend: str = "auto") -> torch.Tensor:
    """Batched rank1 over a ``BitVec``: one ``bitmap_rank1`` launch on the
    card for every query."""
    return bitmap_rank.bitmap_rank1(bv.words, bv.counts, bv.n_bits, pos_q,
                                    kernel_backend=kernel_backend)


def scored_topk(cands: torch.Tensor, query: torch.Tensor, *, k: int,
                tile: int = 1024, valid: torch.Tensor | None = None,
                kernel_backend: str = "auto"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``cands @ query`` (scores, row indices), rows outside the
    optional ``valid`` mask left out; (C, d) / (d,) for one query, (B, C, d)
    / (B, d) for a batch: one ``scored_topk`` launch on the card plus the
    merge of its partials."""
    return topk_score.scored_topk(cands, query, k=k, tile=tile, valid=valid,
                                  kernel_backend=kernel_backend)


def wavelet_count_batch(levels, cw, cw_len, node_off, base_rank,
                        words, los, his, *, kernel_backend: str = "auto"
                        ) -> torch.Tensor:
    """Batched fused 3-level WTBC count (the Algorithm-1 hot path); (M,)
    int32.  One ``wavelet_count`` launch on the card for the whole
    (M x levels x 2) rank workload; the plain batched descent otherwise."""
    return wavelet_descent.wavelet_count(levels, cw, cw_len, node_off,
                                         base_rank, words, los, his,
                                         kernel_backend=kernel_backend)


def segment_tf_batch(bm, byte: int, bounds: torch.Tensor, *,
                     kernel_backend: str = "auto") -> torch.Tensor:
    """Per-span tf of one byte over sorted bounds of a ``ByteMap``: one
    ``segment_tf`` launch on the card."""
    return segment_tf.segment_tf(bm.data, bm.counts, bm.length, byte, bounds,
                                 block=bm.block,
                                 kernel_backend=kernel_backend)
