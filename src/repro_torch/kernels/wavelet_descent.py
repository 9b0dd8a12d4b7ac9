"""The ``wavelet_count`` kernel: fused 3-level WTBC count descent.

Replaces the Pallas kernel family of ``repro/kernels/wavelet_descent.py``
(``_kernel_tpu`` / ``_kernel_gpu`` around the shared ``_descent_levels``).
For M (word, lo, hi) triples it counts the word's occurrences in root range
[lo, hi): each endpoint's three levels back to back on its own warp, each
rank counted from the nearer end of its tile, and the two warps of a triple
combined in shared memory (``csrc/wavelet_descent.cu``, device code shared
with the beam loop through ``csrc/wtbc_descent.cuh``).  The plain version is
``kernels/ref.py:wavelet_count_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.byte_rank import bytemap_args


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"wavelet_count: {what}")


def level_args(levels) -> tuple:
    """The kernels' level arguments: (data, counts, n_blocks, length) per
    level, then the shared block size — each level checked for what the
    device code assumes (``byte_rank.bytemap_args``)."""
    block = levels[0].block
    _require(len(levels) == 3, "expects 3 levels")
    args = []
    for lv in levels:
        _require(lv.block == block, "levels differ in block size")
        args += bytemap_args(lv.data, lv.counts, lv.length, block)[:4]
    return (*args, block)


def table_args(cw, cw_len, node_off, base_rank) -> tuple:
    """Per-word tables: cw (V, 3) uint8 read as bytes in the kernel (not
    widened), cw_len (V,), node_off and base_rank (V, 3) int32."""
    V = cw.shape[0]
    _require(cw.dtype == torch.uint8 and tuple(cw.shape) == (V, 3),
             "cw must be (V, 3) uint8")
    _require(cw_len.dtype == torch.int32 and tuple(cw_len.shape) == (V,),
             "cw_len must be (V,) int32")
    for t in (node_off, base_rank):
        _require(t.dtype == torch.int32 and tuple(t.shape) == (V, 3),
                 "node_off / base_rank must be (V, 3) int32")
    for t in (cw, cw_len, node_off, base_rank):
        _require(t.is_contiguous(), "word tables must be contiguous")
    return (cw.data_ptr(), cw_len.data_ptr(), node_off.data_ptr(),
            base_rank.data_ptr())


def wavelet_count(levels, cw, cw_len, node_off, base_rank, words, los, his,
                  *, kernel_backend: str = "auto") -> torch.Tensor:
    """Occurrences of word-rank ``words[i]`` in root range ``[los[i],
    his[i])``; (M,) int32.  Launches the kernel for tensors on the card
    (raising on what it does not take), runs the plain version for tensors
    on the CPU or when ``kernel_backend="ref"``.  Word ids are trusted to be
    in [0, V)."""
    if not backend.use_kernel(words, kernel_backend):
        return ref.wavelet_count_ref(levels, cw, cw_len, node_off, base_rank,
                                     words, los, his)
    M = words.numel()
    _require(words.dim() == 1 and los.shape == words.shape
             and his.shape == words.shape, "words/los/his must be (M,)")
    dev = words.device
    tensors = [lv.data for lv in levels] + [lv.counts for lv in levels] \
        + [cw, cw_len, node_off, base_rank, los, his]
    _require(all(t.device == dev for t in tensors),
             "all inputs must lie on one CUDA device")
    lv_args = level_args(levels)
    tb_args = table_args(cw, cw_len, node_off, base_rank)
    words = words.to(torch.int32).contiguous()
    los = los.to(torch.int32).contiguous()
    his = his.to(torch.int32).contiguous()
    out = torch.empty(M, dtype=torch.int32, device=dev)
    if M == 0:
        return out
    with torch.cuda.device(dev):
        backend.WAVELET_COUNT.launch(*lv_args, *tb_args, words.data_ptr(),
                                     los.data_ptr(), his.data_ptr(),
                                     out.data_ptr(), M)
    return out
