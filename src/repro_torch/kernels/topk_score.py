"""The ``scored_topk`` kernel (K6): fused candidate scoring + per-tile top-k.

Replaces the Pallas kernel ``repro/kernels/topk_score.py`` (``_kernel``).
Top-k of ``cands @ query`` for one query against C candidate rows: on the
card one thread block per tile of ``tile`` rows scores its rows (left to
right over d, each product rounded and then added) and keeps its k best
(``csrc/topk_score.cu``); the (n_tiles, k) partials are merged here under
the explicit total order (score desc, row asc) that ``lax.top_k`` gives —
the reference merges outside its kernel too.  The plain version is
``kernels/ref.py:scored_topk_ref``.

Unlike the reference, whose padding rows score 0 and are dropped only after
the merge (so a tile of negative real scores can lose rows to them), rows
past C never compete: the result is the true top-k, as the plain version's.
An optional ``valid`` mask keeps rows out in the same way.  A batch of
queries, each with its own candidates, runs in one launch (the grid's second
dimension).  The plain version of WTBC-DRB's bag-of-words search
(``kernels/drb_or.py:drb_or_ref``) ranks a whole batch's (B, n_docs, Q)
per-word score parts against its (B, Q) idf weights here, the mask leaving
out the documents no query word occurs in — the DRB "score every candidate,
keep the best" step; on the card that search runs ``drb_or``, which fuses
this step with the gather.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SMEM_BYTES = 227 * 1024


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"scored_topk: {what}")


def lex_topk(scores: torch.Tensor, index: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k first (score, index) pairs along the last dimension under the
    order (score desc, index asc): a stable sort by index, then a stable
    descending sort by score."""
    o = torch.sort(index, dim=-1, stable=True).indices
    s, i = scores.gather(-1, o), index.gather(-1, o)
    o = torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :k]
    return s.gather(-1, o), i.gather(-1, o)


def scored_topk(cands: torch.Tensor, query: torch.Tensor, *, k: int,
                tile: int = 1024, valid: torch.Tensor | None = None,
                kernel_backend: str = "auto"
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``cands @ query``: ((k,) float32 scores, (k,) int32 row
    indices), best first, ties to the lower row.  ``cands`` (C, d) float32,
    float16 or bfloat16 (read as float32), ``query`` (d,), 1 <= k <=
    min(C, tile).  Rows where the optional (C,) bool ``valid`` is False
    never compete; a slot no eligible row fills is (-inf, 2**31 - 1).  A
    batch of B queries — ``cands`` (B, C, d), ``query`` (B, d), ``valid``
    (B, C) — gives (B, k) results from one launch.  Kernel for tensors on
    the card, plain version for tensors on the CPU or with
    ``kernel_backend="ref"``."""
    batched = cands.dim() == 3
    _require(cands.dim() in (2, 3) and query.dim() == cands.dim() - 1
             and query.shape == cands.shape[:-2] + cands.shape[-1:],
             "cands must be (C, d) and query (d,), or (B, C, d) and (B, d)")
    C, d = cands.shape[-2:]
    _require(tile > 0 and tile % 8 == 0, f"tile {tile} must be a positive "
             "multiple of 8")
    _require(1 <= k <= min(C, tile), f"k={k} must be in [1, min(C, tile)]")
    _require(valid is None or (valid.dtype == torch.bool
                               and valid.shape == cands.shape[:-1]),
             "valid must be a bool mask of cands' rows")
    if not backend.use_kernel(cands, kernel_backend):
        return ref.scored_topk_ref(cands, query, k=k, valid=valid)
    dev = cands.device
    _require(query.device == dev and (valid is None or valid.device == dev),
             "all inputs must lie on one CUDA device")
    _require(cands.dtype in _DTYPES, f"unsupported dtype {cands.dtype}")
    _require(cands.is_contiguous(), "cands must be contiguous")
    _require(C < 2**31 - tile, "C must be below 2**31 - tile")
    _require((d + tile) * 4 + tile <= _SMEM_BYTES,
             "(d + tile) * 4 + tile bytes must fit in shared memory")
    B = cands.shape[0] if batched else 1
    _require(1 <= B <= 65535, f"a batch of {B} queries must be in [1, 65535]")
    ok = None if valid is None else valid.contiguous().view(torch.uint8)
    q = query.to(torch.float32).contiguous()
    n_tiles = -(-C // tile)
    part_s = torch.empty((B, n_tiles * k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, n_tiles * k), dtype=torch.int32, device=dev)
    vec = int((d * cands.element_size()) % 16 == 0
              and cands.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        backend.SCORED_TOPK.launch(cands.data_ptr(), q.data_ptr(),
                                   0 if ok is None else ok.data_ptr(),
                                   B, C, d, _DTYPES[cands.dtype], k, tile,
                                   vec, part_s.data_ptr(), part_i.data_ptr())
    s, i = lex_topk(part_s, part_i, k)
    return (s, i) if batched else (s[0], i[0])
