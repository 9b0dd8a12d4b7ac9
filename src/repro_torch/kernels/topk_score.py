"""The ``scored_topk`` kernel (K6): fused candidate scoring and top-k.

Replaces the Pallas kernel ``repro/kernels/topk_score.py`` (``_kernel``).
Top-k of ``cands @ query`` for one query against C candidate rows, in ONE
launch on the card (``csrc/topk_score.cu``): a persistent grid stages row
blocks through shared memory with ``cp.async``, scores each row left to
right over d (each product rounded and then added), keeps each warp's k
best as it goes, and the last block of each query merges the blocks'
partials by an atomic ticket — the order (score desc, row asc) that
``lax.top_k`` gives.  :func:`launch_plan` sizes the stages and the grid.
The plain version is ``kernels/ref.py:scored_topk_ref``.

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

from typing import NamedTuple

import torch

from repro_torch.kernels import backend, ref

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SMEM_BYTES = 227 * 1024
# csrc/topk_score.cu: warps per block, cp.async stages per warp, the shared
# candidate buffer of a k > 32 list; and the bytes a stage may hold
WARPS, STAGES, BUF = 8, 4, 256
STAGE_BYTES = 5632
SMALL_K = 32                # k up to this keeps its lists in registers
_MAX_B = 65535
# per (device, stream): the queries' merge tickets, zeroed once; each launch
# leaves them at zero again (atomicInc wraps)
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"scored_topk: {what}")


class Plan(NamedTuple):
    """The kernel's launch geometry: ``rs`` rows per row block (a multiple
    of 32), staged ``su`` 16-byte units of a row at a time at a stride of
    ``sp`` units (odd: no bank conflict), ``nslice`` stages per row block,
    ``gx`` blocks per query, ``shmem`` dynamic shared bytes per block."""
    rs: int
    su: int
    sp: int
    nslice: int
    gx: int
    small: bool
    shmem: int


def launch_plan(B: int, C: int, d: int, elem: int, vec: bool, k: int,
                masked: bool, n_sm: int) -> Plan:
    """Stage sizes and grid of one launch (the arithmetic
    ``csrc/topk_score.cu`` trusts).  ``vec``: rows are 16-byte aligned and
    staged; otherwise each lane reads its row from device memory, 32 rows a
    row block.  A whole row fits a stage when 32 rows at an odd stride do
    (``STAGE_BYTES``); the stage then holds as many multiples of 32 rows as
    fit.  Wider rows are staged 32 rows x ``su`` units at a time.  One block
    of ``WARPS`` warps per SM, spread over the B queries (one wave: never
    more blocks than SMs while B fits), no more warps than row blocks; a k > 32 list takes at most one block per 4 * WARPS * k
    rows, so each warp's list sees several k rows."""
    small = k <= SMALL_K
    if vec:
        upr = d * elem // 16
        sp = upr | 1
        if 32 * sp * 16 <= STAGE_BYTES:
            rs, su, nslice = 32 * (STAGE_BYTES // (32 * sp * 16)), upr, 1
        else:
            su = STAGE_BYTES // (32 * 16)
            su -= 1 - su % 2                      # odd
            rs, sp, nslice = 32, su, -(-upr // su)
    else:
        rs, su, sp, nslice = 32, 0, 0, 1
    n_rb = -(-C // rs)
    gx = max(1, min(n_sm // B, -(-n_rb // WARPS)))
    if not small:
        gx = max(1, min(gx, C // (4 * WARPS * k)))
    mask_bytes = (rs + 31) & ~15 if vec and masked else 0
    per_warp = (STAGES * (rs * sp * 16 + mask_bytes) if vec else 0) \
        + (0 if small else BUF * 8)
    return Plan(rs, su, sp, nslice, gx, small, WARPS * per_warp)


def _tickets(dev: torch.device) -> torch.Tensor:
    key = (dev.index, backend.stream())
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(_MAX_B, dtype=torch.int32, device=dev)
    return t


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
    (B, C) — gives (B, k) results from one launch.  ``tile``, the
    reference's tile of rows, bounds k; the kernel plans its own row blocks
    (:func:`launch_plan`).  Kernel for tensors on the card, plain version
    for tensors on the CPU or with ``kernel_backend="ref"``."""
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
    _require(1 <= B <= _MAX_B, f"a batch of {B} queries must be in [1, 65535]")
    ok = None if valid is None else valid.contiguous().view(torch.uint8)
    q = query.to(torch.float32).contiguous()
    vec = (d * cands.element_size()) % 16 == 0 and cands.data_ptr() % 16 == 0
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pl = launch_plan(B, C, d, cands.element_size(), vec, k, ok is not None,
                     n_sm)
    part_s = torch.empty((B, pl.gx, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, pl.gx, k), dtype=torch.int32, device=dev)
    n_list = 0 if pl.small else B * pl.gx * WARPS * 2 * k
    list_s = torch.empty(n_list, dtype=torch.float32, device=dev)
    list_i = torch.empty(n_list, dtype=torch.int32, device=dev)
    s = torch.empty((B, k), dtype=torch.float32, device=dev)
    i = torch.empty((B, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        backend.SCORED_TOPK.launch(
            cands.data_ptr(), q.data_ptr(), 0 if ok is None else ok.data_ptr(),
            B, C, d, _DTYPES[cands.dtype], k, int(vec), pl.rs, pl.su, pl.sp,
            pl.nslice, pl.gx, pl.shmem, part_s.data_ptr(), part_i.data_ptr(),
            list_s.data_ptr(), list_i.data_ptr(), _tickets(dev).data_ptr(),
            s.data_ptr(), i.data_ptr())
    return (s, i) if batched else (s[0], i[0])
