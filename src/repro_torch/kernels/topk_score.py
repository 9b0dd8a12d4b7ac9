"""The ``scored_topk`` kernel (K6): fused candidate scoring and top-k.

Replaces the Pallas kernel ``repro/kernels/topk_score.py`` (``_kernel``).
Top-k of ``cands @ query`` for one query against C candidate rows, in ONE
launch on the card (``csrc/topk_score.cu``): a persistent grid stages row
blocks through shared memory with ``cp.async`` (in pieces of 16, 8, 4 or 2
bytes, whichever the rows' width and address allow), scores each row left
to right over d (each product rounded and then added), keeps the k best as
it goes — each warp's list in registers for k <= 32; for k > 32 a block
buffer behind a rising score threshold, cut back to its k best by a
block-wide radix select — and the last block of each query merges the
blocks' partials by an atomic ticket, in the order (score desc, row asc)
that ``lax.top_k`` gives.  :func:`launch_plan` sizes the stages, the grid
and the buffer.
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

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import backend, ref

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_SMEM_BYTES = 227 * 1024
# csrc/topk_score.cu: warps per block; the bytes a stage of a 4-stage ring
# may hold; an upper bound of the kernel's static shared bytes; the least
# candidate buffer of a k > 32 selection (entries of 8 bytes, in shared
# memory at this size)
WARPS = 8
STAGE_BYTES = 5632
STATIC_SMEM = 5632
BUF_MIN = 4096
SMALL_K = 32                # k up to this keeps its lists in registers
_MAX_B = 65535
# per (device, stream): the queries' merge tickets, zeroed once; each launch
# leaves them at zero again (atomicInc wraps)
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
# and the k > 32 groups' (at most max(SMs, B) groups a launch)
_GTICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"scored_topk: {what}")


class Plan(NamedTuple):
    """The kernel's launch geometry: rows staged in ``unit``-byte pieces,
    ``rs`` rows per row block (a multiple of 32), ``su`` units of a row a
    stage at a stride of ``sp`` units (odd: no bank conflict), ``nslice``
    stages per row block, a ring of ``ns`` stages per warp, ``gx`` blocks
    per query; k > 32: a candidate buffer of ``nc`` entries, in shared
    memory when ``buf_in_smem``, with room for ``every`` rounds of the
    block's row blocks between its barriers, and the partials merged in
    groups of ``grp`` blocks; ``shmem`` dynamic shared bytes per block."""
    unit: int
    rs: int
    su: int
    sp: int
    nslice: int
    ns: int
    gx: int
    nc: int
    every: int
    grp: int
    buf_in_smem: bool
    small: bool
    shmem: int


def staging_unit(row_bytes: int, addr: int, elem: int) -> int:
    """The largest of 16, 8, 4, 2 bytes that divides a row's bytes and the
    candidates' address (at least the element size)."""
    g = 16
    while g > elem and (row_bytes % g or addr % g):
        g //= 2
    return g


def launch_plan(B: int, C: int, d: int, elem: int, unit: int, k: int,
                masked: bool, n_sm: int) -> Plan:
    """Stage sizes, grid and buffer of one launch (the arithmetic
    ``csrc/topk_score.cu`` trusts).  A row is ``d * elem / unit`` units at
    an odd stride.  32 rows that fit ``STAGE_BYTES`` make a ring of 4
    stages of as many multiples of 32 rows as fit; wider rows take a ring
    of 3 stages of 32 rows while it fits shared memory, else are staged 32
    rows x ``su`` units at a time.  One block of ``WARPS`` warps per SM,
    spread over the B queries (one wave: never more blocks than SMs while B
    fits), no more warps than row blocks; a k > 32 selection takes at most
    one block per 4 * k rows and a buffer of at least ``BUF_MIN`` entries,
    the next power of two of k and k plus one round of the block's rows; a
    barrier every round up to 8 while they fill at most half the room past
    k; groups of about sqrt(gx) blocks."""
    small = k <= SMALL_K
    upr = d * elem // unit
    sp = upr | 1
    avail = _SMEM_BYTES - STATIC_SMEM - (0 if small else BUF_MIN * 8)

    def ring(ns: int, rs: int, stride: int) -> int:
        mask = (rs + 31) & ~15 if masked else 0
        return WARPS * ns * (rs * stride * unit + mask)
    row32 = 32 * sp * unit
    if row32 <= STAGE_BYTES:
        ns, rs, su, nslice = 4, 32 * (STAGE_BYTES // row32), upr, 1
        while rs > 32 and ring(ns, rs, sp) > avail:
            rs -= 32
    elif ring(3, 32, sp) <= avail:
        ns, rs, su, nslice = 3, 32, upr, 1
    else:
        su = STAGE_BYTES // (32 * unit)
        su -= 1 - su % 2                      # odd
        ns, rs, sp, nslice = 4, 32, su, -(-upr // su)
    n_rb = -(-C // rs)
    gx = max(1, min(n_sm // B, -(-n_rb // WARPS)))
    nc, every, grp, in_smem = 0, 1, 1, False
    if not small:
        gx = max(1, min(gx, C // (4 * k)))
        need = max(BUF_MIN, 1 << (k - 1).bit_length(), k + WARPS * rs)
        nc = -(-need // 256) * 256
        in_smem = nc == BUF_MIN
        every = max(1, min(8, (nc - k) // (2 * WARPS * rs)))
        grp = math.isqrt(gx - 1) + 1
    shmem = ring(ns, rs, sp) + (nc * 8 if in_smem else 0)
    return Plan(unit, rs, su, sp, nslice, ns, gx, nc, every, grp, in_smem,
                small, shmem)


def work(B: int, C: int, d: int, elem: int, k: int,
         masked: bool) -> tuple[int, int]:
    """(bytes, float32 operations) the least one launch must do: the (B, C,
    d) candidates of ``elem`` bytes, the optional (B, C) mask and the (B, d)
    float32 queries read once, the (B, k) scores and indices written; one
    multiply-add (two operations) per candidate element."""
    nbytes = B * C * d * elem + B * d * 4 + (B * C if masked else 0) \
        + B * k * 8
    return nbytes, 2 * B * C * d


def _tickets(dev: torch.device, store: dict) -> torch.Tensor:
    key = (dev.index, backend.stream())
    t = store.get(key)
    if t is None:
        t = store[key] = torch.zeros(_MAX_B, dtype=torch.int32, device=dev)
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
    es = cands.element_size()
    unit = staging_unit(d * es, cands.data_ptr(), es)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    pl = launch_plan(B, C, d, es, unit, k, ok is not None, n_sm)
    part_s = torch.empty((B, pl.gx, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, pl.gx, k), dtype=torch.int32, device=dev)
    part_t = torch.empty(0 if pl.small else B * pl.gx, dtype=torch.float32,
                         device=dev)
    n_buf = 0 if pl.small or pl.buf_in_smem else B * pl.gx * pl.nc
    gbuf_s = torch.empty(n_buf, dtype=torch.float32, device=dev)
    gbuf_i = torch.empty(n_buf, dtype=torch.int32, device=dev)
    s = torch.empty((B, k), dtype=torch.float32, device=dev)
    i = torch.empty((B, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        backend.SCORED_TOPK.launch(
            cands.data_ptr(), q.data_ptr(), 0 if ok is None else ok.data_ptr(),
            B, C, d, _DTYPES[cands.dtype], k, pl.unit, pl.rs, pl.su, pl.sp,
            pl.nslice, pl.ns, pl.gx, pl.nc, pl.every, pl.grp,
            int(pl.buf_in_smem), pl.shmem, part_s.data_ptr(),
            part_i.data_ptr(), part_t.data_ptr(), gbuf_s.data_ptr(),
            gbuf_i.data_ptr(), _tickets(dev, _TICKETS).data_ptr(),
            _tickets(dev, _GTICKETS).data_ptr(), s.data_ptr(), i.data_ptr())
    return (s, i) if batched else (s[0], i[0])
