"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

They are the CPU path, and the oracle each CUDA kernel is held against on
the card.  Each takes the arrays its kernel takes, under the reference's
argument names and order (``repro/kernels/ref.py``).  The plain version of
the beam loop lives beside its kernel in ``kernels/beam_step.py``, since it
is built from the search core's own pool primitives.
"""
from __future__ import annotations

import torch

# rows of in-block residuals computed per pass of the byte rank (bounds the
# (rows, block) compare temporary)
_RANK_ROWS = 8192
_U32 = 0xFFFFFFFF
_I32_MAX = 2**31 - 1


def byte_rank_ref(data_padded: torch.Tensor, counts: torch.Tensor,
                  length: int, bytes_q: torch.Tensor, pos_q: torch.Tensor, *,
                  block: int) -> torch.Tensor:
    """Occurrences of ``bytes_q[i]`` in ``data[0:pos_q[i]]`` (positions
    clipped to [0, length]); same-shape int32.

    The counter cell of the position's block plus a masked compare over the
    tile prefix.  The tile index is clamped to the last block, which makes
    ``pos == length`` exact at a block edge (the counter row plus one
    full-tile count)."""
    shape = pos_q.shape
    n_blocks = counts.shape[0] - 1
    byte = bytes_q.reshape(-1).long()
    pos = pos_q.reshape(-1).to(torch.int32).clamp(0, length)
    blk = torch.clamp(pos // block, max=n_blocks - 1).long()
    base = counts[blk, byte]
    tiles = data_padded.view(n_blocks, block)
    lane = torch.arange(block, device=pos.device, dtype=torch.int32)
    cut = pos - blk.to(torch.int32) * block
    parts = []
    for s in range(0, pos.numel(), _RANK_ROWS):
        e = s + _RANK_ROWS
        hit = (tiles[blk[s:e]] == byte[s:e, None].to(torch.uint8)) \
            & (lane[None, :] < cut[s:e, None])
        parts.append(hit.sum(1, dtype=torch.int32))
    intile = torch.cat(parts) if parts else cut.new_zeros(0)
    return (base + intile).reshape(shape)


def segment_tf_ref(data_padded: torch.Tensor, counts: torch.Tensor,
                   length: int, byte: int, bounds: torch.Tensor, *,
                   block: int) -> torch.Tensor:
    """tf of ``byte`` in each ``[bounds[d], bounds[d+1])``: the byte's ranks
    at the D+1 bounds, differenced; (D,) int32."""
    r = byte_rank_ref(data_padded, counts, length,
                      torch.full_like(bounds, int(byte), dtype=torch.int32),
                      bounds, block=block)
    return r[1:] - r[:-1]


def popcount32(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit pattern held in ``w`` (int32 or int64; only
    the low 32 bits count) — SWAR arithmetic on int64, since PyTorch has no
    popcount; int32 result."""
    x = w.long() & _U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & _U32) >> 24).to(torch.int32)


def bitmap_rank1_ref(words: torch.Tensor, counts: torch.Tensor, n_bits: int,
                     pos_q: torch.Tensor) -> torch.Tensor:
    """Set bits among the first ``pos_q[i]`` bits (clipped to [0, n_bits]);
    same-shape int32.  ``words`` holds the LSB-first uint32 bit patterns as
    int32, padded to whole counter blocks; ``counts`` the cumulative ones at
    every block start.  A block is ``words.numel() // n_blocks`` words."""
    shape = pos_q.shape
    n_blocks = counts.shape[0] - 1
    wpb = words.numel() // n_blocks
    pos = pos_q.reshape(-1).to(torch.int32).clamp(0, n_bits).long()
    blk = torch.clamp(pos // (wpb * 32), max=n_blocks - 1)
    lane = torch.arange(wpb, device=pos.device, dtype=torch.int64)
    chunk = words.view(n_blocks, wpb)[blk]                      # (M, wpb)
    n_valid = (pos[:, None] - blk[:, None] * (wpb * 32)
               - lane[None, :] * 32).clamp(0, 32)
    mask = (torch.ones_like(n_valid) << n_valid) - 1            # int64: 32 ok
    pc = popcount32(chunk.long() & mask).sum(1, dtype=torch.int32)
    return (counts[blk] + pc).reshape(shape)


def scored_topk_ref(cands: torch.Tensor, query: torch.Tensor, *, k: int,
                    valid: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``cands @ query``: ((k,) float32 scores, (k,) int32 row
    indices) under the total order (score desc, index asc), the order
    ``lax.top_k`` returns.  Rows where the optional (C,) bool ``valid`` is
    False never compete; a slot no eligible row fills is (-inf, 2**31 - 1).
    A batch of queries — ``cands`` (B, C, d), ``query`` (B, d), ``valid``
    (B, C) — gives (B, k) results, one row per query.

    Each row's dot product is formed left to right over ``d``, each product
    rounded to float32 and then added — the order the kernel uses, so the two
    agree bitwise; never ``@``, whose reduction order is the library's."""
    C, d = cands.shape[-2:]
    if not 0 < k <= C:
        raise ValueError(f"scored_topk: k={k} must be in [1, C={C}]")
    q = query.to(torch.float32)
    scores = torch.zeros(cands.shape[:-1], dtype=torch.float32,
                         device=cands.device)
    for j in range(d):
        scores = scores + cands[..., j].to(torch.float32) * q[..., j, None]
    ok = torch.ones_like(scores, dtype=torch.bool) if valid is None else valid
    # eligible rows first, then by score desc, then by row asc
    key = torch.where(ok, scores, float("-inf"))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    order = order.gather(-1, torch.sort((~ok.gather(-1, order)).to(
        torch.uint8), dim=-1, stable=True).indices)[..., :k]
    taken = ok.gather(-1, order)
    return (torch.where(taken, scores.gather(-1, order), float("-inf")),
            torch.where(taken, order.to(torch.int32), _I32_MAX))


def wavelet_count_ref(levels, cw, cw_len, node_off, base_rank,
                      words, los, his) -> torch.Tensor:
    """Batched 3-level count descent: occurrences of ``words[i]`` in root
    range ``[los[i], his[i])``; (M,) int32.

    Per level the 2·M endpoint ranks run as one vectorized batch (the
    level-to-level dependency is the only sequential part).  At each level
    an endpoint maps to ``p = clip(node_off + a, 0, length)`` and its rank is
    the counter cell plus the in-tile count, minus the word's base rank; the
    result is the rank difference at the word's leaf level."""
    words = words.long()
    M = words.shape[0]
    a = los.to(torch.int32)
    b = his.to(torch.int32)
    res = torch.zeros(M, dtype=torch.int32, device=words.device)
    wlen = cw_len[words]
    for L, lv in enumerate(levels):
        byte = cw[words, L]
        off = node_off[words, L]
        base = base_rank[words, L]
        pos = torch.cat([off + a, off + b])
        r = byte_rank_ref(lv.data, lv.counts, lv.length,
                          torch.cat([byte, byte]), pos, block=lv.block)
        ra, rb = r[:M] - base, r[M:] - base
        res = torch.where(wlen == L + 1, rb - ra, res)
        a, b = ra, rb
    return res
