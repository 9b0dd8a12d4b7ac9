#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (WTBC-DR, WTBC-DRB,
positional search, the serving stack and document-sharded search).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the full run (86,445 documents)
    python3 chip_smoke.py --docs 4000   # a short rehearsal of every phase

Phases (any failure exits non-zero; no phase is caught and ignored, and
nothing falls back to the CPU):

1. build  — compile the ten CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once); print the card's name and power limit.
2. data   — a quarter of the paper's ALL collection (718,691-word vocabulary,
   Zipf 1.2, mean 633 tokens per document): 86,445 documents, about 55 M
   tokens, drawn from a seed in one vectorized draw; index built on the
   host at block 4096 and moved to the card.
3. K1     — ``wavelet_count`` against its plain version on the card: 4,096
   random triples (with lo = hi and hi = n), triples whose endpoints land
   on tile edges of levels 0 and 1 (where the nearer-end rank switches
   sides), plus every triple of real ranked and mega trips; bitwise.
4. K2     — ``beam_loop`` (the mega core's whole loop) against its plain
   loop on the card: four batches of B = 8 (and/or x df bands ii/iii,
   Q = 3 words, k = 10) plus a budgeted batch; every leaf bitwise.
5. main path — launch counters reset, then ``warmup`` and ``search`` as a
   user calls them: the heap core at P = 1 and P = 16 and the mega core;
   the cores agree with each other, two queries agree with a brute-force
   scoring of every document, executor counts stay flat after warmup, and
   both kernels were launched.
6. timings — CUDA-event times per launch of each kernel and of its plain
   version at the main path's shapes, the least time the card could take
   for the same work (bytes at 3.35 TB/s, byte compares at 1,979 TOPS; a
   rank needs the nearer end of its tile, ``near_bytes``), and ms per
   batch per core.
7. DRB aux — the tf bitmaps of WTBC-DRB built on the host for the same
   corpus; build time and bytes beside the index's bytes.
8. ``drb_walk`` (the whole DRB ``and`` walk in one launch) against the
   plain walk on the card, every leaf bitwise: the words of the four
   batches under tf-idf and BM25, a P = 16 batch and a budgeted batch, and
   a batch whose rows each take a band-ii word and two more frequent words
   of one document (``doc_batch``: every row has hits, so the walk scores
   and merges candidates) under tf-idf and BM25 at P = 1 and 16.
   ``drb_or`` (the whole DRB ``or`` query: a memset and three kernels)
   against its plain version, every leaf bitwise: the words of the four
   batches and of the ``doc_batch`` under tf-idf and BM25, and edge
   batches — k = 1; a repeated word, a stopword, the padded Q column and a
   row with no valid word; k past the collection on a 2,000-document
   engine.  ``wtbc_decode`` (a whole decode in one launch) against its
   plain version, bitwise: random positions, 0 and n - 1, positions whose
   descent ranks at a tile edge of each level, and every snippet position
   of phase 9.
   K3 ``bitmap_rank1``, K5 ``byte_rank``, K4 ``segment_tf`` and K6
   ``scored_topk`` against their plain versions on the card, bitwise:
   random inputs with their edges, plus every call that the plain DRB
   searches and a plain snippet decode made, recorded in phase 7 (the
   plain ``and`` walk and ``or`` query through ``kernel_backend="ref"``,
   since the engine routes them to ``drb_walk`` and ``drb_or``; ``or``
   under tf-idf and BM25) — K1 at each plain ``and`` trip's triples, K3 at
   its cursor ranks and the ``or`` base ranks, K6 at each plain ``or``
   batch with its mask, K5 at each level of the plain decode; K4 over
   every document bound; K6 at C = 10^6, d = 128.
9. the DRB path — launch counters reset, then ``search(strategy="drb")``
   under tf-idf and BM25 on the four batches of phase 2 and the ``and``
   batch of one document's words, and ``snippets`` of
   every hit, as a user calls them: DRB tf-idf equals the mega core, BM25
   equals a brute-force BM25 computed on the host in numpy from the
   corpus's tokens (two queries per batch), snippets equal the corpus's
   tokens; each ``and`` batch was one ``drb_walk`` launch and each ``or``
   batch one ``drb_or`` launch with no other kernel, and each ``snippets``
   call one ``wtbc_decode`` launch with no ``byte_rank`` launch.
10. timings of the new kernels (device time, wrapper time, plain time,
   bound, K6's library time; K4 over every document bound, K6 at
   C = 10^6 and at the DRB ``or`` batch and K3 at 10^6 random ranks
   (checked bitwise there too) timed cold — the median of CUDA
   events around one call after a 256 MB write (and a 64 MB read) that
   flushes the 50 MB L2, the card spinning while the call is enqueued —
   beside the warm reading and the profiler's, with their libraries'
   calls timed the same way; ``drb_walk`` per ``and`` iii batch and per
   trip of its longest row, its bound from what the plain walk's selects
   (from the nearer end of the block), documents, counts and ranks of valid
   words read; ``drb_or`` per ``or`` ii and iii batch, its bound from what
   the live lanes' bitmap blocks, selects (from the nearer end of the
   block) and documents need plus the tf table's zeroing and scan;
   ``wtbc_decode`` per snippet decode), DRB ms per batch, ``snippets`` ms
   per call, and the device's idle share on the DRB ``or`` ii batch (over
   ten searches) and on the ``and`` ii and iii batches.
11. positional search — batches of B = 8, k = 10: phrase rows of 2-3
   consecutive words of documents (every row has a hit), phrase and near
   rows of the band ii and iii words, near rows of three words of one
   document within 6 tokens at windows 8 and 64, and a near batch whose
   first row's words occur 10^5-10^6 times (several passes of the
   locates and the sweep).  ``wtbc_locate`` against its plain version,
   bitwise: random occurrences of 1-, 2- and 3-byte words, occurrences
   whose select lands on a block edge of each level, j = 0 and occ + 1.
   Every batch under tf-idf and BM25 on the card against the plain
   versions on the card (``kernel_backend="ref"``), every leaf bitwise;
   the phrase and near tables against a host brute force over the
   corpus's tokens (a shifted compare for phrase; for near the minimal
   cover on the documents holding every word, and every word's tf).  Then,
   launch counters reset, ``search(mode="phrase"|"near")`` and
   ``word_positions`` as a user calls them: each batch only
   ``wtbc_locate`` (and for phrase ``wtbc_decode``) launches, the results
   equal the core's, ``word_positions`` of phrase hits equal the tokens
   and each match is the phrase.  Timings: ms per batch, launches per
   batch, the idle share of a phrase and of the heavy near batch, and
   ``wtbc_locate``'s device, wrapper and plain times and bound
   (``locate_bytes``) at the lanes the path gives it.
12. F1 and F2 — DRB ``or`` at k = 40,000 on two rows of words in 46-99% of
   the documents (more than 40,000 hits a row), and the mega core at a
   pool of 1.2 M slots (past one block's shared memory) on the ``and`` ii
   batch and the ``or`` iii batch at 64 pops, each against its plain
   version on the card, every leaf bitwise; device times beside k = 10
   and the default cap.
13. serving — the engine saved as a snapshot and loaded back onto the card
   (every index, tf-bitmap and model array bitwise; save and load seconds,
   bytes on disk and on the device).  On the loaded engine, one
   ``SearchServer`` with metrics on per profile: warmup, then
   ``loadgen.closed_loop`` (8 workers, 256 requests over 64 distinct
   Zipf-repeated 3-word queries, ``max_batch=8``) under DR ``or`` on the
   heap core at a 50 ms deadline (first: the us/pop estimator learns the
   heap core's cost from its own warmup), DR ``or`` and ``and`` on the
   mega core, DRB ``or`` BM25 (the default BM25 route), DRB ``and`` tf-idf
   and phrase over ``loadgen.sample_ngram_queries``; then one
   ``open_loop`` on the mega ``or`` profile at half its closed loop's QPS.
   Each load: no shed, error or timeout; no executor built after warmup
   (at most 4 at the deadline); every distinct query's served row bitwise
   equal to a direct search under the same effective profile; launches
   per served batch equal a direct batch's (mega K1 + K2, one
   ``drb_or`` / ``drb_walk``, one ``wtbc_locate`` + ``wtbc_decode`` per
   phrase pass); p50/p95/p99, QPS, mean batch, cache hit rate, the
   registry's stage shares, the live ``repro_roofline_achieved_frac``
   and the device's idle share over a closed loop without cache.  Then
   ``python -m repro_torch.launch.serve --docs 2000 --requests 200
   --max-batch 8 --smoke --snapshot-dir D --save-snapshot``, and again
   from ``D`` alone: both print ``smoke: PASS``, the second without a
   build.
14. sharded search — ``SearchEngine.shard`` over the same corpus in 4
   shards, placed by default (on one card every shard on ``cuda:0``): host
   build time, cut points, each shard's documents, tokens and bytes on the
   card beside the single engine's.  Launch counters reset, then as a user
   calls them: the five batches of phase 5 on the heap core at P = 1 and
   P = 16, and the four batches plus the ``doc_batch`` on DRB under tf-idf
   and BM25, and ``snippets`` of every hit.  Checks: docs, scores and
   n_found equal the single engine's on every exact batch; the budgeted
   batch's ``certified`` is strict against the max of the shards' own
   bounds and its bound covers the candidate the merge dropped, its
   certified slots equal the exact answer's; snippets equal the tokens;
   each DR batch launches only K1 (no K2), each DRB batch one ``drb_walk``
   or ``drb_or`` per shard, each ``snippets`` call one ``wtbc_decode`` per
   shard holding a hit.  ms per batch, sharded against single, and the
   merge's own device time.  Then a sharded snapshot saved and loaded onto
   the card (answers bitwise equal), one closed-loop ``SearchServer``
   profile on the loaded engine (DRB ``or`` BM25, phase 13's traffic; one
   ``drb_or`` per shard per served batch), and ``python -m
   repro_torch.launch.serve --shards 4 --docs 2000 --smoke``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the paper's ALL collection (219 M words, 345,778 documents)
ALL_DOCS = 345_778
ALL_VOCAB = 718_691
ALL_MEAN_LEN = 633.0
ZIPF_ALPHA = 1.2
QUARTER_DOCS = 86_445
BLOCK = 4096
SEED = 20_260_417

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15    # H100 SXM data sheet, dense int8
FP32_OPS_PER_S = 67e12       # H100 SXM data sheet, float32 outside tensor cores
B, K = 8, 10


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def time_cuda(fn, reps: int, warm: int = 3, setup=None,
              median: bool = False) -> float:
    """ms per call of ``fn`` on the card: CUDA events around each call
    (``setup`` runs outside the timed span), after ``warm`` untimed calls;
    the mean over ``reps`` calls, or their median."""
    import torch
    for _ in range(warm):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)) if median else sum(times) / reps


FLUSH_BYTES = 256 << 20      # written between cold calls: 5x the 50 MB L2
FLUSH_READ = 64 << 20        # then read back, so the L2 holds clean lines
SLEEP_CYCLES = 4_000_000     # about 2 ms at 1.98 GHz: the card waits while
                             # the host enqueues the timed call
_FLUSH = []


def _flush_l2() -> None:
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    buf = _FLUSH[0]
    buf.fill_(1)
    buf[:FLUSH_READ].sum()


def cold_ms(fn, reps: int, warm: int = 2) -> float:
    """Median ms of ``fn`` on the card with a cold L2: before each timed
    call ``FLUSH_BYTES`` are written (and ``FLUSH_READ`` of them read back,
    so the timed call evicts clean lines and pays no write-back), then the
    card spins ``SLEEP_CYCLES`` so the whole call is enqueued before its
    first event: the span is the device's time, not the host's."""
    import torch

    def setup():
        _flush_l2()
        torch.cuda._sleep(SLEEP_CYCLES)
    return time_cuda(fn, reps, warm=warm, setup=setup, median=True)


def warm_ms(fn, reps: int, warm: int = 2) -> float:
    """As ``cold_ms`` without the flush: repeated calls on a warm L2."""
    import torch
    return time_cuda(fn, reps, warm=warm,
                     setup=lambda: torch.cuda._sleep(SLEEP_CYCLES),
                     median=True)


def topk_bound_ms(cands, q, valid, k: int) -> tuple[float, str]:
    """The least time K6 could take: its inputs read once (the candidates,
    the mask, q) and its (B, k) outputs written, against the float32
    multiply-adds of every row's dot."""
    B = cands.shape[0] if cands.dim() == 3 else 1
    nbytes = (cands.numel() * cands.element_size() + q.numel() * 4
              + (0 if valid is None else valid.numel()) + B * k * 8)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 2 * cands.numel() / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


PROFILE_SESSIONS = 4   # a torch.profiler session at times records no
                       # device activity at all; it is then run again


def _profile_rows(fn, reps: int) -> tuple[list[tuple[str, float]], float]:
    """One ``torch.profiler`` session over ``reps`` calls of ``fn``: the
    device kernels' (name, own ms per call) and the wall ms per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
             / 1e3 / reps) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return rows, wall


def _profiled(fn, reps: int, kernel: str | None
              ) -> tuple[list[tuple[str, float]], float] | None:
    """The rows and wall of the first of ``PROFILE_SESSIONS`` sessions that
    recorded device time (for ``kernel`` when it is given), else None."""
    for _ in range(PROFILE_SESSIONS):
        rows, wall = _profile_rows(fn, reps)
        if sum(ms for key, ms in rows
               if kernel is None or kernel in key) > 0:
            return rows, wall
    return None


def profile_device(fn, reps: int, kernel: str | None = None,
                   need: bool = True) -> tuple[float, float]:
    """Run ``fn`` ``reps`` times under ``torch.profiler`` and return (device
    ms per call of the kernels whose name holds ``kernel`` — or of all
    kernels when None —, wall ms per call).  Device time is the sum of the
    kernels' own times on the card, so host overhead between launches is
    not in it.  Where no session records that time, ``need`` falls back to
    CUDA events around each call (then launch gaps are in it, and the log
    says so); without ``need`` (a part that may launch nothing) it is 0."""
    got = _profiled(fn, reps, kernel)
    if got is not None:
        rows, wall = got
        return sum(ms for key, ms in rows
                   if kernel is None or kernel in key), wall
    if not need:
        return 0.0, 0.0
    t0 = time.perf_counter()
    ms = time_cuda(fn, reps=reps, warm=1)
    wall = (time.perf_counter() - t0) * 1e3 / (reps + 1)
    log(f"the profiler recorded no device time for {kernel or 'any kernel'} "
        f"in {PROFILE_SESSIONS} sessions: CUDA events instead, "
        f"{ms:.6f} ms per call")
    check(ms > 0, f"CUDA events timed {kernel or 'the call'} at 0 ms")
    return ms, wall


def device_breakdown(fn, reps: int, top: int = 6
                     ) -> tuple[float, float, list[tuple[str, float]]]:
    """(device ms per call, wall ms per call, the ``top`` device kernels by
    their own ms per call) of ``fn`` from one ``torch.profiler`` session
    over ``reps`` calls, as ``profile_device`` reads them: where a batch's
    device time goes.  Where no session records device time, the busy time
    is ``profile_device``'s CUDA-event time and the list is empty."""
    got = _profiled(fn, reps, None)
    if got is None:
        busy, wall = profile_device(fn, reps)
        return busy, wall, []
    rows, wall = got
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall, rows[:top]


def wall_ms(fn, device: str = "cuda") -> tuple[float, object]:
    """Host ms around ``fn``, ending in a synchronize on the card."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3, out


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def quarter_all_corpus(n_docs: int, seed: int):
    """Document lengths lognormal (sigma 0.6) with mean ALL_MEAN_LEN; tokens
    Zipf(1.2) over the ALL vocabulary, drawn in ONE vectorized choice."""
    from repro_torch.text.corpus import SyntheticCorpus, zipf_probs
    rng = np.random.default_rng(seed)
    mu = np.log(ALL_MEAN_LEN) - 0.6 ** 2 / 2
    lens = np.maximum(2, rng.lognormal(mu, 0.6, n_docs)).astype(np.int64)
    p = zipf_probs(ALL_VOCAB, ZIPF_ALPHA)
    flat = rng.choice(np.arange(1, ALL_VOCAB), size=int(lens.sum()), p=p)
    docs = np.split(flat, np.cumsum(lens)[:-1])
    return SyntheticCorpus(doc_tokens=docs, vocab_size=ALL_VOCAB, seed=seed)


class OpsRecorder:
    """Records the arguments of every call to one ``kernels.ops`` entry
    point (by default ``wavelet_count_batch``'s (words, los, his)), or to a
    function of another ``module``, while a search runs, by wrapping it for
    the duration: ``keep`` gets the call's arguments and returns those to
    record (tensors are cloned)."""

    def __init__(self, name: str = "wavelet_count_batch",
                 keep=lambda *a, **kw: a[5:8], module=None):
        self.name, self.keep, self.module = name, keep, module
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels import ops
        self._mod = ops if self.module is None else self.module
        self._orig = getattr(self._mod, self.name)

        def wrapped(*args, **kw):
            self.calls.append(tuple(x.clone() if hasattr(x, "clone") else x
                                    for x in self.keep(*args, **kw)))
            return self._orig(*args, **kw)
        setattr(self._mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self._mod, self.name, self._orig)



def near_bytes(bm, byte, pos, *, select=False) -> tuple[int, int]:
    """(bytes, byte compares) that byte ranks of ``byte`` at ``pos`` in one
    level need when each counts the nearer end of its tile: a cut past half
    the tile's logical bytes (valid = min(block, length - blk*block)) counts
    the suffix [cut, valid) against the next counter row, any other cut the
    prefix [0, cut) against its own.  Bytes: per block the union of the
    prefixes and suffixes read (capped at valid) and each distinct counter
    cell, each read once; compares: every byte each rank counts.  With
    ``select``, ``pos`` are the positions that selects found: each reads
    the found byte too, the prefix [0, cut] or the suffix [cut, valid),
    whichever is shorter."""
    import torch
    pos = pos.to(torch.int64).reshape(-1).clamp(0, bm.length)
    byte = torch.as_tensor(byte, device=pos.device).to(torch.int64)
    byte = byte.reshape(-1).expand_as(pos)
    nb = bm.n_blocks
    blk = torch.clamp(pos // bm.block, max=nb - 1)
    cut = pos - blk * bm.block
    starts = torch.arange(nb, device=pos.device, dtype=torch.int64) * bm.block
    valid_b = (bm.length - starts).clamp(max=bm.block)
    valid = valid_b[blk]
    head = cut + int(select)              # bytes of the prefix read
    back = valid - cut < head if select else cut > valid // 2
    front = torch.zeros(nb, dtype=torch.long, device=pos.device)
    front.scatter_reduce_(0, blk[~back], head[~back], "amax")
    back_lo = valid_b.clone()
    back_lo.scatter_reduce_(0, blk[back], cut[back], "amin")
    tiles = torch.minimum(valid_b, front + valid_b - back_lo)
    cells = torch.unique((blk + back.long()) * 256 + byte)
    compares = torch.where(back, valid - cut, head)
    return int(tiles.sum()) + 4 * int(cells.numel()), int(compares.sum())


def descent_bytes(idx, words, los, his, *, distinct_nonempty=False
                  ) -> tuple[int, int]:
    """(bytes, byte compares) the count descent of these triples needs: per
    level it visits, what its endpoints' ranks need from the nearer end of
    their tiles (``near_bytes``), plus each triple's inputs, word tables and
    output.  ``distinct_nonempty`` keeps one copy of each triple with lo < hi
    (the descents a search loop really needs: a plain trip also descends for
    stopped rows and singleton pops, whose triples repeat or are empty)."""
    import torch
    from repro_torch.core import bytemap
    if distinct_nonempty:
        t = torch.stack([words.to(torch.int32), los.to(torch.int32),
                         his.to(torch.int32)], 1)
        t = torch.unique(t[t[:, 1] < t[:, 2]], dim=0)
        words, los, his = t[:, 0], t[:, 1], t[:, 2]
    words = words.long()
    a, b = los.to(torch.int32), his.to(torch.int32)
    M = words.numel()
    wlen = idx.cw_len[words]
    nbytes = 16 * M + 31 * int(torch.unique(words).numel())
    compares = 0
    for L, lv in enumerate(idx.levels):
        need = torch.cat([wlen > L, wlen > L])
        byte = idx.cw[words, L].long()
        off = idx.node_off[words, L]
        base = idx.base_rank[words, L]
        pos = torch.cat([off + a, off + b]).clamp(0, lv.length)
        if bool(need.any()):
            nb, ops = near_bytes(lv, torch.cat([byte, byte])[need], pos[need])
            nbytes += nb
            compares += ops
        r = bytemap.rank(lv, torch.cat([byte, byte]), pos,
                         kernel_backend="ref")
        a, b = r[:M] - base, r[M:] - base
    return nbytes, compares


def block_edge_triples(idx, rng, n_words: int = 12, per_word: int = 512):
    """(words, los, his) on the card whose endpoints land on tile edges,
    where the nearer-end rank switches sides: root positions at block edges
    and one either side (with 0 and n), and, for words of two or more
    levels, root positions chosen by select so that the level-1 position is
    a block edge or one either side of it (up to ``per_word`` of each)."""
    import torch
    from repro_torch.core import bytemap
    dev = idx.device
    n, block = idx.n, idx.levels[0].block
    edges = np.arange(0, n + 1, block)
    pos0 = np.unique(np.clip(np.concatenate([edges - 1, edges, edges + 1,
                                             [0, n]]), 0, n))
    cw_len = idx.cw_len.cpu().numpy()
    words = np.concatenate([
        rng.choice(np.flatnonzero(cw_len == L), min(n_words // 3, int(
            np.count_nonzero(cw_len == L))), replace=False) for L in (1, 2, 3)])
    lv0, lv1 = idx.levels[0], idx.levels[1]
    e1 = np.arange(0, lv1.length + 1, lv1.block)
    out = []
    for w in words:
        a = rng.choice(pos0, per_word)
        b = rng.choice(pos0, per_word)
        out.append((np.full(per_word, w), np.minimum(a, b), np.maximum(a, b)))
        if cw_len[w] < 2:
            continue
        off1 = int(idx.node_off[w, 1])
        byte0, base0 = int(idx.cw[w, 0]), int(idx.base_rank[w, 0])
        occ = int(lv0.counts[-1, byte0]) - base0
        t = np.concatenate([e1 - 1, e1, e1 + 1]) - off1
        t = t[(t >= 1) & (t <= occ)]
        if len(t) == 0:
            continue
        t = rng.choice(t, min(per_word, len(t)), replace=False)
        j = torch.from_numpy((t + base0).astype(np.int32)).to(dev)
        x = bytemap.select(lv0, torch.full_like(j, byte0), j).cpu().numpy() + 1
        out.append((np.full(len(x), w), np.zeros(len(x), np.int64), x))
        out.append((np.full(len(x), w), x - 1, np.full(len(x), n)))
    return tuple(torch.from_numpy(np.concatenate([o[i] for o in out]).astype(
        np.int32)).to(dev) for i in range(3))


def walk_bytes(idx, aux, qt, sel_calls, doc_calls, cnt_calls, rank_calls
               ) -> tuple[int, int]:
    """(bytes, byte compares) the DRB ``and`` walk needs, from the calls its
    plain version made (a stopped row or a dead lane repeats a live one's
    query, so distinct queries count, and only those of valid words — the
    kernel skips masked columns and stopwords): each select's found byte
    and the bytes before or after it in its block, whichever are fewer,
    with the counter cell at that end (``near_bytes(select=True)``), the
    descent's nearer tile ends (``descent_bytes``), each bitmap block of a
    cursor rank (128 bytes and its counter), and each candidate document's
    two separators and length."""
    import torch
    from repro_torch.core import bytemap, wtbc
    nb = ops = 0
    for lv in idx.levels:
        qs = [(b.reshape(-1).long(), j.reshape(-1).long())
              for bm, b, j in sel_calls if bm is lv]
        if not qs:
            continue
        bj = torch.unique(torch.stack([torch.cat([x[0] for x in qs]),
                                       torch.cat([x[1] for x in qs])], 1),
                          dim=0)
        bj = bj[(bj[:, 1] >= 1) & (bj[:, 1] <= lv.counts[-1][bj[:, 0]])]
        pos = bytemap.select(lv, bj[:, 0], bj[:, 1]).long()
        sb, sops = near_bytes(lv, bj[:, 0], pos, select=True)
        nb += sb
        ops += sops
    docs = torch.unique(wtbc.doc_of_pos(idx, torch.unique(torch.cat(
        [c[0].reshape(-1) for c in doc_calls]))))
    nb += 12 * docs.numel()
    B, Q = qt.valid.shape
    ok_cnt, ok_rank, words, los, his, rank_pos = [], [], [], [], [], []
    for (w, lo, hi), (pos,) in zip(cnt_calls, rank_calls):
        P = w.numel() // B // Q - 1       # a trip counts B x (P·Q + Q)
        ok_cnt.append(qt.valid.repeat(1, P + 1).reshape(-1))
        ok_rank.append(qt.valid.reshape(-1).repeat(2))  # off + cnt, off
        words.append(w)
        los.append(lo)
        his.append(hi)
        rank_pos.append(pos.reshape(-1))
    ok = torch.cat(ok_cnt)
    dn, dops = descent_bytes(idx, torch.cat(words)[ok], torch.cat(los)[ok],
                             torch.cat(his)[ok], distinct_nonempty=True)
    rank_pos = torch.cat(rank_pos)[torch.cat(ok_rank)].long()
    blocks = torch.unique(torch.clamp(rank_pos.clamp(0, aux.bv.n_bits) // 1024,
                                      max=aux.bv.counts.numel() - 2))
    return nb + dn + (128 + 4) * blocks.numel(), ops + dops


def locate_bytes(idx, w, j) -> tuple[int, int, torch.Tensor]:
    """(bytes, byte compares, root positions) of the locates of the
    ``j``-th (1-based) occurrences of words ``w``, as the device locate runs
    them: from each word's leaf level up, one select per level the word
    reaches, each reading its found byte and the bytes before or after it in
    its block, whichever are fewer, with the counter cell at that end
    (``near_bytes(select=True)``), distinct selects once."""
    import torch
    from repro_torch.core import bytemap
    w = w.long()
    wlen = idx.cw_len[w]
    pos = torch.zeros_like(j)
    nb = ops = 0
    for L in range(len(idx.levels) - 1, -1, -1):
        m = wlen > L
        if not bool(m.any()):
            continue
        lv = idx.levels[L]
        base = idx.base_rank[w, L]
        occ_idx = torch.where(wlen == L + 1, base + j, base + pos + 1)[m]
        byte = idx.cw[w, L][m].long()
        bj = torch.unique(torch.stack([byte, occ_idx.long()], 1), dim=0)
        sb, sops = near_bytes(lv, bj[:, 0], bytemap.select(
            lv, bj[:, 0], bj[:, 1]), select=True)
        nb += sb
        ops += sops
        p = bytemap.select(lv, byte, occ_idx) - idx.node_off[w, L][m]
        pos[m] = p.to(pos.dtype)
    return nb, ops, pos


def or_bytes(idx, aux, words, wmask, cap: int, k: int, bm25: bool
             ) -> tuple[int, int, int]:
    """(bytes, byte compares, live lanes) the DRB ``or`` query needs for a
    (B, Q) batch: per (row, word) its tables (the word, its mask, bitmap
    flag, df, bitmap offsets, idf and codeword path); per live (row, word,
    document) the bitmap blocks its two selects find (128 bytes and a
    counter each, distinct blocks once), its locate (``locate_bytes``) and
    its document's two separators (distinct documents once), and its tf
    cell; the tf table zeroed and scanned (B * N * Q * 4 bytes each way),
    the documents' lengths under BM25, and the result."""
    import torch
    from repro_torch.core import bitvec, wtbc
    B, Q = words.shape
    N = idx.n_docs
    wl = words.long()
    valid = wmask & aux.has_bm[wl]
    df = torch.where(valid, idx.df[wl], 0).reshape(-1)
    live = df.clamp(max=cap)
    lanes = int(live.sum())
    entry = torch.repeat_interleave(torch.arange(B * Q, device=wl.device),
                                    live)
    j = torch.arange(lanes, device=wl.device) - torch.repeat_interleave(
        torch.cumsum(live, 0) - live, live)
    w = wl.reshape(-1)[entry]
    off = aux.bit_off[w]
    base = bitvec.rank1(aux.bv, off, kernel_backend="ref")
    g = (base + 1 + j).to(torch.int32)
    sel = bitvec.select1(aux.bv, g)
    has_next = j + 1 < df[entry]
    nxt = bitvec.select1(aux.bv, g[has_next] + 1)
    blocks = torch.unique(torch.cat([sel, nxt]).long() // 1024)
    nb = (128 + 4) * blocks.numel()
    ln, lops, pos = locate_bytes(idx, w, (sel - off + 1).to(torch.int32))
    docs = torch.unique(wtbc.doc_of_pos(idx, pos))
    nb += ln + 8 * docs.numel() + 4 * lanes
    nb += B * Q * (4 + 1 + 1 + 4 + 8 + 4 + 31)
    nb += 2 * B * N * Q * 4 + (4 * N if bm25 else 0)
    nb += B * k * 9 + B * 17
    return nb, lops, lanes


def decode_bytes(idx, pos) -> tuple[int, int]:
    """(bytes, byte compares) a decode of root positions ``pos`` needs:
    per position and level until its word ends, the node offset and the
    byte read (distinct ones once), and for a continuer byte its ranks at
    the node's start and at the position, each from the nearer end of its
    tile (``near_bytes``); the positions in and the ranks out."""
    import torch
    from repro_torch.core import bytemap
    s, c = idx.s, idx.c
    p = pos.reshape(-1).to(torch.int32)
    prefix = torch.zeros_like(p)
    done = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    nb, ops = 8 * p.numel(), 0
    for L, lv in enumerate(idx.levels):
        if bool(done.all()):
            break
        live = ~done
        off = idx.offsets[L][prefix.long()]
        at = (off + p).clamp(0, max(lv.length - 1, 0))
        nb += 4 * torch.unique(prefix[live]).numel() \
            + torch.unique(at[live]).numel()
        b = bytemap.access(lv, off + p).to(torch.int32)
        stop = b < s
        cont = live & ~stop
        if bool(cont.any()):
            rb, rops = near_bytes(lv, torch.cat([b[cont], b[cont]]),
                                  torch.cat([off[cont] + p[cont],
                                             off[cont]]))
            nb += rb
            ops += rops
        r = bytemap.rank(lv, torch.cat([b, b]), torch.cat([off + p, off]),
                         kernel_backend="ref")
        n = p.numel()
        p = torch.where(stop, p, r[:n] - r[n:])
        prefix = torch.where(stop, prefix, prefix * c + (b - s))
        done = done | stop
    return nb, ops


def decode_edge_positions(idx, rng, per_level: int = 2048):
    """Root positions (on the card) whose decode reads a tile edge, or one
    byte either side of it, at each level: a level-L position is mapped up
    to the root through its node (the node key's last continuer byte and
    the entry's index in its node: the parent's (index + 1)-th occurrence
    of that byte after the parent node's start), with 0 and n - 1."""
    import torch
    from repro_torch.core import bytemap
    dev = idx.device
    s, c = idx.s, idx.c
    out = [torch.tensor([0, idx.n - 1], dtype=torch.int32, device=dev)]
    for L, lv in enumerate(idx.levels):
        if lv.length == 0:
            continue
        e = np.arange(0, lv.length + 1, lv.block)
        q = np.unique(np.clip(np.concatenate([e - 1, e, e + 1]), 0,
                              lv.length - 1))
        q = torch.from_numpy(rng.choice(q, min(per_level, len(q)),
                                        replace=False)).to(dev).long()
        for up in range(L, 0, -1):          # level `up` -> level up - 1
            offs = idx.offsets[up]
            key = torch.searchsorted(offs, q, right=True) - 1
            parent = key // c
            byte = (s + key % c).to(torch.int32)
            plv = idx.levels[up - 1]
            start = idx.offsets[up - 1][parent]
            before = bytemap.rank(plv, byte, start, kernel_backend="ref")
            q = bytemap.select(plv, byte, before + (q - offs[key]).to(
                torch.int32) + 1).long()
        out.append(q.to(torch.int32))
    return torch.unique(torch.cat(out)).clamp(0, idx.n - 1)


def doc_batch(cp, engine, rng, band, n_rows: int, n_words: int = 3
              ) -> np.ndarray:
    """(n_rows, n_words) word ids whose ``and`` has hits: each row takes the
    words of one document of the corpus — one of df in ``band`` (the
    rarest, whose occurrences the DRB walk follows) and others more
    frequent, all with a tf bitmap — in a random column order."""
    rank = engine.model.rank_of_word
    df = engine.idx.df.cpu().numpy()
    has_bm = engine.aux.has_bm.cpu().numpy()
    lo, hi = band
    out = []
    while len(out) < n_rows:
        toks = np.unique(cp.doc_tokens[rng.integers(0, cp.n_docs)])
        r = rank[toks]
        anchor = toks[has_bm[r] & (df[r] >= lo) & (df[r] <= hi)]
        rest = toks[has_bm[r] & (df[r] > hi)]
        if len(anchor) and len(rest) >= n_words - 1:
            out.append(rng.permutation(np.concatenate([
                rng.choice(anchor, 1),
                rng.choice(rest, n_words - 1, replace=False)])))
    return np.stack(out)


def bm25_bruteforce(tokens, ends, n_docs: int, words, *, mode: str, k: int,
                    eps: float = 1e-6, k1: float = 1.2, b: float = 0.75):
    """Top-k BM25 of one query by scoring every document on the host, in
    numpy float32 from the corpus's own tokens, independent of the program:
    ``tokens`` the concatenated documents, ``ends`` their cumulative
    lengths.  Per word: tf per document (its token positions binned by
    document), df, BM25's idf (the argument in float32 steps, the log in
    float64, rounded to float32) and the DRB word rule (a word with
    ln(N / df) < eps has no bitmap and drops out); avg_dl the exact integer
    sum of the lengths over N in float32.  Each per-word part is
    ``tf (k1 + 1) / (tf + k1 ((1 - b) + b (dl / avg_dl)))``, one rounded
    float32 operation at a time, the score the parts times the idfs added
    left to right.  Eligible: ``and`` every kept word occurs, ``or`` some
    kept word occurs; ties go to the lower document.  Returns (docs,
    scores) padded with -1 / -inf to k."""
    f32 = np.float32
    n = f32(n_docs)
    dl = np.diff(np.concatenate([[0], ends])).astype(np.int64)
    avg = f32(f32(dl.sum()) / n)
    norm = f32(1.0 - b) + f32(b) * (dl.astype(f32) / avg)
    score = np.zeros(n_docs, f32)
    occurs = []
    for w in words:
        tf = np.bincount(np.searchsorted(ends, np.flatnonzero(tokens == w),
                                         side="right"), minlength=n_docs)
        df = int(np.count_nonzero(tf))
        if df == 0:
            if mode == "and":            # an absent word empties the result
                return np.full(k, -1), np.full(k, -np.inf, f32)
            continue
        if not np.log(max(n_docs, 1) / df) >= eps:
            continue                     # no bitmap: the word drops out
        dff = f32(df)
        idf = f32(np.log(np.float64(f32(1.0) + (n - dff + f32(0.5))
                                    / (dff + f32(0.5)))))
        tff = tf.astype(f32)
        part = tff * f32(k1 + 1.0) / (tff + f32(k1) * norm)
        score = score + part * idf
        occurs.append(tf > 0)
    if not occurs:
        return np.full(k, -1), np.full(k, -np.inf, f32)
    ok = np.all(occurs, 0) if mode == "and" else np.any(occurs, 0)
    docs = np.flatnonzero(ok)
    top = docs[np.lexsort((docs, -score[docs]))][:k]
    pad = k - len(top)
    return (np.concatenate([top, np.full(pad, -1)]),
            np.concatenate([score[top], np.full(pad, -np.inf, f32)]))


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def leaves_equal(a, b, names) -> list[str]:
    import torch
    bad = []
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        if not torch.equal(x, y):
            bad.append(n)
    return bad


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=QUARTER_DOCS,
                    help="documents to index (default: a quarter of ALL)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import mega, ranked
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import backend, beam_step, wavelet_descent
    from repro_torch.text import corpus as tcorpus

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. build --------------------------------------------------------
    t_build = backend.build()
    log(f"build: nvcc {t_build:.1f} s for {len(backend.KERNELS)} kernels")
    for k in backend.KERNELS:
        lines = k.library_path().with_suffix(".log").read_text().splitlines() \
            if k.library_path().with_suffix(".log").exists() else []
        for ln in lines:
            if "registers" in ln or "spill" in ln:
                log(f"  {k.name}: {ln.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)

    # ---- 2. data ----------------------------------------------------------
    t0 = time.perf_counter()
    cp = quarter_all_corpus(args.docs, SEED)
    t_draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = SearchEngine.build(cp, EngineConfig(block=BLOCK), device="cuda")
    torch.cuda.synchronize()
    t_index = time.perf_counter() - t0
    idx = engine.idx
    log("reduced: " + json.dumps({
        "docs": f"{args.docs} of {ALL_DOCS}",
        "tokens": cp.n_tokens, "vocab": ALL_VOCAB,
        "why": "host-side numpy index build and the run's time limit",
        "draw_s": round(t_draw, 2), "index_build_s": round(t_index, 2)}))
    for L, lv in enumerate(idx.levels):
        log(f"level {L}: {lv.data.numel()} data bytes + "
            f"{lv.counts.numel() * 4} counter bytes on {kind}")
    log(f"index on device: {engine.space_report()['total']} bytes")

    df_word = idx.df.cpu().numpy()[engine.model.rank_of_word]
    bands = tcorpus.fdoc_bands(args.docs)
    batches = []
    for i, (mode, band) in enumerate([("and", "ii"), ("or", "ii"),
                                      ("and", "iii"), ("or", "iii")]):
        q = tcorpus.sample_queries(df_word, bands[band], B, 3, seed=SEED + i)
        batches.append((mode, band, q))
    budget_batch = ("or", "iii", batches[3][2], 64)
    log(f"bands ii {bands['ii']} iii {bands['iii']}; batches of B={B}, "
        f"Q=3 (bucket 4), k={K}")

    # ---- 3. K1 against its plain version ----------------------------------
    rng = np.random.default_rng(SEED)
    n = idx.n
    M = 4096
    w = torch.from_numpy(rng.integers(1, idx.vocab_size, M).astype(np.int32)).to(dev)
    lo = rng.integers(0, n + 1, M)
    hi = np.minimum(n, lo + rng.integers(0, 1 << 20, M))
    lo[:64] = hi[:64]                     # empty ranges
    hi[64:128] = n                        # ranges to the end
    lo, hi = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (lo, hi))
    ranks, masks = engine._encode_queries(batches[3][2])
    words_t = torch.from_numpy(ranks).to(dev)
    wmask_t = torch.from_numpy(masks).to(dev)
    idf = engine._idf_table(engine._resolve_measure("tfidf"))
    with OpsRecorder() as rec16:
        ranked.topk_dr_batch(idx, words_t, wmask_t, idf, k=K, conjunctive=False,
                             heap_cap=2 * idx.n_docs + 4, beam_width=16,
                             max_pops=9 * 16)
    with OpsRecorder() as rec1:
        mega.topk_dr_mega(idx, words_t, wmask_t, idf, k=K, conjunctive=False,
                          cap=idx.n_docs + 2, max_pops=8, kernel_backend="ref")
    k1_sets = [("random", (w, lo, hi)),
               ("block-edge", block_edge_triples(idx, rng))] + \
        [("ranked P=16 trip", c) for c in rec16.calls[:9]] + \
        [("mega trip", c) for c in rec1.calls[:9]]

    def k1(trip, kb):
        return wavelet_descent.wavelet_count(
            idx.levels, idx.cw, idx.cw_len, idx.node_off, idx.base_rank,
            *trip, kernel_backend=kb)

    k1_err = 0
    for name, trip in k1_sets:
        got, want = k1(trip, "auto"), k1(trip, "ref")
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        k1_err = max(k1_err, err)
        check(torch.equal(got, want), f"wavelet_count differs from its plain "
              f"version on {name} triples (max |err| {err})")
    log(f"K1 wavelet_count == plain on {len(k1_sets)} triple sets "
        f"({sum(t[1][0].numel() for t in k1_sets)} triples): bitwise")

    # ---- 4. K2 against its plain version ----------------------------------
    k2_cases = [(m, b, q, None) for m, b, q in batches] + [budget_batch]
    names = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
             "certified", "bound")
    for mode, band, q, budget in k2_cases:
        r, m_ = engine._encode_queries(q)
        wt, mt = torch.from_numpy(r).to(dev), torch.from_numpy(m_).to(dev)
        kw = dict(k=K, conjunctive=mode == "and", cap=idx.n_docs + 2,
                  max_pops=budget)
        got = mega.topk_dr_mega(idx, wt, mt, idf, kernel_backend="auto", **kw)
        want = mega.topk_dr_mega(idx, wt, mt, idf, kernel_backend="ref", **kw)
        torch.cuda.synchronize()
        bad = leaves_equal(got, want, names)
        check(not bad, f"beam_loop differs from its plain loop ({mode}, band "
              f"{band}, budget {budget}): {bad}")
        log(f"K2 beam_loop == plain loop: {mode} band {band} budget {budget}: "
            f"pops/row {got.pops.tolist()}, found {got.n_found.tolist()}")

    # ---- 5. the main path ---------------------------------------------------
    backend.reset_launch_counts()
    profiles = [dict(), dict(beam_width=16), dict(mega=True)]
    warm_rows = [list(map(int, batches[0][2][0]))]
    for mode in ("and", "or"):
        for prof in profiles:
            engine.warmup(warm_rows, max_batch=B, k=K, mode=mode, **prof)
            engine.warmup(warm_rows, max_batch=B, k=K, mode=mode, budget=64,
                          **prof)
    traces = dict(engine.stats["traces"])
    core_ms = {"P=1": [], "P=16": [], "mega": []}
    per_batch = {c: [] for c in core_ms}
    results = []
    for mode, band, q, budget in k2_cases:
        outs = {}
        for label, prof in zip(core_ms, profiles):
            before = backend.launch_counts()
            ms, res = wall_ms(lambda: engine.search(q, k=K, mode=mode,
                                                    budget=budget, **prof))
            after = backend.launch_counts()
            per_batch[label].append({k_: after[k_] - before[k_]
                                     for k_ in after})
            core_ms[label].append(ms)
            outs[label] = res
        # a budget is enforced per trip, so P=16 may pop past it: only the
        # one-pop cores share a budgeted answer
        for label in ("P=16", "mega") if budget is None else ("mega",):
            for leaf in ("docs", "scores", "n_found"):
                check(torch.equal(getattr(outs["P=1"], leaf),
                                  getattr(outs[label], leaf)),
                      f"{label} core differs from P=1 on {leaf} ({mode}, "
                      f"band {band}, budget {budget})")
        results.append((mode, band, q, budget, outs["P=1"]))
        log(f"main path {mode} band {band} budget {budget}: ms/batch " +
            ", ".join(f"{c} {core_ms[c][-1]:.2f}" for c in core_ms) +
            f"; n_found {outs['P=1'].n_found.tolist()}")
    counts = backend.launch_counts()
    log("main path launches: " + json.dumps(counts))
    check(counts["wavelet_count"] > 0, "wavelet_count never launched")
    check(counts["beam_loop"] > 0, "beam_loop never launched")
    check(engine.stats["traces"] == traces, "executors were built after warmup")

    for mode, band, q, budget, res in results:
        if budget is not None:
            continue
        check(bool(torch.isfinite(res.scores[res.scores > -np.inf]).all()),
              "non-finite scores")
        check(tuple(res.docs.shape) == (B, K), "result shape")
    for mode, band, q, budget, res in (results[2], results[3]):
        r, m_ = engine._encode_queries(q[:1])
        bf = ranked.topk_bruteforce(idx, torch.from_numpy(r[0]).to(dev),
                                    torch.from_numpy(m_[0]).to(dev), idf, k=K,
                                    conjunctive=mode == "and")
        check(torch.equal(bf.docs, res.docs[0]) and
              torch.equal(bf.scores, res.scores[0]),
              f"{mode} band {band} row 0 differs from brute force: "
              f"{bf.docs.tolist()} vs {res.docs[0].tolist()}")
        log(f"brute force over {idx.n_docs} docs == search ({mode}, band "
            f"{band}): {res.docs[0].tolist()}")

    # ---- 6. timings -----------------------------------------------------------
    kernels = []
    # K1 at the default core's trip shape (M = B x Q) and the P=16 one
    trip1 = rec1.calls[1]
    trip16 = rec16.calls[1]
    k1_rows = {}
    for label, trip in (("M=%d (P=1 / mega trip)" % trip1[0].numel(), trip1),
                        ("M=%d (P=16 trip)" % trip16[0].numel(), trip16),
                        ("M=4096 (random)", (w, lo, hi))):
        call_ms = time_cuda(lambda: k1(trip, "auto"), reps=200, warm=20)
        kms, _ = profile_device(lambda: k1(trip, "auto"), 100,
                                "wavelet_count_kernel")
        check(kms > 0, "the profiler recorded no device time for "
              "wavelet_count_kernel")
        pms = time_cuda(lambda: k1(trip, "ref"), reps=20, warm=3)
        nb, ops = descent_bytes(idx, *trip)
        bms, by = bound_ms(nb, ops)
        k1_rows[label] = {"shape": label, "ms": kms, "wrapper_ms": call_ms,
                          "plain_ms": pms, "bound_ms": bms, "bound_by": by}
        log(f"K1 {label}: kernel {kms:.6f} ms on the device "
            f"({call_ms:.4f} ms per wrapper call), plain {pms:.4f} ms, "
            f"bound {bms:.6f} ms ({by}: {nb} bytes, {ops} compares)")
    # the main path's shape first; every shape's row rides along
    main_row = next(iter(k1_rows.values()))
    kernels.append({"name": "wavelet_count", "route": "cuda",
                    "source": "src/repro_torch/csrc/wavelet_descent.cu",
                    "replaces": "src/repro/kernels/wavelet_descent.py:94",
                    "launches": counts["wavelet_count"],
                    "max_abs_err": k1_err, "ms": main_row["ms"],
                    "plain_ms": main_row["plain_ms"],
                    "bound_ms": main_row["bound_ms"],
                    "bound_by": main_row["bound_by"], "library_ms": None,
                    "wrapper_ms": main_row["wrapper_ms"],
                    "shapes": list(k1_rows.values())})

    # K2: one whole-batch search loop (or, band iii), state reset each time
    r, m_ = engine._encode_queries(batches[3][2])
    wt, mt = torch.from_numpy(r).to(dev), torch.from_numpy(m_).to(dev)
    idf_w = torch.where(mt, idf[wt.long()], 0.0).to(torch.float32)
    st0 = mega.init_state(idx, wt, mt, idf_w, k=K, conjunctive=False,
                          cap=idx.n_docs + 2, kernel_backend="auto")
    holder = {}

    def fresh():
        holder["st"] = st0.clone()

    def run(kb):
        holder["st"] = beam_step.beam_loop(idx, holder["st"], wt, mt, idf_w,
                                           k=K, conjunctive=False,
                                           max_pops=None, kernel_backend=kb)
    k2_call = time_cuda(lambda: run("auto"), reps=5, warm=1, setup=fresh)
    fresh()
    k2_ms, _ = profile_device(lambda: (fresh(), run("auto")), 3,
                              "beam_loop_kernel")
    check(k2_ms > 0, "the profiler recorded no device time for "
          "beam_loop_kernel")
    k2_plain = time_cuda(lambda: run("ref"), reps=1, warm=0, setup=fresh)
    final = holder["st"]
    with OpsRecorder() as rec:
        fresh()
        run("ref")
    tw = torch.cat([c[0] for c in rec.calls])
    tl = torch.cat([c[1] for c in rec.calls])
    th = torch.cat([c[2] for c in rec.calls])
    nb, ops = descent_bytes(idx, tw, tl, th, distinct_nonempty=True)
    Q = wt.shape[1]
    cap = idx.n_docs + 2
    live_end = int(final.pool.size.sum())
    pops = int(final.pops.sum())
    inserts = live_end + pops - int(st0.pool.size.sum())
    nb += B * cap * 4 + (pops + inserts) * (12 + 4 * Q) + B * (K + 1) * 8
    bms, by = bound_ms(nb, ops)
    log(f"K2 beam_loop (or, band iii, B={B}): kernel {k2_ms:.4f} ms on the "
        f"device ({k2_call:.4f} ms per wrapper call), plain loop "
        f"{k2_plain:.3f} ms, bound {bms:.6f} ms ({by}: {nb} bytes), "
        f"{pops} pops in {len(rec.calls)} trips")
    kernels.append({"name": "beam_loop", "route": "cuda",
                    "source": "src/repro_torch/csrc/beam_step.cu",
                    "replaces": "src/repro/kernels/beam_step.py:67",
                    "launches": counts["beam_loop"], "max_abs_err": 0,
                    "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": None,
                    "wrapper_ms": k2_call})

    for c, v in core_ms.items():
        log(f"core {c}: ms per batch " + ", ".join(f"{x:.2f}" for x in v))
    # how busy the card is on each core's main path (or, band ii batch)
    q = batches[1][2]
    for label, prof in zip(core_ms, profiles):
        busy, wall = profile_device(
            lambda: engine.search(q, k=K, mode="or", **prof), 1)
        log(f"core {label} (or, band ii): device busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall, idle share {1 - busy / wall:.4f}")
    log("launches per batch: " + json.dumps(per_batch))

    phase_s = {"1-6": time.perf_counter() - t_start}

    def timed_phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        phase_s[name] = time.perf_counter() - t
        log(f"phases {name}: {phase_s[name]:.1f} s")
        return out
    drb_rows, k1_drb_err = timed_phase("7-10", drb_phases, engine, cp,
                                       batches, kind)
    kernels[0]["max_abs_err"] = max(k1_err, k1_drb_err)
    kernels += drb_rows
    kernels.append(timed_phase("11", positional_phases, engine, cp, batches))
    f1, f2 = timed_phase("12", cap_phases, engine, batches)
    row = {k_["name"]: k_ for k_ in kernels}
    row["drb_or"]["k_40000"] = f1
    row["beam_loop"]["cap_1200000"] = f2
    serving = timed_phase("13", serving_phase, engine)
    sharded = timed_phase("14", sharded_phase, engine, cp, batches, results,
                          core_ms)
    log("seconds per phase: " + json.dumps(
        {k_: round(v, 1) for k_, v in phase_s.items()}))
    for k_ in kernels:
        k_["served_launches_per_batch"] = {
            name: p["launches_per_batch"][k_["name"]]
            for name, p in serving["profiles"].items()
            if k_["name"] in p["launches_per_batch"]}
        k_["sharded_launches_per_batch"] = {
            label: [b.get(k_["name"], 0) for b in per]
            for label, per in sharded["launches_per_batch"].items()
            if any(k_["name"] in b for b in per)}
        k_["sharded_launches"] = sharded["launches"][k_["name"]]
    log(json.dumps({"serving": serving}))
    log(json.dumps({"sharded": sharded}))
    log(json.dumps({"launches": counts,
                    "kernels": [k["name"] for k in kernels]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def drb_phases(engine, cp, batches, kind) -> tuple[list[dict], int]:
    """Phases 7-10: the DRB aux, drb_walk and K3/K5/K4/K6 (and K1 at the
    plain DRB and trips) against their plain versions, the DRB path as a
    user calls it, and the timings.  Returns the rows of the ``{"kernels":
    ...}`` line from K3 on and K1's largest error at the DRB trips."""
    import torch
    from repro_torch.core import bytemap, drb, wtbc
    from repro_torch.kernels import (backend, bitmap_rank, byte_rank,
                                     segment_tf, topk_score)
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import drb_walk as walk
    from repro_torch.text import corpus as tcorpus
    dev = engine.device
    idx = engine.idx
    measures = {m: engine._resolve_measure(m) for m in ("tfidf", "bm25")}

    # ---- 7. DRB aux ---------------------------------------------------------
    t0 = time.perf_counter()
    aux = engine.aux
    torch.cuda.synchronize()
    t_aux = time.perf_counter() - t0
    rep = engine.space_report()
    drb_bytes = sum(v for k_, v in rep.items() if k_.startswith("drb_"))
    idx_bytes = rep["total"] - drb_bytes
    log(f"DRB aux: built on the host in {t_aux:.2f} s; {drb_bytes} bytes "
        f"({aux.bv.n_bits} bits) beside the index's {idx_bytes} bytes on "
        f"{kind}: +{100.0 * drb_bytes / idx_bytes:.2f}%")
    # a fifth ``and`` batch whose rows have hits (the four batches' ``and``
    # rows of three random band ii/iii words share no document)
    doc_q = doc_batch(cp, engine, np.random.default_rng(SEED + 5),
                      tcorpus.fdoc_bands(cp.n_docs)["ii"], B)
    batches = batches + [("and", "doc", doc_q)]

    def and_walk(q, mname, kb, **kw):
        """DRB ``and`` through its core, as the engine's executor calls it;
        ``kb="ref"`` runs the plain walk (the engine routes to the kernel)."""
        r, m_ = engine._encode_queries(q)
        meas = measures[mname]
        return drb.topk_drb_and(
            idx, aux, torch.from_numpy(r).to(dev), torch.from_numpy(m_).to(dev),
            meas, k=K, idf=engine._idf_table(meas),
            avg_dl=engine._avg_doc_len(), kernel_backend=kb, **kw)

    def or_run(wt, mt, mname, kb, *, k=K, cap=None, eng=engine):
        """DRB ``or`` of (B, Q) ranks and mask on the card through its
        core, as the engine's executor calls it (``cap`` the engine's own
        gather width by default); ``kb="ref"`` runs the plain version."""
        meas = measures[mname]
        if cap is None:
            cap = eng._df_cap(wt.cpu().numpy(), mt.cpu().numpy())
        return drb.topk_drb_or(
            eng.idx, eng.aux, wt, mt, meas, k=k, max_df_cap=cap,
            idf=eng._idf_table(meas), avg_dl=eng._avg_doc_len(),
            kernel_backend=kb)

    def encode(q, eng=engine):
        r, m_ = eng._encode_queries(q)
        return torch.from_numpy(r).to(dev), torch.from_numpy(m_).to(dev)

    def snippet_pos(res, length=8):
        """The root positions ``snippets`` decodes for a result."""
        d = torch.tensor([d for b in range(len(res)) for d, _ in
                          res.hits(b)], dtype=torch.int32, device=dev)
        return (wtbc.doc_start(idx, d)[:, None] + torch.arange(
            length, dtype=torch.int32, device=dev)).clamp(max=idx.n - 1)

    # the inputs every kernel gets from the plain DRB searches (the plain
    # ``and`` walk, whose trips make the K1 and K3 calls drb_walk makes
    # inside itself; the plain ``or`` query under tf-idf and BM25, whose
    # base ranks and top-k drb_or makes inside itself) and from a plain
    # snippet decode (one K5 call per level, which wtbc_decode makes
    # inside itself).  Phase 9 resets the counters before the measured run.
    or_res = engine.search(batches[1][2], k=K, mode="or", strategy="drb",
                           measure="bm25")
    with OpsRecorder("bitmap_rank1_batch", lambda bv, pos, **kw: (pos,)) \
            as rec_k3, \
            OpsRecorder("rank_batch", lambda bm, b, p, **kw: (bm, b, p)) \
            as rec_k5, OpsRecorder() as rec_k1, \
            OpsRecorder("scored_topk", lambda c, q, **kw: (
                c, q, kw["valid"], kw["k"], kw["tile"])) as rec_k6:
        and_walk(batches[0][2], "tfidf", "ref")
        for mname in measures:
            or_run(*encode(batches[1][2]), mname, "ref")
        wtbc.decode_at(idx, snippet_pos(or_res), kernel_backend="ref")
    k5_snip = [c for c in rec_k5.calls if c[1].numel()]
    log(f"recorded from the plain DRB searches (and walk, or query) and a "
        f"plain snippet decode: {len(rec_k1.calls)} wavelet_count, "
        f"{len(rec_k3.calls)} bitmap_rank1, {len(rec_k5.calls)} byte_rank, "
        f"{len(rec_k6.calls)} scored_topk calls")

    # ---- 8. K3, K5, K4, K6 against their plain versions --------------------
    rng = np.random.default_rng(SEED + 8)
    n_bits = aux.bv.n_bits
    e = np.arange(0, n_bits + 1, 1024 * 997)
    pos3 = np.concatenate([[0, n_bits, 1, max(n_bits - 1, 0)], e,
                           np.maximum(e - 1, 0), np.minimum(e + 1, n_bits),
                           rng.integers(0, n_bits + 1, 4096)])
    k3_sets = [("random", torch.from_numpy(pos3.astype(np.int32)).to(dev))] \
        + [("DRB trip", c[0]) for c in rec_k3.calls]

    def k3(pos, kb):
        return bitmap_rank.bitmap_rank1(aux.bv.words, aux.bv.counts, n_bits,
                                        pos, kernel_backend=kb)
    errs = {}
    for name, pos in k3_sets:
        got, want = k3(pos, "auto"), k3(pos, "ref")
        torch.cuda.synchronize()
        errs["bitmap_rank1"] = max(errs.get("bitmap_rank1", 0), int(
            (got - want).abs().max()) if got.numel() else 0)
        check(torch.equal(got, want), f"bitmap_rank1 differs from its plain "
              f"version on {name} positions")
    log(f"K3 bitmap_rank1 == plain on {len(k3_sets)} position sets "
        f"({sum(p.numel() for _, p in k3_sets)} positions): bitwise")

    # drb_walk (the whole DRB and walk) against the plain walk, every leaf:
    # the four batches' words under both measures, P = 16, a budget
    names = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
             "padded", "certified", "bound")
    walk_cases = [(mname, i, {}) for mname in measures for i in range(4)] \
        + [("bm25", 0, dict(beam_width=16)), ("tfidf", 2, dict(max_pops=5))]
    walk_trips = 0
    for mname, i, kw in walk_cases:
        mode, band, q = batches[i]
        got = and_walk(q, mname, "auto", **kw)
        want = and_walk(q, mname, "ref", **kw)
        torch.cuda.synchronize()
        bad = leaves_equal(got, want, names)
        check(not bad, f"drb_walk differs from the plain walk ({mname}, "
              f"words of the {mode} band {band} batch, {kw}): {bad}")
        walk_trips += int(got.iters.sum())
    log(f"drb_walk == plain walk on {len(walk_cases)} batches (four "
        f"batches x tf-idf/BM25, P = 16, budget 5; {walk_trips} row trips): "
        f"every leaf bitwise")
    # rows of one document's words, so every row has hits and the walk
    # scores and merges present candidates
    walk_trips = merged = 0
    for mname in measures:
        for P in (1, 16):
            got = and_walk(doc_q, mname, "auto", beam_width=P)
            want = and_walk(doc_q, mname, "ref", beam_width=P)
            torch.cuda.synchronize()
            check(bool((want.n_found > 0).all()), f"a row of one document's "
                  f"words found no document ({mname}, P = {P}): "
                  f"{want.n_found.tolist()}")
            bad = leaves_equal(got, want, names)
            check(not bad, f"drb_walk differs from the plain walk ({mname}, "
                  f"rows of one document's words, P = {P}): {bad}")
            walk_trips += int(got.iters.sum())
            merged += int(got.n_found.sum())
    log(f"drb_walk == plain walk on rows of one document's words (tf-idf/"
        f"BM25 x P = 1/16; {walk_trips} row trips, {merged} hits kept, "
        f"n_found {got.n_found.tolist()}): every leaf bitwise")

    # drb_or (the whole DRB or query) against its plain version, every leaf
    or_names = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
                "certified", "bound")
    or_cases = [(mname, f"words of the {m} band {b} batch", *encode(q), K,
                 None, engine) for mname in measures for m, b, q in batches]
    # edge rows on the or ii batch (Q = 3, bucket 4: column 3 is padding):
    # row 0 repeats its first word in the padded column, row 1 takes a
    # stopword, row 2 has no valid word
    wt, mt = encode(batches[1][2])
    wt, mt = wt.clone(), mt.clone()
    has_bm = aux.has_bm
    stop = torch.nonzero(~has_bm & (idx.df > 0)).reshape(-1)
    stop = int(stop[stop != 0][0])
    wt[0, 3], mt[0, 3] = wt[0, 0], True
    wt[1, 0] = stop
    mt[2] = False
    edge_cap = engine._df_cap(wt.cpu().numpy(),
                              (mt & has_bm[wt.long()]).cpu().numpy())
    wt3, mt3 = encode(batches[3][2])
    # k past the collection: an engine over the first 2,000 documents
    small_cp = type(cp)(doc_tokens=cp.doc_tokens[:2000],
                        vocab_size=cp.vocab_size, seed=cp.seed)
    small = SearchEngine.build(small_cp, EngineConfig(
        block=idx.levels[0].block), device=dev)
    srng = np.random.default_rng(SEED + 7)
    small_q = [[int(x) for x in srng.choice(np.unique(
        small_cp.doc_tokens[d]), 3, replace=False)]
        for d in srng.integers(0, small_cp.n_docs, B)]
    or_cases += [(mname, "edge rows (repeated word, stopword, padded "
                  "column, no valid word)", wt, mt, K, edge_cap, engine)
                 for mname in measures] \
        + [(mname, "k = 1 on the or iii batch", wt3, mt3, 1, None, engine)
           for mname in measures] \
        + [(mname, f"k = n_docs + 5 on a {small.n_docs}-document engine",
            *encode(small_q, small), small.n_docs + 5, None, small)
           for mname in measures]
    or_found = 0
    for mname, what, wt_, mt_, k_, cap_, eng_ in or_cases:
        got = or_run(wt_, mt_, mname, "auto", k=k_, cap=cap_, eng=eng_)
        want = or_run(wt_, mt_, mname, "ref", k=k_, cap=cap_, eng=eng_)
        torch.cuda.synchronize()
        bad = leaves_equal(got, want, or_names)
        check(not bad, f"drb_or differs from its plain version ({mname}, "
              f"{what}): {bad}")
        or_found += int(got.n_found.sum())
    check(int(got.n_found.min()) > 0 and bool(
        (got.docs[:, small.n_docs:] == -1).all()), "the k past the "
        f"collection: n_found {got.n_found.tolist()}, padding not -1")
    log(f"drb_or == plain on {len(or_cases)} batches (five batches' words "
        f"x tf-idf/BM25; edge rows, k = 1, k = n_docs + 5 x tf-idf/BM25; "
        f"{or_found} hits): every leaf bitwise")

    # wtbc_decode (a whole decode in one launch) against its plain version
    drng = np.random.default_rng(SEED + 9)
    dec_sets = [("random", torch.from_numpy(drng.integers(
        0, idx.n, 4096).astype(np.int32)).to(dev)),
        ("tile edges of each level, 0 and n - 1",
         decode_edge_positions(idx, drng))]
    for i in (1, 3):
        res = engine.search(batches[i][2], k=K, mode="or", strategy="drb",
                            measure="bm25")
        dec_sets.append((f"snippets of the or {batches[i][1]} BM25 batch",
                         snippet_pos(res)))
    for name, pos in dec_sets:
        got = wtbc.decode_at(idx, pos)
        want = wtbc.decode_at(idx, pos, kernel_backend="ref")
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"wtbc_decode differs from its plain "
              f"version on {name} positions")
    log(f"wtbc_decode == plain on {len(dec_sets)} position sets "
        f"({sum(p.numel() for _, p in dec_sets)} positions): bitwise")

    # K1 at the triples of real DRB and trips: B·(P·Q + Q) per trip
    k1_err = 0
    for words, los, his in rec_k1.calls:
        got, want = (wtbc.count_range_batch(idx, words, los, his,
                                            kernel_backend=kb)
                     for kb in ("auto", "ref"))
        torch.cuda.synchronize()
        k1_err = max(k1_err, int((got - want).abs().max()))
        check(torch.equal(got, want), "wavelet_count differs from its plain "
              "version on the triples of a DRB and trip")
    check(len(rec_k1.calls) > 0, "the plain DRB and walk made no count")
    log(f"K1 wavelet_count == plain on the triples of {len(rec_k1.calls)} "
        f"DRB and trips ({sum(c[0].numel() for c in rec_k1.calls)} "
        f"triples): bitwise")

    root = idx.levels[0]
    pos5 = np.concatenate([[0, root.length, 1, root.length - 1],
                           rng.integers(0, root.length + 1, 4092)])
    byte5 = rng.integers(0, 256, len(pos5))
    byte5[: len(pos5) // 2] = rng.choice(
        root.data[:4096].cpu().numpy(), len(pos5) // 2)   # bytes that occur
    k5_sets = [("random", (root, torch.from_numpy(byte5.astype(np.int32)).to(
        dev), torch.from_numpy(pos5.astype(np.int32)).to(dev)))] \
        + [("snippet decode", c) for c in k5_snip]

    def k5(case, kb):
        bm, b, p = case
        return byte_rank.byte_rank(bm.data, bm.counts, bm.length, b, p,
                                   block=bm.block, kernel_backend=kb)
    for name, case in k5_sets:
        got, want = k5(case, "auto"), k5(case, "ref")
        torch.cuda.synchronize()
        errs["byte_rank"] = max(errs.get("byte_rank", 0),
                                int((got - want).abs().max()))
        check(torch.equal(got, want), f"byte_rank differs from its plain "
              f"version on {name} queries")
    log(f"K5 byte_rank == plain on {len(k5_sets)} query sets "
        f"({sum(c[2].numel() for _, c in k5_sets)} ranks): bitwise")

    # a 1-byte word (stopper byte at the root) of band ii
    one_byte = torch.nonzero((idx.cw_len == 1) & (idx.df > 100)).reshape(-1)
    w4 = int(one_byte[len(one_byte) // 2])
    byte4 = int(idx.cw[w4, 0])
    bounds = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        idx.sep_pos + 1]).to(torch.int32)

    def k4(kb):
        return segment_tf.segment_tf(root.data, root.counts, root.length,
                                     byte4, bounds, block=root.block,
                                     kernel_backend=kb)
    got, want = k4("auto"), k4("ref")
    d_all = torch.arange(idx.n_docs, dtype=torch.int32, device=dev)
    tf_k1 = wtbc.count_doc(idx, torch.full_like(d_all, w4), d_all)
    torch.cuda.synchronize()
    errs["segment_tf"] = int((got - want).abs().max())
    check(torch.equal(got, want), "segment_tf differs from its plain version")
    check(torch.equal(got, tf_k1), "segment_tf differs from the count descent")
    log(f"K4 segment_tf == plain == count descent: word rank {w4} (byte "
        f"{byte4}) over {bounds.numel()} document bounds, df "
        f"{int((got > 0).sum())}: bitwise")

    g = torch.Generator(device=dev).manual_seed(SEED)
    cands = torch.randn((1_000_000, 128), generator=g, device=dev)
    qv = torch.randn(128, generator=g, device=dev)

    def k6(kb, c=cands, q=qv, **kw):
        return topk_score.scored_topk(c, q, k=K, tile=1024, kernel_backend=kb,
                                      **kw)
    (s6, i6), (ws6, wi6) = k6("auto"), k6("ref")
    lib_s, lib_i = torch.topk(torch.mv(cands, qv), K)
    torch.cuda.synchronize()
    errs["scored_topk"] = float((s6 - ws6).abs().max())
    check(torch.equal(s6, ws6) and torch.equal(i6, wi6),
          "scored_topk differs from its plain version at C = 10^6")
    # and at every call of the DRB or searches: (B, n_docs, Q) parts
    # against (B, Q) weights, with the mask of the documents that occur
    for c6, q6, ok6, kk, tl in rec_k6.calls:
        (s, i), (ws, wi) = (topk_score.scored_topk(
            c6, q6, k=kk, tile=tl, valid=ok6, kernel_backend=kb)
            for kb in ("auto", "ref"))
        torch.cuda.synchronize()
        fin = torch.isfinite(ws)
        check(torch.equal(torch.isfinite(s), fin), "scored_topk fills "
              "other slots than its plain version on a DRB or batch")
        errs["scored_topk"] = max(errs["scored_topk"],
                                  float((s - ws)[fin].abs().max())
                                  if bool(fin.any()) else 0.0)
        check(torch.equal(s, ws) and torch.equal(i, wi),
              f"scored_topk differs from its plain version on a DRB or "
              f"batch of shape {tuple(c6.shape)}")
    check(len(rec_k6.calls) > 0, "no DRB or search launched scored_topk")
    log(f"K6 scored_topk == plain on {len(rec_k6.calls)} DRB or batches of "
        f"shape {tuple(rec_k6.calls[0][0].shape)} with their masks: bitwise")
    log(f"K6 scored_topk == plain at C = 10^6, d = 128, k = {K}: bitwise; "
        f"indices equal to torch.topk(torch.mv): "
        f"{bool(torch.equal(i6, lib_i.to(torch.int32)))}, max |score - "
        f"library score| {float((s6 - lib_s).abs().max()):.3e}")

    # ---- 9. the DRB path as a user calls it ------------------------------
    mega = {}
    for i, (mode, band, q) in enumerate(batches):
        mega[i] = engine.search(q, k=K, mode=mode, mega=True)
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    drb_ms, drb_res, per_batch = {}, {}, {}
    for mname in measures:
        for i, (mode, band, q) in enumerate(batches):
            before = backend.launch_counts()
            ms, res = wall_ms(lambda: engine.search(
                q, k=K, mode=mode, strategy="drb", measure=mname))
            after = backend.launch_counts()
            key = f"{mname} {mode} {band}"
            drb_ms[key], drb_res[(mname, i)] = ms, res
            per_batch[key] = {k_: after[k_] - before[k_] for k_ in after}
            log(f"DRB {key}: {ms:.2f} ms per batch of {B}; n_found "
                f"{res.n_found.tolist()}; trips {res.work.tolist()}")
    snips, snip_calls = {}, []
    for i in (1, 3):
        res = drb_res[("bm25", i)]
        before = backend.launch_counts()
        snips[i] = (res, engine.snippets(res, length=8))
        after = backend.launch_counts()
        snip_calls.append({k_: after[k_] - before[k_] for k_ in after})
    drb_counts = backend.launch_counts()
    log("DRB path launches: " + json.dumps(drb_counts))
    for name in ("drb_walk", "drb_or", "wtbc_decode"):
        check(drb_counts[name] > 0, f"{name} never launched on the DRB path")
    for key, c in per_batch.items():
        one = "drb_walk" if " and " in key else "drb_or"
        check(c == {k_: int(k_ == one) for k_ in c}, f"DRB {key} is not one "
              f"{one} launch: {c}")
    for c in snip_calls:
        check(c == {k_: int(k_ == "wtbc_decode") for k_ in c},
              f"snippets is not one wtbc_decode launch: {c}")
    log("DRB and: one drb_walk launch per batch; DRB or: one drb_or launch "
        "per batch; snippets: one wtbc_decode launch per call; no other "
        "kernel (K1, K3, K5, K6)")

    for i, (mode, band, q) in enumerate(batches):
        res, ref_ = drb_res[("tfidf", i)], mega[i]
        for leaf in ("docs", "scores", "n_found"):
            check(torch.equal(getattr(res, leaf), getattr(ref_, leaf)),
                  f"DRB tf-idf differs from the mega core on {leaf} ({mode}, "
                  f"band {band})")
        for mname in measures:
            r = drb_res[(mname, i)]
            found = r.scores[r.scores > -np.inf]
            check(bool(torch.isfinite(found).all()), "non-finite DRB scores")
            check(tuple(r.docs.shape) == (B, K), "DRB result shape")
    log("DRB tf-idf == mega core on all five batches: docs, scores, n_found "
        "bitwise")
    tokens = np.concatenate(cp.doc_tokens)
    ends = np.cumsum([len(t) for t in cp.doc_tokens])
    for i, (mode, band, q) in enumerate(batches):
        res = drb_res[("bm25", i)]
        for row in range(2):
            bd, bs = bm25_bruteforce(tokens, ends, idx.n_docs, q[row],
                                     mode=mode, k=K, eps=engine.config.eps)
            got_d = res.docs[row].cpu().numpy()
            got_s = res.scores[row].cpu().numpy()
            check(np.array_equal(bd, got_d) and np.array_equal(bs, got_s),
                  f"DRB BM25 differs from brute force ({mode}, band {band}, "
                  f"row {row}): {bd.tolist()} {bs.tolist()} vs "
                  f"{got_d.tolist()} {got_s.tolist()}")
        log(f"host brute-force BM25 over {idx.n_docs} docs == DRB BM25 "
            f"({mode}, band {band}, rows 0-1): docs and scores bitwise")
    del tokens
    n_snip = 0
    for i, (res, sn) in snips.items():
        for b in range(len(res)):
            for (d, _), toks in zip(res.hits(b), sn[b]):
                check(np.array_equal(toks, cp.doc_tokens[d][:8]),
                      f"snippet of doc {d} differs from its tokens")
                n_snip += 1
    check(n_snip > 0, "no snippet was decoded")
    log(f"snippets(length=8) == corpus tokens for {n_snip} hits")

    # ---- 10. timings ---------------------------------------------------------
    rows = []
    k3_trip = rec_k3.calls[0][0]
    for name, pos in (("M=%d (DRB and trip)" % k3_trip.numel(), k3_trip),
                      ("M=%d (random)" % k3_sets[0][1].numel(),
                       k3_sets[0][1])):
        call_ms = time_cuda(lambda: k3(pos, "auto"), reps=200, warm=20)
        kms, _ = profile_device(lambda: k3(pos, "auto"), 100,
                                "bitmap_rank1_kernel")
        pms = time_cuda(lambda: k3(pos, "ref"), reps=20, warm=3)
        blocks = torch.unique(torch.clamp(pos.long().clamp(0, n_bits) // 1024,
                                          max=aux.bv.counts.numel() - 2))
        nb = blocks.numel() * (128 + 4) + 8 * pos.numel()
        bms, by = bound_ms(nb, 32 * pos.numel())
        rows.append(("bitmap_rank1", name, kms, call_ms, pms, bms, by))
    # K4 and K6 (redesigned for this card), and K3 where its bytes matter
    # (10^6 random ranks), are timed cold: the figure of their rows; the
    # warm reading and the profiler's beside it
    extra = {}
    pos_m = torch.randint(0, n_bits + 1, (1_000_000,), device=dev,
                          dtype=torch.int32,
                          generator=torch.Generator(device=dev).manual_seed(
                              SEED + 3))
    got3, want3 = k3(pos_m, "auto"), k3(pos_m, "ref")
    torch.cuda.synchronize()
    errs["bitmap_rank1"] = max(errs["bitmap_rank1"],
                               int((got3 - want3).abs().max()))
    check(torch.equal(got3, want3), "bitmap_rank1 differs from its plain "
          "version at 10^6 random positions")
    call_ms = time_cuda(lambda: k3(pos_m, "auto"), reps=20, warm=3)
    kms, _ = profile_device(lambda: k3(pos_m, "auto"), 20,
                            "bitmap_rank1_kernel")
    c_ms = cold_ms(lambda: k3(pos_m, "auto"), 20)
    w_ms3 = warm_ms(lambda: k3(pos_m, "auto"), 20)
    pms = cold_ms(lambda: k3(pos_m, "ref"), 3, warm=1)
    blocks = torch.unique(torch.clamp(pos_m.long() // 1024,
                                      max=aux.bv.counts.numel() - 2))
    bms, by = bound_ms(blocks.numel() * (128 + 4) + 8 * pos_m.numel(),
                       32 * pos_m.numel())
    shape3 = f"M={pos_m.numel()} (random)"
    rows.append(("bitmap_rank1", shape3, c_ms, call_ms, pms, bms, by))
    extra[shape3] = {"cold_ms": c_ms, "warm_ms": w_ms3, "profiler_ms": kms,
                     "bound_fraction": bms / c_ms}
    del got3, want3
    k5_case = k5_snip[0] if k5_snip else k5_sets[0][1]
    for name, case in (("M=%d (snippet decode, level 0)" % k5_case[2].numel(),
                        k5_case),
                       ("M=%d (random)" % k5_sets[0][1][2].numel(),
                        k5_sets[0][1])):
        call_ms = time_cuda(lambda: k5(case, "auto"), reps=200, warm=20)
        kms, _ = profile_device(lambda: k5(case, "auto"), 100,
                                "byte_rank_kernel")
        pms = time_cuda(lambda: k5(case, "ref"), reps=20, warm=3)
        nb, ops = near_bytes(case[0], case[1], case[2])
        bms, by = bound_ms(nb + 12 * case[2].numel(), ops)
        rows.append(("byte_rank", name, kms, call_ms, pms, bms, by))
    call_ms = time_cuda(lambda: k4("auto"), reps=50, warm=5)
    kms, _ = profile_device(lambda: k4("auto"), 20, "segment_tf_kernel")
    c_ms = cold_ms(lambda: k4("auto"), 30)
    w_ms4 = warm_ms(lambda: k4("auto"), 30)
    pms = cold_ms(lambda: k4("ref"), 3, warm=1)
    nb, ops = near_bytes(root, byte4, bounds)
    bms, by = bound_ms(nb + 4 * bounds.numel() + 4 * (bounds.numel() - 1),
                       ops)
    shape4 = f"D={bounds.numel() - 1} (every document)"
    rows.append(("segment_tf", shape4, c_ms, call_ms, pms, bms, by))
    extra[shape4] = {"cold_ms": c_ms, "warm_ms": w_ms4, "profiler_ms": kms,
                     "bound_fraction": bms / c_ms}
    call_ms = time_cuda(lambda: k6("auto"), reps=20, warm=3)
    kms, _ = profile_device(lambda: k6("auto"), 10, "scored_topk_kernel")
    c_ms = cold_ms(lambda: k6("auto"), 20)
    w_ms6 = warm_ms(lambda: k6("auto"), 20)
    pms = cold_ms(lambda: k6("ref"), 3, warm=1)
    lib_ms = cold_ms(lambda: torch.topk(torch.mv(cands, qv), K), 20)
    bms, by = topk_bound_ms(cands, qv, None, K)
    shape6 = "C=1000000, d=128, k=10, float32"
    rows.append(("scored_topk", shape6, c_ms, call_ms, pms, bms, by))
    extra[shape6] = {"cold_ms": c_ms, "warm_ms": w_ms6, "profiler_ms": kms,
                     "bound_fraction": bms / c_ms, "library_ms": lib_ms}
    # K6 at the DRB or shape: the recorded BM25 batch (compared in phase 8)
    part, w6, ok6, kk6, tl6 = rec_k6.calls[-1]

    def k6_drb(kb):
        return topk_score.scored_topk(part, w6, k=kk6, tile=tl6, valid=ok6,
                                      kernel_backend=kb)

    def k6_drb_library():
        s_ = torch.bmm(part, w6[:, :, None])[..., 0]
        return torch.topk(s_.masked_fill(~ok6, float("-inf")), kk6)
    call_s = time_cuda(lambda: k6_drb("auto"), reps=100, warm=10)
    kms_s, _ = profile_device(lambda: k6_drb("auto"), 50,
                              "scored_topk_kernel")
    c_s = cold_ms(lambda: k6_drb("auto"), 50)
    w_s = warm_ms(lambda: k6_drb("auto"), 50)
    pms_s = cold_ms(lambda: k6_drb("ref"), 5, warm=1)
    lib_drb = cold_ms(k6_drb_library, 50)
    bms_s, by_s = topk_bound_ms(part, w6, ok6, kk6)
    shape6b = (f"B={part.shape[0]}, C={part.shape[1]}, d={part.shape[2]}, "
               f"k={kk6} (DRB or batch, one launch)")
    rows.append(("scored_topk", shape6b, c_s, call_s, pms_s, bms_s, by_s))
    extra[shape6b] = {"cold_ms": c_s, "warm_ms": w_s, "profiler_ms": kms_s,
                      "bound_fraction": bms_s / c_s, "library_ms": lib_drb}
    for shape, x in extra.items():
        log(f"{shape}: cold {x['cold_ms']:.6f} ms (median, L2 flushed), "
            f"warm {x['warm_ms']:.6f} ms, profiler {x['profiler_ms']:.6f} ms "
            f"on the device; {100 * x['bound_fraction']:.1f}% of the bound"
            + (f"; library {x['library_ms']:.6f} ms cold"
               if "library_ms" in x else ""))
    for kname, shape, kms, call_ms, pms, bms, by in rows:
        check(kms > 0, f"no device time was recorded for {kname}")
        log(f"{kname} {shape}: kernel {kms:.6f} ms on the device "
            f"({call_ms:.4f} ms per wrapper call), plain {pms:.4f} ms, bound "
            f"{bms:.6f} ms ({by})")
    _FLUSH.clear()
    log(f"K6 library torch.topk(torch.mv(cands, q), {K}): {lib_ms:.6f} ms; "
        f"at the DRB or shape torch.topk(torch.bmm(...).masked_fill(...), "
        f"{kk6}): {lib_drb:.6f} ms (both cold)")
    log("DRB launches per batch: " + json.dumps(per_batch))
    # the or batches' device work is a tenth of a millisecond, so their
    # idle share is read over ten searches, against the profiled and an
    # unprofiled wall
    q = batches[1][2]
    for mname in measures:
        def search():
            return engine.search(q, k=K, mode="or", strategy="drb",
                                 measure=mname)
        busy, wall = profile_device(search, 10)
        plain_wall = sum(wall_ms(search)[0] for _ in range(10)) / 10
        log(f"DRB {mname} (or, band ii): device busy {busy:.4f} ms of "
            f"{wall:.3f} ms wall per search, idle share "
            f"{1 - busy / wall:.4f}; of {plain_wall:.3f} ms unprofiled, "
            f"{1 - busy / plain_wall:.4f}")

    # drb_walk: one DRB and batch (band iii, tf-idf, P = 1), the walk's
    # state fresh for each launch
    q = batches[2][2]
    meas = measures["tfidf"]
    r, m_ = engine._encode_queries(q)
    qt = drb.and_tables(idx, aux, torch.from_numpy(r).to(dev),
                        torch.from_numpy(m_).to(dev), meas,
                        engine._idf_table(meas))
    st0 = walk.init_state(qt, K)
    holder = {}

    def fresh():
        holder["st"] = st0.clone()

    def run(kb):
        holder["st"] = walk.drb_walk(idx, aux, qt, holder["st"], meas, k=K,
                                     kernel_backend=kb)
    w_call = time_cuda(lambda: run("auto"), reps=20, warm=3, setup=fresh)
    w_ms, _ = profile_device(lambda: (fresh(), run("auto")), 10,
                             "drb_walk_kernel")
    check(w_ms > 0, "the profiler recorded no device time for "
          "drb_walk_kernel")
    fresh()
    run("auto")
    got = holder["st"]
    w_plain = time_cuda(lambda: run("ref"), reps=1, warm=0, setup=fresh)
    check(all(torch.equal(a, b) for a, b in zip(got, holder["st"])),
          "drb_walk's state differs from the plain walk's (and band iii)")
    trips = int(got.it.max())
    # what the walk needs to read (walk_bytes, from the plain walk's own
    # calls), plus the row tables and state
    with OpsRecorder("select", lambda bm, b, j: (bm, b, j), module=bytemap) \
            as rec_sel, \
            OpsRecorder("doc_of_pos", lambda i, p: (p,), module=wtbc) \
            as rec_doc, OpsRecorder() as rec_cnt, \
            OpsRecorder("bitmap_rank1_batch",
                        lambda bv, pos, **kw: (pos,)) as rec_rank:
        fresh()
        run("ref")
    Qw = qt.wl.shape[1]
    check(len(rec_cnt.calls) == len(rec_rank.calls) >= trips,
          "the plain walk made other calls than one count and one rank "
          "per trip")
    nb, ops = walk_bytes(idx, aux, qt, rec_sel.calls, rec_doc.calls,
                         rec_cnt.calls, rec_rank.calls)
    nb += B * (Qw * 20 + 2 * Qw * 4 + K * 8 + 12)   # tables in, state out
    w_bound, w_by = bound_ms(nb, ops)
    log(f"drb_walk (and band iii, tf-idf, B={B}): kernel {w_ms:.4f} ms on "
        f"the device ({w_call:.4f} ms per wrapper call), plain walk "
        f"{w_plain:.3f} ms, bound {w_bound:.6f} ms ({w_by}: {nb} bytes, "
        f"{ops} compares); longest row {trips} trips: "
        f"{1e3 * w_ms / max(trips, 1):.3f} us per trip; row trips "
        f"{got.it.tolist()}")
    # the profiler's own host cost inflates its wall time, so the idle share
    # is also given against an unprofiled run of the same batch
    for i in (0, 2):
        for mname in measures:
            def batch():
                return engine.search(batches[i][2], k=K, mode="and",
                                     strategy="drb", measure=mname)
            busy, wall = profile_device(batch, 1)
            plain_wall, _ = wall_ms(batch)
            log(f"DRB {mname} (and, band {batches[i][1]}): device busy "
                f"{busy:.3f} ms of {wall:.3f} ms wall, idle share "
                f"{1 - busy / wall:.4f}; of {plain_wall:.3f} ms unprofiled, "
                f"{1 - busy / plain_wall:.4f}")

    # drb_or: one DRB or batch per call (ii and iii, tf-idf and BM25); its
    # device time is the memset's and the three kernels' (the call makes
    # no other device work: the words are on the card already)
    or_rows = []
    for i in (1, 3):
        wt, mt = encode(batches[i][2])
        cap = engine._df_cap(wt.cpu().numpy(), mt.cpu().numpy())
        for mname in measures:
            def one(kb="auto"):
                return or_run(wt, mt, mname, kb, cap=cap)
            call_ms = time_cuda(one, reps=50, warm=5)
            kms, _ = profile_device(one, 20)
            pms = time_cuda(lambda: one("ref"), reps=3, warm=1)
            nb, ops, lanes = or_bytes(idx, aux, wt, mt, cap, K,
                                      mname == "bm25")
            bms, by = bound_ms(nb, ops)
            parts = {name: profile_device(one, 20, name, need=False)[0]
                     for name in ("Memset", "drb_or_prep", "drb_or_gather",
                                  "drb_or_score")}
            log(f"drb_or (or band {batches[i][1]}, {mname}) device ms by "
                f"part: " + ", ".join(f"{k_} {v:.6f}"
                                      for k_, v in parts.items()))
            or_rows.append({"shape": f"or {batches[i][1]} {mname}, B={B}, "
                            f"Q={wt.shape[1]}, k={K}, {lanes} live lanes",
                            "ms": kms, "wrapper_ms": call_ms, "plain_ms": pms,
                            "bound_ms": bms, "bound_by": by,
                            "parts_ms": parts})
            log(f"drb_or (or band {batches[i][1]}, {mname}, B={B}, "
                f"{lanes} live lanes): memset + kernels {kms:.6f} ms on the "
                f"device ({call_ms:.4f} ms per wrapper call), plain "
                f"{pms:.3f} ms, bound {bms:.6f} ms ({by}: {nb} bytes, "
                f"{ops} compares)")
    # snippets as a user calls them, and wtbc_decode at their positions
    snip_ms = {}
    for i, (res, _) in snips.items():
        snip_ms[batches[i][1]] = [wall_ms(lambda: engine.snippets(
            res, length=8))[0] for _ in range(5)]
        log(f"snippets(length=8) of the or {batches[i][1]} BM25 batch "
            f"({int(res.n_found.sum())} hits): ms per call " + ", ".join(
                f"{x:.3f}" for x in snip_ms[batches[i][1]]))
    pos = snippet_pos(snips[3][0])
    d_call = time_cuda(lambda: wtbc.decode_at(idx, pos), reps=200, warm=20)
    d_ms, _ = profile_device(lambda: wtbc.decode_at(idx, pos), 100,
                             "wtbc_decode_kernel")
    check(d_ms > 0, "the profiler recorded no device time for "
          "wtbc_decode_kernel")
    d_plain = time_cuda(lambda: wtbc.decode_at(idx, pos, kernel_backend="ref"),
                        reps=20, warm=3)
    nb, ops = decode_bytes(idx, pos)
    d_bound, d_by = bound_ms(nb, ops)
    log(f"wtbc_decode (M={pos.numel()}, the or iii BM25 batch's snippets): "
        f"kernel {d_ms:.6f} ms on the device ({d_call:.4f} ms per wrapper "
        f"call), plain {d_plain:.4f} ms, bound {d_bound:.6f} ms ({d_by}: "
        f"{nb} bytes, {ops} compares)")

    meta = {
        "bitmap_rank1": ("src/repro_torch/csrc/bitmap_rank.cu",
                         "src/repro/kernels/bitmap_rank.py:26",
                         "no PyTorch call ranks a packed bit vector"),
        "byte_rank": ("src/repro_torch/csrc/byte_rank.cu",
                      "src/repro/kernels/byte_rank.py:34",
                      "no PyTorch call ranks a byte sequence with counters"),
        "segment_tf": ("src/repro_torch/csrc/segment_tf.cu",
                       "src/repro/kernels/segment_tf.py:31",
                       "no PyTorch call counts a byte per span of bounds"),
        "scored_topk": ("src/repro_torch/csrc/topk_score.cu",
                        "src/repro/kernels/topk_score.py:34", None),
    }
    out = []
    for kname, (src, repl, why) in meta.items():
        mine = [r for r in rows if r[0] == kname]
        _, _, kms, call_ms, pms, bms, by = mine[0]
        out.append({"name": kname, "route": "cuda", "source": src,
                    "replaces": repl, "launches": drb_counts[kname],
                    "max_abs_err": errs[kname], "ms": kms, "plain_ms": pms,
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_ms if why is None else None,
                    "library_note": why, "wrapper_ms": call_ms,
                    **{k_: v for k_, v in extra.get(mine[0][1], {}).items()
                       if k_ != "library_ms"},
                    "shapes": [{"shape": r[1], "ms": r[2], "wrapper_ms": r[3],
                                "plain_ms": r[4], "bound_ms": r[5],
                                "bound_by": r[6], **extra.get(r[1], {})}
                               for r in mine]})
    out.append({"name": "drb_walk", "route": "cuda",
                "source": "src/repro_torch/csrc/drb_walk.cu",
                "replaces": "src/repro/kernels/bitmap_rank.py:26",
                "launches": drb_counts["drb_walk"], "max_abs_err": 0,
                "ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound,
                "bound_by": w_by, "library_ms": None,
                "library_note": "no PyTorch call runs a DRB walk",
                "wrapper_ms": w_call, "trips": trips,
                "us_per_trip": 1e3 * w_ms / max(trips, 1),
                "shape": f"and band iii, tf-idf, B={B}, Q={Qw}, k={K}, P=1"})
    main_or = or_rows[-1]                  # or iii BM25: the default path
    out.append({"name": "drb_or", "route": "cuda",
                "source": "src/repro_torch/csrc/drb_or.cu",
                "replaces": "src/repro/kernels/topk_score.py:34",
                "launches": drb_counts["drb_or"], "max_abs_err": 0,
                "ms": main_or["ms"], "plain_ms": main_or["plain_ms"],
                "bound_ms": main_or["bound_ms"],
                "bound_by": main_or["bound_by"], "library_ms": None,
                "library_note": "no PyTorch call runs a DRB or query",
                "wrapper_ms": main_or["wrapper_ms"], "shapes": or_rows})
    out.append({"name": "wtbc_decode", "route": "cuda",
                "source": "src/repro_torch/csrc/wtbc_decode.cu",
                "replaces": "src/repro/kernels/byte_rank.py:34",
                "launches": drb_counts["wtbc_decode"], "max_abs_err": 0,
                "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
                "bound_by": d_by, "library_ms": None,
                "library_note": "no PyTorch call decodes a WTBC",
                "wrapper_ms": d_call,
                "shape": f"M={pos.numel()} (or iii BM25 snippets)",
                "snippets_ms_per_call": snip_ms})
    del cands
    return out, k1_err


# ---------------------------------------------------------------------------
# positional search (phases 11-12)
# ---------------------------------------------------------------------------

def phrase_doc_rows(cp, occ_word, rng, n_rows: int, max_occ: int
                    ) -> list[list[int]]:
    """Rows of 2 or 3 consecutive words of random documents whose rarest
    word occurs at most ``max_occ`` times: every row has a hit, and the
    anchor scan stays bounded."""
    out = []
    while len(out) < n_rows:
        d = cp.doc_tokens[rng.integers(0, cp.n_docs)]
        n = 2 + len(out) % 2
        i = rng.integers(0, len(d) - n + 1)
        run = d[i:i + n]
        if occ_word[run].min() <= max_occ:
            out.append([int(x) for x in run])
    return out


def near_doc_rows(cp, occ_word, rng, n_rows: int, max_occ: int,
                  span: int = 6) -> list[list[int]]:
    """Rows of three words of one document within ``span`` tokens of each
    other, each occurring at most ``max_occ`` times: every row has a
    window of width <= span + 1."""
    out = []
    while len(out) < n_rows:
        d = cp.doc_tokens[rng.integers(0, cp.n_docs)]
        i = rng.integers(0, len(d) - span)
        at = np.sort(rng.choice(np.arange(i, i + span + 1), 3, replace=False))
        row = d[at]
        if occ_word[row].max() <= max_occ:
            out.append([int(x) for x in rng.permutation(row)])
    return out


class TokenIndex:
    """The corpus's tokens on the host, for brute-force checks independent
    of the program: the concatenated documents (no separators), each
    document's start and end, and every word's positions (one stable sort,
    so a word's positions ascend)."""

    def __init__(self, cp):
        self.flat = np.concatenate(cp.doc_tokens)
        lens = np.array([len(t) for t in cp.doc_tokens], dtype=np.int64)
        self.ends = np.cumsum(lens)
        self.starts = self.ends - lens
        self.n_docs = len(lens)
        self.order = np.argsort(self.flat, kind="stable")
        self.bounds = np.searchsorted(self.flat[self.order],
                                      np.arange(cp.vocab_size + 1))

    def positions(self, w: int) -> np.ndarray:
        return self.order[self.bounds[w]:self.bounds[w + 1]]

    def doc_of(self, i: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.ends, i, side="right")


def phrase_bruteforce(tok: TokenIndex, words) -> tuple[np.ndarray, np.ndarray]:
    """Per document the number of occurrences of the phrase ``words`` (word
    ids, in order) and the doc-relative start of the first (-1 if none): a
    shifted-array compare from the first word's positions, kept where the
    phrase ends inside the document it starts in."""
    n = len(words)
    i = tok.positions(words[0])
    for o in range(1, n):
        i = i[i + o < len(tok.flat)]
        i = i[tok.flat[i + o] == words[o]]
    d = tok.doc_of(i)
    keep = i + n <= tok.ends[d]
    i, d = i[keep], d[keep]
    tf = np.bincount(d, minlength=tok.n_docs)
    first = np.full(tok.n_docs, -1, dtype=np.int64)
    ud, at = np.unique(d, return_index=True)
    first[ud] = i[at] - tok.starts[ud]
    return tf, first


def near_bruteforce(tok: TokenIndex, words):
    """Per query word and document its tf, and per document the width and
    doc-relative start of the smallest window holding every word (the
    leftmost of equal widths; INT32_MAX / -1 where a word is missing), over
    the documents that hold every word — at each occurrence the window
    reaches back to the oldest of the words' last positions."""
    N = tok.n_docs
    pos = {w: tok.positions(w) for w in set(words)}
    docs = {w: tok.doc_of(p) for w, p in pos.items()}
    win = np.full(N, 2**31 - 1, dtype=np.int64)
    start = np.full(N, -1, dtype=np.int64)
    if any(len(p) == 0 for p in pos.values()):
        return np.zeros((len(words), N), np.int64), win, start
    tf = np.stack([np.bincount(docs[w], minlength=N) for w in words])
    common = np.flatnonzero(np.all(tf > 0, 0))
    for d in common:
        local = [pos[w][docs[w] == d] - tok.starts[d] for w in pos]
        P = np.unique(np.concatenate(local))
        last = np.stack([np.where(np.searchsorted(x, P, side="right") > 0,
                                  x[np.maximum(np.searchsorted(
                                      x, P, side="right") - 1, 0)], -1)
                         for x in local])
        s = last.min(0)
        width = np.where(s >= 0, P - s + 1, 2**62)
        k = int(np.argmin(width))
        win[d], start[d] = width[k], s[k]
    return tf, win, start


def locate_edge_lanes(idx, rng, per_level: int = 2048):
    """(words, js) on the card whose select at its word's leaf level lands
    on a block edge or one byte either side of it: per level, positions
    around its block edges, each mapped to the word of that leaf level
    whose occurrence it is (the byte's occurrence number there against the
    words' base ranks)."""
    import torch
    from repro_torch.core import bytemap
    dev = idx.device
    cw = idx.cw.cpu().numpy().astype(np.int64)
    lens = idx.cw_len.cpu().numpy()
    base = idx.base_rank.cpu().numpy().astype(np.int64)
    occ = idx.occ.cpu().numpy().astype(np.int64)
    ws, js = [], []
    for L, lv in enumerate(idx.levels):
        if lv.length == 0:
            continue
        e = np.arange(0, lv.length + 1, lv.block)
        p = np.unique(np.clip(np.concatenate([e - 1, e, e + 1]), 0,
                              lv.length - 1))
        p = rng.choice(p, min(per_level, len(p)), replace=False)
        pt = torch.from_numpy(p.astype(np.int32)).to(dev)
        byte = bytemap.access(lv, pt).long()
        r = bytemap.rank(lv, byte.to(torch.int32), pt,
                         kernel_backend="ref").cpu().numpy() + 1
        byte = byte.cpu().numpy()
        cand = np.flatnonzero((lens == L + 1) & (occ > 0))
        key = cw[cand, L] << 32 | base[cand, L]
        o = np.argsort(key)
        cand, key = cand[o], key[o]
        at = np.searchsorted(key, byte << 32 | (r - 1), side="right") - 1
        ok = at >= 0
        w = cand[np.maximum(at, 0)]
        ok &= (cw[w, L] == byte) & (base[w, L] < r) & (r <= base[w, L] + occ[w])
        ws.append(w[ok])
        js.append((r - base[w, L])[ok])
    return tuple(torch.from_numpy(np.concatenate(x).astype(np.int32)).to(dev)
                 for x in (ws, js))


def positional_phases(engine, cp, batches) -> dict:
    """Phase 11: positional search (phrase, near, ``word_positions``) at
    the smoke's size — the kernel against its plain version, the card
    against a host brute force, as a user calls it with its launches, and
    timings.  Returns the ``wtbc_locate`` row of the ``{"kernels": ...}``
    line."""
    import torch
    from repro_torch.core import positional, wtbc
    from repro_torch.kernels import backend
    from repro_torch.kernels import wtbc_locate as locate_mod
    dev = engine.device
    idx = engine.idx
    rank = engine.model.rank_of_word
    occ_word = idx.occ.cpu().numpy()[rank]
    measures = {m: engine._resolve_measure(m) for m in ("tfidf", "bm25")}
    rng = np.random.default_rng(SEED + 11)

    # ---- 11. positional search ------------------------------------------
    # the heavy near row: three words of 50,000-400,000 occurrences each,
    # 10^5-10^6 in all at full size (scaled with the tokens of a smaller
    # run), so its locates and sweep take several passes
    scale = min(1.0, idx.n / 55_000_000)
    pool = np.flatnonzero((occ_word >= 50_000 * scale)
                          & (occ_word <= 400_000 * scale))
    while True:
        heavy = [int(x) for x in rng.choice(pool, 3, replace=False)]
        if 100_000 * scale <= int(occ_word[heavy].sum()) <= 1_000_000:
            break
    ii, iii = batches[0][2], batches[2][2]
    near_rows = near_doc_rows(cp, occ_word, rng, B, 20_000)
    pbatches = [
        ("phrase", "doc", phrase_doc_rows(cp, occ_word, rng, B, 50_000),
         None),
        ("phrase", "ii", [list(map(int, r)) for r in ii], None),
        ("phrase", "iii", [list(map(int, r)) for r in iii], None),
        ("near", "doc", near_rows, 8),
        ("near", "doc w64", near_rows, 64),
        ("near", "ii", [list(map(int, r)) for r in ii], 8),
        ("near", "iii w64", [list(map(int, r)) for r in iii], 64),
        ("near", "heavy", [heavy] + [list(map(int, r)) for r in ii[1:]], 8),
    ]
    log(f"positional batches of B={B}, k={K}: " + "; ".join(
        f"{m} {b}" + (f" window {w}" if w else "") for m, b, _, w in pbatches)
        + f"; heavy near row {heavy} ({int(occ_word[heavy].sum())} "
        "occurrences)")

    def core(q, mode, window, mname, kb, **kw):
        r, m_ = engine._encode_queries(q)
        meas = measures[mname]
        return positional.topk_positional_batch(
            idx, torch.from_numpy(r).to(dev), torch.from_numpy(m_).to(dev),
            engine._idf_table(meas), k=K, phrase=mode == "phrase",
            measure=meas, window=window, avg_dl=engine._avg_doc_len(),
            kernel_backend=kb, **kw)

    # wtbc_locate against its plain version: random occurrences of 1-, 2-
    # and 3-byte words, block edges of each level, j = 0 and occ + 1
    occ = idx.occ.cpu().numpy()
    lens = idx.cw_len.cpu().numpy()
    w_rand = np.concatenate([rng.choice(np.flatnonzero((occ > 0) & (lens == L)),
                                        2048) for L in (1, 2, 3)])
    j_rand = 1 + rng.integers(0, 2**31 - 1, len(w_rand)) % occ[w_rand]
    some = w_rand[::16]
    loc_sets = [
        ("random occurrences", *(torch.from_numpy(x.astype(np.int32)).to(dev)
                                 for x in (w_rand, j_rand))),
        ("block edges of each level", *locate_edge_lanes(idx, rng)),
        ("j = 0 and occ + 1", *(torch.from_numpy(x.astype(np.int32)).to(dev)
                                for x in (np.tile(some, 2), np.concatenate(
                                    [np.zeros_like(some), occ[some] + 1]))))]
    for name, w_, j_ in loc_sets:
        got = wtbc.locate(idx, w_, j_)
        want = wtbc.locate(idx, w_, j_, kernel_backend="ref")
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"wtbc_locate differs from its plain "
              f"version on {name}")
    log(f"wtbc_locate == plain on {len(loc_sets)} lane sets "
        f"({sum(s[1].numel() for s in loc_sets)} lanes: "
        + ", ".join(f"{s[0]} {s[1].numel()}" for s in loc_sets)
        + "): bitwise")

    # the card against the plain versions on the card, every leaf
    names = ("docs", "scores", "n_found", "iters", "match_pos", "match_len")
    for mode, band, q, window in pbatches:
        for mname in measures:
            got = core(q, mode, window, mname, "auto")
            want = core(q, mode, window, mname, "ref")
            torch.cuda.synchronize()
            bad = leaves_equal(got, want, names)
            check(not bad, f"positional {mode} {band} ({mname}) differs from "
                  f"its plain version: {bad}")
    log(f"positional == plain on {len(pbatches)} batches x tf-idf/BM25: "
        "every leaf bitwise")

    # the card's tables against a host brute force over the tokens
    tok = TokenIndex(cp)
    n_docs_hit = 0
    for mode, band, q, window in pbatches:
        if band.endswith("w64"):
            continue                      # the same rows as another batch
        r, m_ = engine._encode_queries(q)
        wt, mt = torch.from_numpy(r).to(dev), torch.from_numpy(m_).to(dev)
        if mode == "phrase":
            tf, first, _ = positional.phrase_tables(idx, wt, mt)
            tf, first = tf.cpu().numpy(), first.cpu().numpy()
            for b, row in enumerate(q):
                btf, bfirst = phrase_bruteforce(tok, row)
                check(np.array_equal(tf[b], btf) and np.array_equal(
                    first[b], bfirst), f"phrase {band} row {b} {row} "
                    "differs from the brute force")
                n_docs_hit += int(np.count_nonzero(btf))
            if band == "doc":
                check(bool((tf > 0).any(1).all()), "a phrase row of a "
                      "document's words found no document")
        else:
            tf, win, pos, _ = positional.near_tables(idx, wt, mt)
            tf, win, pos = (x.cpu().numpy() for x in (tf, win, pos))
            for b, row in enumerate(q):
                btf, bwin, bpos = near_bruteforce(tok, row)
                check(np.array_equal(tf[b, :len(row)], btf)
                      and np.array_equal(win[b], bwin)
                      and np.array_equal(pos[b], bpos),
                      f"near {band} row {b} {row} differs from the brute "
                      "force")
                n_docs_hit += int(np.count_nonzero(bwin < 2**31 - 1))
    log(f"positional tables == host brute force over {len(tok.flat)} "
        f"tokens (phrase: shifted compare; near: minimal cover on the "
        f"documents holding every word): {n_docs_hit} documents with a "
        "match")

    # as a user calls it: launch counters reset, then search and
    # word_positions through the facade
    for mode, band, q, window in pbatches[:1] + pbatches[3:4]:
        engine.warmup(q[:1], max_batch=B, k=K, mode=mode)
    backend.reset_launch_counts()
    pos_ms, per_batch, results = {}, {}, {}
    for mode, band, q, window in pbatches:
        for mname in measures:
            kw = dict(window=window) if mode == "near" else {}
            before = backend.launch_counts()
            ms, res = wall_ms(lambda: engine.search(q, k=K, mode=mode,
                                                    measure=mname, **kw))
            after = backend.launch_counts()
            key = f"{mname} {mode} {band}"
            pos_ms[key] = ms
            per_batch[key] = {k_: after[k_] - before[k_] for k_ in after
                              if after[k_] != before[k_]}
            results[key] = res
            log(f"positional {key}: {ms:.2f} ms per batch of {B}; n_found "
                f"{res.n_found.tolist()}; iters {res.work.tolist()}; "
                f"launches {per_batch[key]}")
    hits = results["bm25 phrase doc"]
    n_wp = 0
    for b in range(2):
        for d, _, p, ln in hits.matches(b)[:3]:
            wp = engine.word_positions(d, pbatches[0][2][b], cap=64)
            toks = cp.doc_tokens[d]
            for w, got in wp.items():
                check(np.array_equal(got, np.flatnonzero(toks == w)[:64]),
                      f"word_positions of {w} in doc {d} differ from the "
                      "tokens")
            check(all(toks[p + o] == w for o, w in
                      enumerate(pbatches[0][2][b])) and ln == len(
                          pbatches[0][2][b]), f"phrase match of doc {d} at "
                  f"{p} is not the phrase")
            n_wp += 1
    pos_counts = backend.launch_counts()
    log("positional path launches: " + json.dumps(pos_counts))
    for name in ("wtbc_locate", "wtbc_decode", "wavelet_count"):
        check(pos_counts[name] > 0, f"{name} never launched on the "
              "positional path")
    others = {k_: v for k_, v in pos_counts.items() if v and k_ not in (
        "wtbc_locate", "wtbc_decode", "wavelet_count")}
    check(not others, f"other kernels launched on the positional path: "
          f"{others}")
    check(n_wp > 0, "no phrase hit for word_positions")
    for key, c in per_batch.items():
        check(c.get("wtbc_locate", 0) >= 1 and set(c) <= {
            "wtbc_locate", "wtbc_decode"}, f"positional {key} launches {c}")
    for mode, band, q, window in pbatches:
        for mname in measures:
            res = results[f"{mname} {mode} {band}"]
            want = core(q, mode, window, mname, "auto")
            check(not leaves_equal(res, want, (
                "docs", "scores", "n_found", "match_pos", "match_len")),
                f"search({mode}) differs from its core on {band}")
            check(tuple(res.docs.shape) == (B, K) and bool(torch.isfinite(
                res.scores[res.n_found[:, None] > torch.arange(
                    K, device=dev)]).all()), "positional result shape or "
                "non-finite scores")
    log(f"search(mode=phrase|near) == the core's batch; word_positions "
        f"== tokens and phrase matches == the phrase on {n_wp} hits")

    # ---- timings --------------------------------------------------------
    for label in ("tfidf phrase doc", "bm25 near heavy"):
        mode, band = label.split()[1], " ".join(label.split()[2:])
        q, window = next((q, w) for m, b, q, w in pbatches
                         if m == mode and b == band)
        mname = label.split()[0]
        kw = dict(window=window) if mode == "near" else {}

        def search():
            return engine.search(q, k=K, mode=mode, measure=mname, **kw)
        busy, wall, top = device_breakdown(search, 3)
        plain_wall = sum(wall_ms(search)[0] for _ in range(3)) / 3
        log(f"positional {label}: device busy {busy:.4f} ms of {wall:.3f} "
            f"ms wall per search, idle share {1 - busy / wall:.4f}; of "
            f"{plain_wall:.3f} ms unprofiled, {1 - busy / plain_wall:.4f}; "
            "device ms by kernel: " + "; ".join(
                f"{k_[:60]} {v:.4f}" for k_, v in top))
    # wtbc_locate at the lanes the positional path gives it
    shapes = []
    for label, mode, band in (("phrase doc anchors", "phrase", "doc"),
                              ("near heavy pass", "near", "heavy")):
        q, window = next((q, w) for m, b, q, w in pbatches
                         if m == mode and b == band)
        with OpsRecorder("wtbc_locate", lambda i, w, j, **kw: (w, j),
                         module=locate_mod) as rec:
            core(q, mode, window, "tfidf", "auto")
        w_, j_ = rec.calls[0]
        w_, j_ = w_.reshape(-1), j_.reshape(-1)

        def loc(kb):
            return wtbc.locate(idx, w_, j_, kernel_backend=kb)
        call_ms = time_cuda(lambda: loc("auto"), reps=50, warm=5)
        kms, _ = profile_device(lambda: loc("auto"), 20,
                                "wtbc_locate_kernel")
        pms = time_cuda(lambda: loc("ref"), reps=3, warm=1)
        nb, ops, _ = locate_bytes(idx, w_, j_)
        nb += 12 * w_.numel() + 31 * int(torch.unique(w_).numel())
        bms, by = bound_ms(nb, ops)
        shapes.append({"shape": f"M={w_.numel()} ({label})", "ms": kms,
                       "wrapper_ms": call_ms, "plain_ms": pms,
                       "bound_ms": bms, "bound_by": by})
        log(f"wtbc_locate M={w_.numel()} ({label}): kernel {kms:.6f} ms on "
            f"the device ({call_ms:.4f} ms per wrapper call), plain "
            f"{pms:.4f} ms, bound {bms:.6f} ms ({by}: {nb} bytes, {ops} "
            "compares)")
    log("positional ms per batch: " + json.dumps(pos_ms))
    main = shapes[0]
    return {"name": "wtbc_locate", "route": "cuda",
            "source": "src/repro_torch/csrc/wtbc_locate.cu",
            "replaces": "src/repro/core/wtbc.py:292",
            "replaces_note": "the reference's locate is plain jnp, not a "
                             "Pallas kernel: the port's own launch",
            "launches": pos_counts["wtbc_locate"], "max_abs_err": 0,
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "library_note": "no PyTorch call locates in a WTBC",
            "wrapper_ms": main["wrapper_ms"], "shapes": shapes,
            "positional_ms_per_batch": pos_ms,
            "positional_launches_per_batch": per_batch}



def cap_phases(engine, batches) -> tuple[dict, dict]:
    """Phase 12: DRB ``or`` past the old k cap of 32,768 (F1) and the mega
    core past the old pool cap of about 1 M slots (F2), each against its
    plain version on the card, every leaf bitwise, with their device
    times beside the same batch at the default k and cap."""
    import torch
    from repro_torch.core import drb, mega
    dev = engine.device
    idx = engine.idx
    measures = {m: engine._resolve_measure(m) for m in ("tfidf", "bm25")}
    names = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
             "certified", "bound")
    # ---- 12. F1: two rows of words in 46% to 99% of the documents (so
    # with tf bitmaps; at full size more than 40,000 documents hit a row)
    df_word = idx.df.cpu().numpy()[engine.model.rank_of_word]
    pool = np.flatnonzero((df_word > 0.46 * idx.n_docs)
                          & (df_word < 0.99 * idx.n_docs))
    pool = pool[pool > 0]
    rng = np.random.default_rng(SEED + 12)
    rows = [[int(x) for x in rng.choice(pool, 3, replace=False)]
            for _ in range(2)]
    r, m_ = engine._encode_queries(rows)
    wt, mt = torch.from_numpy(r).to(dev), torch.from_numpy(m_).to(dev)
    cap = engine._df_cap(r, m_)
    f1 = {"rows": rows, "k": 40_000}
    for mname, meas in measures.items():
        for k in (K, 40_000):
            def one(kb="auto"):
                return drb.topk_drb_or(
                    idx, engine.aux, wt, mt, meas, k=k, max_df_cap=cap,
                    idf=engine._idf_table(meas), avg_dl=engine._avg_doc_len(),
                    kernel_backend=kb)
            got = one()
            if k > K:
                want = one("ref")
                torch.cuda.synchronize()
                bad = leaves_equal(got, want, names)
                check(not bad, f"drb_or at k = {k} differs from its plain "
                      f"version ({mname}): {bad}")
                check(int(got.n_found.min()) > min(32_768, idx.n_docs // 3),
                      f"F1 rows found {got.n_found.tolist()} documents, not "
                      "past 32,768")
            parts = {name: profile_device(one, 5, name, need=False)[0]
                     for name in ("drb_or_gather", "drb_or_score")}
            total, _ = profile_device(one, 5)
            f1[f"{mname} k={k}"] = {"ms": total, "parts_ms": parts,
                                    "n_found": got.n_found.tolist()}
            log(f"F1 drb_or ({mname}, k = {k}, n_found "
                f"{got.n_found.tolist()}): {total:.6f} ms on the device; "
                + ", ".join(f"{k_} {v:.6f}" for k_, v in parts.items()))
    log("F1: drb_or at k = 40,000 == plain (tf-idf/BM25): every leaf "
        "bitwise")

    # ---- F2: the mega core at a pool of 1.2 M slots
    big = 1_200_000
    idf = engine._idf_table(measures["tfidf"])
    f2 = {"cap": big}
    for mode, band, q, budget in ((*batches[0], None), (*batches[3], 64)):
        r, m_ = engine._encode_queries(q)
        wt, mt = torch.from_numpy(r).to(dev), torch.from_numpy(m_).to(dev)
        for c in (idx.n_docs + 2, big):
            def run(kb="auto"):
                return mega.topk_dr_mega(idx, wt, mt, idf, k=K,
                                         conjunctive=mode == "and", cap=c,
                                         max_pops=budget, kernel_backend=kb)
            got = run()
            if c == big:
                want = run("ref")
                torch.cuda.synchronize()
                bad = leaves_equal(got, want, names)
                check(not bad, f"beam_loop at cap {c} differs from its plain "
                      f"loop ({mode} {band}, budget {budget}): {bad}")
            kms, _ = profile_device(run, 3, "beam_loop_kernel")
            f2[f"{mode} {band} budget {budget} cap={c}"] = kms
            log(f"F2 beam_loop ({mode} {band}, budget {budget}, cap {c}): "
                f"{kms:.6f} ms on the device; pops/row {got.pops.tolist()}")
    log(f"F2: the mega core at cap {big} == its plain loop: every leaf "
        "bitwise")
    return f1, f2


# ---------------------------------------------------------------------------
# serving (phase 13)
# ---------------------------------------------------------------------------

SERVE_DISTINCT, SERVE_REQUESTS, SERVE_WORKERS, SERVE_BATCH = 64, 256, 8, 8
DEADLINE_MS = 50.0
SNAPSHOT_LEAVES = ("cw", "cw_len", "node_off", "base_rank", "sep_pos", "df",
                   "occ", "doc_len")


def engine_arrays(eng) -> list[tuple[str, object]]:
    """Every index, tf-bitmap and model array of an engine, and its host
    integers, by name."""
    idx, aux = eng.idx, eng.aux
    out = []
    for i, lv in enumerate(idx.levels):
        out += [(f"levels[{i}].data", lv.data), (f"levels[{i}].counts",
                                                 lv.counts),
                (f"levels[{i}].length", lv.length),
                (f"levels[{i}].block", lv.block), (f"offsets[{i}]",
                                                   idx.offsets[i])]
    out += [(f, getattr(idx, f)) for f in SNAPSHOT_LEAVES]
    out += [("n", idx.n), ("n_docs", idx.n_docs), ("s", idx.s), ("c", idx.c),
            ("bv.words", aux.bv.words), ("bv.counts", aux.bv.counts),
            ("bv.n_bits", aux.bv.n_bits), ("bit_off", aux.bit_off),
            ("has_bm", aux.has_bm), ("eps", aux.eps)]
    out += [(f"model.{f}", getattr(eng.model, f)) for f in
            ("codes", "lens", "rank_of_word", "word_of_rank", "freqs")]
    return out


def same_value(a, b) -> bool:
    import torch
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and a.device == b.device and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return type(a) is type(b) and a == b


ROW_LEAVES = ("docs", "scores", "certified", "match_pos", "match_len")
ROW_SCALARS = ("n_found", "work", "pops", "overflowed", "padded",
               "score_bound")


def row_differs(row, res, b: int) -> list[str]:
    """Leaves of a served row that differ from row ``b`` of a direct
    search's results (bitwise)."""
    bad = []
    for name in ROW_LEAVES:
        got, want = getattr(row, name), getattr(res, name)
        if (got is None) != (want is None) or (
                want is not None and not np.array_equal(
                    got, want[b].cpu().numpy())):
            bad.append(name)
    for name in ROW_SCALARS:
        got, want = getattr(row, name), getattr(res, name)
        if (got is None) != (want is None) or (
                want is not None and got != want[b].item()):
            bad.append(name)
    return bad


def serve_profiles(eng, queries, ngrams):
    """(name, profile, distinct queries) of phase 13, the deadline profile
    first: it runs on the heap core, whose cost the us/pop estimator learns
    from its own exhaustive warmup batches."""
    from repro_torch.serve import QueryProfile
    return [
        ("dr-or-heap-deadline", QueryProfile(mode="or", k=K,
                                             deadline_ms=DEADLINE_MS,
                                             sla="bounded"), queries),
        ("dr-or-mega", QueryProfile(mode="or", k=K, mega=True), queries),
        ("dr-and-mega", QueryProfile(mode="and", k=K, mega=True), queries),
        ("drb-or-bm25", QueryProfile(mode="or", measure="bm25", k=K,
                                     df_cap=eng.suggested_df_cap(queries)),
         queries),
        ("drb-and-tfidf", QueryProfile(mode="and", strategy="drb", k=K),
         queries),
        ("phrase-tfidf", QueryProfile(mode="phrase", k=K), ngrams),
    ]


def serve_one(eng, name, profile, distinct, *, device: str, open_qps=None
              ) -> dict:
    """One profile through a fresh ``SearchServer`` with metrics on: warmup,
    then a closed loop (or an open loop at ``open_qps``), every distinct
    query's served row against a direct search, launches per served batch
    against a direct batch's, and the device's busy share over a closed
    loop without cache."""
    import torch
    import repro_torch.obs as obs
    from repro_torch.kernels import backend
    from repro_torch.serve import SearchServer, loadgen

    reg = obs.Registry(enabled=True)
    server = SearchServer(eng, max_batch=SERVE_BATCH, registry=reg)
    server.warmup(distinct, profile)
    traces0 = sum(eng.stats["traces"].values())
    workload = loadgen.zipf_workload(distinct, SERVE_REQUESTS, seed=SEED)
    before = backend.launch_counts()
    with server:
        if open_qps is None:
            rep = loadgen.closed_loop(server, workload,
                                      n_workers=SERVE_WORKERS,
                                      profile=profile)
        else:
            rep = loadgen.open_loop(server, workload, target_qps=open_qps,
                                    profile=profile, seed=SEED)
        after = backend.launch_counts()
        dispatches = server.stats["dispatches"]
        built = sum(eng.stats["traces"].values()) - traces0
        tickets = [server.submit(q, profile) for q in distinct]
        rows = [t.result(120.0) for t in tickets]
    st = rep.server_stats
    check(rep.n_shed == 0 and rep.n_err == 0 and rep.n_timeout == 0
          and rep.n_ok == SERVE_REQUESTS,
          f"{name}: {rep.n_ok} ok, {rep.n_shed} shed, {rep.n_err} errors, "
          f"{rep.n_timeout} timeouts of {SERVE_REQUESTS}")
    check(built <= (4 if profile.deadline_ms is not None else 0),
          f"{name}: {built} executors built after warmup")

    # every distinct query's served row == a direct search of the same query
    # under the same effective profile (the port's results are bitwise
    # equal across batch shapes, so the direct searches go 8 at a time)
    groups = {}
    for q, t, row in zip(distinct, tickets, rows):
        groups.setdefault(t.profile, []).append((q, row))
    budgets = sorted({str(p.budget) for p in groups})
    for eff, items in groups.items():
        for at in range(0, len(items), SERVE_BATCH):
            chunk = items[at:at + SERVE_BATCH]
            res = eng.search([q for q, _ in chunk], **eff.search_kwargs())
            for b, (q, row) in enumerate(chunk):
                bad = row_differs(row, res, b)
                check(not bad, f"{name}: served row of {q} differs from "
                      f"direct search on {bad}")

    # launches per served batch == a direct batch's
    loop = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    eff = tickets[0].profile
    b0 = backend.launch_counts()
    eng.search(distinct[:SERVE_BATCH], **eff.search_kwargs())
    direct = {k: v - b0[k] for k, v in backend.launch_counts().items()
              if v > b0[k]}
    check(dispatches > 0, f"{name}: no batch was dispatched")
    if device == "cuda":          # the plain versions launch nothing
        check(set(loop) == set(direct) and loop,
              f"{name}: served batches launched {loop} in {dispatches} "
              f"batches, a direct batch {direct}")
        if name == "phrase-tfidf":
            check(loop["wtbc_locate"] == loop["wtbc_decode"] >= dispatches,
                  f"{name}: {loop} in {dispatches} batches (one wtbc_locate "
                  "and one wtbc_decode per pass)")
        elif "heap" not in name:
            check(all(loop[k] == dispatches * direct[k] for k in loop),
                  f"{name}: {loop} in {dispatches} batches, a direct batch "
                  f"{direct}")
    per_batch = {k: v / dispatches for k, v in loop.items()}

    # the device's busy share over one closed loop of a server without
    # cache (every request dispatched), the server's start and stop outside
    def busy_loop(srv):
        r = loadgen.closed_loop(srv, distinct[:32], n_workers=SERVE_WORKERS,
                                profile=profile)
        check(r.n_ok == 32, f"{name}: busy loop served {r.n_ok} of 32")
    busy_ms, wall = 0.0, float("nan")
    with SearchServer(eng, max_batch=SERVE_BATCH, cache_size=0) as srv:
        if device == "cuda":
            busy_ms, wall = profile_device(lambda: busy_loop(srv), 1)
    stages = rep.stages or {}
    # shares of a dispatched request's time (cache hits have no stages)
    parts = ("queue_wait", "device", "slice")
    total = sum(stages[k]["mean_ms"] for k in parts if k in stages)
    frac = [g.value for g in reg.find("repro_roofline_achieved_frac")]
    out = {"p50_ms": rep.p50_ms, "p95_ms": rep.p95_ms, "p99_ms": rep.p99_ms,
           "qps": rep.qps, "n_ok": rep.n_ok, "duration_s": rep.duration_s,
           "mean_batch": st["mean_batch"], "batch_hist": st["batch_hist"],
           "cache_hit_rate": st["cache"]["hit_rate"],
           "dispatches": dispatches, "executors_after_warmup": built,
           "budgets": budgets, "degraded": rep.n_degraded,
           "certified_fraction": rep.certified_fraction,
           "stages_ms": {k: {m: v[m] for m in ("p50_ms", "p99_ms",
                                               "mean_ms")}
                         for k, v in stages.items()},
           "stage_share": {k: stages[k]["mean_ms"] / total for k in parts
                           if k in stages},
           "roofline_achieved_frac": frac[0] if frac else None,
           "launches": loop, "launches_per_batch": per_batch,
           "busy_loop_device_ms": busy_ms, "busy_loop_wall_ms": wall,
           "idle_share": 1.0 - busy_ms / wall if wall == wall else None}
    log(f"serve {name}{'' if open_qps is None else f' open {open_qps:.0f}'}"
        f": {rep.summary()} | mean batch {st['mean_batch']:.2f}, cache hit "
        f"rate {st['cache']['hit_rate']:.3f}, budgets {budgets}, launches "
        f"per batch {per_batch}, stage shares "
        + json.dumps({k: round(v, 4) for k, v in out['stage_share'].items()})
        + f", roofline {out['roofline_achieved_frac']}, idle share "
        f"{out['idle_share']}")
    return out


def serving_phase(engine, device: str = "cuda") -> dict:
    """Phase 13: the engine saved as a snapshot and loaded back onto the
    card (every array bitwise), served through ``SearchServer`` under six
    profiles and an open loop, then the CLI booted twice (build + save,
    then from the snapshot)."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.serve import loadgen, snapshot

    tmp = Path(tempfile.mkdtemp(prefix="wtbc-serve-"))
    try:
        # ---- 13a. snapshot round trip
        t0 = time.perf_counter()
        path = snapshot.save(engine, tmp / "snap")
        t_save = time.perf_counter() - t0
        disk = sum(p.stat().st_size for p in path.iterdir())
        t0 = time.perf_counter()
        eng = snapshot.load(tmp / "snap", device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        live, loaded = engine_arrays(engine), engine_arrays(eng)
        bad = [n for (n, a), (_, b) in zip(live, loaded)
               if not same_value(a, b)]
        check(not bad, f"snapshot round trip differs on {bad}")
        on_card = eng.space_report()["total"]
        snap = {"save_s": t_save, "load_s": t_load, "disk_bytes": disk,
                "device_bytes": on_card, "leaves": len(live)}
        log(f"snapshot: saved in {t_save:.3f} s ({disk} bytes on disk), "
            f"loaded onto {eng.device} in {t_load:.3f} s ({on_card} bytes on "
            f"the device); {len(live)} arrays and integers bitwise equal")

        # ---- 13b. the server under six profiles and an open loop
        queries = loadgen.sample_queries(eng, SERVE_DISTINCT, 3, seed=SEED)
        ngrams = loadgen.sample_ngram_queries(eng, SERVE_DISTINCT, 3,
                                              seed=SEED)
        profiles = {}
        for name, profile, distinct in serve_profiles(eng, queries, ngrams):
            profiles[name] = serve_one(eng, name, profile, distinct,
                                       device=device)
        mega_or = serve_profiles(eng, queries, ngrams)[1]
        qps = profiles[mega_or[0]]["qps"] / 2
        profiles["dr-or-mega-open"] = serve_one(
            eng, "dr-or-mega-open", mega_or[1], queries, device=device,
            open_qps=qps)
        profiles["dr-or-mega-open"]["target_qps"] = qps

        # ---- 13c. the CLI: build + save, then boot from the snapshot
        cli = {}
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                              .parent / "src"))
        base = [sys.executable, "-m", "repro_torch.launch.serve",
                "--device", device, "--requests", "200", "--max-batch", "8",
                "--smoke", "--snapshot-dir", str(tmp / "cli")]
        for label, extra in (("build", ["--docs", "2000", "--save-snapshot"]),
                             ("boot", [])):
            t0 = time.perf_counter()
            r = subprocess.run(base + extra, capture_output=True, text=True,
                               env=env, timeout=400,
                               cwd=Path(__file__).resolve().parent)
            secs = time.perf_counter() - t0
            tail = (r.stdout + r.stderr)[-3000:]
            check(r.returncode == 0 and "smoke: PASS" in r.stdout,
                  f"CLI {label} run failed (exit {r.returncode}):\n{tail}")
            built = "building corpus" in r.stdout
            check(built == (label == "build"),
                  f"CLI {label} run {'built' if built else 'did not build'} "
                  f"an index:\n{tail}")
            summary = [ln for ln in r.stdout.splitlines()
                       if " ok / " in ln or ln.startswith("batch sizes")]
            cli[label] = {"s": secs, "summary": summary}
            log(f"CLI {label}: smoke: PASS in {secs:.1f} s; "
                + " | ".join(summary))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"snapshot": snap, "profiles": profiles, "cli": cli}


# ---------------------------------------------------------------------------
# document-sharded search (phase 14)
# ---------------------------------------------------------------------------

N_SHARDS = 4


def sharded_phase(engine, cp, batches, single_dr, single_ms,
                  device: str = "cuda") -> dict:
    """Phase 14: ``SearchEngine.shard`` over the same corpus (default
    placement: every shard on the one card), its searches as a user calls
    them against the single engine, the budgeted batch's certification,
    snippets, launches per batch, a snapshot round trip, one served
    profile and the CLI with ``--shards``.  ``single_dr`` holds phase 5's
    (mode, band, q, budget, heap P=1 result) and ``single_ms`` its ms per
    batch by core."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.core import distributed, drb, ranked, wtbc
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import backend
    from repro_torch.serve import QueryProfile, loadgen, snapshot
    from repro_torch.text import corpus as tcorpus
    on_card = device == "cuda"

    # ---- 14a. the build --------------------------------------------------
    t0 = time.perf_counter()
    eng = SearchEngine.shard(cp, N_SHARDS, EngineConfig(block=BLOCK),
                             device=None if on_card else "cpu")
    _sync(device)
    t_build = time.perf_counter() - t0
    sh = eng.sharded
    bases = sh.bases
    parts = eng.shard_space_reports()
    single_bytes = engine.space_report()["total"]
    shards = [{"device": str(i.device), "first_doc": b, "docs": i.n_docs,
               "tokens": i.n - i.n_docs, "device_bytes": r["total"]}
              for i, b, r in zip(sh.idx, bases, parts)]
    log(f"sharded: {N_SHARDS} shards built on the host in {t_build:.2f} s "
        f"(index and tf bitmaps); devices "
        f"{sorted({s_['device'] for s_ in shards})}")
    for s, row in enumerate(shards):
        log(f"  shard {s}: documents [{row['first_doc']}, "
            f"{row['first_doc'] + row['docs']}) ({row['docs']} docs, "
            f"{row['tokens']} tokens), {row['device_bytes']} bytes on "
            f"{row['device']}")
    log(f"sharded bytes on the device {sum(p_['total'] for p_ in parts)} "
        f"beside the single engine's {single_bytes}")
    check(eng.n_docs == engine.n_docs and all(
        i.device.type == device for i in sh.idx), "shard placement")

    # ---- 14b. the sharded path as a user calls it ---------------------------
    doc_q = doc_batch(cp, engine, np.random.default_rng(SEED + 5),
                      tcorpus.fdoc_bands(cp.n_docs)["ii"], B)
    drb_batches = [(m, b, q) for m, b, q in batches] + [("and", "doc", doc_q)]
    warm = [list(map(int, batches[0][2][0]))]
    for mode in ("and", "or"):
        for prof in (dict(), dict(beam_width=16)):
            eng.warmup(warm, max_batch=B, k=K, mode=mode, **prof)
            eng.warmup(warm, max_batch=B, k=K, mode=mode, budget=64, **prof)
        for meas in ("tfidf", "bm25"):
            eng.warmup(warm, max_batch=B, k=K, mode=mode, strategy="drb",
                       measure=meas)
    traces = dict(eng.stats["traces"])
    backend.reset_launch_counts()
    ms = {"dr P=1": [], "dr P=16": [], "drb tfidf": [], "drb bm25": []}
    launches = {k_: [] for k_ in ms}
    results = []

    def run(label, q, **kw):
        before = backend.launch_counts()
        t, res = wall_ms(lambda: eng.search(q, k=K, **kw), device)
        after = backend.launch_counts()
        ms[label].append(t)
        launches[label].append({k_: after[k_] - before[k_] for k_ in after
                                if after[k_] > before[k_]})
        return res

    def same(a, b, what):
        for leaf in ("docs", "scores", "n_found"):
            check(torch.equal(getattr(a, leaf).cpu(), getattr(b, leaf).cpu()),
                  f"sharded differs from the single engine on {leaf} "
                  f"({what})")

    budgeted = None
    exact = {(m, b): r for m, b, _, budget, r in single_dr if budget is None}
    for mode, band, q, budget, single in single_dr:
        for label, prof in (("dr P=1", {}), ("dr P=16", {"beam_width": 16})):
            res = run(label, q, mode=mode, budget=budget, **prof)
            if budget is None:
                same(res, single, f"{label} {mode} band {band}")
            elif label == "dr P=1":
                budgeted = (q, budget, res, exact[mode, band])
    check(eng.stats["traces"] == traces, "sharded DR executors were built "
          "after warmup")
    for mode, band, q in drb_batches:
        for label, meas in (("drb tfidf", "tfidf"), ("drb bm25", "bm25")):
            res = run(label, q, mode=mode, strategy="drb", measure=meas)
            same(res, engine.search(q, k=K, mode=mode, strategy="drb",
                                    measure=meas),
                 f"{label} {mode} band {band}")
            results.append((mode, band, meas, q, res))
    # snippets of every hit of every DRB batch, from each hit's own shard
    snip_launch, hits_seen = [], set()
    for mode, band, meas, q, res in results:
        before = backend.launch_counts()
        sn = eng.snippets(res, length=8)
        after = backend.launch_counts()
        holders = set()
        for b in range(B):
            for (d, _), words in zip(res.hits(b), sn[b]):
                check(np.array_equal(words, cp.doc_tokens[d][:8]),
                      f"sharded snippet of document {d} differs from its "
                      "tokens")
                holders.add(int(np.searchsorted(bases, d, "right")) - 1)
        hits_seen |= holders
        snip_launch.append({k_: after[k_] - before[k_] for k_ in after
                            if after[k_] > before[k_]})
        if on_card:
            check(snip_launch[-1] == ({"wtbc_decode": len(holders)}
                                      if holders else {}),
                  f"snippets launched {snip_launch[-1]} for hits on "
                  f"{len(holders)} shards")
    counts = backend.launch_counts()
    log("sharded path launches: " + json.dumps(counts))
    if on_card:
        for label in ms:
            for got in launches[label]:
                if label.startswith("dr "):
                    check(set(got) == {"wavelet_count"},
                          f"{label} batch launched {got}: K1 only, no K2")
                else:
                    check(set(got) <= {"drb_walk", "drb_or"} and
                          sum(got.values()) == N_SHARDS and
                          len(got) == 1,
                          f"{label} batch launched {got}: one drb_walk or "
                          f"drb_or per shard")
        for k_ in ("wavelet_count", "drb_walk", "drb_or", "wtbc_decode"):
            check(counts[k_] > 0, f"{k_} never launched on the sharded path")
        check(counts["beam_loop"] == 0, "the sharded path launched beam_loop")
    check(len(hits_seen) > 1, f"snippet hits on shards {hits_seen} only")

    # the budgeted batch: merged certified / bound against the shards' own
    q, budget, res, exact = budgeted
    r_, m_ = eng._encode_queries(q)
    wt, mt = torch.from_numpy(r_), torch.from_numpy(m_)
    idf = eng._idf_table(eng._resolve_measure("tfidf"))
    per = [ranked.topk_dr_batch(i, wt.to(i.device), mt.to(i.device),
                                idf.to(i.device), k=K, conjunctive=False,
                                heap_cap=eng._heap_cap, max_pops=budget)
           for i in sh.idx]
    bound = torch.stack([p_.bound.cpu() for p_ in per]).amax(0)
    over = torch.stack([p_.overflowed.cpu() for p_ in per]).any(0)
    gathered = torch.cat([p_.scores.cpu() for p_ in per], 1)
    dropped = torch.sort(gathered, 1, descending=True).values[:, K]
    s_ = res.scores.cpu()
    want = (s_ > bound[:, None]) & ~over[:, None] & (s_ > -np.inf)
    check(torch.equal(res.certified.cpu(), want),
          "budgeted sharded batch: certified is not strict against the max "
          "shard bound")
    check(torch.equal(res.score_bound.cpu(), torch.maximum(bound, dropped)),
          "budgeted sharded batch: the bound does not cover the dropped "
          "candidate")
    cert = res.certified.cpu()
    for b in range(B):
        nc = int(cert[b].sum())
        check(bool(cert[b, :nc].all()) and torch.equal(
            res.docs[b, :nc].cpu(), exact.docs[b, :nc].cpu()),
            f"budgeted sharded row {b}: certified slots differ from the "
            "exact answer")
    log(f"sharded budget {budget} (or iii): certified per row "
        f"{cert.sum(1).tolist()}, bound {res.score_bound.tolist()}, pops "
        f"{res.pops.tolist()}")

    # ms per batch, sharded against single, and the merge's own time
    single_drb = {"drb tfidf": [], "drb bm25": []}
    for mode, band, q in drb_batches:
        for label, meas in (("drb tfidf", "tfidf"), ("drb bm25", "bm25")):
            single_drb[label].append(wall_ms(lambda: engine.search(
                q, k=K, mode=mode, strategy="drb", measure=meas), device)[0])
    versus = {"dr P=1": single_ms["P=1"], "dr P=16": single_ms["P=16"],
              **single_drb}
    for label in ms:
        log(f"sharded {label}: ms per batch " +
            ", ".join(f"{x:.2f}" for x in ms[label]) + " (single: " +
            ", ".join(f"{x:.2f}" for x in versus[label]) + ")")
    mode, band, q = drb_batches[3]                    # or, band iii
    r_, m_ = eng._encode_queries(q)
    meas = eng._resolve_measure("bm25")
    cap = eng._df_cap(r_, m_)
    shard_res = [drb.topk_drb_or(i, a, torch.from_numpy(r_).to(i.device),
                                 torch.from_numpy(m_).to(i.device), meas,
                                 k=K, max_df_cap=cap, idf=t_, avg_dl=avg)
                 for i, a, t_, avg in zip(sh.idx, sh.aux,
                                          eng._shard_idf(meas),
                                          sh.replicate(sh.global_avg_dl))]

    def merge():
        return distributed.merge_topk(shard_res, bases, k=K,
                                      device=sh.devices[0], has_pad=False)
    check(torch.equal(merge().docs, eng.search(
        q, k=K, mode="or", strategy="drb", measure="bm25").docs),
        "merge of the shards' DRB or results differs from the search")
    merge_ms = merge_wall = None
    if on_card:
        merge_ms, merge_wall = profile_device(merge, 50)
        log(f"merge (B={B}, {N_SHARDS} x k={K}): {merge_ms:.6f} ms of device "
            f"time, {merge_wall:.4f} ms per call on the host")

    # ---- 14c. snapshot round trip -------------------------------------------
    tmp = Path(tempfile.mkdtemp(prefix="wtbc-sharded-"))
    try:
        t0 = time.perf_counter()
        path = snapshot.save(eng, tmp / "snap")
        t_save = time.perf_counter() - t0
        disk = sum(p_.stat().st_size for p_ in path.iterdir())
        t0 = time.perf_counter()
        loaded = snapshot.load(tmp / "snap", device=None if on_card
                               else "cpu")
        _sync(device)
        t_load = time.perf_counter() - t0
        check(loaded.backend == "sharded" and [
            str(i.device) for i in loaded.idx] == [
            str(i.device) for i in sh.idx], "sharded snapshot placement")
        names = ("docs", "scores", "n_found", "work", "pops", "overflowed",
                 "padded", "certified", "score_bound")
        for mode, band, meas, q, res in results:
            again = loaded.search(q, k=K, mode=mode, strategy="drb",
                                  measure=meas)
            bad = [n for n in names if (getattr(res, n) is None) != (
                getattr(again, n) is None) or (getattr(res, n) is not None
                and not torch.equal(getattr(res, n), getattr(again, n)))]
            check(not bad, f"loaded sharded snapshot differs on {bad} "
                  f"({mode} band {band} {meas})")
        a = eng.search(batches[0][2], k=K, mode="and", beam_width=16)
        b_ = loaded.search(batches[0][2], k=K, mode="and", beam_width=16)
        check(torch.equal(a.docs, b_.docs) and torch.equal(a.scores,
                                                             b_.scores),
              "loaded sharded snapshot differs on DR and ii")
        snap = {"save_s": t_save, "load_s": t_load, "disk_bytes": disk,
                "device_bytes": loaded.space_report()["total"]}
        log(f"sharded snapshot: saved in {t_save:.3f} s ({disk} bytes on "
            f"disk), loaded in {t_load:.3f} s; answers bitwise equal")

        # ---- 14d. one served profile on the loaded engine ------------------
        queries = loadgen.sample_queries(loaded, SERVE_DISTINCT, 3,
                                         seed=SEED)
        profile = QueryProfile(mode="or", measure="bm25", k=K,
                               df_cap=loaded.suggested_df_cap(queries))
        served = serve_one(loaded, "sharded-drb-or-bm25", profile, queries,
                           device=device)
        if on_card:
            check(served["launches_per_batch"] == {"drb_or": N_SHARDS},
                  f"served sharded batches launched "
                  f"{served['launches_per_batch']}")

        # ---- 14e. the CLI with --shards ------------------------------------
        env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve()
                                              .parent / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--shards",
               str(N_SHARDS), "--docs", "2000", "--requests", "200",
               "--max-batch", "8", "--smoke", "--device", device]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=400, cwd=Path(__file__).resolve().parent)
        secs = time.perf_counter() - t0
        tail = (r.stdout + r.stderr)[-3000:]
        check(r.returncode == 0 and "smoke: PASS" in r.stdout,
              f"CLI --shards {N_SHARDS} failed (exit {r.returncode}):\n{tail}")
        summary = [ln for ln in r.stdout.splitlines()
                   if " ok / " in ln or ln.startswith("batch sizes")]
        log(f"CLI --shards {N_SHARDS}: smoke: PASS in {secs:.1f} s; "
            + " | ".join(summary))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"build_s": t_build, "shards": shards,
            "single_device_bytes": single_bytes, "ms_per_batch": ms,
            "single_ms_per_batch": versus, "launches_per_batch": launches,
            "snippet_launches": snip_launch, "launches": counts,
            "merge_device_ms": merge_ms, "merge_wall_ms": merge_wall,
            "snapshot": snap, "served": served,
            "cli": {"s": secs, "summary": summary}}


if __name__ == "__main__":
    sys.exit(main())
