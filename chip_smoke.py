#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (WTBC-DR, WTBC-DRB,
positional search, the serving stack, document-sharded search, the
quickstart, the LM serving path, the recsys towers and EGNN, training, the
paper's deployment with the dry run, and expert-parallel MoE at full
width).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the full run (86,445 documents)
    python3 chip_smoke.py --docs 4000   # a short rehearsal of every phase

Phases (any failure exits non-zero; no phase is caught and ignored, and
nothing falls back to the CPU):

1. build  — compile the eleven CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all at once); print the card's name and power
   limit.
2. data   — a quarter of the paper's ALL collection (718,691-word vocabulary,
   Zipf 1.2, mean 633 tokens per document): 86,445 documents, about 55 M
   tokens, drawn from a seed in one vectorized draw; index built on the
   host at block 4096 and moved to the card.
3. K1     — ``wavelet_count`` against its plain version on the card: 4,096
   random triples (with lo = hi and hi = n), triples whose endpoints land
   on tile edges of levels 0 and 1 (where the nearer-end rank switches
   sides), plus every triple of the plain heap (P = 16) and mega loops'
   trips; bitwise.
4. K2     — ``beam_loop`` (the mega core's whole loop) against its plain
   loop on the card: four batches of B = 8 (and/or x df bands ii/iii,
   Q = 3 words, k = 10) plus a budgeted batch; every leaf bitwise.
4b. ``heap_loop`` (the heap core's whole loop at P >= 2) at P = 2, 3, 16
   and the P = 1 route (``beam_loop`` on the heap's pool) against the plain
   heap loop on the card, every leaf bitwise with ``padded``: the four
   batches, budgets of 64 and 9·P pops, a pool that overflows, rows of 2
   and 6 words (Q buckets 2 and 8).
5. main path — launch counters reset, then ``warmup`` and ``search`` as a
   user calls them: the heap core at P = 1 and P = 16 and the mega core;
   heap P = 1 equals mega on every leaf and P = 16 equals them on the
   answers, two queries agree with a brute-force scoring of every
   document, executor counts stay flat after warmup, and every batch was
   one K1 launch (the root tf) and one search loop: ``beam_loop`` (heap
   P = 1, mega) or ``heap_loop`` (P = 16).
6. timings — CUDA-event times per launch of each kernel and of its plain
   version at the main path's shapes, the least time the card could take
   for the same work (bytes at 3.35 TB/s, byte compares at 1,979 TOPS; a
   rank needs the nearer end of its tile, ``near_bytes``), and ms per
   batch per core; ``heap_loop`` at P = 16 on the ``or`` iii batch also
   cold (after an L2 flush).
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
   per served batch equal a direct batch's (K1 + ``beam_loop``, one
   ``drb_or`` / ``drb_walk``, one ``wtbc_locate`` + ``wtbc_decode`` per
   phrase pass); p50/p95/p99, QPS, mean batch, cache hit rate, the
   registry's stage shares, the live ``repro_roofline_achieved_frac``
   and the device's idle share over a closed loop without cache; for the
   deadline profile the budget it bought, the device stage's p50 and p99
   beside the deadline, and QPS (F3).  Then
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
   each DR batch one K1 and one ``beam_loop`` (P = 1) or ``heap_loop``
   (P = 16) per shard, each DRB batch one ``drb_walk``
   or ``drb_or`` per shard, each ``snippets`` call one ``wtbc_decode`` per
   shard holding a hit.  ms per batch, sharded against single, and the
   merge's own device time.  Then a sharded snapshot saved and loaded onto
   the card (answers bitwise equal), one closed-loop ``SearchServer``
   profile on the loaded engine (DRB ``or`` BM25, phase 13's traffic; one
   ``drb_or`` per shard per served batch), and ``python -m
   repro_torch.launch.serve --shards 4 --docs 2000 --smoke``.
15. the torch quickstart — ``examples/torch_quickstart.py`` as a user runs
   it on the card (K1, one ``drb_or``, one ``wtbc_decode``) and on the CPU:
   its DR ``and``, DRB ``or`` BM25 and snippet answers equal.
16. the LM serving path (plain PyTorch: it launches none of the port's
   kernels, and the run checks that).  (a) Every LM config at smoke size
   in float32 with TF32 off, the same weights on the card and on the CPU
   (``convert.lm_params_from_jax``): forward logits, prefill caches and 8
   decode steps within 1e-4 (relative to the logits' scale), and gemma2's
   smoke prefill at S = 2,048 (the blockwise attention).  (b) qwen3-1.7b at
   full width in bf16, random weights from a seeded generator on the card:
   ``prefill`` of 4 x 2,048 tokens, the caches placed into
   ``init_cache(cfg, 4, 2080)``'s rings, 32 greedy ``decode_step``s, then
   ``forward`` over the 2,080 tokens: every value finite, each step's
   logits within 0.25 of the forward's (worst step's mean within 0.03),
   the greedy tokens equal to its argmax wherever its top-2 margin exceeds
   0.5.  Prefill ms and tokens/s, decode ms per step and tokens/s, their
   bounds (bf16 operations; weight and cache bytes), the device's busy
   share, ``torch.cuda.max_memory_allocated``, and one layer's attention
   at the prefill's shapes against ``scaled_dot_product_attention`` (a
   yardstick, never on the path).
17. recsys and GNN (float32, TF32 off; launch counters reset before the
   phase; the main path's launches are tallied apart from the comparisons
   and timings, and are K6 alone, once per SASRec retrieval step).  (a)
   FM, xDeepFM, DLRM and SASRec at smoke size, the same weights on the
   card and on the CPU: ``serve`` and ``retrieval`` within 1e-5 of the
   scale (top-k indices equal wherever the scores lie further apart), SASRec's
   retrieval one ``scored_topk`` launch equal to its plain version on the
   card; EGNN ``forward`` / ``loss_fn`` on a Cora-like and a molecule
   graph.  (b) SASRec at full width (10^6 items, d 50, seq 50, 2 blocks):
   ``serve_p99`` (B = 512) and ``serve_bulk`` (B = 262,144) against the
   CPU, ``retrieval_cand`` over a seeded permutation of the 10^6 items —
   K6 bitwise its plain version, the top-100 against a float64 rescoring
   on the host —, the steps' CUDA-event times, K6 cold beside its bound and
   ``torch.topk(torch.mv(cands, h), 100)``, the gather, peak memory.  (c)
   FM and xDeepFM at full width: ``serve_p99`` against the CPU,
   ``retrieval_cand`` at C = 10^6 in chunks (FM: every score against the
   CPU's; xDeepFM: the returned 100 rescored, a sample of 4,096 on the
   CPU).  (d) DLRM-MLPerf at full widths with every table capped at 2^22
   rows (96.1 GB of tables do not fit the card's 80 GB; listed as
   ``reduced``): ``serve_p99`` against the CPU.  (e) EGNN at full width on
   Cora's sizes, a ``graph_sampler`` minibatch (1,024 seeds, fanout
   (15, 10), from a random graph of Reddit's 232,965 nodes) and 128
   molecules: ``forward`` and ``loss_fn`` against the CPU, a repeat bitwise,
   rotation and translation equivariance, forward ms.
18. training (plain PyTorch and autograd: it launches none of the port's
   kernels, and the run checks that).  (a) ``make_step(cfg, "train")`` of
   each of the ten smoke configs (five LMs, FM, xDeepFM, DLRM, SASRec,
   EGNN; float32, TF32 off) on the card and on the CPU from the same
   parameters, optimizer state and batch: loss, metrics, grad_norm and lr
   within 1e-5, 99.9% of the updated parameters within 1e-3 x lr and all
   within AdamW's step bound.  (b) ``run_with_restarts`` on qwen3's smoke
   config in bf16 on the card, failures at steps 3 and 11: the 14 losses
   and the final state bitwise the uninterrupted run's.  (c) ``python -m
   repro_torch.launch.train --arch qwen3-1.7b --steps 20``, then ``--steps
   25 --resume``: both end in ``done``, the second resumes from step 20.
   (d) qwen3-1.7b at full width and depth, bf16, remat, the default AdamW,
   B x S = 2 x 4,096 (train_4k's S; B cut from 256 by one card, printed as
   ``reduced``) from ``pipeline.lm_batch``, five steps on one batch: step
   0's loss equals the forward-only ``loss_fn`` (bf16 tolerance) and lies
   within 1.0 of ln V; step 0 twice from one state bitwise; grad_norm
   finite and lr equal to ``schedule`` every step; the loss falls from step
   0 to step 4; step 1's update on three sampled leaves (embedding rows, an
   attention and an MLP weight) within 1 bf16 ulp of a float64 AdamW from
   the saved g, m and v.  ms per step, tokens/s, the model FLOPs share of
   989 TFLOP/s (6 N tokens over the matmul weights, the remat forward,
   attention's four passes), device busy time and top kernels,
   ``torch.cuda.max_memory_allocated``, beside the card's name and power
   limit.  The bytes each placement adds on the card (parameters, AdamW
   state, batch) are kept for phase 19.
19. the paper's deployment and the dry run (launch counters reset before
   the phase; the main path's launches, the four query methods' batches,
   are tallied apart from the comparisons and timings).  (a)
   ``configs/wtbc_paper.py`` at block 32,768 (where a descent loops past
   one tile and a select takes several passes): 4 shards of its 6,750
   documents, 27,000 documents of ``quarter_all_corpus``'s generator
   (about 17 M tokens, ALL's 718,691-word vocabulary), built with
   ``build_sharded`` on the card, and a single index over the same
   documents with the same codes and DRB word set; 64 queries of 4 words
   from ``zipf_real_queries`` on the global df (``or``: over the words
   within the config's gather of 2,048 documents a shard, listed as
   ``reduced``),
   k = 10.  The four methods through
   ``WTBCPaperArch.make_query_fn``: docs, scores and n_found equal the
   single index's under the same cores and idf table, two rows each equal
   a host brute force over the tokens; ms per batch, launches per batch
   (DR one K1 and one ``beam_loop`` per shard, DRB one ``drb_walk`` /
   ``drb_or`` per shard), the idle share of each method's first batch
   (traced with device activity only).  Each shard's bytes on the card beside
   ``abstract_sharded``'s per device, leaf by leaf (names and dtypes
   equal); the fitted (s, c) beside the config's.  K1 at two trips,
   ``drb_walk`` on 8 rows and ``drb_or`` on 2 against their plain versions
   bitwise at this block; K1's µs per launch beside phase 6's at 4,096.
   (b) ``dryrun.argument_leaves`` of qwen3-1.7b's ``train_4k`` at phase
   18's B = 2 on ``make_local_mesh()``: parameters, AdamW state and batch
   equal the card's requested bytes of phase 18's placements exactly, and
   ``memory_allocated``'s growth within the allocator's rounding.  (c)
   ``dryrun.run`` of the ``wtbc`` and qwen3-1.7b cells on the single-pod
   mesh and their roofline rows.
20. MoE at full width, expert-parallel (plain PyTorch: it launches none of
   the port's kernels, and the run checks that).  (a) The llama4-scout and
   qwen3-moe smoke configs in float32 under (data, model) = (1, 4) and
   (2, 2), every shard on the card, against the CPU: ``forward``,
   ``prefill``, 4 ``decode_step``s and one train step through EP, which
   the same step on experts placed per shard equals; one MoE layer on a
   batch that overflows the dense capacity but not EP's: EP
   card == CPU, and EP differs from the dense dispatch.  (b) qwen3-moe-235b
   and (c) llama4-scout at full width cut to 4 layers (llama4: one pattern
   group, three chunked layers and a global one), bf16, random weights,
   EP over 4 shards of 32 / 4 experts placed on ``cuda:0`` by
   ``place_experts`` (views: nothing copied): ``prefill`` of 2 x 4,096
   (C = 1,280 a local expert), 32 greedy ``decode_step``s, ``forward`` over
   the extended sequence; decode against forward as 16b on the tokens
   routed alike in every layer with every copy kept (a top-k tie broken
   the other way by bf16 noise moves a token by a whole expert; those are
   counted); one layer's EP at M = 4 against M = 1 (the same slots) and
   the dense dispatch, 16 of its tokens against a float64 recomputation on
   the host (``MOE_F64_REL``); prefill ms at M = 4, M = 1 and dense, decode
   ms a step, the device's busy share and top kernels of one prefill,
   ``max_memory_allocated``, beside the card's name and power limit.  Each
   model is freed before the next.
21. The two search examples and the dry run's collectives.  (a)
   ``examples/torch_search_engine.py`` and
   ``examples/torch_distributed_retrieval.py`` (8 shards on ``cuda:0``):
   ``run("cuda")`` against ``run("cpu")``, every answer leaf bitwise, at a
   cut size (``EXAMPLE_SEARCH``, ``EXAMPLE_SHARDED``); the launches of the
   card's runs, counts reset just before (K1, ``beam_loop``, ``heap_loop``,
   ``drb_walk``, ``drb_or``, ``wtbc_locate`` and ``wtbc_decode`` each at
   least once).  (b) the dry
   run's ``wtbc`` cells on a one-axis mesh of phase 19's 4 shards at each
   method's phase-19 batch and k: the all-gather bytes equal what
   ``merge_topk`` took from the shards there (the numel x element size of
   the gathered documents and scores, recorded by phase 19).  (c) the
   ``wtbc`` and EP collective rows on both production meshes, beside the
   card's name and power limit (NVLink's rate is a data-sheet figure).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
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
# the leaves two DR cores share: heap P = 1 and mega pop, emit and push
# alike (every leaf); heap P = 16 emits the same answers exactly
MEGA_LEAVES = ("docs", "scores", "n_found", "work", "pops", "overflowed",
               "certified", "score_bound")
WIDE_LEAVES = ("docs", "scores", "n_found", "overflowed", "certified")
HEAP_LEAVES = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
               "padded", "certified", "bound")
HEAP_PS = (2, 3, 16)     # heap_loop's beam widths in phase 4b (3: buckets
                         # 1, 2, 3, not all pow2)
HEAP_WIDE_PS = (32, 64)  # and past one warp's 32 lanes (the block-wide
                         # pop, emission and push scans)
HEAP_SMALL_CAP = 2       # a pool that overflows (the root fills a slot)


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
    """The least time K6 could take (``topk_score.work``): its inputs read
    once (the candidates, the mask, q) and its (B, k) outputs written,
    against the float32 multiply-adds of every row's dot."""
    from repro_torch.kernels import topk_score
    B = cands.shape[0] if cands.dim() == 3 else 1
    C, d = cands.shape[-2:]
    nbytes, ops = topk_score.work(B, C, d, cands.element_size(), k,
                                  valid is not None)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
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


def host_bruteforce(tokens, ends, n_docs: int, words, *, mode: str, k: int,
                    measure: str = "bm25", eps: float | None = 1e-6,
                    k1: float = 1.2, b: float = 0.75):
    """Top-k BM25 (or tf-idf) of one query by scoring every document on the
    host, in numpy float32 from the corpus's own tokens, independent of the
    program: ``tokens`` the concatenated documents, ``ends`` their
    cumulative lengths.  Per word: tf per document (its token positions
    binned by document), df, the idf — BM25's (the argument in float32
    steps, the log in float64, rounded to float32) or tf-idf's ln(N / df)
    (the quotient and the log in float64, rounded to float32: a sharded
    build's global table) — and the DRB word rule (a word with ln(N / df) <
    eps has no bitmap and drops out; ``eps=None``: DR keeps every word);
    avg_dl the exact integer sum of the lengths over N in float32.  BM25's
    per-word part is ``tf (k1 + 1) / (tf + k1 ((1 - b) + b (dl /
    avg_dl)))``, one rounded float32 operation at a time, tf-idf's is tf;
    the score the parts times the idfs added left to right.  Eligible:
    ``and`` every kept word occurs, ``or`` some kept word occurs; ties go to
    the lower document.  Returns (docs, scores) padded with -1 / -inf to
    k."""
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
        if eps is not None and not np.log(max(n_docs, 1) / df) >= eps:
            continue                     # no bitmap: the word drops out
        dff = f32(df)
        tff = tf.astype(f32)
        if measure == "tfidf":
            idf = f32(np.log(n_docs / df))
            part = tff
        else:
            idf = f32(np.log(np.float64(f32(1.0) + (n - dff + f32(0.5))
                                        / (dff + f32(0.5)))))
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
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        # the script copied out of the repository, without the port
        print(f"chip_smoke: the port is not beside this script ({src} has no "
              "repro_torch); run it from the repository's root",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
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
    # the plain heap loop's trips (on the card the heap core calls K1 only
    # for the root tf: its trips run inside heap_loop)
    with OpsRecorder() as rec16:
        ranked.topk_dr_batch(idx, words_t, wmask_t, idf, k=K, conjunctive=False,
                             heap_cap=2 * idx.n_docs + 4, beam_width=16,
                             max_pops=9 * 16, kernel_backend="ref")
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

    # ---- 4b. heap_loop and the P = 1 route against the plain heap loop -----
    t4b = time.perf_counter()
    heap_err = heap_phase(engine, batches, df_word, bands, idf)
    t4b = time.perf_counter() - t4b
    log(f"phase 4b: {t4b:.1f} s")

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
        # heap P = 1 and mega pop, emit and push alike: every leaf; P = 16
        # emits the same answers exactly but pops more (a budget is enforced
        # per trip, so it may pop past one): its answers when unbudgeted
        pairs = [("mega", MEGA_LEAVES)]
        if budget is None:
            pairs.append(("P=16", WIDE_LEAVES))
        for label, leaves in pairs:
            bad = leaves_equal(outs["P=1"], outs[label], leaves)
            check(not bad, f"{label} core differs from P=1 on {bad} ({mode}, "
                  f"band {band}, budget {budget})")
        results.append((mode, band, q, budget, outs["P=1"]))
        log(f"main path {mode} band {band} budget {budget}: ms/batch " +
            ", ".join(f"{c} {core_ms[c][-1]:.2f}" for c in core_ms) +
            f"; n_found {outs['P=1'].n_found.tolist()}")
    counts = backend.launch_counts()
    log("main path launches: " + json.dumps(counts))
    # every DR batch is the whole search in kernels: one K1 (the root tf)
    # and one search loop, beam_loop (heap P = 1, mega) or heap_loop (P = 16)
    expect = {"P=1": {"wavelet_count": 1, "beam_loop": 1},
              "P=16": {"wavelet_count": 1, "heap_loop": 1},
              "mega": {"wavelet_count": 1, "beam_loop": 1}}
    for label, per in per_batch.items():
        for got in per:
            check({k_: v for k_, v in got.items() if v} == expect[label],
                  f"{label} batch launched {got}, expected {expect[label]}")
    for name in ("wavelet_count", "beam_loop", "heap_loop"):
        check(counts[name] > 0, f"{name} never launched")
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

    kernels.append(heap_loop_row(idx, wt, mt, idf, counts["heap_loop"]))
    kernels[-1]["max_abs_err"] = heap_err

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

    phase_s = {"1-6": time.perf_counter() - t_start, "4b (in 1-6)": t4b}

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
    quick = timed_phase("15", quickstart_phase)
    lm = timed_phase("16", lm_phase)
    rs = timed_phase("17", recsys_phase)
    row["scored_topk"]["sasrec_retrieval"] = rs["sasrec"]["k6"]
    tr = timed_phase("18", train_phase)
    # a --docs rehearsal draws that many documents for the deployment too
    dep = timed_phase("19", deploy_phase, "cuda",
                      None if args.docs == QUARTER_DOCS else args.docs,
                      kernels[0]["ms"], tr["qwen3-1.7b"]["placed"])
    moe_run = timed_phase("20", moe_phase)
    ex = timed_phase("21", collectives_phase, dep)
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
        k_["quickstart_launches"] = quick["launches"][k_["name"]]
        k_["lm_launches"] = lm["launches"][k_["name"]]
        k_["recsys_launches"] = rs["launches"][k_["name"]]
        k_["train_launches"] = tr["launches"][k_["name"]]
        k_["deploy_launches"] = dep["launches"][k_["name"]]
        k_["moe_launches"] = moe_run["launches"][k_["name"]]
        k_["examples_launches"] = ex["launches"][k_["name"]]
    log(json.dumps({"serving": serving}))
    log(json.dumps({"sharded": sharded}))
    log(json.dumps({"quickstart": quick}))
    log(json.dumps({"lm": lm}))
    log(json.dumps({"recsys": rs}))
    log(json.dumps({"train": tr}))
    log(json.dumps({"deploy": dep}))
    log(json.dumps({"moe": moe_run}))
    log(json.dumps({"collectives_examples": ex}))
    log(json.dumps({"launches": counts,
                    "kernels": [k["name"] for k in kernels]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def heap_phase(engine, batches, df_word, bands, idf) -> int:
    """Phase 4b: ``heap_loop`` (P = 2, 3, 16, 32, 64) and the P = 1 route
    (``beam_loop`` on the heap's pool) against the plain heap loop on the
    card (``kernel_backend="ref"``), every leaf bitwise, ``padded``
    included: the four batches, budgets of 64 and 9·P pops, a pool of
    ``HEAP_SMALL_CAP`` slots that overflows, and rows of 2 and 6 words (Q
    buckets 2 and 8; the batches are bucket 4).  Returns the largest
    |difference| of any leaf (0: the check is bitwise)."""
    import torch
    from repro_torch.core import ranked
    from repro_torch.text import corpus as tcorpus
    idx = engine.idx
    full = 2 * idx.n_docs + 4
    cases = [(f"{m} {b}", q, m, P, None, full)
             for m, b, q in batches for P in (1,) + HEAP_PS]
    or3 = batches[3][2]
    cases += [("or iii", or3, "or", P, budget, full)
              for P in (1,) + HEAP_PS for budget in (64, 9 * P)]
    cases += [(f"{m} {b}", q, m, P, None, full)
              for m, b, q in batches for P in HEAP_WIDE_PS]
    cases += [("or iii", or3, "or", P, 9 * P, full) for P in HEAP_WIDE_PS]
    cases += [("and ii", batches[0][2], "and", 16, 64, full)]
    cases += [(f"or ii, cap {HEAP_SMALL_CAP}", batches[1][2], "or", P, None,
               HEAP_SMALL_CAP) for P in (2, 16)]
    for nw in (2, 6):
        for mode, band in (("or", "ii"), ("and", "iii")):
            q = tcorpus.sample_queries(df_word, bands[band], B, nw,
                                       seed=SEED + 40 + nw)
            cases += [(f"{mode} {band}, {nw} words", q, mode, P, None, full)
                      for P in (3, 16)]
    overflowed = False
    for label, q, mode, P, budget, cap in cases:
        r, m_ = engine._encode_queries(q)
        wt = torch.from_numpy(r).to(idx.device)
        mt = torch.from_numpy(m_).to(idx.device)
        kw = dict(k=K, conjunctive=mode == "and", heap_cap=cap,
                  max_pops=budget, beam_width=P)
        got = ranked.topk_dr_batch(idx, wt, mt, idf, **kw)
        want = ranked.topk_dr_batch(idx, wt, mt, idf, kernel_backend="ref",
                                    **kw)
        _sync(idx.device.type)
        bad = leaves_equal(got, want, HEAP_LEAVES)
        check(not bad, f"{'beam_loop (heap P = 1)' if P == 1 else 'heap_loop'}"
              f" differs from the plain heap loop ({label}, P = {P}, budget "
              f"{budget}, cap {cap}, Q = {wt.shape[1]}): {bad}")
        overflowed |= cap < full and bool(got.overflowed.any())
        log(f"heap {'P = 1 route' if P == 1 else 'heap_loop'} == plain loop: "
            f"{label}, P = {P}, budget {budget}, cap {cap}, Q = "
            f"{wt.shape[1]}: pops {got.pops.tolist()}, iters "
            f"{got.iters.tolist()}, padded {got.padded.tolist()}, found "
            f"{got.n_found.tolist()}, overflowed "
            f"{int(got.overflowed.sum())}")
    check(overflowed, f"no row overflowed a pool of {HEAP_SMALL_CAP} slots")
    log(f"phase 4b: {len(cases)} cases, every leaf bitwise")
    return 0


def heap_loop_row(idx, words, wmask, idf, launches: int, P: int = 16) -> dict:
    """``heap_loop``'s row of the kernels line: one whole-batch loop at
    width P (``or``, band iii, B = 8), state reset each time — device ms
    (the profiler), ms per wrapper call, cold ms (after an L2 flush), the
    plain loop's ms, and the bound: the descents the kernel needs (each
    popped multi's count of each valid word, ``descent_bytes``), the pool
    read once, every pop's and insert's slot, the outputs and the trips'
    widths, over 3.35 TB/s."""
    import torch
    from repro_torch.core import heap as H
    from repro_torch.core import ranked
    from repro_torch.kernels import heap_loop as HL
    Bq, Q = words.shape
    cap = 2 * idx.n_docs + 4
    wm = wmask.to(torch.bool)
    idf_w = torch.where(wm, idf[words.long()], 0.0).to(torch.float32)
    pool0, _ = ranked.init_search(idx, words, wm, idf_w, k=K,
                                  conjunctive=False, cap=cap,
                                  kernel_backend="auto")
    holder = {}

    def fresh():
        holder["pool"] = H.Pool(*(t.clone() for t in pool0))
        holder["st"] = HL.init_state(Bq, K, idx.device)

    def run(kb):
        holder["out"] = HL.heap_loop(idx, holder["pool"], holder["st"], words,
                                     wm, idf_w, P=P, k=K, conjunctive=False,
                                     max_pops=None, kernel_backend=kb)

    def cold_setup():
        fresh()
        _flush_l2()
        torch.cuda._sleep(SLEEP_CYCLES)
    call = time_cuda(lambda: run("auto"), reps=5, warm=1, setup=fresh)
    cold = time_cuda(lambda: run("auto"), reps=5, warm=1, setup=cold_setup,
                     median=True)
    kms, _ = profile_device(lambda: (fresh(), run("auto")), 3,
                            "heap_loop_kernel")
    st, widths = holder["out"]
    pops, iters = int(st.pops.sum()), int(st.iters.max())
    inserts = int(holder["pool"].size.sum()) + pops - int(pool0.size.sum())
    plain = time_cuda(lambda: run("ref"), reps=1, warm=0, setup=fresh)
    # the descents the kernel makes: the plain loop's, kept where the pop
    # lane is a multi and the word is valid
    popped, real_pop = [], H.pop_p

    def pop_spy(*a, **kw):
        out = real_pop(*a, **kw)
        popped.append((out[1], out[2], out[4]))
        return out
    H.pop_p = pop_spy
    try:
        with OpsRecorder() as rec:
            fresh()
            run("ref")
    finally:
        H.pop_p = real_pop
    keep = [[], [], []]
    for (d0, d1, valid), trip in zip(popped, rec.calls):
        need = ((valid & (d1 - d0 > 1))[:, :, None] & wm[:, None, :])
        need = need.reshape(-1)
        for i in range(3):
            keep[i].append(trip[i][need])
    nb, ops = descent_bytes(idx, *(torch.cat(x) for x in keep),
                            distinct_nonempty=True)
    nb += Bq * cap * 4 + (pops + inserts) * (12 + 4 * Q) + Bq * (K + 1) * 8
    nb += int(st.iters.sum()) * 4
    bms, by = bound_ms(nb, ops)
    log(f"heap_loop (or, band iii, B = {Bq}, P = {P}): kernel {kms:.4f} ms "
        f"on the device ({call:.4f} ms per wrapper call, cold {cold:.4f} ms),"
        f" {kms / max(iters, 1) * 1e3:.2f} µs a trip of the longest row "
        f"({iters} trips, {pops} pops); plain loop {plain:.3f} ms; bound "
        f"{bms:.6f} ms ({by}: {nb} bytes)")
    return {"name": "heap_loop", "route": "cuda",
            "source": "src/repro_torch/csrc/heap_loop.cu",
            "replaces": "none: the reference's compiled while_loop around "
                        "K1, src/repro/core/ranked.py:364-427",
            "launches": launches, "max_abs_err": 0, "ms": kms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "wrapper_ms": call, "cold_ms": cold,
            "trips": iters, "pops": pops}


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
            bd, bs = host_bruteforce(tokens, ends, idx.n_docs, q[row],
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
    # the us/pop estimate the load's deadline budgets come from (only
    # unbudgeted batches feed it: the warmup's, not the load's)
    us_per_pop = eng.us_per_pop
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
        else:
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
           "us_per_pop": us_per_pop,
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
        # F3: the deadline, the budget it bought, the device stage, QPS
        dl = profiles["dr-or-heap-deadline"]
        stage = dl["stages_ms"].get("device", {})
        dl["f3"] = {"deadline_ms": DEADLINE_MS, "budgets": dl["budgets"],
                    "us_per_pop": dl["us_per_pop"],
                    "device_p50_ms": stage.get("p50_ms"),
                    "device_p99_ms": stage.get("p99_ms"), "qps": dl["qps"],
                    "p99_ms": dl["p99_ms"]}
        p99 = stage.get("p99_ms")
        under = p99 is not None and p99 <= DEADLINE_MS
        log(f"F3 heap or at a {DEADLINE_MS} ms deadline: budgets "
            f"{dl['budgets']} (the estimator at {dl['us_per_pop']:.3f} µs a "
            f"pop after warmup), device stage p50 {stage.get('p50_ms')} ms, "
            f"p99 {p99} ms ({'at or under' if under else 'over'} the "
            f"deadline), QPS {dl['qps']:.1f}, request p99 "
            f"{dl['p99_ms']:.2f} ms")
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
        loop = {"dr P=1": "beam_loop", "dr P=16": "heap_loop"}
        for label in ms:
            for got in launches[label]:
                if label.startswith("dr "):
                    want = {"wavelet_count": N_SHARDS, loop[label]: N_SHARDS}
                    check(got == want, f"{label} batch launched {got}: one "
                          f"K1 and one {loop[label]} per shard")
                else:
                    check(set(got) <= {"drb_walk", "drb_or"} and
                          sum(got.values()) == N_SHARDS and
                          len(got) == 1,
                          f"{label} batch launched {got}: one drb_walk or "
                          f"drb_or per shard")
        for k_ in ("wavelet_count", "beam_loop", "heap_loop", "drb_walk",
                   "drb_or", "wtbc_decode"):
            check(counts[k_] > 0, f"{k_} never launched on the sharded path")
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

# ---------------------------------------------------------------------------
# the torch quickstart (phase 15) and the LM serving path (phase 16)
# ---------------------------------------------------------------------------

def quickstart_phase(device: str = "cuda") -> dict:
    """Phase 15: ``examples/torch_quickstart.py`` as a user runs it on the
    card (launch counters reset just before, read just after), against the
    same script on the CPU: its DR, DRB and snippet answers equal."""
    import runpy
    from repro_torch.kernels import backend
    path = Path(__file__).resolve().parent / "examples" / "torch_quickstart.py"
    quick = runpy.run_path(str(path), run_name="torch_quickstart")
    backend.reset_launch_counts()
    secs, card = wall_ms(lambda: quick["run"](device), device)
    counts = backend.launch_counts()
    cpu = quick["run"]("cpu")
    for key in ("dr_and", "drb_or_bm25", "snippets"):
        check(card[key] == cpu[key], f"quickstart {key} differs between "
              f"{device} and the CPU: {card[key]} vs {cpu[key]}")
    check(len(card["dr_and"]) == 3 and len(card["snippets"]) == 3,
          f"quickstart answers: {card}")
    if device == "cuda":
        check(counts["wavelet_count"] > 0 and counts["drb_or"] == 1
              and counts["wtbc_decode"] == 1,
              f"quickstart launches: {counts}")
    log(f"quickstart on {device} == on the CPU (DR and {card['dr_and']}, DRB "
        f"or BM25 {card['drb_or_bm25']}, snippets {card['snippets']}) in "
        f"{secs:.1f} ms; launches {json.dumps(counts)}")
    return {"ms": secs, "launches": counts, "answers": card}


LM_CONFIGS = ("qwen3_1p7b", "granite_3_8b", "gemma2_9b", "qwen3_moe_235b_a22b",
              "llama4_scout_17b_a16e")
LM_FP32_TOL = 1e-4        # card vs CPU, float32 with TF32 off: matmul sum order
LM_BF16_MAX = 0.25        # decode vs forward, bf16 logits of |x| <= ~5: 8 ulps
LM_BF16_MEAN = 0.03       # ... and their mean |difference| per step
LM_B, LM_S, LM_STEPS = 4, 2048, 32
BF16_OPS_PER_S = 989e12   # H100 SXM data sheet, dense bf16 tensor cores


def _lm_err(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def lm_smoke_configs(device: str = "cuda") -> dict:
    """Phase 16a: every LM config at smoke size in float32, the same weights
    on the card and on the CPU (the port's own init, carried to both by
    ``convert.lm_params_from_jax``): forward logits, prefill caches and 8
    decode steps (rings of 8 slots wrap on the windowed layers), then a
    prefill at S = 2,048 (the blockwise path) of gemma2's smoke config."""
    import importlib
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch import convert
    from repro_torch.models import transformer as T
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    out = {}
    for mod in LM_CONFIGS:
        arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
        cfg = arch.config(smoke=True)
        check(cfg.dtype == torch.float32, f"{mod} smoke config is not fp32")
        tree = pytree.tree_map(lambda t: t.numpy(), arch.init_params(
            cfg, seed=SEED, device="cpu"))
        sides = {d: convert.lm_params_from_jax(tree, cfg, device=d)
                 for d in (device, "cpu")}
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (2, 16)).astype(np.int32))
        got = {}
        for d, params in sides.items():
            t = toks.to(d)
            logits, caches = arch.make_step(cfg, "prefill")(params, t)
            step = arch.make_step(cfg, "decode")
            ring = T.init_cache(cfg, 2, 16, device=d)
            dec = []
            for i in range(8):
                lg, ring = step(params, ring, t[:, i], i)
                dec.append(lg)
            got[d] = (logits, caches, torch.stack(dec), ring)
        a, b = got[device], got["cpu"]
        errs = {"forward": _lm_err(a[0], b[0]),
                "prefill_caches": max(_lm_err(x, y) for pa, pb in
                                      zip(a[1], b[1]) for x, y in zip(pa, pb)),
                "decode": _lm_err(a[2], b[2]),
                "decode_caches": max(_lm_err(x, y) for pa, pb in
                                     zip(a[3], b[3]) for x, y in zip(pa, pb))}
        for d in (device, "cpu"):
            check(bool(torch.isfinite(got[d][0]).all()
                       and torch.isfinite(got[d][2]).all()),
                  f"{mod}: non-finite logits on {d}")
        for what, err in errs.items():
            check(err <= LM_FP32_TOL * (1 + float(b[0].abs().max())),
                  f"{mod}: {what} differs between {device} and the CPU by "
                  f"{err:.3e}")
        log(f"LM {cfg.name} ({device} vs CPU, fp32): max |err| " +
            ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        out[cfg.name] = errs
    # the blockwise path at smoke widths
    arch = importlib.import_module("repro_torch.configs.gemma2_9b").ARCH
    cfg = arch.config(smoke=True)
    tree = pytree.tree_map(lambda t: t.numpy(), arch.init_params(
        cfg, seed=SEED + 1, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (1, LM_S)).astype(np.int32))
    res = [T.prefill(convert.lm_params_from_jax(tree, cfg, device=d),
                     toks.to(d), cfg) for d in (device, "cpu")]
    err = max(_lm_err(res[0][0], res[1][0]),
              max(_lm_err(x, y) for pa, pb in zip(res[0][1], res[1][1])
                  for x, y in zip(pa, pb)))
    check(err <= LM_FP32_TOL * (1 + float(res[1][0].abs().max())),
          f"gemma2 smoke prefill at S={LM_S} differs by {err:.3e}")
    log(f"LM {cfg.name} prefill at S={LM_S} (blockwise) {device} vs CPU: "
        f"max |err| {err:.3e}")
    out[f"{cfg.name} S={LM_S}"] = {"prefill": err}
    return out


def lm_full_width(device: str = "cuda") -> dict:
    """Phase 16b: qwen3-1.7b at full width in bf16 (random weights from a
    seeded generator on the card): ``prefill`` of B x S = 4 x 2,048 tokens
    (the blockwise attention), the caches placed into ``init_cache``'s rings
    of S + 32 slots (slot = pos % S_kv), 32 greedy ``decode_step``s, then
    ``forward`` over the extended sequence: each step's logits against the
    forward's at the same position and the greedy tokens against its argmax.
    Times: prefill and decode by CUDA events, the device's busy share by
    the profiler, and ``scaled_dot_product_attention`` at the prefill's
    attention shapes as a yardstick (never on the path)."""
    import torch
    import torch.nn.functional as F
    from torch.utils import _pytree as pytree
    from repro_torch.configs import qwen3_1p7b
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    arch = qwen3_1p7b.ARCH
    cfg = arch.config()
    B, S, N = LM_B, LM_S, LM_STEPS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = arch.init_params(cfg, seed=SEED, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    w_bytes = sum(t.numel() * t.element_size()
                  for t in pytree.tree_leaves(params))
    gen = torch.Generator(device=device).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device,
                         dtype=torch.int32)
    prefill = arch.make_step(cfg, "prefill")
    decode = arch.make_step(cfg, "decode")

    # ---- prefill: a first call (cuBLAS set-up), then the timed one --------
    # (the output is dropped at once: a name holding it would keep 6 GB)
    first_ms = wall_ms(lambda: prefill(params, toks), device)[0]
    prefill_ms = time_cuda(lambda: prefill(params, toks), reps=3, warm=0,
                           median=True)
    logits, pre = prefill(params, toks)
    check(tuple(logits.shape) == (B, S, cfg.vocab)
          and logits.dtype == torch.float32, f"prefill logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(all(bool(torch.isfinite(x).all()) for p in pre for x in p),
          "non-finite prefill caches")
    first = logits[:, -1].argmax(-1).to(torch.int32)
    del logits

    # ---- the caches placed into decode rings -------------------------------
    caches = T.init_cache(cfg, B, S + N, device=device)
    for (pk, pv), (rk, rv) in zip(pre, caches):
        pos = torch.arange(max(0, S - rk.shape[2]), S, device=device)
        rk[:, :, pos % rk.shape[2]] = pk[:, :, pos]
        rv[:, :, pos % rv.shape[2]] = pv[:, :, pos]
    del pre
    kv_bytes = sum(x.numel() * x.element_size() for p in caches for x in p)

    # ---- 32 greedy decode steps --------------------------------------------
    inputs, outs, step_ms = [first], [], []
    for t in range(N):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lg, caches = decode(params, caches, inputs[-1], S + t)
        b.record()
        outs.append(lg)
        inputs.append(lg.argmax(-1).to(torch.int32))
        b.synchronize()
        step_ms.append(a.elapsed_time(b))
    dec = torch.stack(outs, 1)                                   # (B, N, V)
    check(bool(torch.isfinite(dec).all()), "non-finite decode logits")

    # ---- consistency with forward over the extended sequence --------------
    ext = torch.cat([toks, torch.stack(inputs[:N], 1)], 1)      # (B, S + N)
    fwd_ms, (full, _aux) = wall_ms(lambda: T.forward(params, ext, cfg),
                                   device)
    ref = full[:, S:].clone()
    del full
    diff = (dec - ref).abs()
    max_err, mean_err = float(diff.max()), float(diff.mean(-1).max())
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = ref.argmax(-1) == torch.stack(inputs[1:], 1).long()
    decided = margin > 2 * LM_BF16_MAX
    n_agree, n_decided = int(agree.sum()), int(decided.sum())
    check(max_err <= LM_BF16_MAX and mean_err <= LM_BF16_MEAN,
          f"decode logits differ from forward's: max |err| {max_err:.4f} "
          f"(limit {LM_BF16_MAX}), worst step's mean {mean_err:.4f} "
          f"(limit {LM_BF16_MEAN})")
    check(bool(agree[decided].all()), "a greedy token differs from forward's "
          f"argmax where its margin exceeds {2 * LM_BF16_MAX}")
    log(f"LM qwen3-1.7b full width bf16: decode vs forward over {S + N} "
        f"tokens: max |err| {max_err:.4f}, worst step's mean |err| "
        f"{mean_err:.5f} (|logit| <= {float(ref.abs().max()):.2f}); greedy "
        f"tokens == forward's argmax at {n_agree} of {B * N} steps, at all "
        f"{n_decided} whose top-2 margin exceeds {2 * LM_BF16_MAX}")
    del ref, diff

    # ---- where the time goes ------------------------------------------------
    last = inputs[N - 1]
    # re-running the last step rewrites its slot with the same key and value
    step_busy, step_wall, step_top = device_breakdown(
        lambda: decode(params, caches, last, S + N - 1), 5)
    pre_busy, pre_wall, pre_top = device_breakdown(
        lambda: prefill(params, toks), 1)
    # attention alone at the prefill's shapes: the port's blockwise path
    # and the library's fused attention (a yardstick, never on the path)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((B, S, H, Dh), generator=gen, device=device,
                    dtype=cfg.dtype)
    k = torch.randn((B, S, KV, Dh), generator=gen, device=device,
                    dtype=cfg.dtype)
    v = torch.randn((B, S, KV, Dh), generator=gen, device=device,
                    dtype=cfg.dtype)
    scale = 1.0 / Dh ** 0.5
    port_attn = lambda: A._flash_attend(q.reshape(B, S, KV, H // KV, Dh), k, v,
                                        0, 0, None, scale, A.KV_BLOCK)
    sdpa = lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, scale=scale, enable_gqa=True)
    mine = port_attn().float()
    lib = sdpa().transpose(1, 2).reshape(mine.shape).float()
    attn_err = float((mine - lib).abs().max())
    check(attn_err < 0.05, f"port attention vs SDPA max |err| {attn_err:.4f}")
    port_attn_ms = time_cuda(port_attn, reps=10, warm=2, median=True)
    sdpa_ms = time_cuda(sdpa, reps=20, warm=3, median=True)
    del q, k, v, mine, lib

    peak = torch.cuda.max_memory_allocated()
    dec_ms = float(np.median(step_ms))
    # matmul FLOPs: every weight but the embedding lookup, 2 per token;
    # attention: QK^T and PV over the full S x S square the port computes
    w_flops = 2 * (cfg.param_count() - cfg.vocab * cfg.d_model) * B * S
    a_flops = 4 * B * H * S * S * Dh * cfg.n_layers
    pre_bound = (w_flops + a_flops) / BF16_OPS_PER_S * 1e3
    dec_bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    row = {"params": cfg.param_count(), "weight_bytes": w_bytes,
           "kv_cache_bytes": kv_bytes, "init_s": init_s,
           "prefill_first_ms": first_ms, "prefill_ms": prefill_ms,
           "prefill_tokens_per_s": B * S / prefill_ms * 1e3,
           "prefill_bound_ms": pre_bound, "prefill_bound_by": "operations",
           "prefill_device_busy_ms": pre_busy, "prefill_wall_ms": pre_wall,
           "decode_ms_per_step": dec_ms,
           "decode_ms_steps": step_ms,
           "decode_tokens_per_s": B / dec_ms * 1e3,
           "decode_bound_ms": dec_bound, "decode_bound_by": "bytes",
           "decode_device_busy_ms": step_busy, "decode_wall_ms": step_wall,
           "forward_ms": fwd_ms,
           "attention_port_ms": port_attn_ms, "attention_sdpa_ms": sdpa_ms,
           "attention_port_vs_sdpa_err": attn_err,
           "max_memory_allocated": peak,
           "max_abs_err": max_err, "worst_step_mean_abs_err": mean_err,
           "greedy_agree": n_agree, "greedy_decided": n_decided,
           "prefill_top": pre_top, "decode_top": step_top}
    log(f"LM qwen3-1.7b full width bf16 on {torch.cuda.get_device_name(0)}: "
        f"{cfg.param_count()} params ({w_bytes} bytes), prefill {B}x{S} "
        f"{prefill_ms:.2f} ms ({row['prefill_tokens_per_s']:.0f} tokens/s; "
        f"first call {first_ms:.1f} ms; bound {pre_bound:.2f} ms by bf16 "
        f"operations; device busy {pre_busy:.2f} of {pre_wall:.2f} ms), decode "
        f"{dec_ms:.3f} ms per step (median of {N}; {row['decode_tokens_per_s']:.0f}"
        f" tokens/s; bound {dec_bound:.4f} ms by bytes; device busy "
        f"{step_busy:.3f} of {step_wall:.3f} ms), forward over {S + N} "
        f"{fwd_ms:.1f} ms, max_memory_allocated {peak} bytes; attention of "
        f"one layer at the prefill's shapes: port {port_attn_ms:.3f} ms, "
        f"scaled_dot_product_attention {sdpa_ms:.3f} ms (yardstick)")
    log("LM prefill top device kernels (ms): " + json.dumps(pre_top))
    log("LM decode step top device kernels (ms): " + json.dumps(step_top))
    return row


def lm_phase(device: str = "cuda") -> dict:
    """Phase 16: the LM serving path (launch counters reset just before,
    read just after: the path is plain PyTorch and launches none of the
    port's CUDA kernels)."""
    from repro_torch.kernels import backend
    backend.reset_launch_counts()
    smoke = lm_smoke_configs(device)
    full = lm_full_width(device) if device == "cuda" else None
    counts = backend.launch_counts()
    check(not any(counts.values()), f"the LM path launched {counts}")
    return {"smoke": smoke, "qwen3-1.7b": full, "launches": counts}


# ---------------------------------------------------------------------------
# phase 17: recsys and GNN
# ---------------------------------------------------------------------------

RECSYS_MODS = ("fm", "xdeepfm", "dlrm_mlperf", "sasrec")
RS_REL = 1e-5            # card vs CPU, float32 with TF32 off: matmul sum order
SASREC_REL = 1e-6        # K6 adds over d left to right, float64 / XLA otherwise
EQUIV_REL = 1e-4         # rotated + translated coordinates vs the originals
RS_K = 100
DLRM_ROW_CAP = 1 << 22   # rows per DLRM table on one card (96.1 GB > 80 GB)
XDEEPFM_SAMPLE = 4096
PROFILE_CHUNKS = 16      # chunks of a tabular retrieval under the profiler
CORA_NODES, CORA_EDGES = 2_708, 10_556          # Cora (full_graph_sm)
REDDIT_NODES, REDDIT_DEG = 232_965, 50          # Reddit (GraphSAGE's graph)
MB_SEEDS, MB_FANOUT = 1024, (15, 10)            # minibatch_lg


def _rel(a, b) -> float:
    """max |a - b| over max |b|, in float64 on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _to(tree, device):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda t: t.to(device), tree)


def _ms(fn, device: str, reps: int, warm: int = 1) -> float | None:
    """Median CUDA-event ms of ``fn`` on the card (None on the CPU: a CPU
    rehearsal measures nothing)."""
    if device != "cuda":
        fn()
        return None
    return time_cuda(fn, reps=reps, warm=warm, median=True)


def _peak(device: str, reset: bool = False) -> int | None:
    import torch
    if device != "cuda":
        return None
    if reset:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return None
    return torch.cuda.max_memory_allocated()


class Tally:
    """The port's kernel launches on the main path only: ``run`` calls a
    step as a user would and adds its launches to ``counts``; launches made
    to compare a kernel with its plain version, or to time it, are outside
    any ``run``."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def run(self, fn, *a):
        from repro_torch.kernels import backend
        before = backend.launch_counts()
        out = fn(*a)
        after = backend.launch_counts()
        delta = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        for k, v in after.items():
            self.counts[k] = self.counts.get(k, 0) + v - before[k]
        return out, delta


def recsys_inputs(cfg, B: int, seed: int, n_cand: int = 0) -> dict:
    """A CPU batch drawn from ``seed``: SASRec item sequences, or sparse ids
    inside each table (and dense features); ``n_cand`` candidates, a seeded
    permutation of the item ids (of table 0's ids for tabular towers)."""
    import torch
    rng = np.random.default_rng(seed)
    if cfg.interaction == "self-attn-seq":
        b = {"seq": rng.integers(1, cfg.n_items, (B, cfg.seq_len))}
        hi = cfg.n_items
    else:
        rows = np.array(cfg.rows())
        b = {"sparse": (rng.random((B, cfg.n_sparse)) * rows).astype(np.int64)}
        if cfg.n_dense:
            b["dense"] = rng.standard_normal((B, cfg.n_dense))
        hi = cfg.rows()[0]
    if n_cand:
        b["candidates"] = rng.permutation(hi)[:n_cand]
    return {k: torch.from_numpy(v.astype(np.float32 if v.dtype.kind == "f"
                                         else np.int32))
            for k, v in b.items()}


def topk_agree(gs, gi, ws, wi, rel: float) -> tuple[float, int]:
    """Top-k against a reference top-k: (max |score difference| over max
    |reference score|, positions compared).  Fails unless the scores agree
    within ``rel`` and the indices are equal wherever the reference's
    adjacent scores lie further apart than ``rel`` of that scale."""
    import torch
    err = _rel(gs, ws)
    w = ws.detach().double().cpu()
    gap = (w[:-1] - w[1:]) > rel * float(w.abs().max())
    apart = torch.ones(w.shape[0], dtype=torch.bool)
    apart[1:] &= gap
    apart[:-1] &= gap
    check(err <= rel, f"top-k scores differ by {err:.3e} of their scale")
    check(torch.equal(gi.cpu()[apart], wi.cpu()[apart]),
          "top-k indices differ where the scores are apart")
    return err, int(apart.sum())


def cora_like(cfg, seed: int, n: int, e: int) -> dict:
    """``full_graph_sm``: a graph of Cora's node and edge counts (skewed
    sources, uniform destinations, the reference's ``random_graph``
    recipe), padded to multiples of 4,096; padding edges join the last
    padding node to itself and padding nodes carry no label."""
    from repro_torch.configs.base import pad_to
    from repro_torch.configs.egnn import PAD
    rng = np.random.default_rng(seed)
    pn, pe = pad_to(n, PAD), pad_to(e, PAD)
    edges = np.full((pe, 2), pn - 1, np.int32)
    edges[:e, 0] = (rng.random(e) ** 2 * n).astype(np.int64)
    edges[:e, 1] = rng.integers(0, n, e)
    feats = np.zeros((pn, cfg.d_feat), np.float32)
    feats[:n] = rng.standard_normal((n, cfg.d_feat))
    coords = np.zeros((pn, 3), np.float32)
    coords[:n] = rng.standard_normal((n, 3))
    labels = np.zeros(pn, np.int32)
    labels[:n] = rng.integers(0, cfg.n_classes, n)
    mask = np.zeros(pn, np.float32)
    mask[:n] = 1.0
    return {"feats": feats, "coords": coords, "edges": edges,
            "labels": labels, "label_mask": mask}


def molecules(cfg, seed: int, nodes_per: int, edges_per: int) -> dict:
    """``molecule``: ``cfg.n_graphs`` graphs of ``nodes_per`` nodes and
    ``edges_per`` random edges each (block diagonal), padded to a multiple
    of 4,096 nodes; padding nodes belong to graph ``n_graphs``, which the
    readout drops."""
    from repro_torch.configs.base import pad_to
    from repro_torch.configs.egnn import PAD
    rng = np.random.default_rng(seed)
    G = cfg.n_graphs
    n, e = G * nodes_per, G * edges_per
    pn = pad_to(n, PAD)
    base = np.repeat(np.arange(G), edges_per) * nodes_per
    edges = np.stack([rng.integers(0, nodes_per, e) + base,
                      rng.integers(0, nodes_per, e) + base], 1)
    feats = np.zeros((pn, cfg.d_feat), np.float32)
    feats[:n] = rng.standard_normal((n, cfg.d_feat))
    coords = np.zeros((pn, 3), np.float32)
    coords[:n] = rng.standard_normal((n, 3))
    gid = np.full(pn, G, np.int32)
    gid[:n] = np.repeat(np.arange(G), nodes_per)
    return {"feats": feats, "coords": coords, "edges": edges.astype(np.int32),
            "graph_ids": gid,
            "labels": rng.integers(0, cfg.n_classes, G).astype(np.int32),
            "label_mask": np.ones(G, np.float32)}


def sampled_minibatch(cfg, seed: int, n_nodes: int, deg: int, n_seeds: int,
                      fanout) -> tuple[dict, float]:
    """``minibatch_lg``: a seeded random CSR graph (``CSRGraph.random``),
    ``n_seeds`` seed nodes sampled at ``fanout`` by ``sample_subgraph``,
    padded to the cell's multiples of 4,096; and the host seconds taken."""
    from repro_torch.configs.base import pad_to
    from repro_torch.configs.egnn import PAD, SHAPES
    from repro_torch.data.graph_sampler import CSRGraph, sample_subgraph
    t0 = time.perf_counter()
    g = CSRGraph.random(n_nodes, deg, cfg.d_feat, cfg.n_classes, seed=seed)
    seeds = np.random.default_rng(seed + 1).choice(n_nodes, n_seeds,
                                                   replace=False)
    m = SHAPES["minibatch_lg"]
    hops = np.cumprod(fanout)
    pn = pad_to(max(m["nodes"], n_seeds * (1 + int(hops.sum()))), PAD)
    pe = pad_to(max(m["edges"], n_seeds * int(hops.sum())), PAD)
    b = sample_subgraph(g, seeds, tuple(fanout), pn, pe, seed=seed + 2)
    return b, time.perf_counter() - t0


def _np_to_torch(b: dict) -> dict:
    import torch
    return {k: torch.from_numpy(v) for k, v in b.items()}


def egnn_check(shape: str, cfg, graph: dict, device: str, tally: Tally,
               seed: int, reps: int) -> dict:
    """EGNN ``forward`` and ``loss_fn`` on ``device`` against the same
    weights on the CPU, repeated bitwise on the device, a rotation plus a
    translation of the coordinates (logits unchanged within ``EQUIV_REL``
    of their scale), and the forward's ms."""
    import torch
    from repro_torch.configs import egnn
    from repro_torch.models import gnn
    params = egnn.ARCH.init_params(cfg, seed=seed, device=device)
    cpu = _to(params, "cpu")
    b = _np_to_torch(graph)
    bd = _to(b, device)
    logits, d1 = tally.run(gnn.forward, params, bd, cfg)
    (loss, _), d2 = tally.run(gnn.loss_fn, params, bd, cfg)
    check(not d1 and not d2, f"EGNN launched port kernels: {d1} {d2}")
    n_out = cfg.n_graphs if cfg.graph_readout else graph["feats"].shape[0]
    check(tuple(logits.shape) == (n_out, cfg.n_classes)
          and bool(torch.isfinite(logits).all()) and bool(torch.isfinite(loss)),
          f"EGNN {shape}: logits {tuple(logits.shape)}, loss {float(loss)}")
    again = gnn.forward(params, bd, cfg)
    check(torch.equal(again, logits), f"EGNN {shape}: a second forward on "
          f"{device} differs")
    err = _rel(logits, gnn.forward(cpu, b, cfg))
    err_loss = _rel(loss, gnn.loss_fn(cpu, b, cfg)[0])
    check(err <= RS_REL and err_loss <= RS_REL, f"EGNN {shape}: {device} vs "
          f"CPU {err:.3e} (loss {err_loss:.3e})")
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    qt = torch.from_numpy(q.astype(np.float32)).to(device)
    moved = dict(bd, coords=bd["coords"] @ qt + 5.0)
    equiv = _rel(gnn.forward(params, moved, cfg), logits)
    check(equiv <= EQUIV_REL, f"EGNN {shape}: rotated logits differ by "
          f"{equiv:.3e} of their scale")
    ms = _ms(lambda: gnn.forward(params, bd, cfg), device, reps)
    return {"nodes": int(graph["feats"].shape[0]),
            "edges": int(graph["edges"].shape[0]), "err": err,
            "loss": float(loss), "loss_err": err_loss, "equivariance": equiv,
            "forward_ms": ms}


def recsys_smoke(device: str, tally: Tally) -> dict:
    """Phase 17a: the four recsys towers and EGNN at smoke size, the same
    weights on ``device`` and on the CPU: ``serve`` (B = 16) and
    ``retrieval`` (up to 1,000 candidates), EGNN ``forward`` / ``loss_fn``;
    on the card SASRec's retrieval step is one ``scored_topk`` launch and
    equals its plain version there bitwise, and no other step launches a
    port kernel."""
    import importlib
    import torch
    from repro_torch.configs import egnn
    from repro_torch.models import recsys
    out = {}
    for mod in RECSYS_MODS:
        arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
        cfg = arch.config(smoke=True)
        cpu = arch.init_params(cfg, seed=SEED, device="cpu")
        dev = _to(cpu, device)
        serve = arch.make_step(cfg, "serve")
        retr = arch.make_step(cfg, "retrieval")
        b = recsys_inputs(cfg, 16, SEED)
        got, d = tally.run(serve, dev, _to(b, device))
        check(not d, f"{cfg.name} serve launched {d}")
        err_serve = _rel(got, serve(cpu, b))
        check(err_serve <= RS_REL, f"{cfg.name} serve differs between "
              f"{device} and the CPU by {err_serve:.3e}")
        hi = cfg.n_items if cfg.interaction == "self-attn-seq" else cfg.rows()[0]
        r = recsys_inputs(cfg, 1, SEED + 1, n_cand=min(hi, 1000))
        rd = _to(r, device)
        (gs, gi), d = tally.run(retr, dev, rd)
        sasrec = cfg.interaction == "self-attn-seq"
        if device == "cuda":
            check(d == ({"scored_topk": 1} if sasrec else {}),
                  f"{cfg.name} retrieval launched {d}")
        if sasrec:
            rs, ri = recsys.retrieval_scores(dev, rd, cfg, k=RS_K,
                                             kernel_backend="ref")
            check(torch.equal(gs, rs) and torch.equal(gi, ri),
                  f"{cfg.name}: scored_topk differs from its plain version")
        ws, wi = retr(cpu, r)
        err_r, n_apart = topk_agree(gs, gi, ws, wi, RS_REL)
        log(f"recsys {cfg.name} ({device} vs CPU, fp32): serve max |err| "
            f"{err_serve:.3e} of the scale, retrieval top-{RS_K} scores "
            f"{err_r:.3e}, indices equal at all {n_apart} positions apart; "
            f"retrieval launches {json.dumps(d)}")
        out[cfg.name] = {"serve_err": err_serve, "retrieval_err": err_r,
                         "retrieval_launches": d}
    for shape in ("full_graph_sm", "molecule"):
        cfg = egnn.ARCH.config_for(shape, smoke=True)
        graph = (cora_like(cfg, SEED, 300, 1200) if shape == "full_graph_sm"
                 else molecules(cfg, SEED, 6, 10))
        row = egnn_check(shape, cfg, graph, device, tally, SEED, reps=3)
        log(f"EGNN smoke {shape} ({device} vs CPU, fp32): max |err| "
            f"{row['err']:.3e} of the scale, loss {row['loss_err']:.3e}, "
            f"rotation {row['equivariance']:.3e}")
        out[f"egnn-smoke {shape}"] = row
    return out


def sasrec_full(device: str, tally: Tally, small: bool = False) -> dict:
    """Phase 17b: SASRec at full width (10^6 items, d 50, seq 50, 2 blocks),
    weights from a seed on the card.  ``serve_p99`` (B = 512) against the
    CPU; ``serve_bulk`` (B = 262,144), its first 512 rows against the CPU;
    ``retrieval_cand`` over a seeded permutation of the 10^6 item ids: one
    ``scored_topk`` launch, K6 bitwise its plain version on the card, the
    top-100 against a float64 rescoring on the host.  Times: the steps by
    CUDA events, K6 cold (``cold_ms``) beside its bound, the gather and
    ``torch.topk(torch.mv(cands, h), 100)`` cold, ``max_memory_allocated``."""
    import dataclasses
    import torch
    from repro_torch.configs import sasrec
    from repro_torch.configs.recsys_common import N_CANDIDATES, SHAPES
    from repro_torch.kernels import ops
    arch = sasrec.ARCH
    cfg = arch.config()
    bulk_B = SHAPES["serve_bulk"]["batch"]
    if small:
        cfg = dataclasses.replace(cfg, n_items=20_000)
        bulk_B = 2048
    C = min(N_CANDIDATES, cfg.n_items)
    _peak(device, reset=True)
    t0 = time.perf_counter()
    params = arch.init_params(cfg, seed=SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    cpu = _to(params, "cpu")
    serve = arch.make_step(cfg, "serve")
    retr = arch.make_step(cfg, "retrieval")

    p99 = recsys_inputs(cfg, SHAPES["serve_p99"]["batch"], SEED + 2)
    p99d = _to(p99, device)
    got, d = tally.run(serve, params, p99d)
    check(not d, f"sasrec serve launched {d}")
    err_p99 = _rel(got, serve(cpu, p99))
    check(err_p99 <= RS_REL, f"sasrec serve_p99 {device} vs CPU {err_p99:.3e}")
    p99_ms = _ms(lambda: serve(params, p99d), device, reps=20, warm=3)

    bulk = _to(recsys_inputs(cfg, bulk_B, SEED + 3), device)
    got, d = tally.run(serve, params, bulk)
    check(not d and tuple(got.shape) == (bulk_B, cfg.embed_dim)
          and bool(torch.isfinite(got).all()), "sasrec serve_bulk output")
    err_bulk = _rel(got[:512], serve(cpu, {"seq": bulk["seq"][:512].cpu()}))
    check(err_bulk <= RS_REL, f"sasrec serve_bulk rows vs CPU {err_bulk:.3e}")
    del got
    bulk_ms = _ms(lambda: serve(params, bulk), device, reps=3)

    r = recsys_inputs(cfg, 1, SEED + 4, n_cand=C)
    rd = _to(r, device)
    (gs, gi), d = tally.run(retr, params, rd)
    if device == "cuda":
        check(d == {"scored_topk": 1}, f"sasrec retrieval launched {d}")
    h = serve(params, {"seq": rd["seq"]})[0]
    idx = rd["candidates"].long()
    cands = params["item_emb"][idx]                      # the step's gather
    ks, ki = ops.scored_topk(cands, h, k=RS_K)
    rs, ri = ops.scored_topk(cands, h, k=RS_K, kernel_backend="ref")
    check(torch.equal(ks, rs) and torch.equal(ki, ri),
          "scored_topk differs from its plain version at SASRec's shape")
    check(torch.equal(ks, gs) and torch.equal(ki, gi),
          "the retrieval step differs from scored_topk on its gather")
    s64 = cpu["item_emb"].double()[r["candidates"].long()] @ h.double().cpu()
    scale = float(s64.abs().max())
    want64 = torch.sort(s64, descending=True).values[:RS_K]
    got64 = torch.sort(s64[gi.long().cpu()], descending=True).values
    err64 = float((got64 - want64).abs().max()) / scale
    err_s = float((gs.double().cpu() - s64[gi.long().cpu()]).abs().max()) / scale
    check(err64 <= SASREC_REL and err_s <= SASREC_REL,
          f"sasrec top-{RS_K} vs a float64 top-k: {err64:.3e}, scores "
          f"{err_s:.3e} of the scale")
    row = {"items": cfg.n_items, "candidates": C, "init_s": init_s,
           "serve_p99_err": err_p99, "serve_bulk_err": err_bulk,
           "serve_p99_ms": p99_ms, "serve_bulk_ms": bulk_ms,
           "serve_bulk_batch": bulk_B, "f64_topk_err": err64,
           "f64_score_err": err_s, "launches": d}
    if device == "cuda":
        step_ms = time_cuda(lambda: retr(params, rd), reps=20, warm=3,
                            median=True)
        k6 = lambda: ops.scored_topk(cands, h, k=RS_K)
        k6_cold = cold_ms(k6, reps=30)
        k6_warm = warm_ms(k6, reps=30)
        k6_dev, _ = profile_device(k6, 20, "scored_topk")
        bms, by = topk_bound_ms(cands, h, None, RS_K)
        plain = time_cuda(lambda: ops.scored_topk(cands, h, k=RS_K,
                                                  kernel_backend="ref"),
                          reps=5, warm=1, median=True)
        gather_cold = cold_ms(lambda: params["item_emb"][idx], reps=30)
        gather_bound = (2 * cands.numel() * 4 + idx.numel() * 8) \
            / HBM_BYTES_PER_S * 1e3
        lib_cold = cold_ms(lambda: torch.topk(torch.mv(cands, h), RS_K),
                           reps=30)
        busy, wall, top = device_breakdown(lambda: retr(params, rd), 20)
        probe = k6_probe(cands, h, ks, ki)
        row.update({"retrieval_step_ms": step_ms,
                    "retrieval_device_busy_ms": busy,
                    "retrieval_wall_ms": wall, "retrieval_top": top,
                    "k6_probe": probe, "k6": {
            "shape": f"C={C}, d={cfg.embed_dim}, k={RS_K}, float32",
            "launches": 1, "max_abs_err": 0, "ms": k6_cold,
            "cold_ms": k6_cold, "warm_ms": k6_warm, "device_ms": k6_dev,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_cold,
            "library": f"torch.topk(torch.mv(cands, h), {RS_K})"},
            "gather_cold_ms": gather_cold, "gather_bound_ms": gather_bound,
            "max_memory_allocated": _peak(device)})
        log(f"recsys sasrec full width on {torch.cuda.get_device_name(0)}: "
            f"serve_p99 {p99_ms:.4f} ms, serve_bulk (B={bulk_B}) "
            f"{bulk_ms:.3f} ms, retrieval_cand step {step_ms:.4f} ms; K6 at "
            f"C={C}, d={cfg.embed_dim}, k={RS_K}: cold {k6_cold:.6f} ms "
            f"(warm {k6_warm:.6f}, profiler {k6_dev:.6f}), bound "
            f"{bms:.6f} ms ({by}), plain {plain:.4f} ms, "
            f"torch.topk(torch.mv) cold {lib_cold:.6f} ms; the gather cold "
            f"{gather_cold:.6f} ms (bound {gather_bound:.6f}); "
            f"max_memory_allocated {row['max_memory_allocated']} bytes; "
            f"the step's device busy {busy:.4f} of {wall:.4f} ms wall")
        log("recsys sasrec retrieval step top device kernels (ms): "
            + json.dumps(top))
    log(f"recsys sasrec full width: serve_p99 vs CPU {err_p99:.3e}, "
        f"serve_bulk rows vs CPU {err_bulk:.3e}; retrieval == scored_topk "
        f"== its plain version bitwise, top-{RS_K} vs float64 {err64:.3e} "
        f"(scores {err_s:.3e}) of the scale; launches {json.dumps(d)}")
    return row


def k6_probe(cands, h, ks, ki) -> dict:
    """Where K6's time goes at SASRec's shape (a diagnosis, not the path):
    its launch plan and cold ms at k = 10 and 100, on the 200-byte rows
    (staged in 8-byte units, each 32-row block one 6,400-byte span) and on
    the same rows zero-padded to d = 52 (208 bytes: 16-byte units at an odd
    stride; the padding adds +0.0 products, so the top-100 must equal
    ``(ks, ki)`` bitwise)."""
    import torch
    from repro_torch.kernels import ops, topk_score
    C, d = cands.shape
    d_pad = -(-d * 4 // 16) * 4
    padded = torch.zeros((C, d_pad), dtype=cands.dtype, device=cands.device)
    padded[:, :d] = cands
    h_pad = torch.zeros(d_pad, dtype=h.dtype, device=h.device)
    h_pad[:d] = h
    s, i = ops.scored_topk(padded, h_pad, k=RS_K)
    check(torch.equal(s, ks) and torch.equal(i, ki), "K6 on zero-padded rows "
          "differs from K6 on the rows")
    n_sm = torch.cuda.get_device_properties(cands.device).multi_processor_count
    out = {}
    for c, q, dd in ((cands, h, d), (padded, h_pad, d_pad)):
        unit = topk_score.staging_unit(dd * 4, c.data_ptr(), 4)
        for k in (10, RS_K):
            pl = topk_score.launch_plan(1, C, dd, 4, unit, k, False, n_sm)
            ms = cold_ms(lambda: ops.scored_topk(c, q, k=k), reps=20)
            label = f"d={dd} unit={unit} k={k}"
            out[label] = {"cold_ms": ms, "plan": pl._asdict()}
    log("K6 probe at C=%d (cold ms): " % C + ", ".join(
        f"{k} {v['cold_ms']:.6f} (gx {v['plan']['gx']}, rows/block "
        f"{v['plan']['rs']}, stages {v['plan']['ns']}, buffer "
        f"{v['plan']['nc']})" for k, v in out.items()))
    return out


def tabular_full(mod: str, device: str, tally: Tally,
                 small: bool = False) -> dict:
    """Phase 17c: FM or xDeepFM at full width (39 tables of 1,000,448 x 10),
    weights from a seed on the card.  ``serve_p99`` against the CPU;
    ``retrieval_cand`` over a seeded permutation of 10^6 ids, chunked.
    FM: every candidate's score against the CPU's and the top-100 against
    the CPU's.  xDeepFM (≈ 69 TFLOP over 10^6 candidates, too slow for the
    CPU): the card's rescoring of the returned 100 equals them bitwise
    (a score does not depend on its chunk), the CPU's rescoring of them
    agrees, and no candidate of a seeded sample of 4,096, other than the
    returned ones, beats the 100th score on the CPU by more than the
    tolerance."""
    import dataclasses
    import importlib
    import torch
    from repro_torch.configs.recsys_common import N_CANDIDATES, SHAPES
    from repro_torch.models import recsys
    arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
    cfg = arch.config()
    if small:
        cfg = dataclasses.replace(cfg, table_rows=(20_000,) * cfg.n_sparse)
    C = min(N_CANDIDATES, cfg.rows()[0])
    _peak(device, reset=True)
    params = arch.init_params(cfg, seed=SEED, device=device)
    cpu = _to(params, "cpu")
    serve = arch.make_step(cfg, "serve")
    retr = arch.make_step(cfg, "retrieval")
    p99 = recsys_inputs(cfg, SHAPES["serve_p99"]["batch"], SEED + 5)
    p99d = _to(p99, device)
    got, d = tally.run(serve, params, p99d)
    check(not d, f"{cfg.name} serve launched {d}")
    err_p99 = _rel(got, serve(cpu, p99))
    check(err_p99 <= RS_REL, f"{cfg.name} serve_p99 vs CPU {err_p99:.3e}")
    p99_ms = _ms(lambda: serve(params, p99d), device, reps=20, warm=3)

    r = recsys_inputs(cfg, 1, SEED + 6, n_cand=C)
    rd = _to(r, device)
    t0 = time.perf_counter()
    (gs, gi), d = tally.run(retr, params, rd)
    _sync(device)
    first_s = time.perf_counter() - t0
    check(not d, f"{cfg.name} retrieval launched {d}")
    check(bool(torch.isfinite(gs).all()), f"{cfg.name}: non-finite scores")
    row = {"chunk": recsys.retrieval_chunk(cfg), "candidates": C,
           "serve_p99_err": err_p99, "serve_p99_ms": p99_ms,
           "retrieval_first_s": first_s}
    if cfg.interaction == "fm":
        card_all = recsys.candidate_scores(params, rd, cfg)
        ts, ti = recsys.top_k(card_all, RS_K)
        check(torch.equal(ts, gs) and torch.equal(ti, gi),
              "FM top-k differs from its own scores")
        t0 = time.perf_counter()
        cpu_all = recsys.candidate_scores(cpu, r, cfg)
        row["cpu_all_s"] = time.perf_counter() - t0
        row["all_err"] = _rel(card_all, cpu_all)
        check(row["all_err"] <= RS_REL, f"FM scores of every candidate "
              f"differ from the CPU's by {row['all_err']:.3e}")
        row["topk_err"], row["n_apart"] = topk_agree(
            gs, gi, *recsys.top_k(cpu_all, RS_K), RS_REL)
        note = (f"all {C} scores vs CPU {row['all_err']:.3e}, top-{RS_K} "
                f"{row['topk_err']:.3e}, indices equal at {row['n_apart']}")
    else:
        ret = r["candidates"][gi.long().cpu()]
        again = recsys.candidate_scores(params, dict(rd, candidates=ret.to(
            device)), cfg)
        check(torch.equal(again, gs), f"{cfg.name}: the returned candidates "
              "rescored on the card differ from their scores")
        pos = np.random.default_rng(SEED + 7).choice(
            C, min(XDEEPFM_SAMPLE, C), replace=False)
        sample = r["candidates"][torch.from_numpy(pos)]
        t0 = time.perf_counter()
        cpu_ret = recsys.candidate_scores(cpu, dict(r, candidates=ret), cfg)
        cpu_smp = recsys.candidate_scores(cpu, dict(r, candidates=sample), cfg)
        row["cpu_rescore_s"] = time.perf_counter() - t0
        scale = max(float(cpu_ret.abs().max()), float(cpu_smp.abs().max()))
        row["returned_err"] = float((gs.cpu() - cpu_ret).abs().max()) / scale
        # a sampled candidate among the returned ones rightly beats the
        # 100th: only the others are held to it
        rest = cpu_smp[~torch.isin(sample, ret)]
        row["sample_in_top"] = int(len(pos) - rest.numel())
        row["sample_beats_by"] = (float(rest.max()) - float(gs[-1])) / scale
        check(row["returned_err"] <= RS_REL, f"{cfg.name}: the returned "
              f"scores vs the CPU's {row['returned_err']:.3e}")
        check(row["sample_beats_by"] <= RS_REL, f"{cfg.name}: a sampled "
              f"candidate beats the {RS_K}th score by "
              f"{row['sample_beats_by']:.3e} of the scale")
        note = (f"returned {RS_K} rescored on the card bitwise, on the CPU "
                f"{row['returned_err']:.3e}; best of {len(pos)} sampled "
                f"candidates ({row['sample_in_top']} of them returned) vs "
                f"the {RS_K}th score {row['sample_beats_by']:+.3e}")
    if device == "cuda":
        reps = 5 if cfg.interaction == "fm" else 1
        row["retrieval_step_ms"] = time_cuda(lambda: retr(params, rd),
                                             reps=reps, warm=0, median=True)
        row["max_memory_allocated"] = _peak(device)
        # the step is its chunks in turn: a profile of the first few tells
        # where a chunk's time goes (a whole step holds 10^4-10^5 kernels,
        # too many for a quick profiler session)
        n = PROFILE_CHUNKS * row["chunk"]
        part = dict(rd, candidates=rd["candidates"][:n])
        busy, wall, top = device_breakdown(
            lambda: recsys.candidate_scores(params, part, cfg), 1)
        row.update({"profiled_candidates": n, "profile_busy_ms": busy,
                    "profile_wall_ms": wall, "profile_top": top})
        log(f"recsys {cfg.name} retrieval_cand, its first {PROFILE_CHUNKS} "
            f"chunks ({n} candidates): device busy {busy:.3f} of {wall:.3f} "
            f"ms wall; top device kernels (ms) " + json.dumps(top))
        log(f"recsys {cfg.name} full width: serve_p99 {p99_ms:.4f} ms, "
            f"retrieval_cand (C={C}, chunks of {row['chunk']}) "
            f"{row['retrieval_step_ms']:.2f} ms, max_memory_allocated "
            f"{row['max_memory_allocated']} bytes")
    log(f"recsys {cfg.name} full width ({device} vs CPU): serve_p99 "
        f"{err_p99:.3e}; {note}")
    return row


def dlrm_full(device: str, tally: Tally, small: bool = False) -> dict:
    """Phase 17d: DLRM-MLPerf at full widths (26 tables of embed 128, MLPs
    13-512-256-128 and 1024-1024-512-256-1) with every table capped at
    ``DLRM_ROW_CAP`` rows (the published 187,775,488 rows x 128 float32 are
    96.1 GB, more than the card's 80 GB).  ``serve_p99`` against the CPU,
    which holds only the rows the batch reads (the batch's ids are inside
    the capped tables, so no id is clipped)."""
    import dataclasses
    import torch
    from repro_torch.configs import dlrm_mlperf
    from repro_torch.configs.recsys_common import SHAPES
    from repro_torch.models.recsys import CRITEO_1TB_ROWS
    arch = dlrm_mlperf.ARCH
    cap = 4096 if small else DLRM_ROW_CAP
    cfg = dataclasses.replace(arch.config(), table_rows=tuple(
        min(r, cap) for r in CRITEO_1TB_ROWS))
    full_rows = sum(arch.config().rows())
    reduced = {"table_rows": f"each table capped at {cap} rows: "
               f"{sum(r > cap for r in CRITEO_1TB_ROWS)} of 26 tables cut, "
               f"{sum(cfg.rows())} of {full_rows} rows "
               f"({sum(cfg.rows()) * 128 * 4} of {full_rows * 128 * 4} bytes)",
               "why": "the published tables (96.1 GB) exceed one H100's 80 GB"}
    log("reduced (dlrm-mlperf): " + json.dumps(reduced))
    _peak(device, reset=True)
    params = arch.init_params(cfg, seed=SEED, device=device)
    serve = arch.make_step(cfg, "serve")
    b = recsys_inputs(cfg, SHAPES["serve_p99"]["batch"], SEED + 8)
    bd = _to(b, device)
    got, d = tally.run(serve, params, bd)
    check(not d, f"dlrm serve launched {d}")
    # the CPU side: each table's rows that the batch reads, ids renumbered
    tables, sparse = [], b["sparse"].clone()
    for f, t in enumerate(params["tables"]):
        u = torch.unique(b["sparse"][:, f].long())
        tables.append(t[u.to(device)].cpu())
        sparse[:, f] = torch.searchsorted(u, b["sparse"][:, f].long()).int()
    cpu = {"tables": tables, "bot": _to(params["bot"], "cpu"),
           "top": _to(params["top"], "cpu")}
    err = _rel(got, serve(cpu, {"sparse": sparse, "dense": b["dense"]}))
    check(err <= RS_REL, f"dlrm serve_p99 vs CPU {err:.3e}")
    row = {"reduced": reduced, "serve_p99_err": err,
           "table_bytes": sum(t.numel() * 4 for t in params["tables"])}
    if device == "cuda":
        row["serve_p99_ms"] = time_cuda(lambda: serve(params, bd), reps=20,
                                        warm=3, median=True)
        row["max_memory_allocated"] = _peak(device)
        log(f"recsys dlrm-mlperf (capped) serve_p99 {row['serve_p99_ms']:.4f} "
            f"ms, tables {row['table_bytes']} bytes, max_memory_allocated "
            f"{row['max_memory_allocated']} bytes")
    log(f"recsys dlrm-mlperf (capped) serve_p99 {device} vs CPU {err:.3e}")
    return row


def egnn_full(device: str, tally: Tally, small: bool = False) -> dict:
    """Phase 17e: EGNN at full width (4 layers, H 64) on three graphs:
    ``full_graph_sm`` at Cora's sizes, ``minibatch_lg`` sampled by
    ``graph_sampler`` (1,024 seeds at fanout (15, 10) from a seeded random
    graph of Reddit's 232,965 nodes at mean degree 50), ``molecule`` (128 x
    30 nodes, 64 edges each); ``egnn_check`` on each."""
    from repro_torch.configs import egnn
    out = {}
    for shape in ("full_graph_sm", "minibatch_lg", "molecule"):
        cfg = egnn.ARCH.config_for(shape)
        host_s = None
        if shape == "full_graph_sm":
            graph = cora_like(cfg, SEED, CORA_NODES, CORA_EDGES)
        elif shape == "minibatch_lg":
            graph, host_s = sampled_minibatch(
                cfg, SEED, 20_000 if small else REDDIT_NODES,
                10 if small else REDDIT_DEG, 64 if small else MB_SEEDS,
                MB_FANOUT)
        else:
            graph = molecules(cfg, SEED, 30, 64)
        _peak(device, reset=True)
        row = egnn_check(shape, cfg, graph, device, tally, SEED, reps=5)
        row["sample_s"] = host_s
        row["max_memory_allocated"] = _peak(device)
        ms = row["forward_ms"]
        log(f"EGNN {shape} full width (N={row['nodes']}, E={row['edges']}): "
            f"{device} vs CPU {row['err']:.3e}, loss {row['loss']:.6f} "
            f"({row['loss_err']:.3e}), rotation {row['equivariance']:.3e}, "
            f"repeats bitwise; forward "
            + (f"{ms:.4f} ms" if ms is not None else "not timed on the CPU")
            + (f"; sampled in {host_s:.2f} s" if host_s else ""))
        out[shape] = row
    return out


def recsys_phase(device: str = "cuda", small: bool = False) -> dict:
    """Phase 17: recsys and GNN (launch counters reset just before, read
    just after; ``launches`` counts the main path's steps only — the
    comparisons and timings launch K6 too)."""
    from repro_torch.kernels import backend
    backend.reset_launch_counts()
    tally = Tally()
    parts = {"smoke": lambda: recsys_smoke(device, tally),
             "sasrec": lambda: sasrec_full(device, tally, small),
             "fm": lambda: tabular_full("fm", device, tally, small),
             "xdeepfm": lambda: tabular_full("xdeepfm", device, tally, small),
             "dlrm-mlperf": lambda: dlrm_full(device, tally, small),
             "egnn": lambda: egnn_full(device, tally, small)}
    out, secs = {}, {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        out[name] = part()
        secs[name] = round(time.perf_counter() - t0, 1)
    out["seconds"] = secs
    log("phase 17 seconds per part: " + json.dumps(secs))
    out["phase_launches"] = backend.launch_counts()
    out["launches"] = {k: tally.counts.get(k, 0)
                       for k in out["phase_launches"]}
    if device == "cuda":
        # two SASRec retrieval steps (smoke and full width): one K6 each
        want = {k: 2 if k == "scored_topk" else 0 for k in out["launches"]}
        check(out["launches"] == want, f"the recsys / GNN path launched "
              f"{out['launches']}, expected {want}")
    log(f"recsys / GNN main path launches {json.dumps(out['launches'])}; "
        f"with the comparisons and timings {json.dumps(out['phase_launches'])}")
    return out


# ---------------------------------------------------------------------------
# phase 18: training
# ---------------------------------------------------------------------------

TRAIN_MODS = LM_CONFIGS + RECSYS_MODS + ("egnn",)
TRAIN_REL = 1e-5         # card vs CPU, float32 with TF32 off: sum order
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 5
TRAIN_BF16 = dict(rtol=5e-2, atol=5e-2)    # tests/test_torch_models.py BF16


def _train_batch(arch, cfg, seed: int, step: int, device) -> dict:
    from repro_torch.data import pipeline
    if arch.family == "lm":
        return pipeline.lm_batch(seed, step, 2, 32, cfg.vocab, device=device)
    if arch.family == "recsys":
        return pipeline.recsys_batch(seed, step, 64, cfg, device=device)
    return pipeline.random_graph(seed, 400, 1600, cfg.d_feat, cfg.n_classes,
                                 pad_nodes=512, pad_edges=2048, device=device)


def _step_agree(after_dev, after_cpu, before, lr: float, wd: float
                ) -> tuple[float, float]:
    """(share of elements within 1e-3 x lr + 1e-6 |p| of the CPU's, the
    largest difference over AdamW's bound on a step, 2 lr (1 + wd |p|))."""
    from repro_torch.checkpoint import ckpt
    n_ok = n_all = 0
    worst = 0.0
    for (_, x), (_, y), (_, p0) in zip(ckpt.flatten_with_names(after_dev),
                                       ckpt.flatten_with_names(after_cpu),
                                       ckpt.flatten_with_names(before)):
        err = (x.double().cpu() - y.double()).abs()
        n_ok += int((err <= 1e-3 * lr + 1e-6 * y.double().abs()).sum())
        n_all += err.numel()
        bound = 2 * lr * (1 + wd * float(p0.double().abs().max()))
        worst = max(worst, float(err.max()) / bound)
    return n_ok / n_all, worst


def train_smoke_configs(device: str = "cuda") -> dict:
    """Phase 18a: one ``make_step(cfg, "train")`` of each of the ten smoke
    configs (float32, TF32 off) on the card and on the CPU from the same
    parameters, optimizer state and batch: loss, metrics, grad_norm and lr
    within 1e-5 (relative; of 1 for values below 1), 99.9% of the updated
    parameters within 1e-3 x lr of the CPU's and every one within AdamW's
    bound on a step (an element whose gradient is float32 noise around 0
    may step either way)."""
    import importlib
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.optim import adamw
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    out = {}
    for mod in TRAIN_MODS:
        arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
        cfg = arch.config(smoke=True)
        cpu = arch.init_params(cfg, seed=SEED, device="cpu")
        dev = pytree.tree_map(lambda t: t.to(device, copy=True), cpu)
        before = pytree.tree_map(lambda t: t.clone(), cpu)
        b = _train_batch(arch, cfg, SEED, 0, "cpu")
        step = arch.make_step(cfg, "train")
        cpu, _, mc = step(cpu, adamw.init_state(cpu), b)
        dev, od, md = step(dev, adamw.init_state(dev),
                           {k: v.to(device) for k, v in b.items()})
        check(all(t.device.type == torch.device(device).type
                  for t in pytree.tree_leaves((dev, od, md))),
              f"{mod}: a train step's output left {device}")
        errs = {k: abs(float(md[k]) - float(mc[k])) / max(abs(float(mc[k])),
                                                          1.0) for k in mc}
        for k, e in errs.items():
            check(np.isfinite(float(md[k])) and e <= TRAIN_REL,
                  f"{mod}: train metric {k} {float(md[k])} on {device} vs "
                  f"{float(mc[k])} on the CPU")
        lr = float(mc["lr"])
        share, worst = _step_agree(dev, cpu, before, lr,
                                   arch.optimizer_cfg().weight_decay)
        check(share >= 0.999 and worst <= 1.0,
              f"{mod}: updated parameters on {device} vs the CPU: {share:.5f} "
              f"within 1e-3 lr, worst {worst:.3f} of the step bound")
        out[cfg.name] = {"loss": float(md["loss"]), "metric_rel_err": errs,
                         "params_within_1e-3_lr": share,
                         "worst_over_step_bound": worst}
        log(f"train {cfg.name} ({device} vs CPU): loss {float(md['loss']):.5f},"
            f" grad_norm {float(md['grad_norm']):.4f}, max metric rel err "
            f"{max(errs.values()):.2e}; parameters {share:.5f} within 1e-3 lr,"
            f" worst {worst:.2e} of the step bound")
    return out


def train_restarts(device: str = "cuda") -> dict:
    """Phase 18b: ``run_with_restarts`` on qwen3-1.7b's smoke config in bf16
    on ``device``, 14 steps, checkpoints every 5, failures injected at
    steps 3 and 11 (before the first checkpoint and mid-interval): every
    step's metrics and the final state bitwise equal to the uninterrupted
    run's."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import qwen3_1p7b
    from repro_torch.data import pipeline
    from repro_torch.optim import adamw
    from repro_torch.runtime import fault_tolerance as ft
    arch = qwen3_1p7b.ARCH
    cfg = dataclasses.replace(arch.config(smoke=True), dtype=torch.bfloat16)
    step = arch.make_step(cfg, "train")
    params = arch.init_params(cfg, seed=SEED, device=device)
    init = {"params": params, "opt": adamw.init_state(params)}
    batch_fn = lambda s: pipeline.lm_batch(SEED, s, 4, 64, cfg.vocab,  # noqa: E731
                                           device=device)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, failures in (("clean", ()), ("faulty", (3, 11))):
            log_ = []
            final = ft.run_with_restarts(init, 14, step, batch_fn,
                                         f"{tmp}/{label}", ckpt_every=5,
                                         failures=failures, metrics_log=log_)
            runs[label] = (dict(log_), len(log_), final)
    clean, faulty = runs["clean"], runs["faulty"]
    check(clean[0] == faulty[0], "run_with_restarts: the loss curve with two "
          "failures differs from the uninterrupted one")
    check(faulty[1] == 14 + 4 + 2, f"run_with_restarts ran {faulty[1]} steps,"
          " expected 20 (steps 0-3 and 10-11 again)")
    same = all(torch.equal(a, b) and a.device.type == torch.device(device).type
               for (_, a), (_, b) in zip(ckpt.flatten_with_names(clean[2]),
                                         ckpt.flatten_with_names(faulty[2])))
    check(same, "run_with_restarts: the final state differs")
    losses = [clean[0][s]["loss"] for s in range(14)]
    log(f"train restarts on {device}: failures at 3 and 11, {faulty[1]} steps "
        f"run, the 14 losses bitwise the uninterrupted run's "
        f"({losses[0]:.5f} -> {losses[-1]:.5f}), the final state too")
    return {"steps_run": faulty[1], "losses": losses}


def train_cli(device: str = "cuda") -> dict:
    """Phase 18c: ``python -m repro_torch.launch.train --arch qwen3-1.7b
    --steps 20``, then ``--steps 25 --resume``, each in a subprocess on
    ``device``: both end in ``done``, the second resumes from step 20."""
    import os
    import tempfile
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, extra in (("first", ["--steps", "20"]),
                             ("resume", ["--steps", "25", "--resume"])):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                                "--arch", "qwen3-1.7b", "--ckpt-dir", tmp,
                                "--device", device, *extra], cwd=root, env=env,
                               capture_output=True, text=True, timeout=300)
            secs = time.perf_counter() - t0
            lines = r.stdout.strip().splitlines()
            check(r.returncode == 0 and lines and lines[-1] == "done",
                  f"launch.train {label} failed (rc {r.returncode}): "
                  f"{r.stdout[-1500:]} {r.stderr[-3000:]}")
            out[label] = {"s": round(secs, 1), "lines": lines}
            log(f"launch.train {' '.join(extra)}: {secs:.1f} s, last lines "
                f"{lines[-3:]}")
    check(out["resume"]["lines"][0] == "resumed from step 20",
          f"launch.train --resume: {out['resume']['lines'][:2]}")
    return out


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def train_full_width(device: str = "cuda", small: bool = False) -> dict:
    """Phase 18d: qwen3-1.7b at full width and depth in bf16 with remat,
    ``arch.make_step(cfg, "train")`` with the default AdamW config, on B x S
    = 2 x 4,096 tokens from ``pipeline.lm_batch`` (train_4k's S; B cut from
    256 by one card), five steps on one repeated batch.  Checks: step 0's
    loss equals ``loss_fn`` forward-only under ``no_grad`` (bf16 tolerance)
    and lies within 1.0 of ln V; step 0 run twice from the same state gives
    bitwise equal parameters; ``grad_norm`` finite and ``lr`` equal to
    ``schedule`` on every step; the loss falls from step 0 to step 4; on
    three sampled leaves (embedding rows, one attention and one MLP weight)
    step 1's update equals a float64 recomputation of AdamW from the saved
    g, m and v within 1 bf16 ulp of the parameter.  ``small`` shrinks the
    model and the batch for a CPU rehearsal (no timings)."""
    import dataclasses
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.configs import base, qwen3_1p7b
    from repro_torch.data import pipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    arch = qwen3_1p7b.ARCH
    cfg = arch.config()
    B, S = TRAIN_B, TRAIN_S
    if small:
        cfg = dataclasses.replace(cfg, n_layers=3, d_model=128, n_heads=4,
                                  n_kv_heads=2, d_head=32, d_ff=256,
                                  vocab=4096)
        S = 128
    check(cfg.remat and cfg.dtype == torch.bfloat16, f"config {cfg}")
    ocfg = arch.optimizer_cfg()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def held():
        """(allocated, requested) bytes on the card: what a placement adds
        (phase 19b holds it against the dry run)."""
        if not on_card:
            return None
        sync()
        stats = torch.cuda.memory_stats()
        return (torch.cuda.memory_allocated(),
                stats.get("requested_bytes.all.current"))

    def grew(before, after):
        return None if before is None else {
            "allocated": after[0] - before[0],
            "requested": None if before[1] is None else after[1] - before[1]}
    placed = {}
    h0 = held()
    t0 = time.perf_counter()
    params = arch.init_params(cfg, seed=SEED, device=device)
    sync()
    init_s = time.perf_counter() - t0
    placed["params"] = grew(h0, held())
    p0 = pytree.tree_map(lambda t: t.clone(), params)
    h0 = held()
    batch = pipeline.lm_batch(SEED, 0, B, S, cfg.vocab, device=device)
    placed["batch"] = grew(h0, held())
    step = arch.make_step(cfg, "train")
    with torch.no_grad():
        fwd_loss = float(T.loss_fn(params, batch, cfg)[0])

    def timed_step(opt):
        t = time.perf_counter()
        out = step(params, opt, batch)
        float(out[2]["loss"])                 # waits for the step
        return out, (time.perf_counter() - t) * 1e3

    # ---- step 0, twice from the same state: bitwise -----------------------
    h0 = held()
    opt = adamw.init_state(params)
    placed["opt_state"] = grew(h0, held())
    (_, opt, m0), first_ms = timed_step(opt)
    loss0 = float(m0["loss"])
    tol = TRAIN_BF16["atol"] + TRAIN_BF16["rtol"] * abs(fwd_loss)
    check(abs(loss0 - fwd_loss) <= tol, f"step 0 loss {loss0} vs forward-only "
          f"{fwd_loss} (tolerance {tol})")
    ln_v = float(np.log(cfg.vocab))
    check(abs(loss0 - ln_v) <= 1.0, f"step 0 loss {loss0}, ln V = {ln_v:.3f}")
    after0 = pytree.tree_map(lambda t: t.clone(), params)
    del opt
    with torch.no_grad():
        for a, b in zip(pytree.tree_leaves(params), pytree.tree_leaves(p0)):
            a.copy_(b)
    del p0
    (_, opt, m0b), _ = timed_step(adamw.init_state(params))
    repeat_ok = all(torch.equal(a, b) for a, b in
                    zip(pytree.tree_leaves(params), pytree.tree_leaves(after0)))
    repeat_ok &= all(torch.equal(m0[k], m0b[k]) for k in m0)
    check(repeat_ok, "step 0 from the same state twice: parameters or metrics "
          "differ")
    del after0

    # ---- step 1: AdamW against float64 on three sampled leaves -------------
    rows = min(cfg.vocab, 4096)
    pick = {"embed[:4096]": lambda t: t["embed"][:rows],
            "blocks[0].attn.wq[layer 3]":
                lambda t: t["blocks"][0]["attn"]["wq"][min(3, cfg.n_groups - 1)],
            "blocks[0].mlp.wo[layer 5]":
                lambda t: t["blocks"][0]["mlp"]["wo"][min(5, cfg.n_groups - 1)]}
    f64 = lambda t: t.detach().double().cpu().numpy()  # noqa: E731
    saved = {n: (f64(f(params)), f64(f(opt.m)), f64(f(opt.v)))
             for n, f in pick.items()}
    grads, _, _ = base.gradients(T.loss_fn, params, batch, cfg)
    g_norm = adamw.global_norm(grads)
    g_saved = {n: f64(f(grads)) for n, f in pick.items()}
    del grads
    (_, opt, m1), _ = timed_step(opt)
    check(torch.equal(m1["grad_norm"], g_norm), "step 1's grad_norm differs "
          "from a separate gradient pass on the same state")
    gn, lr, t = float(m1["grad_norm"]), float(m1["lr"]), int(opt.step)
    scale = min(1.0, ocfg.clip_norm / max(gn, 1e-9))
    adam = {}
    for n, f in pick.items():
        p, m, v = saved[n]
        g = g_saved[n] * scale
        m = ocfg.b1 * m + (1 - ocfg.b1) * g
        v = ocfg.b2 * v + (1 - ocfg.b2) * g * g
        mh, vh = m / (1 - ocfg.b1 ** t), v / (1 - ocfg.b2 ** t)
        want = p - lr * (mh / (np.sqrt(vh) + ocfg.eps) + ocfg.weight_decay * p)
        got = f64(f(params))
        ulps = float((np.abs(got - want) / _bf16_ulp(want)).max())
        moved = float((got != p).mean())
        m_err = float(np.abs(f64(f(opt.m)) - m).max() / max(np.abs(m).max(),
                                                            1e-30))
        check(ulps <= 1.0 and m_err <= 1e-5, f"AdamW on {n}: {ulps:.3f} bf16 "
              f"ulps from float64, m within {m_err:.2e}")
        adam[n] = {"max_bf16_ulps": ulps, "moved_share": moved,
                   "m_rel_err": m_err}

    # ---- steps 2-4, timed ------------------------------------------------------
    metrics = [m0, m1]
    step_ms = []
    for _ in range(2, TRAIN_STEPS):
        (_, opt, m), ms = timed_step(opt)
        metrics.append(m)
        step_ms.append(ms)
    losses = [float(m["loss"]) for m in metrics]
    for k, m in enumerate(metrics):
        check(np.isfinite(float(m["grad_norm"])), f"step {k} grad_norm "
              f"{float(m['grad_norm'])}")
        want_lr = adamw.schedule(ocfg, torch.tensor(k + 1, dtype=torch.int32,
                                                    device=device))
        check(torch.equal(m["lr"], want_lr), f"step {k} lr {float(m['lr'])} "
              f"vs schedule {float(want_lr)}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    row = {"B": B, "S": S, "params": cfg.param_count(), "init_s": init_s,
           "forward_only_loss": fwd_loss, "losses": losses,
           "grad_norms": [float(m["grad_norm"]) for m in metrics],
           "lrs": [float(m["lr"]) for m in metrics], "adamw_check": adam,
           "first_step_ms": first_ms, "placed": placed}
    if on_card:
        ms = float(np.median(step_ms))
        tokens = B * S
        n_mat = cfg.param_count() - cfg.vocab * cfg.d_model   # no lookup
        n_layers = cfg.param_count() - 2 * cfg.vocab * cfg.d_model
        attn = 4 * B * cfg.n_heads * S * S * cfg.head_dim * cfg.n_layers
        flops = 6 * n_mat * tokens + 2 * n_layers * tokens + 4 * attn
        busy, wall, top = device_breakdown(lambda: step(params, opt, batch), 1)
        peak = torch.cuda.max_memory_allocated()
        row.update({"step_ms": step_ms, "ms_per_step": ms,
                    "tokens_per_s": tokens / ms * 1e3, "model_flops": flops,
                    "model_flops_share": flops / (ms * 1e-3) / BF16_OPS_PER_S,
                    "device_busy_ms": busy, "wall_ms": wall, "top": top,
                    "max_memory_allocated": peak})
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        log(f"train qwen3-1.7b full width bf16 remat, B x S = {B} x {S} on "
            f"{smi}: {ms:.1f} ms per step (steps 2-4: "
            f"{', '.join(f'{x:.1f}' for x in step_ms)}; first {first_ms:.1f}),"
            f" {row['tokens_per_s']:.0f} tokens/s, model FLOPs {flops:.3e} a "
            f"step = {row['model_flops_share']:.4f} of 989 TFLOP/s, device "
            f"busy {busy:.1f} of {wall:.1f} ms, max_memory_allocated {peak} "
            "bytes")
        log("train step top device kernels (ms): " + json.dumps(top))
    log(f"train qwen3-1.7b full width: losses {losses} (forward-only "
        f"{fwd_loss:.5f}, ln V {ln_v:.4f}), grad_norm "
        f"{[round(x, 4) for x in row['grad_norms']]}, lr {row['lrs']}; step 0 "
        f"twice bitwise; AdamW vs float64: " + json.dumps(adam))
    return row


def train_phase(device: str = "cuda", small: bool = False) -> dict:
    """Phase 18: training (launch counters reset just before, read just
    after: the path is plain PyTorch and launches none of the port's CUDA
    kernels)."""
    from repro_torch.kernels import backend
    backend.reset_launch_counts()
    if small:
        print("reduced: " + json.dumps({"phase 18": "CPU rehearsal: qwen3 "
              "shrunk to 3 layers of d 128, S = 128"}), flush=True)
    else:
        log("reduced: " + json.dumps({
            "phase 18 qwen3-1.7b train_4k": f"B = {TRAIN_B} of 256 at S = "
            f"{TRAIN_S}", "why": "one card's 80 GB: bf16 weights and "
            "gradients 8.1 GB, float32 moments 16.3 GB, float32 logits and "
            "their gradient about 5 GB a sequence"}))
    out, secs = {}, {}
    for name, part in (("smoke", lambda: train_smoke_configs(device)),
                       ("restarts", lambda: train_restarts(device)),
                       ("cli", lambda: train_cli(device)),
                       ("qwen3-1.7b", lambda: train_full_width(device, small))):
        t0 = time.perf_counter()
        out[name] = part()
        secs[name] = round(time.perf_counter() - t0, 1)
    out["seconds"] = secs
    log("phase 18 seconds per part: " + json.dumps(secs))
    counts = backend.launch_counts()
    check(not any(counts.values()), f"the training path launched {counts}")
    out["launches"] = counts
    return out


# ---------------------------------------------------------------------------
# phase 19: the paper's deployment, and the dry run against the card
# ---------------------------------------------------------------------------

DEPLOY_SHARDS = 4
DEPLOY_SEED = SEED + 19
DEPLOY_REPS = 5          # timed repeats of each method's batch
DEPLOY_BRUTE_ROWS = 2
DR_LEAVES = ("docs", "scores", "n_found", "iters", "pops", "overflowed",
             "certified", "bound")


def shard_leaves(idx, aux, base: int) -> dict:
    """One shard as it lies on its device, under the stacked form's leaf
    names (``ShardedWTBC.stack()``, ``wtbc_paper.abstract_sharded``): a
    tensor, or a host int where the stacked form holds an int32 row."""
    out = {}
    for L, lv in enumerate(idx.levels):
        pre = f"['idx']['levels'][{L}]"
        out.update({pre + "['data']": lv.data, pre + "['counts']": lv.counts,
                    pre + "['length']": lv.length})
    for L, o in enumerate(idx.offsets):
        out[f"['idx']['offsets'][{L}]"] = o
    for f in ("cw", "cw_len", "node_off", "base_rank", "sep_pos", "df", "occ",
              "doc_len", "n", "n_docs"):
        out[f"['idx'][{f!r}]"] = getattr(idx, f)
    out.update({"['aux']['words']": aux.bv.words,
                "['aux']['counts']": aux.bv.counts,
                "['aux']['n_bits']": aux.bv.n_bits,
                "['aux']['bit_off']": aux.bit_off,
                "['aux']['has_bm']": aux.has_bm, "['doc_base']": base})
    return out


def shard_bytes_table(sh, abs_sh, mesh) -> dict:
    """Each shard's bytes on its device beside ``abstract_sharded``'s
    per-device bytes, leaf by leaf.  Leaf names and dtypes must be equal;
    the bitmap words lie on the card as int32 bit patterns of the stacked
    form's uint32."""
    import torch
    from repro_torch.configs import wtbc_paper
    from repro_torch.launch import dryrun
    specs = wtbc_paper.ARCH.sharded_specs(abs_sh, mesh.axis_names)
    want = {n: (t, dryrun.device_bytes(t, sp, mesh)) for n, t, sp in
            dryrun.leaves_with_specs(abs_sh, specs)
            if not n.startswith("['global_")}
    rows, totals = [], []
    for s, (idx, aux, base) in enumerate(zip(sh.idx, sh.aux, sh.bases)):
        got = shard_leaves(idx, aux, base)
        check(sorted(got) == sorted(want), f"shard {s} leaves "
              f"{sorted(set(got) ^ set(want))} differ from abstract_sharded's")
        total = 0
        for name, (t_abs, b_abs) in want.items():
            t = got[name]
            if isinstance(t, int):
                card, dtype = "host int", str(t_abs.dtype)
            else:
                card = t.numel() * t.element_size()
                total += card
                dtype = str(t.dtype)
                if name == "['aux']['words']" and t.dtype == torch.int32:
                    dtype = "torch.uint32"          # the same 32 bits
            check(dtype == str(t_abs.dtype), f"shard {s} {name}: {dtype} on "
                  f"the card, {t_abs.dtype} in abstract_sharded")
            if s == 0:
                rows.append({"leaf": name, "dtype": dtype.removeprefix(
                    "torch."), "abstract_bytes": b_abs, "shard0_bytes": card,
                    "shard0_shape": None if isinstance(t, int)
                    else list(t.shape),
                    "abstract_shape": list(t_abs.shape[1:])})
        totals.append(total)
    return {"leaves": rows, "shard_bytes": totals,
            "abstract_bytes": sum(b for _, b in want.values())}


def deploy_phase(device: str = "cuda", n_docs: int | None = None,
                 k1_ms: float | None = None, placed: dict | None = None
                 ) -> dict:
    """Phase 19: (a) the paper's deployment — ``configs/wtbc_paper.py`` at
    block 32,768 — on 4 shards of one card, its four query methods through
    ``WTBCPaperArch.make_query_fn`` against a single index over the same
    documents and a host brute force; (b) the dry run's argument bytes of
    qwen3-1.7b's ``train_4k`` cell at phase 18's B against what phase 18's
    placements added on the card (``placed``); (c) the dry run and roofline
    rows of the ``wtbc`` and qwen3-1.7b cells on the single-pod mesh.
    ``k1_ms``: phase 6's K1 device ms at block 4,096 (M = 32)."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.configs import base, qwen3_1p7b, wtbc_paper
    from repro_torch.core import distributed, drb, mega, ranked, scoring, wtbc
    from repro_torch.kernels import backend, wavelet_descent
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.text import corpus as tcorpus
    on_card = device == "cuda"
    arch = wtbc_paper.ARCH
    cfg = arch.config()
    n_docs = n_docs or DEPLOY_SHARDS * cfg.docs_per_shard
    B, Q, k = cfg.query_batch, cfg.words_per_query, cfg.k
    backend.reset_launch_counts()
    out = {"config": {"block": cfg.block, "shards": DEPLOY_SHARDS,
                      "docs": n_docs, "B": B, "Q": Q, "k": k}}

    secs, t_part = {}, time.perf_counter()

    def part_done(name):
        nonlocal t_part
        secs[name] = round(time.perf_counter() - t_part, 1)
        t_part = time.perf_counter()

    # ---- 19a. the corpus, the shards and a single index --------------------
    t0 = time.perf_counter()
    cp = quarter_all_corpus(n_docs, DEPLOY_SEED)
    t_draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh, model = distributed.build_sharded(
        cp.doc_tokens, cp.vocab_size, DEPLOY_SHARDS, block=cfg.block,
        device=None if on_card else "cpu")
    _sync(device)
    t_build = time.perf_counter() - t0
    dev = sh.devices[0]
    t0 = time.perf_counter()
    single = wtbc.build_index_with_model(cp.doc_tokens, model, cfg.block,
                                         device=dev)
    single_aux = drb.build_aux(single, model, cp.doc_tokens, sh.aux[0].eps,
                               has_bm_override=sh.aux[0].has_bm.cpu().numpy())
    _sync(device)
    t_single = time.perf_counter() - t0
    log("reduced: " + json.dumps({
        "phase 19 deployment": f"{DEPLOY_SHARDS} shards of the config's "
        f"{cfg.docs_per_shard} documents ({n_docs} documents, "
        f"{cp.n_tokens} tokens) on one card; the config deploys 256 shards "
        f"of {cfg.tokens_per_shard} tokens over a 16 x 16 mesh",
        "why": "one card; each shard holds the config's documents, its "
        "tokens follow ALL's mean document length"}))
    fitted = (int(model.s), int(model.c))
    log(f"deployment: {n_docs} documents drawn in {t_draw:.2f} s; "
        f"{DEPLOY_SHARDS} shards built at block {cfg.block} in {t_build:.2f} "
        f"s on {sorted({str(d) for d in sh.devices})}, a single index over "
        f"the same documents in {t_single:.2f} s; (s, c) fitted {fitted}"
        + ("" if fitted == (cfg.s, cfg.c) else
           f", the config's ({cfg.s}, {cfg.c})"))
    check(all(i.levels[0].block == cfg.block for i in sh.idx)
          and single.levels[0].block == cfg.block, "block")
    check((single.s, single.c) == fitted and all(
        (i.s, i.c) == fitted for i in sh.idx), "shards and the single index "
        "use different codes")
    mesh4 = mesh_lib.MeshShape(("data",), (DEPLOY_SHARDS,))
    abs_sh = wtbc_paper.abstract_sharded(cfg, DEPLOY_SHARDS)
    space = shard_bytes_table(sh, abs_sh, mesh4)
    for r in space["leaves"]:
        log(f"  {r['leaf']}: {r['dtype']} shard 0 {r['shard0_bytes']} bytes "
            f"{r['shard0_shape']}, abstract_sharded {r['abstract_bytes']} "
            f"bytes {r['abstract_shape']}")
    log(f"bytes per shard on {dev}: {space['shard_bytes']}; "
        f"abstract_sharded per device: {space['abstract_bytes']}")
    out.update(build_s=t_build, single_build_s=t_single, draw_s=t_draw,
               tokens=cp.n_tokens, fitted_sc=fitted, space=space,
               shard_docs=[i.n_docs for i in sh.idx],
               shard_tokens=[i.n - i.n_docs for i in sh.idx])

    part_done("build")

    # ---- 19a. the queries ----------------------------------------------------
    rank = np.asarray(model.rank_of_word)
    df_word = sh.global_df.cpu().numpy()[rank]
    shard_df = np.stack([i.df.cpu().numpy() for i in sh.idx]).max(0)[rank]
    cap = min(cfg.docs_per_shard, 2048)
    q_all = tcorpus.zipf_real_queries(df_word, B, Q, seed=DEPLOY_SEED)
    q_cap = tcorpus.zipf_real_queries(np.where(shard_df <= cap, df_word, 0),
                                      B, Q, seed=DEPLOY_SEED)
    over = int((shard_df[q_all] > cap).any(1).sum())
    log("reduced: " + json.dumps({
        "phase 19 or queries": f"dr-or and drb-or draw zipf_real_queries "
        f"over the words whose document frequency on every shard is at most "
        f"the config's DRB or gather of {cap} documents (wtbc_paper.py: "
        f"min(docs_per_shard, 2048)); {over} of the {B} rows of the "
        f"unrestricted draw hold a word past it, whose documents past the "
        f"{cap}th on a shard the gather leaves out, and whose DR or pops "
        "most of each shard's tree"}))
    batches = {"dr-and": q_all, "dr-or": q_cap, "drb-and": q_all,
               "drb-or": q_cap}
    idf = sh.global_idf
    tfidf = scoring.TfIdf()

    def encode(q):
        w = torch.from_numpy(rank[q].astype(np.int32)).to(dev)
        return w, torch.ones(w.shape, dtype=torch.bool, device=dev)

    def on_single(method, w, m, **kw):
        if method.startswith("dr-"):
            return mega.topk_dr_mega(single, w, m, idf, k=k,
                                     conjunctive=method == "dr-and",
                                     cap=2 * single.n_docs + 4, **kw)
        if method == "drb-and":
            return drb.topk_drb_and(single, single_aux, w, m, tfidf, k=k,
                                    idf=idf, **kw)
        full = int(single.df[w.long()].max()) + 2
        return drb.topk_drb_or(single, single_aux, w, m, tfidf, k=k,
                               max_df_cap=full, idf=idf, **kw)

    tokens = np.concatenate(cp.doc_tokens)
    ends = np.cumsum([len(t) for t in cp.doc_tokens])
    tally = Tally()
    methods = {}
    # the bytes each method's merge takes from the shards (its first call),
    # held against the dry run's all-gathers in phase 21
    gathered, gather = {}, distributed.gather_candidates

    def gather_spy(results, bases, device_):
        got = gather(results, bases, device_)
        gathered.setdefault(method, {
            "B": int(got[0].shape[0]), "k": k,
            "dtypes": [str(t.dtype) for t in got],
            "bytes": sum(t.numel() * t.element_size() for t in got)})
        return got
    distributed.gather_candidates = gather_spy
    for shape, method in wtbc_paper.SHAPES.items():
        q = batches[method]
        w, m = encode(q)
        query = arch.make_query_fn(cfg, shape, sh.devices)
        (res, launched), first_ms, busy = profiled(
            lambda: tally.run(query, sh, w, m), device)
        t_check = time.perf_counter()
        want = on_single(method, w, m)
        for leaf in ("docs", "scores", "n_found"):
            check(torch.equal(getattr(res, leaf).cpu(),
                              getattr(want, leaf).cpu()),
                  f"deployment {method} differs from the single index on "
                  f"{leaf}")
        check(not bool(res.overflowed.any()), f"{method}: a shard overflowed")
        for row in range(DEPLOY_BRUTE_ROWS):
            bd, bs = host_bruteforce(
                tokens, ends, n_docs, q[row], mode=method.split("-")[1], k=k,
                measure="tfidf",
                eps=sh.aux[0].eps if method.startswith("drb") else None)
            got_d = res.docs[row].cpu().numpy()
            got_s = res.scores[row].cpu().numpy()
            check(np.array_equal(bd, got_d) and np.array_equal(bs, got_s),
                  f"deployment {method} row {row} differs from the host brute "
                  f"force: {bd.tolist()} {bs.tolist()} vs {got_d.tolist()} "
                  f"{got_s.tolist()}")
        check_s = time.perf_counter() - t_check
        ms = [first_ms] + [wall_ms(lambda: query(sh, w, m), device)[0]
                           for _ in range(DEPLOY_REPS - 1)]
        row = {"B": len(q), "ms_per_batch": float(np.median(ms)), "ms": ms,
               "launches": launched, "n_found": res.n_found.tolist(),
               "pops": res.pops.tolist(), "device_busy_ms": busy,
               "checks_s": check_s,
               "idle_share": None if busy is None else 1 - busy / first_ms}
        if on_card:
            expect = {"dr-and": ("wavelet_count", "beam_loop"),
                      "dr-or": ("wavelet_count", "beam_loop"),
                      "drb-and": ("drb_walk",), "drb-or": ("drb_or",)}[method]
            want = {name: DEPLOY_SHARDS for name in expect}
            check(launched == want, f"{method} batch launched {launched}, "
                  f"expected {want}: one launch of each per shard")
        methods[method] = row
        log(f"deployment {method} (B = {len(q)}, Q = {Q}, k = {k}): == "
            f"single index (docs, scores, n_found) and the host brute force "
            f"(rows 0-{DEPLOY_BRUTE_ROWS - 1}); ms per batch "
            f"{row['ms_per_batch']:.3f} ({', '.join(f'{x:.3f}' for x in ms)})"
            f"; launches {launched}; pops per row (summed over shards) "
            f"{row['pops']}; device busy {busy} ms, idle share "
            f"{row['idle_share']}; checks {check_s:.1f} s")
    del tokens
    distributed.gather_candidates = gather
    out.update(methods=methods, drb_or_rows_over_cap=over,
               gathered=gathered)
    part_done("methods")

    # ---- 19a. kernels against their plain versions at block 32,768 --------
    w, m = encode(q_all)
    w8, m8 = w[:8].contiguous(), m[:8].contiguous()
    # the plain DRB or reads every lane's whole 32 KB block: 2 rows within
    # the gather cap (8 unrestricted rows read 7 GB a level)
    wc2, mc2 = (x[:2].contiguous() for x in encode(q_cap))
    idx0, aux0 = sh.idx[0], sh.aux[0]
    idf0 = sh.replicate(idf)[0]
    with OpsRecorder() as rec:       # a plain loop's trips (on the card
        ranked.topk_dr_batch(          # the search calls K1 once)
            idx0, w, m, idf0, k=k, conjunctive=False,
            heap_cap=2 * cfg.docs_per_shard + 4, max_pops=3,
            kernel_backend="ref")
    trip = rec.calls[1]

    def k1(t, kb):
        return wavelet_descent.wavelet_count(
            idx0.levels, idx0.cw, idx0.cw_len, idx0.node_off,
            idx0.base_rank, *t, kernel_backend=kb)
    trip32 = tuple(x[:32].contiguous() for x in trip)
    for t in (trip, trip32):
        check(torch.equal(k1(t, "auto"), k1(t, "ref")),
              f"wavelet_count differs from its plain version at block "
              f"{cfg.block} (M = {t[0].numel()})")
    for name, run in (
            ("drb_walk", lambda kb: drb.topk_drb_and(
                idx0, aux0, w8, m8, tfidf, k=k, idf=idf0, kernel_backend=kb)),
            ("drb_or", lambda kb: drb.topk_drb_or(
                idx0, aux0, wc2, mc2, tfidf, k=k, idf=idf0,
                max_df_cap=int(idx0.df[wc2.long()].max()) + 2,
                kernel_backend=kb))):
        got, want = run("auto"), run("ref")
        bad = [n for n in DR_LEAVES if not torch.equal(getattr(got, n),
                                                       getattr(want, n))]
        check(not bad, f"{name} differs from its plain version at block "
              f"{cfg.block} on {bad}")
    log(f"K1 (M = {trip[0].numel()} and 32), drb_walk (8 rows) and drb_or "
        f"(2 rows) on shard 0 == their plain versions at block {cfg.block}: "
        "bitwise")
    if on_card:
        k1_us = {}
        for t in (trip32, trip):
            kms, _ = profile_device(lambda: k1(t, "auto"), 100,
                                    "wavelet_count_kernel")
            k1_us[t[0].numel()] = kms * 1e3
        log(f"K1 at block {cfg.block}: " + ", ".join(
            f"{v:.3f} µs at M = {mm}" for mm, v in k1_us.items())
            + ("" if k1_ms is None else
               f"; phase 6 at block {BLOCK}: {k1_ms * 1e3:.3f} µs at M = 32"))
        out["k1_us"] = k1_us
        out["k1_us_block4096"] = None if k1_ms is None else k1_ms * 1e3
    out["launches"] = {name: tally.counts.get(name, 0)
                       for name in backend.launch_counts()}
    log("deployment path launches: " + json.dumps(out["launches"]))
    part_done("kernels")

    # ---- 19b. the dry run's argument bytes against the card ---------------
    qarch = qwen3_1p7b.ARCH
    cell = next(c for c in qarch.cells() if c.shape == "train_4k")
    batch = {"batch": {n: base.meta((TRAIN_B, TRAIN_S), base.I32)
                       for n in ("tokens", "labels")}}
    local = mesh_lib.make_local_mesh(device)
    leaves = dryrun.argument_leaves(qarch, cell, local, inputs=batch)
    dry = dryrun.argument_bytes(leaves)
    groups = [g for g in dry if g != "total"]
    n_tensors = {g: sum(1 for g_, _, _ in leaves if g_ == g) for g in groups}
    rounded = {g: sum(-(-b // 512) * 512 for g_, _, b in leaves if g_ == g)
               for g in groups}
    out["dryrun_vs_card"] = {"mesh": local.shape, "dryrun": dry,
                             "tensors": n_tensors, "rounded_512": rounded,
                             "card": placed}
    log(f"dry run of qwen3-1.7b train_4k at B = {TRAIN_B} on {local.shape}: "
        f"argument bytes {json.dumps(dry)} in {json.dumps(n_tensors)} tensors")
    if placed:
        for g in ("params", "opt_state", "batch"):
            got = placed[g]
            check(got["requested"] is None or got["requested"] == dry[g],
                  f"{g}: the card's requested bytes grew by "
                  f"{got['requested']}, the dry run says {dry[g]}")
            slack = got["allocated"] - dry[g]
            check(0 <= slack <= n_tensors[g] * (512 + (1 << 20)),
                  f"{g}: memory_allocated grew by {got['allocated']}, the "
                  f"dry run says {dry[g]}")
            log(f"  {g}: dry run {dry[g]} bytes; the card's requested bytes "
                f"+{got['requested']}, memory_allocated +{got['allocated']} "
                f"(each tensor rounded to 512: {rounded[g]}; "
                f"{'equal' if got['allocated'] == rounded[g] else 'more'})")

    # ---- 19c. the dry run and roofline rows on the single-pod mesh --------
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        t0 = time.perf_counter()
        fails = sum(dryrun.run("single", a, None, force=True,
                               art=Path(tmp))
                    for a in ("wtbc", "qwen3-1.7b"))
        dry_s = time.perf_counter() - t0
        check(fails == 0, f"{fails} dry-run cells failed")
        rows = roofline.load_all("single", art=Path(tmp))
    table = roofline.markdown_table(rows)
    for line in table.splitlines():
        log("  " + line)
    out["roofline"] = [dataclasses.asdict(r) for r in rows]
    out["dryrun_s"] = dry_s
    part_done("dry run")
    out["seconds"] = secs
    log("phase 19 seconds per part: " + json.dumps(secs))
    return out


# ---------------------------------------------------------------------------
# phase 20: MoE at full width, expert-parallel
# ---------------------------------------------------------------------------

MOE_MODS = ("qwen3_moe_235b_a22b", "llama4_scout_17b_a16e")
MOE_MESHES = {"(1, 4)": (("data", "model"), (1, 4)),
              "(2, 2)": (("data", "model"), (2, 2))}
MOE_SHARDS = 4            # model shards at full width, every one on cuda:0
MOE_LAYERS = 4            # full width cut in depth: one card's 80 GB
MOE_B, MOE_S, MOE_STEPS = 2, 4096, 32
MOE_SAMPLE = 16           # tokens of one layer recomputed in float64
MOE_F64_REL = 0.03        # bf16 layer vs float64, of the sampled rows' max
                          # |value|: bf16 rounds the FFN's hidden state, each
                          # copy and each add of the combine (2^-8 each)
MOE_AGREE_MIN = 0.5       # share of decode tokens routed as the forward's
PLACED_TRAIN_TOL = 1e-6   # a train step on placed experts vs unplaced: only
                          # the float32 order of the global norm's sum differs


def _moe_mesh(sizes):
    from repro_torch.launch.mesh import MeshShape
    return MeshShape(("data", "model"), sizes)


def _clone(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda t: t.clone(), tree)


def _placed_err(placed, plain) -> float:
    """Largest |difference| between an LM tree whose experts
    ``place_experts`` split into shards, joined back along the experts'
    dim, and an unsplit tree."""
    import torch
    from repro_torch.checkpoint import ckpt

    def join(v):
        return torch.cat(v, dim=-3) if isinstance(v, tuple) else v
    joined = dict(placed, blocks=[
        dict(b, moe={k: join(v) for k, v in b["moe"].items()})
        for b in placed["blocks"]])
    return max(float((x.double() - y.double()).abs().max())
               for x, y in zip(ckpt.tree_leaves(joined),
                               ckpt.tree_leaves(plain)))


@contextlib.contextmanager
def _routing_log():
    """The expert ids (T, K) of every MoE router call inside, in call
    order, in the list it yields: a check compares two runs' choices there
    (a top-k tie broken the other way moves a token's output by a whole
    expert's).  The EP path routes once a token block, so under a mesh of
    one block the list holds one entry a MoE layer."""
    from repro_torch.models import moe as M
    real, log = M._router, []

    def router(params, x, cfg):
        out = real(params, x, cfg)
        log.append(out[1].detach())
        return out
    M._router = router
    try:
        yield log
    finally:
        M._router = real


def moe_smoke(device: str = "cuda") -> dict:
    """Phase 20a: the llama4-scout and qwen3-moe smoke configs in float32
    (TF32 off) under the meshes (data, model) = (1, 4) and (2, 2), every
    shard on ``device``, the same weights there and on the CPU: ``forward``,
    ``prefill`` and 4 ``decode_step``s (expert parallelism at 2 tokens too)
    within ``LM_FP32_TOL``; one ``make_step(cfg, "train", mesh=...)`` step
    through EP as phase 18a holds it, and the same step on the card with
    the experts placed per shard (``place_experts``) within
    ``PLACED_TRAIN_TOL`` of it; then one MoE layer on a batch whose
    busiest expert overflows the dense capacity but not EP's doubled one:
    EP on the card equals EP on the CPU and differs from the dense
    dispatch, which drops copies."""
    import importlib
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    out = {}
    for mod in MOE_MODS:
        arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
        cfg = arch.config(smoke=True)
        cpu = arch.init_params(cfg, seed=SEED, device="cpu")
        dev = pytree.tree_map(lambda t: t.to(device, copy=True), cpu)
        toks = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab, (2, 16)).astype(np.int32))
        for label, (_, sizes) in MOE_MESHES.items():
            mesh = _moe_mesh(sizes)
            check(M.use_ep(toks.numel(), cfg.moe, mesh) and
                  M.use_ep(2, cfg.moe, mesh), f"{mod} {label}: no EP")
            got = {}
            for d, params in ((device, dev), ("cpu", cpu)):
                t = toks.to(d)
                logits, aux = T.forward(params, t, cfg, mesh=mesh)
                pl, pc = arch.make_step(cfg, "prefill", mesh=mesh)(params, t)
                step = arch.make_step(cfg, "decode", mesh=mesh)
                ring = T.init_cache(cfg, 2, 16, device=d)
                dec = []
                for i in range(4):
                    lg, ring = step(params, ring, t[:, i], i)
                    dec.append(lg)
                got[d] = (logits, pl, torch.stack(dec), aux, pc, ring)
            a, b = got[device], got["cpu"]
            errs = {"forward": _lm_err(a[0], b[0]),
                    "prefill": _lm_err(a[1], b[1]),
                    "decode": _lm_err(a[2], b[2]), "aux": _lm_err(a[3], b[3]),
                    "caches": max(_lm_err(x, y) for ca, cb in
                                  ((a[4], b[4]), (a[5], b[5]))
                                  for pa, pb in zip(ca, cb)
                                  for x, y in zip(pa, pb))}
            check(all(bool(torch.isfinite(x).all()) for x in a[:4]),
                  f"{mod} {label}: non-finite outputs on {device}")
            for what, err in errs.items():
                check(err <= LM_FP32_TOL * (1 + float(b[0].abs().max())),
                      f"{mod} {label}: EP {what} differs between {device} "
                      f"and the CPU by {err:.3e}")
            # one train step through EP from the same state on both sides
            batch = _train_batch(arch, cfg, SEED, 0, "cpu")
            tstep = arch.make_step(cfg, "train", mesh=mesh)
            pc_, _, mc = tstep(_clone(cpu), adamw.init_state(cpu), batch)
            pd_, _, md = tstep(_clone(dev), adamw.init_state(dev),
                               {k: v.to(device) for k, v in batch.items()})
            terr = {k: abs(float(md[k]) - float(mc[k])) /
                    max(abs(float(mc[k])), 1.0) for k in mc}
            for k, e in terr.items():
                check(np.isfinite(float(md[k])) and e <= TRAIN_REL,
                      f"{mod} {label}: EP train metric {k} {float(md[k])} on "
                      f"{device} vs {float(mc[k])} on the CPU")
            share, worst = _step_agree(pd_, pc_, cpu, float(mc["lr"]),
                                       arch.optimizer_cfg().weight_decay)
            check(share >= 0.999 and worst <= 1.0,
                  f"{mod} {label}: EP train step's parameters on {device} vs "
                  f"the CPU: {share:.5f} within 1e-3 lr, worst {worst:.3f}")
            # the same step on the experts placed per shard (views on the
            # card): the one router leaf takes every shard's gradient once
            n_sh = mesh.shape["model"]
            placed = T.place_experts(_clone(dev), cfg, n_sh, [device] * n_sh)
            pq_, _, _ = tstep(placed, adamw.init_state(placed),
                              {k: v.to(device) for k, v in batch.items()})
            placed_err = _placed_err(pq_, pd_)
            check(placed_err <= PLACED_TRAIN_TOL,
                  f"{mod} {label}: a train step on placed experts differs "
                  f"from the unplaced step by {placed_err:.3e}")
            out[f"{cfg.name} {label}"] = {
                **errs, "train_metric_rel_err": max(terr.values()),
                "train_params_within_1e-3_lr": share,
                "train_worst_over_step_bound": worst,
                "train_placed_vs_unplaced": placed_err}
            log(f"MoE {cfg.name} EP {label} ({device} vs CPU, fp32): max "
                f"|err| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; train step: loss {float(md['loss']):.5f}, metrics "
                f"{max(terr.values()):.2e}, parameters {share:.5f} within "
                f"1e-3 lr; placed experts vs unplaced {placed_err:.3e}")
        out[f"{cfg.name} overflow"] = moe_overflow(cfg, device)
    return out


def moe_overflow(cfg, device: str) -> dict:
    """One MoE layer of ``cfg``'s widths (float32) under (1, 4) on 64 tokens
    of which n lean to expert 0, n halfway between the dense capacity and
    EP's: EP keeps every copy, the dense dispatch drops some."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    mesh, T_, D = _moe_mesh((1, 4)), 64, cfg.d_model
    mc = cfg.moe
    p = M.init_moe(L.generator(SEED, "cpu"), D, mc, torch.float32,
                   device="cpu")
    c_dense, c_ep = M.capacity(T_, mc), M.ep_capacity(T_, mc, 4)
    n_hot = (c_dense + c_ep) // 2
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((T_, D)).astype(np.float32)
    x[:, 0] = -1.0
    x[:n_hot, 0] = 5.0
    p["router"][0, 0] = 5.0
    x = torch.from_numpy(x)
    load = int((M._router(p, x, mc)[1] == 0).sum())
    check(c_dense < load <= c_ep, f"overflow batch: expert 0 holds {load} "
          f"copies, dense capacity {c_dense}, EP's {c_ep}")
    pd = {k: (v.to(device) if isinstance(v, torch.Tensor) else
              {kk: vv.to(device) for kk, vv in v.items()})
          for k, v in p.items()}
    ep_dev = M.moe_apply(pd, x.to(device), mc, mesh)[0]
    ep_cpu = M.moe_apply(p, x, mc, mesh)[0]
    dense = M.moe_apply_dense(p, x, mc)[0]
    err, gap = _lm_err(ep_dev, ep_cpu), _lm_err(ep_cpu, dense)
    check(err <= LM_FP32_TOL * (1 + float(ep_cpu.abs().max())),
          f"overflow batch: EP on {device} vs the CPU {err:.3e}")
    check(gap > 0.1, f"overflow batch: EP equals the dense dispatch ({gap})")
    log(f"MoE {cfg.name} overflow batch: expert 0 holds {load} copies "
        f"(dense capacity {c_dense}, EP {c_ep}); EP {device} vs CPU {err:.3e},"
        f" EP vs dense max |diff| {gap:.3f}")
    return {"load": load, "dense_capacity": c_dense, "ep_capacity": c_ep,
            "ep_err": err, "ep_vs_dense": gap}


def _moe_small(cfg):
    """A CPU rehearsal's cut of a full config: same pattern and top-k;
    room for every copy (at 128 tokens a narrow router overflows the
    capacity, and prefill and forward then drop different copies)."""
    import dataclasses
    return dataclasses.replace(
        cfg, d_model=128, n_heads=4, n_kv_heads=2, d_head=32, vocab=1024,
        window=min(cfg.window, 128) if cfg.window else 0,
        moe=dataclasses.replace(cfg.moe, n_experts=min(cfg.moe.n_experts, 16),
                                d_ff=64, capacity_factor=8.0))


def _kept(eidx: np.ndarray, C: int, E: int) -> np.ndarray:
    """(T, K) mask of the copies a block's dispatch keeps: fewer than C
    earlier copies, in (token, k) order, chose the same expert."""
    e = eidx.reshape(-1)
    order = np.argsort(e, kind="stable")
    rank = np.empty_like(order)
    starts = np.searchsorted(e[order], np.arange(E))
    rank[order] = np.arange(e.size) - starts[e[order]]
    return (rank < C).reshape(eidx.shape)


def moe_layer_f64(p, h, gates, eidx, C: int, cfg, rng) -> dict:
    """``MOE_SAMPLE`` tokens of one MoE layer's input ``h`` recomputed in
    float64 on the host from the layer's weights, the path's gates and its
    kept copies (a copy is kept when fewer than C earlier copies, in (token,
    k) order, chose its expert): the routed experts' SwiGLU weighted by the
    gates, plus the shared expert."""
    T_, K = eidx.shape
    keep = _kept(eidx.cpu().numpy(), C, cfg.n_experts)
    rows = np.sort(rng.choice(T_, MOE_SAMPLE, replace=False))
    x = h[rows].double().cpu().numpy()
    g = gates[rows].double().cpu().numpy()
    ids = eidx[rows].cpu().numpy()
    y = np.zeros_like(x)

    def f64(t):
        return t.float().cpu().numpy().astype(np.float64)

    def swiglu(xr, wg, wu, wo):
        a = xr @ wg
        return (a / (1 + np.exp(-a)) * (xr @ wu)) @ wo
    for ex in np.unique(ids):
        wg, wu, wo = (f64(p[k][ex]) for k in ("wi_gate", "wi_up", "wo"))
        for i, r in enumerate(rows):
            for k in range(K):
                if ids[i, k] == ex and keep[r, k]:
                    y[i] += g[i, k] * swiglu(x[i], wg, wu, wo)
    if cfg.n_shared:
        y += swiglu(x, *(f64(p["shared"][k]) for k in ("wi_gate", "wi_up",
                                                        "wo")))
    return {"rows": rows, "want": y, "dropped": int((~keep).sum())}


def moe_full_width(mod: str, device: str = "cuda", small: bool = False
                   ) -> dict:
    """Phase 20b/c: ``mod`` at full width cut to ``MOE_LAYERS`` layers in
    bf16 (random weights from a seeded generator on the card), expert
    parallelism over ``MOE_SHARDS`` shards placed on the card once
    (``place_experts``: views, nothing copied): ``prefill`` of B x S = 2 x
    4,096, the caches placed into rings of S + 32 slots, 32 greedy
    ``decode_step``s, ``forward`` over the extended sequence; then one MoE
    layer: EP at M = 4 against M = 1 and the dense dispatch, and 16 tokens
    against a float64 recomputation on the host.  Decode against forward as
    phase 16b, on the tokens routed alike: a top-k tie broken the other way
    in any layer (bf16 noise moves a router logit) changes a token's output
    by a whole expert's, so those tokens are counted and left out."""
    import importlib
    import dataclasses
    import torch
    from torch.utils import _pytree as pytree
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
    cfg = dataclasses.replace(arch.config(), n_layers=MOE_LAYERS)
    B, S, N = MOE_B, MOE_S, MOE_STEPS
    if small:
        cfg, S, N = _moe_small(cfg), 64, 4
    on_card = device == "cuda"
    mesh4, mesh1 = _moe_mesh((1, MOE_SHARDS)), _moe_mesh((1, 1))
    _peak(device, reset=True)
    t0 = time.perf_counter()
    base = arch.init_params(cfg, seed=SEED, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    w_bytes = sum(t.numel() * t.element_size()
                  for t in pytree.tree_leaves(base))
    alloc = torch.cuda.memory_allocated() if on_card else None
    params = T.place_experts(base, cfg, MOE_SHARDS, [device] * MOE_SHARDS)
    if on_card:
        check(torch.cuda.memory_allocated() == alloc,
              "placing the shards on their own card copied weights")
    gen = torch.Generator(device=device).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device,
                         dtype=torch.int32)
    prefill = arch.make_step(cfg, "prefill", mesh=mesh4)
    decode = arch.make_step(cfg, "decode", mesh=mesh4)
    check(M.use_ep(B * S, cfg.moe, mesh4) and M.use_ep(B, cfg.moe, mesh4),
          f"{cfg.name}: no EP at {B} x {S} tokens")

    # ---- prefill: a first call, then the timed ones ------------------------
    first_ms = wall_ms(lambda: prefill(params, toks), device)[0]
    prefill_ms = _ms(lambda: prefill(params, toks), device, reps=2, warm=0)
    logits, pre = prefill(params, toks)
    check(tuple(logits.shape) == (B, S, cfg.vocab)
          and logits.dtype == torch.float32, f"prefill logits {logits.shape}")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(all(bool(torch.isfinite(x).all()) for p in pre for x in p),
          "non-finite prefill caches")
    first = logits[:, -1].argmax(-1).to(torch.int32)
    del logits

    # ---- the caches placed into decode rings, 32 greedy steps --------------
    caches = T.init_cache(cfg, B, S + N, device=device)
    for (pk, pv), (rk, rv) in zip(pre, caches):
        pos = torch.arange(max(0, S - rk.shape[2]), S, device=device)
        rk[:, :, pos % rk.shape[2]] = pk[:, :, pos]
        rv[:, :, pos % rv.shape[2]] = pv[:, :, pos]
    del pre
    inputs, outs, step_ms, dec_routes = [first], [], [], []
    for t in range(N):
        t0 = time.perf_counter()
        with _routing_log() as routes:
            lg, caches = decode(params, caches, inputs[-1], S + t)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(lg)
        inputs.append(lg.argmax(-1).to(torch.int32))
        dec_routes.append([r.sort(-1).values for r in routes])
    dec = torch.stack(outs, 1)                                   # (B, N, V)
    check(bool(torch.isfinite(dec).all()), "non-finite decode logits")

    # ---- consistency with forward over the extended sequence --------------
    ext = torch.cat([toks, torch.stack(inputs[:N], 1)], 1)      # (B, S + N)
    with _routing_log() as routes:
        fwd_ms, (full, _aux) = wall_ms(lambda: T.forward(
            params, ext, cfg, mesh=mesh4), device)
    fwd_routes = [r.sort(-1).values for r in routes]
    del routes
    ref = full[:, S:].clone()
    del full
    # the same forward again: is the first call's time set-up?
    fwd2_ms = wall_ms(lambda: T.forward(params, ext, cfg, mesh=mesh4
                                        )[0].shape, device)[0]
    # a (b, t) is routed alike when every layer chose the same experts and
    # the forward kept every copy (decode's 2 tokens never overflow)
    c_fwd = M.ep_capacity(B * (S + N), cfg.moe, MOE_SHARDS)
    alike = torch.ones((B, N), dtype=torch.bool, device=device)
    fwd_dropped = 0
    for layer, fr in enumerate(fwd_routes):
        kept = torch.from_numpy(_kept(fr.cpu().numpy(), c_fwd,
                                      cfg.moe.n_experts)).to(device)
        fwd_dropped += int((~kept).sum())
        fr = fr.reshape(B, S + N, -1)[:, S:]
        dr = torch.stack([dec_routes[t][layer] for t in range(N)], 1)
        alike &= (fr == dr).all(-1) & kept.reshape(B, S + N, -1)[:, S:].all(-1)
    n_alike = int(alike.sum())
    check(n_alike >= MOE_AGREE_MIN * B * N,
          f"{cfg.name}: decode routed {n_alike} of {B * N} tokens as the "
          "forward did")
    diff = (dec - ref).abs()
    max_err = float(diff[alike].max())
    mean_err = float(diff.mean(-1)[alike].max())
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = ref.argmax(-1) == torch.stack(inputs[1:], 1).long()
    decided = (margin > 2 * LM_BF16_MAX) & alike
    check(max_err <= LM_BF16_MAX and mean_err <= LM_BF16_MEAN,
          f"{cfg.name}: decode logits differ from forward's on the tokens "
          f"routed alike: max |err| {max_err:.4f} (limit {LM_BF16_MAX}), "
          f"worst step's mean {mean_err:.4f} (limit {LM_BF16_MEAN})")
    check(bool(agree[decided].all()), f"{cfg.name}: a greedy token differs "
          "from forward's argmax where its margin exceeds "
          f"{2 * LM_BF16_MAX} and its routing matched")
    log(f"MoE {cfg.name} full width ({MOE_LAYERS} layers) bf16, EP over "
        f"{MOE_SHARDS} shards: decode vs forward over {S + N} tokens: "
        f"{fwd_dropped} copies dropped by the forward's capacity {c_fwd}; "
        f"{n_alike} of {B * N} tokens routed alike in every layer; on them "
        f"max |err| {max_err:.4f}, worst step's mean {mean_err:.5f}; greedy "
        f"== forward's argmax at {int(agree[alike].sum())} of {n_alike}, at "
        f"all {int(decided.sum())} whose top-2 margin exceeds "
        f"{2 * LM_BF16_MAX}; over every token max |err| "
        f"{float(diff.max()):.4f}")
    del ref, diff, dec

    # ---- one MoE layer: M = 4 against M = 1 and dense; float64 -----------
    p0 = T.layers(base, cfg)[0][2]["moe"]
    h = torch.randn((B * S, cfg.d_model), generator=gen, device=device,
                    dtype=torch.float32).to(cfg.dtype)
    out4 = M.moe_apply(p0, h, cfg.moe, mesh4)[0]
    out1 = M.moe_apply(p0, h, cfg.moe, mesh1)[0]
    outd = M.moe_apply_dense(p0, h, cfg.moe)[0]
    C = M.ep_capacity(B * S, cfg.moe, MOE_SHARDS)
    check(C == M.ep_capacity(B * S, cfg.moe, 1), "M = 1 and M = 4 slots")
    layer_m4_m1 = _lm_err(out4, out1)
    layer_m4_dense = _lm_err(out4, outd)
    gates, eidx = M._router(p0, h, cfg.moe)[:2]
    f64 = moe_layer_f64(p0, h, gates, eidx, C, cfg.moe,
                        np.random.default_rng(SEED))
    got = out4[torch.from_numpy(f64["rows"]).to(device)].double().cpu().numpy()
    f64_err = float(np.abs(got - f64["want"]).max())
    scale = float(np.abs(f64["want"]).max())
    check(np.isfinite(got).all() and f64_err <= MOE_F64_REL * scale,
          f"{cfg.name}: layer 0 vs float64 on {MOE_SAMPLE} tokens: max |err| "
          f"{f64_err:.4g} of {scale:.4g} (limit {MOE_F64_REL})")
    log(f"MoE {cfg.name} layer 0 at {B * S} tokens (C = {C} a local expert, "
        f"{f64['dropped']} of {eidx.numel()} copies dropped): EP M = 4 vs "
        "M = 1 " + ("bitwise equal" if layer_m4_m1 == 0 else
                    f"max |diff| {layer_m4_m1:.4g}") + "; vs dense "
        f"(C = {M.capacity(B * S, cfg.moe)}) max |diff| {layer_m4_dense:.4g};"
        f" {MOE_SAMPLE} tokens vs float64 on the host: max |err| "
        f"{f64_err:.4g} of max |value| {scale:.4g}")
    del out4, out1, outd, h

    # ---- prefill end to end: M = 4 against M = 1; times of the three ------
    pre1 = arch.make_step(cfg, "prefill", mesh=mesh1)
    pred = arch.make_step(cfg, "prefill")
    l4 = prefill(params, toks)[0]
    l1 = pre1(base, toks)[0]
    e2e_m4_m1 = _lm_err(l4, l1)
    del l4, l1
    m1_ms = _ms(lambda: pre1(base, toks), device, reps=2)
    dense_ms = _ms(lambda: pred(base, toks), device, reps=2)
    busy = wall = None
    top = []
    if on_card:
        busy, wall, top = device_breakdown(lambda: prefill(params, toks), 1)
    peak = _peak(device)
    dec_ms = float(np.median(step_ms))
    row = {"layers": MOE_LAYERS, "shards": MOE_SHARDS, "weight_bytes": w_bytes,
           "init_s": init_s, "prefill_first_ms": first_ms,
           "prefill_ms": prefill_ms, "prefill_m1_ms": m1_ms,
           "prefill_dense_ms": dense_ms,
           "prefill_tokens_per_s": None if prefill_ms is None else
           B * S / prefill_ms * 1e3,
           "prefill_device_busy_ms": busy, "prefill_wall_ms": wall,
           "prefill_top": top, "decode_ms_per_step": dec_ms,
           "decode_ms_steps": step_ms, "forward_ms": fwd_ms,
           "forward_again_ms": fwd2_ms,
           "max_memory_allocated": peak, "routed_alike": n_alike,
           "forward_dropped_copies": fwd_dropped,
           "tokens": B * N, "max_abs_err": max_err,
           "worst_step_mean_abs_err": mean_err,
           "layer_m4_vs_m1": layer_m4_m1, "layer_m4_vs_dense": layer_m4_dense,
           "prefill_m4_vs_m1": e2e_m4_m1, "layer_f64_err": f64_err,
           "layer_f64_scale": scale, "capacity": C}
    log(f"MoE {cfg.name} full width on "
        f"{torch.cuda.get_device_name(0) if on_card else device}: "
        f"{w_bytes} weight bytes, prefill {B}x{S} {prefill_ms} ms (EP M = 4; "
        f"first call {first_ms:.1f} ms; M = 1 {m1_ms} ms, dense {dense_ms} "
        f"ms; device busy {busy} of {wall} ms), decode {dec_ms:.3f} ms per "
        f"step (median of {N}, host clock to a synchronize), forward over "
        f"{S + N} {fwd_ms:.1f} ms (again {fwd2_ms:.1f} ms), "
        f"max_memory_allocated {peak} bytes; "
        "prefill logits M = 4 vs M = 1 " + ("bitwise equal" if e2e_m4_m1 == 0
                                             else f"max |diff| {e2e_m4_m1:.4g}"))
    if top:
        log(f"MoE {cfg.name} prefill top device kernels (ms): "
            + json.dumps(top))
    return row


def moe_phase(device: str = "cuda", small: bool = False) -> dict:
    """Phase 20: MoE at full width, expert-parallel (launch counters reset
    just before, read just after: the path is plain PyTorch and launches
    none of the port's CUDA kernels).  Each full-width model is freed before
    the next."""
    import gc
    import torch
    from repro_torch.kernels import backend
    backend.reset_launch_counts()
    t0 = time.perf_counter()
    out = {"smoke": moe_smoke(device)}
    secs = {"smoke": round(time.perf_counter() - t0, 1)}
    if device == "cuda" or small:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip() if device == "cuda" \
            else "not measured (CPU rehearsal)"
        for mod in MOE_MODS:
            t0 = time.perf_counter()
            out[mod] = moe_full_width(mod, device, small=small)
            secs[mod] = round(time.perf_counter() - t0, 1)
            r = out[mod]
            log(f"MoE {mod} times ({smi}): prefill {r['prefill_ms']} ms "
                f"(EP M = 4), M = 1 {r['prefill_m1_ms']} ms, dense "
                f"{r['prefill_dense_ms']} ms; decode "
                f"{r['decode_ms_per_step']:.3f} ms per step; "
                f"max_memory_allocated {r['max_memory_allocated']}")
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
    counts = backend.launch_counts()
    check(not any(counts.values()), f"the MoE path launched {counts}")
    out["launches"] = counts
    out["seconds"] = secs
    log("phase 20 seconds per part: " + json.dumps(secs))
    return out


#: phase 21's cut of the examples: sizes whose CPU run (the reference
#: answers) stays within the phase's time
EXAMPLE_SEARCH = dict(docs=1000, vocab=20000, batch=16, k=10)
EXAMPLE_SHARDED = dict(docs=1000, n_queries=16)


def _example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "examples"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _answers_equal(a: dict, b: dict) -> list[str]:
    """The leaves where two examples' answers ({workload: {leaf: array}})
    differ."""
    return [f"{w}/{n}" for w in a for n in a[w]
            if not np.array_equal(a[w][n], b[w][n])] + \
        [w for w in set(a) ^ set(b)]


def collectives_phase(dep: dict | None, device: str = "cuda") -> dict:
    """Phase 21: (a) both search examples' ``run`` on ``device`` against
    ``run("cpu")``, every answer leaf bitwise, with the launches of the
    card's runs (counts reset just before, read just after); (b) the dry
    run's ``wtbc`` count on a one-axis mesh of phase 19's 4 shards at each
    method's phase-19 batch and k: its all-gather bytes against the bytes
    ``merge_topk`` took from the shards there (``dep["gathered"]``: the
    numel x element size of the gathered documents and scores); (c) the
    ``wtbc`` and EP collective rows of the dry run on both production
    meshes (NVLink 4's 450e9 B/s one way: a data-sheet figure)."""
    import dataclasses
    from repro_torch.configs import registry, wtbc_paper
    from repro_torch.kernels import backend
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    out, secs, t0 = {}, {}, time.perf_counter()
    se = _example("torch_search_engine")
    dr = _example("torch_distributed_retrieval")
    log("reduced: " + json.dumps({
        "phase 21 examples": f"torch_search_engine at {EXAMPLE_SEARCH}, "
        f"torch_distributed_retrieval at {EXAMPLE_SHARDED} (8 shards)",
        "why": "the CPU answers they are held against come from the plain "
        "heap core on the host within the phase's time"}))
    cpu_se = se.run("cpu", warm=False, **EXAMPLE_SEARCH)
    cpu_dr = dr.run("cpu", warm=False, **EXAMPLE_SHARDED)
    secs["cpu"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    backend.reset_launch_counts()
    dev_se = se.run(device, **EXAMPLE_SEARCH)
    dev_dr = dr.run(device, **EXAMPLE_SHARDED)
    out["launches"] = counts = backend.launch_counts()
    secs[device] = round(time.perf_counter() - t0, 1)
    for name, a, b in (("torch_search_engine", dev_se["answers"],
                        cpu_se["answers"]),
                       ("torch_distributed_retrieval", dev_dr["sharded"],
                        cpu_dr["sharded"]),
                       ("torch_distributed_retrieval single",
                        dev_dr["single"], cpu_dr["single"])):
        bad = _answers_equal(a, b)
        check(not bad, f"{name} on {device} differs from the CPU: {bad}")
    found = {w: int(v["n_found"].sum()) for w, v in dev_se["answers"].items()}
    log(f"examples on {device} == on the CPU, every leaf bitwise; hits per "
        f"workload {found}; ms per query {dev_se['ms_per_query']} and "
        f"sharded {dev_dr['ms_per_query']}; launches {counts}")
    if device == "cuda":
        for kname in ("wavelet_count", "beam_loop", "heap_loop", "drb_walk",
                      "drb_or", "wtbc_locate", "wtbc_decode"):
            check(counts[kname] > 0, f"the examples launched no {kname}")
    out.update(examples_found=found, ms_per_query=dev_se["ms_per_query"],
               sharded_ms_per_query=dev_dr["ms_per_query"])

    # (b) the deployment's gathers: the dry run against the card
    t0 = time.perf_counter()
    arch = wtbc_paper.ARCH
    mesh4 = mesh_lib.MeshShape(("data",), (DEPLOY_SHARDS,))
    rows = []
    for shape, method in wtbc_paper.SHAPES.items():
        got = (dep or {}).get("gathered", {}).get(method)
        check(got is not None, f"phase 19 recorded no merge for {method}")
        cell = next(c for c in arch.cells() if c.shape == shape)
        rec = dryrun.lower_cell(arch, cell, mesh4, "phase19", cfg_override=(
            lambda c, B=got["B"]: dataclasses.replace(c, query_batch=B)))
        ag = rec["collectives"]["all-gather"]
        check(ag["bytes"] == got["bytes"] and ag["count"] == 2,
              f"{method}: the dry run's all-gathers {ag} differ from the "
              f"{got['bytes']} bytes the merge took from the shards")
        rows.append({"method": method, "B": got["B"], "k": got["k"],
                     "all_gather": ag, "gathered_bytes": got["bytes"],
                     "all_reduce": rec["collectives"]["all-reduce"]})
        log(f"wtbc {method} on 1 x {DEPLOY_SHARDS} (B = {got['B']}, k = "
            f"{got['k']}): dry-run all-gathers {ag} == the merge's gathered "
            f"{got['bytes']} bytes ({got['dtypes']}); all-reduces "
            f"{rec['collectives']['all-reduce']}")
    out["wtbc_phase19"] = rows

    # (c) the wtbc and EP rows on the production meshes
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if device == "cuda" \
        else "not measured (CPU rehearsal)"
    prod = []
    for mesh_name in ("single", "multi"):
        mesh = mesh_lib.make_production_mesh(multi_pod=mesh_name == "multi")
        for cell in arch.cells():
            ops = dryrun.wtbc_collectives(arch, cell, arch.config(), mesh)
            r = dryrun.collective_record(ops)
            prod.append({"cell": cell.cell_id, "mesh": mesh_name,
                         "collectives": r,
                         "collective_s": r["total_bytes"] / mesh_lib.LINK_BW})
        for name in ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"):
            a = registry.get(name)
            for cell in a.cells():
                if cell.skip:
                    continue
                cfg = a.config_for(cell.shape)
                layout = dryrun.ep_layout(a, cell, cfg, mesh)
                if layout is None:
                    prod.append({"cell": cell.cell_id, "mesh": mesh_name,
                                 "ep": None})
                    continue
                psum = dryrun.ep_psum(cfg, layout)
                prod.append({"cell": cell.cell_id, "mesh": mesh_name,
                             "ep_psum": psum,
                             "psum_s": psum["bytes"] / mesh_lib.LINK_BW})
    for r in prod:
        log("collective row (NVLink 450e9 B/s one way, data sheet; "
            f"{smi}): " + json.dumps(r))
    out["production_rows"] = prod
    secs["dry_run"] = round(time.perf_counter() - t0, 1)
    out["seconds"] = secs
    log("phase 21 seconds per part: " + json.dumps(secs))
    return out


def profiled(fn, device: str, trace: bool = True):
    """(``fn()``, host ms around it ending in a synchronize, device busy ms)
    of one call, traced by ``torch.profiler`` with device activity only (no
    host-op tracing, so the host time is the call's own); busy is None where
    the session recorded no device time, on the CPU, and without
    ``trace``."""
    if device != "cuda" or not trace:
        ms, out = wall_ms(fn, device)
        return out, ms, None
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)
    return out, wall, busy if busy > 0 else None


if __name__ == "__main__":
    sys.exit(main())
