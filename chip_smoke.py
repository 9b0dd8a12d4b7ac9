#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (slice 1: WTBC-DR search).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py            # the full run (86,445 documents)
    python3 chip_smoke.py --docs 4000   # a short rehearsal of every phase

Phases (any failure exits non-zero; no phase is caught and ignored, and
nothing falls back to the CPU):

1. build  — compile both CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once); print the card's name and power limit.
2. data   — a quarter of the paper's ALL collection (718,691-word vocabulary,
   Zipf 1.2, mean 633 tokens per document): 86,445 documents, about 55 M
   tokens, drawn from a seed in one vectorized draw; index built on the
   host at block 4096 and moved to the card.
3. K1     — ``wavelet_count`` against its plain version on the card: 4,096
   random triples (with lo = hi and hi = n) plus every triple of real
   ranked and mega trips; bitwise.
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
   for the same work (bytes at 3.35 TB/s, byte compares at 1,979 TOPS),
   and ms per batch per core.

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

def time_cuda(fn, reps: int, warm: int = 3, setup=None) -> float:
    """ms per call of ``fn`` on the card: CUDA events around each call
    (``setup`` runs outside the timed span), after ``warm`` untimed calls."""
    import torch
    for _ in range(warm):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def profile_device(fn, reps: int, kernel: str | None = None
                   ) -> tuple[float, float]:
    """Run ``fn`` ``reps`` times under ``torch.profiler`` and return (device
    ms per call of the kernels whose name holds ``kernel`` — or of all
    kernels when None —, wall ms per call).  Device time is the sum of the
    kernels' own times on the card, so host overhead between launches is
    not in it."""
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
    dev_us = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or (
                kernel is not None and kernel not in e.key):
            continue
        dev_us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
    return dev_us / 1e3 / reps, wall


def wall_ms(fn) -> tuple[float, object]:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


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


class TripRecorder:
    """Records the (words, los, his) of every count batch a search makes,
    by wrapping ``kernels.ops.wavelet_count_batch`` for the duration."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops, self._orig = ops, ops.wavelet_count_batch

        def wrapped(levels, cw, cw_len, node_off, base_rank, words, los, his,
                    **kw):
            self.calls.append((words.clone(), los.clone(), his.clone()))
            return self._orig(levels, cw, cw_len, node_off, base_rank, words,
                              los, his, **kw)
        ops.wavelet_count_batch = wrapped
        return self

    def __exit__(self, *exc):
        self._ops.wavelet_count_batch = self._orig


def descent_bytes(idx, words, los, his, *, distinct_nonempty=False
                  ) -> tuple[int, int]:
    """(bytes, byte compares) the count descent of these triples needs: per
    level it visits, the distinct tile prefixes [0, p - blk*block) and
    counter cells its endpoints touch, each read once, plus each triple's
    inputs, word tables and output.  Compares: every prefix byte counted.
    ``distinct_nonempty`` keeps one copy of each triple with lo < hi (the
    descents a search loop really needs: a plain trip also descends for
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
        blk = torch.clamp(pos // lv.block, max=lv.n_blocks - 1).long()
        cut = (pos - blk.to(torch.int32) * lv.block).long()
        if bool(need.any()):
            widest = torch.zeros(lv.n_blocks, dtype=torch.long, device=pos.device)
            widest.scatter_reduce_(0, blk[need], cut[need], "amax")
            cells = torch.unique(blk[need] * 256 + torch.cat([byte, byte])[need])
            nbytes += int(widest.sum()) + 4 * int(cells.numel())
            compares += int(cut[need].sum())
        r = bytemap.rank(lv, torch.cat([byte, byte]), pos)
        a, b = r[:M] - base, r[M:] - base
    return nbytes, compares


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
    with TripRecorder() as rec16:
        ranked.topk_dr_batch(idx, words_t, wmask_t, idf, k=K, conjunctive=False,
                             heap_cap=2 * idx.n_docs + 4, beam_width=16,
                             max_pops=9 * 16)
    with TripRecorder() as rec1:
        mega.topk_dr_mega(idx, words_t, wmask_t, idf, k=K, conjunctive=False,
                          cap=idx.n_docs + 2, max_pops=8, kernel_backend="ref")
    k1_sets = [("random", (w, lo, hi))] + \
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
    with TripRecorder() as rec:
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
        dev, wall = profile_device(
            lambda: engine.search(q, k=K, mode="or", **prof), 1)
        log(f"core {label} (or, band ii): device busy {dev:.3f} ms of "
            f"{wall:.3f} ms wall, idle share {1 - dev / wall:.4f}")
    log("launches per batch: " + json.dumps(per_batch))
    log(json.dumps({"launches": counts,
                    "kernels": [k["name"] for k in kernels]}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
