#!/usr/bin/env python3
"""A/B timings of the count-descent kernels (K1 ``wavelet_count``, K2
``beam_loop``) between two source trees, on one card, in one process.

    python3 scripts/descent_ab.py --csrc parent=build/parent/src/repro_torch/csrc \\
        --csrc change=src/repro_torch/csrc [--stamps] [--e2e] [--docs N]

Each ``--csrc TAG=DIR`` names a ``csrc`` directory whose ``wavelet_descent.cu``
and ``beam_step.cu`` keep the C interface of this tree's wrappers.  The script
builds both kernels of every tree with ``nvcc``, builds the ALL/4 index of
``chip_smoke.py`` once (same corpus, seed and query batches), and then, for
rounds in the order A, B, B, A, swaps each tree's libraries into the
wrappers and measures, at the main path's shapes:

* K1 device time (``torch.profiler``) at M = 32 (a mega trip), a P = 16
  trip and 4,096 random triples, and its wrapper time;
* K2 device time on the ``or`` band iii batch of B = 8 (state reset before
  each launch), and its wrapper time;
* with ``--e2e``: ms per batch (host clock) of the heap core at P = 1 and
  P = 16, the mega core, DRB tf-idf and DRB BM25 on the four batches.

Every tree's results are first held bitwise against the plain versions.

``--stamps`` also builds, for every tree, a throwaway copy of its
``beam_step.cu`` with ``clock64()`` stamps taken by thread 0 after every
``__syncthreads()`` and ``__syncwarp()`` of the trip loop (the copy goes to ``build/``, never into
the sources), runs it once on the same batch and prints the cycles of each
phase of a trip; ``--phases TAG=name,name,...`` names them in source order.

Prints the card's name and power limit, one line per measurement, and as its
last line a JSON object of every number.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "descent_ab"
MAX_ROWS, MAX_STAMPS = 1024, 16

_STAMP_DECL = """
__device__ unsigned long long g_stamp_acc[%d][%d];
__device__ unsigned long long g_stamp_n[%d][%d];
extern "C" int beam_loop_stamps(void* acc, void* n) {
  cudaMemcpyFromSymbol(acc, g_stamp_acc, sizeof(g_stamp_acc));
  cudaMemcpyFromSymbol(n, g_stamp_n, sizeof(g_stamp_n));
  return static_cast<int>(cudaGetLastError());
}
""" % (MAX_ROWS, MAX_STAMPS, MAX_ROWS, MAX_STAMPS)


def instrument(src: str) -> tuple[str, int]:
    """The beam loop's source with a clock64() stamp by thread 0 after every
    __syncthreads() and __syncwarp() of its trip loop; returns (source,
    number of stamps)."""
    m = re.search(r"for \(int trip = 0;; \+\+trip\) \{", src)
    if m is None:
        raise ValueError("no trip loop found")
    depth, end = 0, None
    for i in range(m.end() - 1, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            end = i
            break
    body = src[m.end():end]
    k = 0

    def stamp(m):
        nonlocal k
        k += 1
        return (m.group(0) + " if (threadIdx.x == 0) { long long t_ = "
                f"clock64(); st_acc[{k - 1}] += t_ - st_last; "
                f"st_n[{k - 1}] += 1; st_last = t_; }}")
    body = re.sub(r"__syncthreads\(\);|__syncwarp\(\);", stamp, body)
    if not 0 < k <= MAX_STAMPS:
        raise ValueError(f"{k} stamps")
    head = (f"unsigned long long st_acc[{k}] = {{0}}, st_n[{k}] = {{0}}; "
            "long long st_last = clock64();\n  ")
    tail = ("\n  if (threadIdx.x == 0 && blockIdx.x < %d) for (int s_ = 0; "
            "s_ < %d; ++s_) { g_stamp_acc[blockIdx.x][s_] = st_acc[s_]; "
            "g_stamp_n[blockIdx.x][s_] = st_n[s_]; }" % (MAX_ROWS, k))
    out = (src[:m.start()] + head + src[m.start():m.end()] + body
           + src[end:end + 1] + tail + src[end + 1:])
    out = out.replace('#include "wtbc_descent.cuh"',
                      '#include "wtbc_descent.cuh"\n' + _STAMP_DECL, 1)
    return out, k


def nvcc_all(jobs) -> None:
    """jobs: (source, include dir, output) — all nvcc processes at once."""
    from repro_torch.kernels import backend
    nvcc = backend._nvcc()
    procs = [(src, out, subprocess.Popen(
        [nvcc, *backend.NVCC_FLAGS, f"-I{inc}", "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, inc, out in jobs]
    for src, out, p in procs:
        log_ = p.communicate()[0]
        for ln in log_.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {out.name}: {ln.strip()}")
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {src}:\n{log_[-4000:]}")


POOL_LEAVES = ("pool.scores", "pool.d0", "pool.d1", "pool.tf", "pool.size",
               "pool.overflowed", "out_docs", "out_scores", "n_out", "iters",
               "pops")


def leaves(st):
    """A mega state's arrays, the pool's without the scratch column (which
    only the plain bulk insert writes)."""
    cap = st.pool.cap
    return (*(x[:, :cap] for x in st.pool[:4]), *st.pool[4:], *st[1:])


def load(kernel, so: Path):
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, kernel.name)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    err = getattr(lib, f"{kernel.name}_error_string")
    err.argtypes, err.restype = (ctypes.c_int,), ctypes.c_char_p
    return lib, fn, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", required=True,
                    help="TAG=DIR of a csrc tree (repeat: A then B)")
    ap.add_argument("--phases", action="append", default=[],
                    help="TAG=name,name,... names of the stamped phases")
    ap.add_argument("--docs", type=int, default=cs.QUARTER_DOCS)
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("descent_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.core import mega, ranked
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import backend, beam_step, wavelet_descent
    from repro_torch.text import corpus as tcorpus

    trees = dict(s.split("=", 1) for s in args.csrc)
    names = {t: n.split(",") for t, n in (s.split("=", 1) for s in args.phases)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # ---- build every tree's K1 and K2 (and the stamped K2 copies)
    shutil.rmtree(OUT, ignore_errors=True)
    jobs, libs = [], {}
    for tag, d in trees.items():
        d = (ROOT / d).resolve()
        od = OUT / tag
        od.mkdir(parents=True)
        for kern in (backend.WAVELET_COUNT, backend.BEAM_LOOP):
            jobs.append((d / kern.source, d, od / f"{kern.name}.so"))
        if args.stamps:
            sd = od / "stamps"
            sd.mkdir()
            for h in d.glob("*.cuh"):
                shutil.copy(h, sd / h.name)
            text, _ = instrument((d / "beam_step.cu").read_text())
            (sd / "beam_step.cu").write_text(text)
            jobs.append((sd / "beam_step.cu", sd, od / "beam_loop_stamps.so"))
    nvcc_all(jobs)
    for tag in trees:
        od = OUT / tag
        libs[tag] = {k.name: load(k, od / f"{k.name}.so")
                     for k in (backend.WAVELET_COUNT, backend.BEAM_LOOP)}
        if args.stamps:
            libs[tag]["stamps"] = load(backend.BEAM_LOOP,
                                       od / "beam_loop_stamps.so")

    def use(tag, k2="beam_loop"):
        for kern, key in ((backend.WAVELET_COUNT, "wavelet_count"),
                          (backend.BEAM_LOOP, k2)):
            _, kern._fn, kern._err = libs[tag][key]

    # ---- the index and the batches of chip_smoke.py
    dev = torch.device("cuda")
    cp = cs.quarter_all_corpus(args.docs, cs.SEED)
    engine = SearchEngine.build(cp, EngineConfig(block=cs.BLOCK), device=dev)
    idx = engine.idx
    df_word = idx.df.cpu().numpy()[engine.model.rank_of_word]
    bands = tcorpus.fdoc_bands(args.docs)
    batches = []
    for i, (mode, band) in enumerate([("and", "ii"), ("or", "ii"),
                                      ("and", "iii"), ("or", "iii")]):
        q = tcorpus.sample_queries(df_word, bands[band], cs.B, 3,
                                   seed=cs.SEED + i)
        batches.append((mode, band, q))
    idf = engine._idf_table(engine._resolve_measure("tfidf"))
    ranks, masks = engine._encode_queries(batches[3][2])
    wt = torch.from_numpy(ranks).to(dev)
    mt = torch.from_numpy(masks).to(dev)
    rng = np.random.default_rng(cs.SEED)
    n, M = idx.n, 4096
    w = torch.from_numpy(rng.integers(1, idx.vocab_size, M).astype(np.int32)).to(dev)
    lo = rng.integers(0, n + 1, M)
    hi = np.minimum(n, lo + rng.integers(0, 1 << 20, M))
    lo[:64] = hi[:64]
    hi[64:128] = n
    lo, hi = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (lo, hi))
    with cs.OpsRecorder() as rec16:
        ranked.topk_dr_batch(idx, wt, mt, idf, k=cs.K, conjunctive=False,
                             heap_cap=2 * idx.n_docs + 4, beam_width=16,
                             max_pops=9 * 16)
    with cs.OpsRecorder() as rec1:
        mega.topk_dr_mega(idx, wt, mt, idf, k=cs.K, conjunctive=False,
                          cap=idx.n_docs + 2, max_pops=8, kernel_backend="ref")
    shapes = {"M=%d (mega trip)" % rec1.calls[1][0].numel(): rec1.calls[1],
              "M=%d (P=16 trip)" % rec16.calls[1][0].numel(): rec16.calls[1],
              "M=4096 (random)": (w, lo, hi)}

    def k1(trip, kb="auto"):
        return wavelet_descent.wavelet_count(
            idx.levels, idx.cw, idx.cw_len, idx.node_off, idx.base_rank,
            *trip, kernel_backend=kb)

    idf_w = torch.where(mt, idf[wt.long()], 0.0).to(torch.float32)
    st0 = mega.init_state(idx, wt, mt, idf_w, k=cs.K, conjunctive=False,
                          cap=idx.n_docs + 2, kernel_backend="ref")
    holder = {}

    def fresh():
        holder["st"] = st0.clone()

    def k2(kb="auto"):
        holder["st"] = beam_step.beam_loop(idx, holder["st"], wt, mt, idf_w,
                                           k=cs.K, conjunctive=False,
                                           max_pops=None, kernel_backend=kb)
    fresh()
    k2("ref")
    want2 = holder["st"]
    want1 = {s: k1(t, "ref") for s, t in shapes.items()}

    # ---- correctness of every tree, then the stamped trip breakdown
    res = {"device": smi, "trees": trees, "rounds": []}
    for tag in trees:
        use(tag)
        for s, t in shapes.items():
            if not torch.equal(k1(t), want1[s]):
                raise SystemExit(f"{tag}: wavelet_count differs at {s}")
        fresh()
        k2()
        got = holder["st"]
        for name, x, y in zip(POOL_LEAVES, leaves(got), leaves(want2)):
            if not torch.equal(x, y):
                raise SystemExit(f"{tag}: beam_loop differs from plain on "
                                 f"{name}")
        print(f"{tag}: K1 and K2 bitwise equal to their plain versions",
              flush=True)
    if args.stamps:
        res["stamps"] = {}
        for tag in trees:
            use(tag, "stamps")
            fresh()
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            k2()
            ev[1].record()
            torch.cuda.synchronize()
            acc = np.zeros((MAX_ROWS, MAX_STAMPS), np.uint64)
            cnt = np.zeros((MAX_ROWS, MAX_STAMPS), np.uint64)
            lib = libs[tag]["stamps"][0]
            lib.beam_loop_stamps.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
            code = lib.beam_loop_stamps(acc.ctypes.data, cnt.ctypes.data)
            if code:
                raise SystemExit(f"stamps copy failed: {code}")
            B = wt.shape[0]
            acc, cnt = acc[:B].astype(np.float64), cnt[:B].astype(np.int64)
            used = int(np.max(np.nonzero(cnt.sum(0))[0])) + 1
            trips = int(cnt[:, 0].sum())
            longest = int(np.argmax(cnt[:, 0]))
            pn = names.get(tag, [f"stamp{i}" for i in range(used)])
            tot = acc[:, :used].sum()
            rows = []
            for i in range(used):
                rows.append({"phase": pn[i] if i < len(pn) else f"stamp{i}",
                             "cycles_per_trip": float(acc[:, i].sum() / trips),
                             "share": float(acc[:, i].sum() / tot),
                             "passes": int(cnt[:, i].sum())})
                print(f"{tag} stamped K2 phase {rows[-1]['phase']}: "
                      f"{rows[-1]['cycles_per_trip']:.1f} cycles per trip, "
                      f"share {rows[-1]['share']:.4f}", flush=True)
            kern_ms = ev[0].elapsed_time(ev[1])
            res["stamps"][tag] = {
                "phases": rows, "trips": trips,
                "longest_row_trips": int(cnt[longest, 0]),
                "longest_row_cycles": float(acc[longest, :used].sum()),
                "stamped_call_ms": kern_ms}
            print(f"{tag} stamped K2: {trips} trips over {B} rows, longest "
                  f"row {int(cnt[longest, 0])} trips in "
                  f"{acc[longest, :used].sum():.0f} cycles; stamped call "
                  f"{kern_ms:.4f} ms", flush=True)
            use(tag)

    # ---- rounds A, B, B, A
    order = list(trees)
    order = order + order[::-1] if len(order) > 1 else order * 2
    profiles = [("P=1", dict()), ("P=16", dict(beam_width=16)),
                ("mega", dict(mega=True))]
    if args.e2e:                  # executors and DRB bitmaps are set-up
        engine.aux
        warm = [list(map(int, batches[0][2][0]))]
        for mode in ("and", "or"):
            for _, prof in profiles:
                for budget in (None, 64):
                    engine.warmup(warm, max_batch=cs.B, k=cs.K, mode=mode,
                                  budget=budget, **prof)
            for mname in ("tfidf", "bm25"):
                for _, _, q in batches:
                    engine.search(q, k=cs.K, mode=mode, strategy="drb",
                                  measure=mname)
    for tag in order:
        use(tag)
        rnd = {"tree": tag, "k1": {}, "e2e": {}}
        for s, t in shapes.items():
            kms, _ = cs.profile_device(lambda: k1(t), 100,
                                       "wavelet_count_kernel")
            call = cs.time_cuda(lambda: k1(t), reps=200, warm=20)
            rnd["k1"][s] = {"ms": kms, "wrapper_ms": call}
            print(f"[{tag}] K1 {s}: {kms:.6f} ms device, {call:.4f} ms "
                  f"wrapper", flush=True)
        fresh()
        k2ms, _ = cs.profile_device(lambda: (fresh(), k2()), 3,
                                    "beam_loop_kernel")
        call = cs.time_cuda(k2, reps=5, warm=1, setup=fresh)
        rnd["k2"] = {"ms": k2ms, "wrapper_ms": call}
        print(f"[{tag}] K2 or iii B=8: {k2ms:.4f} ms device, {call:.4f} ms "
              f"wrapper", flush=True)
        if args.e2e:
            cases = [(m, b, q, None) for m, b, q in batches] + \
                [("or", "iii", batches[3][2], 64)]
            for label, prof in profiles:
                for mode, band, q, budget in cases:
                    ms, _ = cs.wall_ms(lambda: engine.search(
                        q, k=cs.K, mode=mode, budget=budget, **prof))
                    rnd["e2e"].setdefault(label, []).append(ms)
            for mname in ("tfidf", "bm25"):
                for mode, band, q in batches:
                    ms, _ = cs.wall_ms(lambda: engine.search(
                        q, k=cs.K, mode=mode, strategy="drb", measure=mname))
                    rnd["e2e"].setdefault(f"DRB {mname}", []).append(ms)
            for label, v in rnd["e2e"].items():
                print(f"[{tag}] {label}: ms per batch "
                      + ", ".join(f"{x:.2f}" for x in v), flush=True)
        res["rounds"].append(rnd)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
