#!/usr/bin/env python3
"""A/B timings of the count-descent kernels (K1 ``wavelet_count``, K2
``beam_loop``) or of ``drb_walk`` between source trees, on one card, in one
process.

    python3 scripts/descent_ab.py --csrc parent=build/parent/src/repro_torch/csrc \\
        --csrc change=src/repro_torch/csrc [--stamps] [--e2e] [--docs N]
    python3 scripts/descent_ab.py --kernel drb_walk --csrc A=DIR \\
        --csrc B=src/repro_torch/csrc [--stamps] [--docs N]

Each ``--csrc TAG=DIR`` names a ``csrc`` directory whose kernel sources keep
the C interface of this tree's wrappers.  The script builds the kernels of
every tree with ``nvcc``, builds the ALL/4 index of ``chip_smoke.py`` once
(same corpus, seed and query batches), and then, for rounds in the order A,
B, B, A, swaps each tree's libraries into the wrappers and measures, at the
main path's shapes:

* K1 device time (``torch.profiler``) at M = 32 (a mega trip), a P = 16
  trip and 4,096 random triples, and its wrapper time;
* K2 device time on the ``or`` band iii batch of B = 8 (state reset before
  each launch), and its wrapper time;
* with ``--e2e``: ms per batch (host clock) of the heap core at P = 1 and
  P = 16, the mega core, DRB tf-idf and DRB BM25 on the four batches;
* with ``--kernel drb_walk`` instead of the above: ``drb_walk``'s device
  time on the ``and`` band ii and iii batches under tf-idf and BM25 (the
  walk's state fresh for each launch) and µs per trip of the batch's
  longest row.

Every tree's results are first held bitwise against the plain versions.

``--stamps`` also builds, for every tree, a throwaway copy of the kernel's
source (K2's ``beam_step.cu``, or ``drb_walk.cu``; the copy goes to
``build/``, never into the sources) with ``clock64()`` stamps taken by
thread 0 of each row at the points ``STAMPS`` lists for it, runs it once
(K2 on the same batch, ``drb_walk`` on the ``and`` iii tf-idf batch) and
prints the cycles of each phase of a trip — for ``drb_walk`` also of a byte
select's counter-column search and of the whole select.  K2's phases close
after every ``__syncthreads()`` and ``__syncwarp()`` of its trip loop;
``--phases TAG=name,name,...`` names them in source order.

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

# Where a stamped copy takes its stamps: ``loop`` opens the trip loop;
# after each match of ``points`` inside it (in source order) a stamp closes
# a phase — a point ``if (!__syncthreads_or(x)) continue;`` is stamped
# between its barrier and its test; ``adds`` put text before or after the
# first match of a pattern anywhere in the source, for the counters of
# ``g_extra`` (summed per row by thread 0 in shared memory ``s_extra``).
STAMPS = {
    "beam_loop": dict(
        source="beam_step.cu", loop=r"for \(int trip = 0;; \+\+trip\) \{",
        points=r"__syncthreads\(\);|__syncwarp\(\);", names=None,
        adds=(), extra=()),
    "drb_walk": dict(
        source="drb_walk.cu", loop=r"for \(;;\) \{",
        points=(r"__syncthreads\(\);|const int pos = warp_locate\([^;]*\);|"
                r"const int d = warp_lower_bound\([^;]*\);|"
                r"if \(!__syncthreads_or\(mine\)\) continue;"),
        names=("pick (warp 0) + barrier", "locate of candidate 0 (warp 0)",
               "document search (warp 0)", "barrier after the candidates",
               "counts + barrier", "score + cursor ranks + barrier",
               "top-k merge + barrier"),
        # inside warp_select: its counter-column search, the whole select,
        # the number of selects
        adds=((r"int byte, int j\) \{", "after",
               " long long t_sel_ = clock64();"),
              (r"warp_lower_bound\(col, [^;]*;", "after",
               " if (threadIdx.x == 0) s_extra[0] += clock64() - t_sel_;"),
              (r"return start \+ __shfl_sync\(kFull(?:Mask)?, at, t\);",
               "before",
               "if (threadIdx.x == 0) { s_extra[1] += clock64() - t_sel_; "
               "s_extra[2] += 1; } "),
              (r"sh_cur = 0;", "after",
               " s_extra[0] = s_extra[1] = s_extra[2] = 0;")),
        extra=("select: counter-column search", "select: whole", "selects"),
        # headers whose code the points and adds reach, inlined into the
        # stamped copy where the source includes them
        inline=("wtbc_select.cuh",)),
}

_STAMP_DECL = """
__device__ unsigned long long g_stamp_acc[%d][%d];
__device__ unsigned long long g_stamp_n[%d][%d];
__device__ unsigned long long g_extra[%d][4];
%s
extern "C" int read_stamps(void* acc, void* n, void* extra) {
  cudaMemcpyFromSymbol(acc, g_stamp_acc, sizeof(g_stamp_acc));
  cudaMemcpyFromSymbol(n, g_stamp_n, sizeof(g_stamp_n));
  cudaMemcpyFromSymbol(extra, g_extra, sizeof(g_extra));
  return static_cast<int>(cudaGetLastError());
}
"""


def instrument(src: str, spec: dict) -> tuple[str, int]:
    """The kernel's source with a clock64() stamp by thread 0 at every point
    of ``spec`` (see ``STAMPS``); returns (source, number of stamps)."""
    m = re.search(spec["loop"], src)
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
        rec = (" if (threadIdx.x == 0) { long long t_ = "
               f"clock64(); st_acc[{k - 1}] += t_ - st_last; "
               f"st_n[{k - 1}] += 1; st_last = t_; }}")
        text = m.group(0)
        bar = re.fullmatch(r"if \(!(__syncthreads_or\([^;]*\))\) continue;",
                           text)
        if bar:
            return (f"{{ const int any_ = {bar.group(1)};" + rec
                    + " if (!any_) continue; }")
        return text + rec
    body = re.sub(spec["points"], stamp, body)
    if not 0 < k <= MAX_STAMPS or (spec["names"] and k != len(spec["names"])):
        raise ValueError(f"{k} stamps")
    head = (f"unsigned long long st_acc[{k}] = {{0}}, st_n[{k}] = {{0}}; "
            "long long st_last = clock64();\n  ")
    tail = ("\n  if (threadIdx.x == 0 && blockIdx.x < %d) for (int s_ = 0; "
            "s_ < %d; ++s_) { g_stamp_acc[blockIdx.x][s_] = st_acc[s_]; "
            "g_stamp_n[blockIdx.x][s_] = st_n[s_]; }" % (MAX_ROWS, k))
    if spec["extra"]:
        tail += ("\n  if (threadIdx.x == 0 && blockIdx.x < %d) for (int s_ = "
                 "0; s_ < %d; ++s_) g_extra[blockIdx.x][s_] = s_extra[s_];"
                 % (MAX_ROWS, len(spec["extra"])))
    out = (src[:m.start()] + head + src[m.start():m.end()] + body
           + src[end:end + 1] + tail + src[end + 1:])
    for pat, where, add in spec["adds"]:
        out, n = re.subn(pat, lambda mm: (mm.group(0) + add if where ==
                                          "after" else add + mm.group(0)),
                         out, count=1)
        if n != 1:
            raise ValueError(f"no {pat!r} in {spec['source']}")
    decl = _STAMP_DECL % (MAX_ROWS, MAX_STAMPS, MAX_ROWS, MAX_STAMPS,
                          MAX_ROWS, "__shared__ unsigned long long s_extra[4];"
                          if spec["extra"] else "")
    inc = '#include "wtbc_descent.cuh"'
    if inc not in out:
        raise ValueError(f"no {inc} in {spec['source']}")
    return out.replace(inc, inc + "\n" + decl, 1), k


def read_stamps(lib, n_rows: int):
    """(cycles, passes, extra) per row and stamp from a stamped library."""
    acc = np.zeros((MAX_ROWS, MAX_STAMPS), np.uint64)
    cnt = np.zeros_like(acc)
    extra = np.zeros((MAX_ROWS, 4), np.uint64)
    lib.read_stamps.argtypes = (ctypes.c_void_p,) * 3
    code = lib.read_stamps(acc.ctypes.data, cnt.ctypes.data, extra.ctypes.data)
    if code:
        raise SystemExit(f"stamps copy failed: {code}")
    return (acc[:n_rows].astype(np.float64), cnt[:n_rows].astype(np.int64),
            extra[:n_rows].astype(np.float64))


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


def walk_rounds(args, engine, batches, trees, use, libs) -> dict:
    """``--kernel drb_walk``: every tree's walk held against the plain walk
    on the ``and`` ii and iii batches under tf-idf and BM25, the stamped
    trip breakdown on the ``and`` iii tf-idf batch, then rounds A, B, B, A
    of device time and µs per trip of the longest row."""
    import torch
    from repro_torch.core import drb
    from repro_torch.kernels import drb_walk as walk
    idx, aux, dev = engine.idx, engine.aux, engine.device
    spec = STAMPS["drb_walk"]
    cases = {}
    for mode, band, q in batches:
        if mode != "and":
            continue
        r, m_ = engine._encode_queries(q)
        for mname in ("tfidf", "bm25"):
            meas = engine._resolve_measure(mname)
            qt = drb.and_tables(idx, aux, torch.from_numpy(r).to(dev),
                                torch.from_numpy(m_).to(dev), meas,
                                engine._idf_table(meas),
                                engine._avg_doc_len())
            cases[f"and {band} {mname}"] = (qt, meas)

    def run(case, kb="auto"):
        qt, meas = cases[case]
        return walk.drb_walk(idx, aux, qt, walk.init_state(qt, cs.K), meas,
                             k=cs.K, kernel_backend=kb)

    want = {c: run(c, "ref") for c in cases}
    res = {"trees": trees, "ms": {}, "us_per_trip": {}}
    for tag in trees:
        use(tag)
        for c in cases:
            got = run(c)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want[c])):
                raise SystemExit(f"{tag}: drb_walk differs from the plain "
                                 f"walk on {c}")
    print(f"every tree == the plain walk on {len(cases)} batches", flush=True)
    if args.stamps:
        res["stamps"] = {}
        c = "and iii tfidf"
        for tag in trees:
            use(tag, stamps=True)
            got = run(c)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want[c])):
                raise SystemExit(f"{tag}: the stamped copy differs")
            acc, cnt, extra = read_stamps(libs[tag]["stamps"][0], cs.B)
            trips = int(got.it.sum())
            per = {p: float(acc[:, i].sum()) / trips
                   for i, p in enumerate(spec["names"])}
            n_sel = float(extra[:, 2].sum())
            per_sel = {p: float(extra[:, i].sum()) / n_sel
                       for i, p in enumerate(spec["extra"][:2])}
            res["stamps"][tag] = {"row_trips": trips, "cycles_per_trip": per,
                                  "merges": int(cnt[:, 6].sum()),
                                  "selects_per_trip": n_sel / trips,
                                  "cycles_per_select": per_sel}
            print(f"{tag} stamps ({c}, {trips} row trips): cycles per trip " +
                  ", ".join(f"{p} {v:.1f}" for p, v in per.items()) +
                  f"; total {sum(per.values()):.1f}; {n_sel / trips:.3f} "
                  f"selects per trip (thread 0), cycles per select: " +
                  ", ".join(f"{p} {v:.1f}" for p, v in per_sel.items()),
                  flush=True)
    for tag in list(trees) + list(trees)[::-1]:
        use(tag)
        for c in cases:
            ms, _ = cs.profile_device(lambda: run(c), args.reps,
                                      "drb_walk_kernel")
            trips = int(want[c].it.max())
            res["ms"].setdefault(tag, {}).setdefault(c, []).append(ms)
            res["us_per_trip"].setdefault(tag, {}).setdefault(c, []).append(
                1e3 * ms / trips)
            print(f"[{tag}] {c}: {ms:.4f} ms on the device, longest row "
                  f"{trips} trips: {1e3 * ms / trips:.3f} us per trip",
                  flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", required=True,
                    help="TAG=DIR of a csrc tree (repeat: A then B)")
    ap.add_argument("--kernel", choices=("descent", "drb_walk"),
                    default="descent", help="K1 and K2, or drb_walk")
    ap.add_argument("--phases", action="append", default=[],
                    help="TAG=name,name,... names of the stamped phases")
    ap.add_argument("--docs", type=int, default=cs.QUARTER_DOCS)
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--reps", type=int, default=10,
                    help="profiled drb_walk launches per measurement")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("descent_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import backend
    from repro_torch.text import corpus as tcorpus

    trees = dict(s.split("=", 1) for s in args.csrc)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # ---- build every tree's kernels (and the stamped copies)
    walk = args.kernel == "drb_walk"
    kerns = (backend.DRB_WALK,) if walk else (backend.WAVELET_COUNT,
                                              backend.BEAM_LOOP)
    stamped = backend.DRB_WALK if walk else backend.BEAM_LOOP
    spec = STAMPS[stamped.name]
    shutil.rmtree(OUT, ignore_errors=True)
    jobs, libs = [], {}
    for tag, d in trees.items():
        d = (ROOT / d).resolve()
        od = OUT / tag
        od.mkdir(parents=True)
        for kern in kerns:
            jobs.append((d / kern.source, d, od / f"{kern.name}.so"))
        if args.stamps:
            sd = od / "stamps"
            sd.mkdir()
            for h in d.glob("*.cuh"):
                shutil.copy(h, sd / h.name)
            text = (d / spec["source"]).read_text()
            for h in spec.get("inline", ()):
                inc = f'#include "{h}"'
                if inc in text:
                    text = text.replace(inc, (d / h).read_text().replace(
                        "#pragma once", ""), 1)
            text, _ = instrument(text, spec)
            (sd / spec["source"]).write_text(text)
            jobs.append((sd / spec["source"], sd, od / "stamps.so"))
    nvcc_all(jobs)
    for tag in trees:
        od = OUT / tag
        libs[tag] = {k.name: load(k, od / f"{k.name}.so") for k in kerns}
        if args.stamps:
            libs[tag]["stamps"] = load(stamped, od / "stamps.so")

    def use(tag, stamps=False):
        for kern in kerns:
            key = "stamps" if stamps and kern is stamped else kern.name
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
    if walk:
        res = walk_rounds(args, engine, batches, trees, use, libs)
        res["device"] = smi
        print(json.dumps(res))
        return 0
    from repro_torch.core import mega, ranked
    from repro_torch.kernels import beam_step, wavelet_descent
    names = {t: n.split(",") for t, n in (s.split("=", 1) for s in args.phases)}
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
            use(tag, stamps=True)
            fresh()
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            k2()
            ev[1].record()
            torch.cuda.synchronize()
            B = wt.shape[0]
            acc, cnt, _ = read_stamps(libs[tag]["stamps"][0], B)
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
