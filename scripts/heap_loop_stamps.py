#!/usr/bin/env python3
"""Where a ``heap_loop`` trip spends its time: a clock64() breakdown by phase.

    python3 scripts/heap_loop_stamps.py [--docs 86445] [--widths 16 64]

Copies ``src/repro_torch/csrc`` to ``build/heap_loop_stamps/``, inserts a
stamp before each phase comment of ``heap_loop.cu`` (thread 0 of each row's
block reads ``clock64()`` there and adds the cycles since the last stamp to
the phase just ended; the sums go to a ``__device__`` array at the row's
end, read back through an extra ``extern "C"`` function), builds that copy
with ``nvcc`` and the package's flags, and swaps it in for the wrapper's
library.  It then draws ``chip_smoke.py``'s corpus and batches (ALL/4,
B = 8, the four `and`/`or` x band ii/iii batches of Q = 3), runs each batch
through ``ranked.topk_dr_batch`` at each beam width with the stamped and
the real kernel, checks every leaf bitwise between the two, and prints the
cycles a trip by phase (summed over the rows, over the rows' trips) and the
SM clock.  The stamps add a few hundred cycles a trip.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "heap_loop_stamps"

# (text in heap_loop.cu, the phase that starts there, stamp after the text)
MARKS = [("  for (int trip = 0;; ++trip) {\n", "trip start", True),
         ("    // ---- pop: the nv best chunks", "select chunks", False),
         ("    // a live slot of a chosen chunk", "gather candidates", False),
         ("    const int nc = sh_nc;", "select slots", False),
         ("    // the nv chosen in pop order", "sort pops", False),
         ("    // their tf rows; free them", "tf rows, free, extents", False),
         ("    const int n_pch = sh_nch;", "summarise popped", False),
         ("    // ---- the pending top after the pops", "pending top", False),
         ("    // ---- emit and split", "emit, split", False),
         ("    // ---- descent:", "descents", False),
         ("      // ---- score: a thread per multi", "score", False),
         ("    // ---- the enabled push lanes", "push lanes", False),
         ("    // ---- push: the r-th push takes", "place, write, summarise",
          False)]


def stamped_source(cu: str) -> str:
    for i, (text, _, after) in enumerate(MARKS):
        if text not in cu:
            raise SystemExit(f"heap_loop_stamps: no {text.strip()!r} in "
                             "heap_loop.cu; move the marks with the kernel")
        st = f"    STAMP({i});\n"
        cu = cu.replace(text, text + st if after else st + text, 1)
    cu = cu.replace("namespace {\n",
                    "__device__ unsigned long long g_stamps[16];\n"
                    "namespace {\n", 1)
    head = "  const int n_chunks = (cap + kChunk - 1) / kChunk;\n"
    cu = cu.replace(head, head + """\
  __shared__ long long st_acc[16], st_last;
  __shared__ int st_cur;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 16; ++i) st_acc[i] = 0;
    st_last = clock64();
    st_cur = 15;
  }
#define STAMP(i) do { if (threadIdx.x == 0) { const long long t_ = clock64(); \\
  st_acc[st_cur] += t_ - st_last; st_last = t_; st_cur = (i); } } while (0)
""", 1)
    end = "  if (tid == 0) {\n    n_out_g[row] = sh_n_out;"
    cu = cu.replace(end, "  STAMP(14);\n  if (tid == 0) for (int i = 0; i < 16; "
                    "++i) atomicAdd(&g_stamps[i], (unsigned long long)"
                    "st_acc[i]);\n" + end, 1)
    return cu + """
extern "C" int heap_loop_stamps(void* out, int reset) {
  if (reset) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_stamps, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * 16);
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=86_445)
    ap.add_argument("--widths", type=int, nargs="+", default=[16, 64])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import ranked
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import backend
    from repro_torch.text import corpus as tcorpus

    if not torch.cuda.is_available():
        raise SystemExit("heap_loop_stamps: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    shutil.copytree(backend.CSRC, OUT / "csrc")
    cu = OUT / "csrc" / "heap_loop.cu"
    cu.write_text(stamped_source(cu.read_text()))
    lib_path = OUT / "heap_loop_stamps.so"
    r = subprocess.run(["nvcc", *backend.NVCC_FLAGS, "-o", str(lib_path),
                        str(cu)], capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.heap_loop
    fn.argtypes, fn.restype = backend.HEAP_LOOP.argtypes, ctypes.c_int
    err = lib.heap_loop_error_string
    err.argtypes, err.restype = (ctypes.c_int,), ctypes.c_char_p
    get = lib.heap_loop_stamps
    get.argtypes, get.restype = (ctypes.c_void_p, ctypes.c_int), ctypes.c_int

    cp = cs.quarter_all_corpus(args.docs, cs.SEED)
    engine = SearchEngine.build(cp, EngineConfig(block=cs.BLOCK),
                                device="cuda")
    idx = engine.idx
    df_word = idx.df.cpu().numpy()[engine.model.rank_of_word]
    bands = tcorpus.fdoc_bands(args.docs)
    idf = engine._idf_table(engine._resolve_measure("tfidf"))
    phases = [name for _, name, _ in MARKS]
    for i, (mode, band) in enumerate([("and", "ii"), ("or", "ii"),
                                      ("and", "iii"), ("or", "iii")]):
        q = tcorpus.sample_queries(df_word, bands[band], cs.B, 3,
                                   seed=cs.SEED + i)   # chip_smoke's batches
        r_, m_ = engine._encode_queries(q)
        wt, mt = torch.from_numpy(r_).cuda(), torch.from_numpy(m_).cuda()
        for P in args.widths:
            kw = dict(k=cs.K, conjunctive=mode == "and",
                      heap_cap=2 * idx.n_docs + 4, beam_width=P)
            want = ranked.topk_dr_batch(idx, wt, mt, idf, **kw)
            real = (backend.HEAP_LOOP._fn, backend.HEAP_LOOP._err)
            backend.HEAP_LOOP._fn, backend.HEAP_LOOP._err = fn, err
            try:
                get(None, 1)
                got = ranked.topk_dr_batch(idx, wt, mt, idf, **kw)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 16)()
                get(ctypes.addressof(buf), 0)
            finally:
                backend.HEAP_LOOP._fn, backend.HEAP_LOOP._err = real
            bad = cs.leaves_equal(got, want, cs.HEAP_LEAVES)
            if bad:
                print(f"heap_loop_stamps: FAILED: the stamped kernel differs "
                      f"({mode} {band}, P = {P}): {bad}", file=sys.stderr)
                return 1
            trips = int(got.iters.sum())
            cyc = np.array(list(buf), dtype=np.float64)[:len(phases)]
            print(f"{mode} {band} P={P}: {trips} row-trips, cycles a trip "
                  f"{cyc.sum() / trips:.0f}: " + ", ".join(
                      f"{name} {c / trips:.0f}"
                      for name, c in zip(phases, cyc)), flush=True)
    print("SM clock (current, max):", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
