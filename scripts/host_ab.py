#!/usr/bin/env python3
"""Host-side cost of the DR search path in several source trees on one card,
in turns: a kernel wrapper's time per call and the cores' batch times.

    python3 scripts/host_ab.py --src parent=build/parent/src --src change=src

Each ``--src TAG=DIR`` names a directory that holds a ``repro_torch``
package (another tree's copy lives under ``build/``, which git ignores:
``git archive <commit> | tar -x -C build/parent``).  The trees run in the
rounds A, B, ..., B, A, one process per round.  Each process draws
``chip_smoke.py``'s corpus at ``--docs`` documents (its seed), builds its
tree's engine on the card and times:

* ``wavelet_count`` per wrapper call at M = 32 random triples (CUDA events
  over ``--calls`` calls, after 50 untimed ones) — host time per launch;
* ``search`` of ``chip_smoke.py``'s four batches (``and``/``or`` x bands
  ii/iii, B = 8, Q = 3, k = 10) on the heap core at P = 1 and 16 and on the
  mega core, ``--reps`` times each after one untimed call (host clock
  around the call and a synchronize), in ms per batch.

Prints the card's name and power limit, one line per round, and as its last
line a JSON object of every number.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CORES = {"P=1": {}, "P=16": {"beam_width": 16}, "mega": {"mega": True}}


def worker(src: str, docs: int, reps: int, calls: int) -> dict:
    """One tree's numbers (run in a process of its own)."""
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import backend, wavelet_descent
    from repro_torch.text import corpus as tcorpus

    if not torch.cuda.is_available():
        raise SystemExit("host_ab: no CUDA device is available")
    backend.build()
    cp = cs.quarter_all_corpus(docs, cs.SEED)
    engine = SearchEngine.build(cp, EngineConfig(block=cs.BLOCK),
                                device="cuda")
    idx = engine.idx
    rng = np.random.default_rng(cs.SEED)
    M = 32
    trip = [torch.from_numpy(x.astype(np.int32)).cuda() for x in (
        rng.integers(1, idx.vocab_size, M), rng.integers(0, idx.n // 2, M))]
    trip.append(trip[1] + torch.from_numpy(
        rng.integers(0, idx.n // 2, M).astype(np.int32)).cuda())

    def k1():
        return wavelet_descent.wavelet_count(
            idx.levels, idx.cw, idx.cw_len, idx.node_off, idx.base_rank,
            *trip)
    out = {"src": src, "k1_wrapper_ms": cs.time_cuda(k1, reps=calls,
                                                      warm=50),
           "batch_ms": {}}
    df_word = idx.df.cpu().numpy()[engine.model.rank_of_word]
    bands = tcorpus.fdoc_bands(docs)
    for i, (mode, band) in enumerate([("and", "ii"), ("or", "ii"),
                                      ("and", "iii"), ("or", "iii")]):
        q = tcorpus.sample_queries(df_word, bands[band], cs.B, 3,
                                   seed=cs.SEED + i)
        for core, kw in CORES.items():
            def search():
                return engine.search(q, k=cs.K, mode=mode, **kw)
            search()
            out["batch_ms"][f"{core} {mode} {band}"] = [
                cs.wall_ms(search)[0] for _ in range(reps)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="TAG=DIR of a tree's src directory (two or more)")
    ap.add_argument("--docs", type=int, default=20_000)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.docs, args.reps,
                                args.calls)))
        return 0
    trees = dict(s.split("=", 1) for s in args.src)
    tags = list(trees)
    order = tags + tags[::-1]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rounds = []
    for tag in order:
        r = subprocess.run(
            [sys.executable, __file__, "--src", f"{tag}={trees[tag]}",
             "--docs", str(args.docs), "--reps", str(args.reps),
             "--calls", str(args.calls), "--worker", trees[tag]],
            capture_output=True, text=True, check=True)
        got = json.loads(r.stdout.strip().splitlines()[-1])
        got["tag"] = tag
        rounds.append(got)
        med = {k: sorted(v)[len(v) // 2] for k, v in got["batch_ms"].items()}
        print(f"{tag}: K1 wrapper {got['k1_wrapper_ms']:.4f} ms; median ms "
              "per batch " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       med.items()), flush=True)
    print(json.dumps({"docs": args.docs, "rounds": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
