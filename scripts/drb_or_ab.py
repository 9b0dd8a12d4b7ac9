#!/usr/bin/env python3
"""DRB ``or`` batch times and ``snippets`` times of several source trees on
one card, in turns.

    python3 scripts/drb_or_ab.py --src parent=build/parent/src --src change=src

Each ``--src TAG=DIR`` names a directory that holds a ``repro_torch``
package (another tree's copy lives under ``build/``, which git ignores:
``git archive <commit> | tar -x -C build/parent``).  The trees run in the
rounds A, B, ..., B, A, one process per round, since two copies of the
package cannot share one.  Each process draws ``chip_smoke.py``'s corpus
(86,445 documents by default, its seed), builds its tree's engine on the
card, and times, as a user calls them:

* ``search(mode="or", strategy="drb")`` of ``chip_smoke.py``'s ``or`` ii
  and iii batches (B = 8, Q = 3, k = 10) under tf-idf and BM25, in ms per
  batch (host clock around the call and a synchronize);
* ``snippets(res, length=8)`` of those BM25 results, in ms per call;

each repeated ``--reps`` times after one untimed call, and prints the
kernel launches of one batch and of one ``snippets`` call.  Prints the
card's name and power limit, one line per round, and as its last line a
JSON object of every number.  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(src: str, docs: int, reps: int) -> dict:
    """One tree's numbers (run in a process of its own)."""
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.kernels import backend
    from repro_torch.text import corpus as tcorpus

    if not torch.cuda.is_available():
        raise SystemExit("drb_or_ab: no CUDA device is available")
    backend.build()
    cp = cs.quarter_all_corpus(docs, cs.SEED)
    engine = SearchEngine.build(cp, EngineConfig(block=cs.BLOCK),
                                device="cuda")
    engine.aux                                   # the tf bitmaps, built once
    df_word = engine.idx.df.cpu().numpy()[engine.model.rank_of_word]
    bands = tcorpus.fdoc_bands(docs)
    out = {"src": src, "batch_ms": {}, "snippets_ms": {}, "launches": {}}
    for i, band in ((1, "ii"), (3, "iii")):     # chip_smoke's or batches
        q = tcorpus.sample_queries(df_word, bands[band], cs.B, 3,
                                   seed=cs.SEED + i)
        for mname in ("tfidf", "bm25"):
            def search():
                return engine.search(q, k=cs.K, mode="or", strategy="drb",
                                     measure=mname)
            res = search()
            before = backend.launch_counts()
            ms = []
            for _ in range(reps):
                t, res = cs.wall_ms(search)
                ms.append(t)
            after = backend.launch_counts()
            out["batch_ms"][f"{mname} or {band}"] = ms
            out["launches"][f"{mname} or {band}"] = {
                k: (after[k] - before[k]) // reps for k in after
                if after[k] != before[k]}
        engine.snippets(res, length=8)
        before = backend.launch_counts()
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.snippets(res, length=8)     # ends in a host copy
            ms.append((time.perf_counter() - t0) * 1e3)
        after = backend.launch_counts()
        out["snippets_ms"][f"bm25 or {band}"] = ms
        out["launches"][f"snippets bm25 or {band}"] = {
            k: (after[k] - before[k]) // reps for k in after
            if after[k] != before[k]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="TAG=DIR of a tree's package directory (repeat)")
    ap.add_argument("--docs", type=int, default=86_445)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.docs, args.reps)))
        return 0
    trees = dict(s.split("=", 1) for s in args.src)
    if not trees:
        ap.error("give at least one --src TAG=DIR")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    tags = list(trees)
    rounds = tags + tags[::-1]
    res = {"card": smi, "rounds": []}
    for tag in rounds:
        p = subprocess.run([sys.executable, __file__, "--worker", trees[tag],
                            "--docs", str(args.docs), "--reps",
                            str(args.reps)], capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"drb_or_ab: round {tag} failed")
        r = json.loads(p.stdout.strip().splitlines()[-1])
        r["tag"] = tag
        res["rounds"].append(r)
        print(f"{tag}: batch ms " + "; ".join(
            f"{k} " + ", ".join(f"{x:.3f}" for x in v)
            for k, v in r["batch_ms"].items()) + " | snippets ms " + "; ".join(
            f"{k} " + ", ".join(f"{x:.3f}" for x in v)
            for k, v in r["snippets_ms"].items()) + " | launches "
            + json.dumps(r["launches"]), flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
