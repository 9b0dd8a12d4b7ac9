#!/usr/bin/env python3
"""K4 ``segment_tf`` and K6 ``scored_topk`` of several source trees on one
card, timed cold, in turns.

    python3 scripts/k4k6_ab.py --src parent=build/parent/src --src change=src

Each ``--src TAG=DIR`` names a directory that holds a ``repro_torch``
package (another tree's copy lives under ``build/``, which git ignores:
``git archive <commit> | tar -x -C build/parent``).  This process first
draws ``chip_smoke.py``'s corpus (86,445 documents by default, its seed),
builds the index and the DRB tf bitmaps on the card with the repository's
own package, and saves the kernels' inputs under ``build/``:

* K4: the root level, the byte of ``chip_smoke.py``'s 1-byte word and
  every document bound (D = n_docs);
* K6 at the DRB ``or`` shape: the (B, n_docs, Q) parts, (B, Q) weights
  and (B, n_docs) mask that the plain ``or`` query (BM25, the ``or`` ii
  batch) hands to ``scored_topk``; and at C = 10^6, d = 128, k = 10: random
  float32 rows from ``chip_smoke.py``'s seed, drawn on the card.

The trees then run in the rounds A, B, ..., B, A, one process per round
(two copies of the package cannot share one).  Each times its own wrappers
with ``chip_smoke.cold_ms`` (median over CUDA-event spans after a 256 MB
write and read that flush the 50 MB L2, the card held in a spin while the
call is enqueued) and ``warm_ms`` (the same without the flush), counts the
device kernels one call runs (``torch.profiler``), and times the library
calls ``torch.topk(torch.mv(...))`` and ``torch.topk(torch.bmm(...)
.masked_fill(...))`` the same way.  Every round's outputs must equal the
first round's bitwise.  Prints the card's name and power limit, one line
per round and as its last line a JSON object of every number.  It needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INPUTS = ROOT / "build" / "k4k6_inputs.pt"


def prepare(docs: int) -> None:
    """The kernels' inputs from the repository's own package, saved once."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.core import drb
    from repro_torch.engine import EngineConfig, SearchEngine
    from repro_torch.text import corpus as tcorpus

    cp = cs.quarter_all_corpus(docs, cs.SEED)
    engine = SearchEngine.build(cp, EngineConfig(block=cs.BLOCK),
                                device="cuda")
    idx = engine.idx
    root = idx.levels[0]
    one_byte = torch.nonzero((idx.cw_len == 1) & (idx.df > 100)).reshape(-1)
    w4 = int(one_byte[len(one_byte) // 2])
    bounds = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                        idx.sep_pos + 1]).to(torch.int32)
    aux = engine.aux
    df_word = idx.df.cpu().numpy()[engine.model.rank_of_word]
    q = tcorpus.sample_queries(df_word, tcorpus.fdoc_bands(docs)["ii"], cs.B,
                               3, seed=cs.SEED + 1)     # chip_smoke's or ii
    r, m = engine._encode_queries(q)
    wt, mt = torch.from_numpy(r).cuda(), torch.from_numpy(m).cuda()
    meas = engine._resolve_measure("bm25")
    with cs.OpsRecorder("scored_topk", lambda c, q_, **kw: (
            c, q_, kw["valid"], kw["k"], kw["tile"])) as rec:
        drb.topk_drb_or(idx, aux, wt, mt, meas, k=cs.K,
                        max_df_cap=engine._df_cap(r, m),
                        idf=engine._idf_table(meas),
                        avg_dl=engine._avg_doc_len(), kernel_backend="ref")
    part, w6, ok6, k6, tile6 = rec.calls[-1]
    INPUTS.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"root": (root.data, root.counts, root.length, root.block),
                "byte4": int(idx.cw[w4, 0]), "bounds": bounds,
                "drb": (part, w6, ok6, k6, tile6)}, INPUTS)


def _digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(src: str, reps: int) -> dict:
    """One tree's numbers (run in a process of its own)."""
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import backend, segment_tf, topk_score

    if not torch.cuda.is_available():
        raise SystemExit("k4k6_ab: no CUDA device is available")
    backend.build([backend.SEGMENT_TF, backend.SCORED_TOPK])
    x = torch.load(INPUTS, map_location="cuda")
    data, counts, length, block = x["root"]
    byte4, bounds = x["byte4"], x["bounds"]
    part, w6, ok6, k6, tile6 = x["drb"]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    cands = torch.randn((1_000_000, 128), generator=g, device="cuda")
    qv = torch.randn(128, generator=g, device="cuda")

    calls = {
        "segment_tf D=%d" % (bounds.numel() - 1): lambda: (
            segment_tf.segment_tf(data, counts, length, byte4, bounds,
                                  block=block)),
        "scored_topk C=1000000 d=128 k=%d" % cs.K: lambda: (
            topk_score.scored_topk(cands, qv, k=cs.K, tile=1024)),
        "scored_topk B=%d C=%d d=%d k=%d (DRB or)" % (
            part.shape[0], part.shape[1], part.shape[2], k6): lambda: (
            topk_score.scored_topk(part, w6, k=k6, tile=tile6, valid=ok6)),
    }
    out = {"src": src, "cold_ms": {}, "warm_ms": {}, "profiler_ms": {},
           "device_kernels": {}, "launches": {}, "digest": {}}
    for name, fn in calls.items():
        res = fn()
        out["digest"][name] = _digest(*(res if isinstance(res, tuple)
                                        else (res,)))
        before = backend.launch_counts()
        out["cold_ms"][name] = cs.cold_ms(fn, reps)
        out["warm_ms"][name] = cs.warm_ms(fn, reps)
        after = backend.launch_counts()
        out["launches"][name] = {k: (after[k] - before[k]) / (2 * reps + 4)
                                 for k in after if after[k] != before[k]}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        out["device_kernels"][name] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / 5
        out["profiler_ms"][name] = cs.profile_device(fn, 20)[0]
    out["library_cold_ms"] = {
        "torch.topk(torch.mv(cands, q), k)": cs.cold_ms(
            lambda: torch.topk(torch.mv(cands, qv), cs.K), reps),
        "torch.topk(torch.bmm(part, w).masked_fill(~valid, -inf), k)":
            cs.cold_ms(lambda: torch.topk(torch.bmm(part, w6[:, :, None])[
                ..., 0].masked_fill(~ok6, float("-inf")), k6), reps),
    }
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[],
                    help="TAG=DIR of a tree's repro_torch package (repeat)")
    ap.add_argument("--docs", type=int, default=86_445)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.reps)))
        return 0
    trees = dict(s.split("=", 1) for s in args.src)
    if len(trees) < 1:
        ap.error("give at least one --src TAG=DIR")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    prepare(args.docs)
    tags = list(trees)
    order = tags + tags[::-1]
    rounds = []
    for tag in order:
        r = subprocess.run([sys.executable, __file__, "--worker", trees[tag],
                            "--reps", str(args.reps)], capture_output=True,
                           text=True)
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-6000:], file=sys.stderr)
            return 1
        res = json.loads(r.stdout.strip().splitlines()[-1])
        res["tag"] = tag
        rounds.append(res)
        print(json.dumps({"tag": tag, "cold_ms": res["cold_ms"],
                          "warm_ms": res["warm_ms"],
                          "profiler_ms": res["profiler_ms"],
                          "device_kernels": res["device_kernels"],
                          "library_cold_ms": res["library_cold_ms"]}),
              flush=True)
    for res in rounds[1:]:
        if res["digest"] != rounds[0]["digest"]:
            print(f"k4k6_ab: FAILED: {res['tag']}'s outputs differ from "
                  f"{rounds[0]['tag']}'s", file=sys.stderr)
            return 1
    print(json.dumps({"card": smi, "rounds": rounds}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
