"""Serving launcher — a thin CLI over the ``repro_torch.serve`` subsystem
(the port's ``python -m repro.launch.serve``).

Starts a :class:`repro_torch.serve.SearchServer` from a **snapshot** when one
exists (the paper's premise: the compressed index is the only thing we
keep), else builds from a synthetic corpus (optionally persisting the
snapshot for next boot), prints the index space report, warms every executor
bucket (and builds the CUDA kernels), then drives load and reports latency
percentiles.  It runs on the card unless ``--device cpu`` is given:

  # build once, snapshot, serve 2000 closed-loop requests
  PYTHONPATH=src python -m repro_torch.launch.serve --docs 2000 \
      --snapshot-dir snap --save-snapshot --requests 2000

  # next boot: no corpus, no build — straight from the snapshot
  PYTHONPATH=src python -m repro_torch.launch.serve --snapshot-dir snap \
      --target-qps 200 --requests 500 --mode or --strategy drb --measure bm25

  # the plain PyTorch path on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --docs 250 \
      --vocab 3000 --requests 100 --max-batch 8 --smoke

  # a document-sharded engine: 4 shards (round-robin over the cards)
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 4 --docs 2000 \
      --smoke

``--target-qps 0`` (default) runs the closed-loop shape (``--workers``
back-to-back clients); a positive value runs the open-loop Poisson shape.
``--smoke`` exits non-zero unless the run was healthy (finite p99, zero
shed, no error or timeout, no executor built after warmup).  ``--shards N``
(N > 0) builds a document-sharded engine of N shards
(``SearchEngine.shard``; shard ``s`` on ``cuda:{s % device_count}``, or all
on the CPU with ``--device cpu``) and snapshots it like a single one.

Deadlines & SLA classes (DESIGN.md §11): ``--deadline-ms`` asks for
anytime answers — admission converts the wall target into a pop budget at
the live us/pop estimate and every response carries per-slot certified
bits.  ``--sla best_effort`` additionally lets overload shrink budgets
(degraded serving) before shedding; ``--retries N`` adds client-side
jittered-backoff retries on shed.

Observability (DESIGN.md §10): ``--metrics`` enables the process
:mod:`repro_torch.obs` registry (span timelines, per-stage histograms, live
roofline gauges); ``--metrics-port N`` additionally serves Prometheus text
at ``http://127.0.0.1:N/metrics`` (0 = ephemeral, the chosen port is
printed) plus a JSON snapshot at ``/metrics.json``; ``--stats-every S``
appends one JSONL registry snapshot every S seconds to ``--stats-jsonl``
(or stdout).  Any of the three implies ``--metrics``.
"""
from __future__ import annotations

import argparse
import sys
import threading

import numpy as np

import repro_torch.obs as obs
from repro_torch.engine import SearchEngine
from repro_torch.engine.facade import MEASURES
from repro_torch.serve import QueryProfile, SearchServer, loadgen, snapshot
from repro_torch.text import corpus


def build_or_load(args) -> SearchEngine:
    if args.snapshot_dir and snapshot.list_versions(args.snapshot_dir):
        v = snapshot.list_versions(args.snapshot_dir)[-1]
        print(f"loading snapshot v{v} from {args.snapshot_dir} ...", flush=True)
        return snapshot.load(args.snapshot_dir, device=args.device)
    print(f"building corpus: {args.docs} docs ...", flush=True)
    cp = corpus.make_corpus(args.docs, args.mean_doc_len, args.vocab,
                            seed=args.seed)
    if args.shards:
        engine = SearchEngine.shard(cp, n_shards=args.shards,
                                    device=args.device)
    else:
        engine = SearchEngine.build(cp, device=args.device)
    if args.save_snapshot:
        if not args.snapshot_dir:
            raise SystemExit("--save-snapshot needs --snapshot-dir")
        p = snapshot.save(engine, args.snapshot_dir)
        print(f"snapshot committed: {p}")
    return engine


def print_space_report(engine: SearchEngine) -> None:
    rep = engine.space_report()
    text = rep["level_bytes"]
    print("index space (bytes):")
    for k, v in rep.items():
        if k != "total":
            print(f"  {k:20s} {v:12,d}  ({v / max(text, 1):6.1%} of "
                  "compressed text)")
    print(f"  {'total':20s} {rep['total']:12,d}")


def main():
    ap = argparse.ArgumentParser()
    # corpus/build (ignored when a snapshot is loaded)
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--mean-doc-len", type=int, default=300)
    ap.add_argument("--vocab", type=int, default=20000)
    ap.add_argument("--shards", type=int, default=0,
                    help="0 = single index; N = a document-sharded engine "
                         "of N shards")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (cpu = the plain PyTorch "
                         "path)")
    # snapshot
    ap.add_argument("--snapshot-dir", default=None,
                    help="load the newest snapshot here (skips the build); "
                         "with --save-snapshot, also where builds are saved")
    ap.add_argument("--save-snapshot", action="store_true")
    # query profile
    ap.add_argument("--mode", default="or",
                    choices=("and", "or", "phrase", "near"))
    ap.add_argument("--strategy", default="auto", choices=("dr", "drb", "auto"))
    ap.add_argument("--measure", default="tfidf", choices=("tfidf", "bm25"))
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--words", type=int, default=3, help="words per query")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request wall target: admission converts it to "
                         "a pop budget at the live us/pop estimate "
                         "(DESIGN.md §11); answers carry certified bits")
    ap.add_argument("--sla", default=None,
                    choices=("exact", "bounded", "best_effort"),
                    help="SLA class (default: engine config; auto-'bounded' "
                         "when --budget/--deadline-ms is given).  'exact' "
                         "rejects anytime knobs; 'best_effort' additionally "
                         "lets overload shrink budgets before shedding")
    ap.add_argument("--retries", type=int, default=0,
                    help="client-side retry budget on shed (jittered "
                         "exponential backoff; the report prints the "
                         "attempts histogram)")
    ap.add_argument("--beam-width", type=int, default=None)
    ap.add_argument("--mega", action="store_true",
                    help="route DR and/or batches through the pool-frontier "
                         "megabatch core (bitwise-equal, faster batched)")
    # serving knobs
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--queue-depth", type=int, default=256)
    ap.add_argument("--cache-size", type=int, default=1024)
    ap.add_argument("--work-buckets", action="store_true",
                    help="df-predicted admission lanes: coalesce only within "
                         "factor-8 work buckets; heavy queries run alone")
    ap.add_argument("--heavy-df", type=int, default=None,
                    help="summed-df threshold for the batch-1 heavy lane "
                         "(default: 2x the engine's document count)")
    ap.add_argument("--adaptive-wait", action="store_true",
                    help="EWMA inter-arrival tracking: coalescing wait "
                         "drops to 0 while the stream is idle")
    # load shape
    ap.add_argument("--requests", type=int, default=500)
    ap.add_argument("--distinct", type=int, default=64,
                    help="distinct queries in the (Zipf-repeated) workload")
    ap.add_argument("--target-qps", type=float, default=0.0,
                    help="open-loop offered load; 0 = closed loop")
    ap.add_argument("--workers", type=int, default=8,
                    help="closed-loop client concurrency")
    ap.add_argument("--smoke", action="store_true",
                    help="exit 1 unless p99 is finite and nothing was shed")
    # observability
    ap.add_argument("--metrics", action="store_true",
                    help="enable the repro_torch.obs registry (span timelines, "
                         "stage histograms, roofline gauges)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text at /metrics on this port "
                         "(0 = ephemeral; implies --metrics)")
    ap.add_argument("--stats-every", type=float, default=0.0,
                    help="append a JSONL registry snapshot every S seconds "
                         "(implies --metrics)")
    ap.add_argument("--stats-jsonl", default=None,
                    help="path the periodic/final JSONL snapshots append to "
                         "(default: print to stdout)")
    args = ap.parse_args()
    if args.shards < 0:
        raise SystemExit(f"error: --shards must be >= 0, got {args.shards}")

    metrics_on = (args.metrics or args.metrics_port is not None
                  or args.stats_every > 0)
    reg = obs.enable() if metrics_on else None
    metrics_http = None
    if args.metrics_port is not None:
        metrics_http = obs.MetricsServer(reg, port=args.metrics_port)
        print(f"metrics: http://127.0.0.1:{metrics_http.port}/metrics",
              flush=True)

    def emit_snapshot():
        if args.stats_jsonl:
            obs.write_jsonl(args.stats_jsonl, reg)
        else:
            print(obs.snapshot_line(reg), flush=True)

    stats_stop = threading.Event()
    stats_thread = None
    if args.stats_every > 0:
        def _stats_loop():
            while not stats_stop.wait(args.stats_every):
                emit_snapshot()
        stats_thread = threading.Thread(target=_stats_loop, daemon=True,
                                        name="obs-stats-jsonl")

    try:
        engine = build_or_load(args)
    except ValueError as e:       # e.g. more shards than documents
        raise SystemExit(f"error: {e}")
    print_space_report(engine)
    if args.requests == 0:
        print("no traffic requested (--requests 0); exiting after "
              "build/snapshot")
        return

    if args.mode in ("phrase", "near"):
        # n-grams decoded from the index: positional queries that exercise
        # the matching path, not the empty one (no corpus needed)
        queries = loadgen.sample_ngram_queries(engine, args.distinct,
                                               args.words, seed=args.seed)
    else:
        queries = loadgen.sample_queries(engine, args.distinct, args.words,
                                         seed=args.seed)
    # pin the DRB/OR gather width whenever traffic will ROUTE to drb/or —
    # "auto" routes by the measure's own DR-compatibility, so ask the
    # engine's measure table instead of duplicating the routing rule
    routed_drb = args.mode == "or" and (
        args.strategy == "drb"
        or (args.strategy == "auto"
            and not MEASURES[args.measure].dr_compatible))
    profile = QueryProfile(
        mode=args.mode, strategy=args.strategy, measure=args.measure,
        k=args.k, window=args.window, budget=args.budget,
        beam_width=args.beam_width,
        df_cap=engine.suggested_df_cap(queries) if routed_drb else None,
        mega=True if args.mega else None,
        sla=args.sla, deadline_ms=args.deadline_ms)

    server = SearchServer(engine, max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          queue_depth=args.queue_depth,
                          cache_size=args.cache_size,
                          work_buckets=args.work_buckets,
                          heavy_df=args.heavy_df,
                          adaptive_wait=args.adaptive_wait,
                          registry=reg)
    print("warming up (kernels and executor buckets) ...", flush=True)
    try:
        n = server.warmup(queries, profile)
    except ValueError as e:       # e.g. BM25 + strategy=dr, budget + drb
        raise SystemExit(f"error: {e}")
    traces0 = sum(engine.stats["traces"].values())
    print(f"warmed {n} executors; admitting traffic", flush=True)

    workload = loadgen.zipf_workload(queries, args.requests, seed=args.seed)
    retry = loadgen.RetryPolicy(max_retries=args.retries, seed=args.seed) \
        if args.retries else loadgen.NO_RETRY
    if stats_thread is not None:
        stats_thread.start()
    with server:
        if args.target_qps > 0:
            rep = loadgen.open_loop(server, workload,
                                    target_qps=args.target_qps,
                                    profile=profile, seed=args.seed,
                                    retry=retry)
        else:
            rep = loadgen.closed_loop(server, workload,
                                      n_workers=args.workers, profile=profile,
                                      retry=retry)
    stats_stop.set()

    retraces = sum(engine.stats["traces"].values()) - traces0
    st = rep.server_stats
    print(rep.summary())
    print(f"batch sizes: {st['batch_hist']} (mean {st['mean_batch']:.2f}) | "
          f"cache hit rate {st['cache']['hit_rate']:.1%} | "
          f"executors built after warmup: {retraces}")
    if metrics_on:
        if rep.stages:
            print("stage latency attribution (registry-derived):")
            for stage, d in sorted(rep.stages.items()):
                print(f"  {stage:10s} p50 {d['p50_ms']:.2f}ms  "
                      f"p95 {d['p95_ms']:.2f}ms  p99 {d['p99_ms']:.2f}ms  "
                      f"(n={d['count']})")
        for g in reg.find("repro_roofline_achieved_frac"):
            be = dict(g.labels).get("backend", "?")
            print(f"roofline[{be}]: achieved fraction {g.value:.2e} of the "
                  "memory-bandwidth floor")
        emit_snapshot()
        if metrics_http is not None:
            metrics_http.close()
    if st["overflowed"]:
        print(f"WARNING: {st['overflowed']} responses hit heap overflow — "
              "their rankings may be incomplete (rebuild with a larger "
              "heap_cap or query a smaller k)")
    if args.smoke:
        # deadline traffic may build executors when the live us/pop estimate
        # drifts across a pow-4 bucket boundary mid-run; the bucketing
        # bounds that to a handful of rungs, never per-request churn
        retrace_ok = retraces == 0 if args.deadline_ms is None \
            else retraces <= 4
        healthy = (np.isfinite(rep.p99_ms) and rep.n_shed == 0
                   and st["errors"] == 0 and retrace_ok
                   and rep.n_timeout == 0
                   and rep.n_ok == args.requests)
        print(f"smoke: {'PASS' if healthy else 'FAIL'}")
        sys.exit(0 if healthy else 1)


if __name__ == "__main__":
    main()
