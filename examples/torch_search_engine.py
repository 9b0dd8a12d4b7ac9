"""End-to-end example of the PyTorch/CUDA port: a small in-memory search
engine serving batched ranked queries over a synthetic corpus, through the
one ``repro_torch.engine.SearchEngine`` facade — one build call, one
``search`` call per workload.  The port's counterpart of
``examples/search_engine.py``: the same flags, corpus, queries and
workloads, plus ``--device``.

    PYTHONPATH=src python examples/torch_search_engine.py --docs 2000 --batch 32
    PYTHONPATH=src python examples/torch_search_engine.py --docs 200 --batch 4 --device cpu

``run(device, ...)`` returns every workload's answers as numpy arrays, so a
caller can hold the card's answers against the CPU's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.engine import SearchEngine
from repro_torch.text import corpus

#: (name, query set, search keywords): the reference example's workloads
WORKLOADS = (
    ("DR/AND", "words", dict(mode="and", strategy="dr")),
    ("DR/OR", "words", dict(mode="or", strategy="dr")),
    ("DR/OR·16", "words", dict(mode="or", strategy="dr", beam_width=16)),
    ("DRB/AND", "words", dict(mode="and", strategy="drb")),
    ("BM25/OR", "words", dict(mode="or", strategy="auto", measure="bm25")),
    ("PHRASE", "grams", dict(mode="phrase")),
    ("NEAR/8", "grams", dict(mode="near", window=8)),
)
#: the result leaves ``run`` returns, where a workload has them
LEAVES = ("docs", "scores", "n_found", "work", "pops", "padded",
          "match_pos", "match_len")


def query_sets(cp: corpus.Corpus, batch: int) -> dict:
    """The reference example's queries: 3 words from the "ii" document
    frequency band, and bigrams lifted from the documents (so phrase
    queries have occurrences to rank)."""
    df = cp.doc_freqs()
    bands = corpus.fdoc_bands(cp.n_docs)
    return {"words": corpus.sample_queries(df, bands["ii"], batch, 3, seed=1),
            "grams": corpus.sample_ngram_queries(cp.doc_tokens, batch, 2,
                                                 seed=2)}


def answers(res) -> dict:
    """The result's leaves (``LEAVES``) as host numpy arrays."""
    return {n: getattr(res, n).cpu().numpy() for n in LEAVES
            if getattr(res, n) is not None}


def run(device=None, *, docs: int = 2000, vocab: int = 20000,
        batch: int = 32, k: int = 10, warm: bool = True) -> dict:
    """Build the engine on ``device`` (default: the card) over the reference
    example's corpus and answer each workload, timed after a first call
    when ``warm``: ``{"answers": {workload: leaves}, "ms_per_query":
    {workload: ms}, "n_tokens", "n_docs", "index_bytes", "build_s"}``."""
    t0 = time.time()
    cp = corpus.make_corpus(n_docs=docs, mean_doc_len=200, vocab_size=vocab,
                            seed=0)
    engine = SearchEngine.build(cp, device=device)
    out = {"n_tokens": cp.n_tokens, "n_docs": cp.n_docs,
           "index_bytes": engine.space_report()["total"],
           "build_s": time.time() - t0, "answers": {}, "ms_per_query": {}}
    qs = query_sets(cp, batch)
    for name, key, kw in WORKLOADS:
        if warm:
            answers(engine.search(qs[key], k=k, **kw))
        t0 = time.time()
        out["answers"][name] = answers(engine.search(qs[key], k=k, **kw))
        out["ms_per_query"][name] = (time.time() - t0) / batch * 1e3
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--vocab", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    out = run(args.device, docs=args.docs, vocab=args.vocab,
              batch=args.batch, k=args.k)
    print(f"indexed {out['n_tokens']} tokens / {out['n_docs']} docs "
          f"in {out['build_s']:.1f}s")
    print(f"index bytes: {out['index_bytes']:,} "
          f"({out['index_bytes'] / out['n_tokens']:.2f} B/token)")
    for name, _, kw in WORKLOADS:
        a = out["answers"][name]
        extra = ""
        if kw.get("beam_width", 1) > 1:
            extra = (f" | beam {kw['beam_width']}: {int(np.sum(a['work']))} "
                     f"trips / {int(np.sum(a['pops']))} pops")
        if "match_pos" in a and a["n_found"][0] > 0:
            extra = (f" | q0 match: doc {int(a['docs'][0, 0])} @ "
                     f"{int(a['match_pos'][0, 0])} width "
                     f"{int(a['match_len'][0, 0])}")
        print(f"{name:8s} {out['ms_per_query'][name]:7.2f} ms/query | "
              f"top doc of q0: {int(a['docs'][0, 0])}{extra}")


if __name__ == "__main__":
    main()
