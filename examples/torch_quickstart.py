"""Quickstart of the PyTorch/CUDA port: build a SearchEngine over a few
documents and run the query types of ``examples/quickstart.py`` through the
one facade — an AND query on WTBC-DR, an OR query under BM25 (auto-routed to
WTBC-DRB) — then recover snippets straight from the compressed index.

    PYTHONPATH=src python examples/torch_quickstart.py               # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # plain path

``run(device)`` returns the answers (hits and snippets as plain Python
values), so a caller can hold the card's answers against the CPU's.
"""
from __future__ import annotations

import argparse

from repro_torch.engine import SearchEngine
from repro_torch.text import vocab

DOCS = [
    "ranked document retrieval in almost no space".split(),
    "the wavelet tree on bytecodes rearranges compressed text".split(),
    "dense codes give fast byte oriented decompression".split(),
    "ranked retrieval needs only rank and select on bytes".split(),
    "the quick brown fox jumps over the lazy dog".split(),
    "wavelet trees support ranked retrieval in compressed space space space".split(),
]


def run(device=None) -> dict:
    """Build the engine on ``device`` (default: the card) and answer the
    quickstart's queries: ``{"dr_and": hits, "drb_or_bm25": hits,
    "snippets": [[word, ...], ...], "space": bytes}``."""
    v = vocab.Vocabulary.from_documents(DOCS)
    engine = SearchEngine.build(v.encode_docs(DOCS), vocab_size=v.size,
                                device=device)

    def ids(*ws):
        return [v.id_of(w) for w in ws]

    dr = engine.search([ids("ranked", "retrieval")], k=3, mode="and",
                       strategy="dr")
    drb = engine.search([ids("space", "fox")], k=3, mode="or", measure="bm25")
    snippets = [[v.words[int(w)] for w in s]
                for s in engine.snippets(drb, length=5)[0]]
    return {"dr_and": dr.hits(0), "drb_or_bm25": drb.hits(0),
            "snippets": snippets, "space": engine.space_report()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    out = run(ap.parse_args(argv).device)

    print("== AND query: 'ranked retrieval' (DR — no extra space) ==")
    for d, s in out["dr_and"]:
        print(f"  doc {d} (tf-idf {s:.2f}): {' '.join(DOCS[d])}")
    print("== OR query, BM25: 'space fox' (auto-routed to DRB) ==")
    for d, s in out["drb_or_bm25"]:
        print(f"  doc {d} (bm25 {s:.2f}): {' '.join(DOCS[d])}")
    print("== snippet extraction from the compressed text ==")
    for (d, _), words in zip(out["drb_or_bm25"], out["snippets"]):
        print(f"  doc {d}: {' '.join(words)} ...")
    rep = out["space"]
    print(f"== space == total index bytes: {rep['total']} "
          f"(byte stream {rep['level_bytes']}, counters {rep['rank_counters']})")


if __name__ == "__main__":
    main()
