"""Document-sharded distributed retrieval in the PyTorch/CUDA port: 8
shards served through ``repro_torch.engine.SearchEngine.shard``, shard s on
``cuda:{s % device_count}`` (or every shard on the CPU), the merge on the
first shard's device.  The port's counterpart of
``examples/distributed_retrieval.py``: the same corpus, queries and
searches, plus ``--device``.

    PYTHONPATH=src python examples/torch_distributed_retrieval.py
    PYTHONPATH=src python examples/torch_distributed_retrieval.py --device cpu

``run(device)`` returns every search's answers, and those of one unsharded
engine over the same corpus, as numpy arrays.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.engine import SearchEngine
from repro_torch.text import corpus

N_SHARDS = 8
#: (mode, strategy) of the reference example's searches
SEARCHES = (("or", "dr"), ("and", "dr"), ("and", "drb"))
LEAVES = ("docs", "scores", "n_found", "work", "pops", "padded")


def answers(res) -> dict:
    """The result's leaves (``LEAVES``) as host numpy arrays."""
    return {n: getattr(res, n).cpu().numpy() for n in LEAVES
            if getattr(res, n) is not None}


def run(device=None, *, docs: int = 2000, n_queries: int = 16,
        single: bool = True, warm: bool = True) -> dict:
    """Shard the reference example's corpus (``docs`` documents) 8 ways
    (``device="cpu"``: every shard on the CPU; default: shard s on
    ``cuda:{s % count}``) and run its searches over ``n_queries`` queries,
    timed after a first call when ``warm``: ``{"sharded": {search: leaves},
    "single": {search: leaves} (with ``single``: one engine over the same
    corpus on the first shard's device), "ms_per_query", "build_s", "s",
    "c", "n_tokens"}``."""
    cp = corpus.make_corpus(n_docs=docs, mean_doc_len=150, vocab_size=20000,
                            seed=0)
    t0 = time.time()
    engine = SearchEngine.shard(cp, n_shards=N_SHARDS, device=device)
    out = {"build_s": time.time() - t0, "s": engine.model.s,
           "c": engine.model.c, "n_tokens": cp.n_tokens, "sharded": {},
           "ms_per_query": {}}
    df = cp.doc_freqs()
    bands = corpus.fdoc_bands(cp.n_docs)
    queries = corpus.sample_queries(df, bands["ii"], n_queries, 3, seed=2)
    for mode, strategy in SEARCHES:
        name = f"{strategy}-{mode}"
        if warm:
            engine.search(queries, k=10, mode=mode, strategy=strategy)
        t0 = time.time()
        out["sharded"][name] = answers(engine.search(
            queries, k=10, mode=mode, strategy=strategy))
        out["ms_per_query"][name] = (time.time() - t0) / len(queries) * 1e3
    if single:
        one = SearchEngine.build(cp, device=engine.sharded.devices[0])
        out["single"] = {f"{s}-{m}": answers(one.search(
            queries, k=10, mode=m, strategy=s)) for m, s in SEARCHES}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default: shard s on cuda:{s % count}) or cpu")
    out = run(ap.parse_args(argv).device, single=False)
    print(f"built {N_SHARDS} shards in {out['build_s']:.1f}s "
          f"({out['n_tokens']} tokens, global (s,c)=({out['s']},{out['c']}))")
    for name, a in out["sharded"].items():
        strategy, mode = name.split("-")
        print(f"{strategy}-{mode:4s} {out['ms_per_query'][name]:7.2f} ms/query "
              f"| global top doc q0: {int(a['docs'][0, 0])} | shard pops: "
              f"{int(a['work'][0])}")


if __name__ == "__main__":
    main()
