"""The port's two search examples (``examples/torch_search_engine.py``,
``examples/torch_distributed_retrieval.py``) against the reference's
``SearchEngine``, built and called as the reference examples
(``examples/search_engine.py``, ``examples/distributed_retrieval.py``) call
it, on the same corpus and queries, cut to a small size (150 documents,
vocabulary 3,000, 4 queries; 300 documents and 4 queries over 8 shards).

``run("cpu")``'s answers — docs, scores, n_found and the work leaves (work,
pops, padded, and the positional match position and length) of every
workload — equal the reference's bitwise: under the parity contract that
holds at B >= 2 and Q = 3 (bucket 4) for the one-pop cores with the same
idf table, and at these sizes the port's own host idf table gives the
reference's scores on every query word; the heap core at P = 16, DRB and
the positional paths give them bitwise here too.  The sharded example's
answers also equal one unsharded engine's docs, scores and n_found (the
work leaves of a sharded search are summed over the shards).

The reference runs in ONE subprocess started with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` by the first test
(about 30 s), while the port's examples run here.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
SIZE = dict(docs=150, vocab=3000, batch=4, k=10)
SHARDED = dict(docs=300, n_queries=4)


def example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    from repro.engine import SearchEngine
    from repro.text import corpus

    size, sharded = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    LEAVES = ("docs", "scores", "n_found", "work", "pops", "padded",
              "match_pos", "match_len")

    def leaves(res):
        return {n: np.asarray(getattr(res, n)).tolist() for n in LEAVES
                if getattr(res, n, None) is not None}

    out = {"search": {}, "distributed": {}}
    # examples/search_engine.py
    cp = corpus.make_corpus(n_docs=size["docs"], mean_doc_len=200,
                            vocab_size=size["vocab"], seed=0)
    engine = SearchEngine.build(cp)
    df = cp.doc_freqs()
    bands = corpus.fdoc_bands(cp.n_docs)
    queries = corpus.sample_queries(df, bands["ii"], size["batch"], 3, seed=1)
    grams = corpus.sample_ngram_queries(cp.doc_tokens, size["batch"], 2,
                                        seed=2)
    for name, qs, kw in [
        ("DR/AND", queries, dict(mode="and", strategy="dr")),
        ("DR/OR", queries, dict(mode="or", strategy="dr")),
        ("DR/OR·16", queries, dict(mode="or", strategy="dr", beam_width=16)),
        ("DRB/AND", queries, dict(mode="and", strategy="drb")),
        ("BM25/OR", queries, dict(mode="or", strategy="auto",
                                  measure="bm25")),
        ("PHRASE", grams, dict(mode="phrase")),
        ("NEAR/8", grams, dict(mode="near", window=8)),
    ]:
        out["search"][name] = leaves(engine.search(qs, k=size["k"], **kw))
    # examples/distributed_retrieval.py
    cp = corpus.make_corpus(n_docs=sharded["docs"], mean_doc_len=150,
                            vocab_size=20000, seed=0)
    engine = SearchEngine.shard(cp, n_shards=8)
    df = cp.doc_freqs()
    bands = corpus.fdoc_bands(cp.n_docs)
    queries = corpus.sample_queries(df, bands["ii"], sharded["n_queries"], 3,
                                    seed=2)
    for mode, strategy in (("or", "dr"), ("and", "dr"), ("and", "drb")):
        out["distributed"][f"{strategy}-{mode}"] = leaves(engine.search(
            queries, k=10, mode=mode, strategy=strategy))
    with open(sys.argv[1], "w") as fh:
        json.dump(out, fh)
""")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("examples") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(path),
         json.dumps(SIZE), json.dumps(SHARDED)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, path = reference_run
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def search_answers(reference_run):
    return example("torch_search_engine").run("cpu", warm=False, **SIZE)


@pytest.fixture(scope="module")
def sharded_answers(reference_run):
    return example("torch_distributed_retrieval").run("cpu", warm=False,
                                                      **SHARDED)


def assert_leaves_equal(got: dict, want: dict, names=None):
    assert set(names or want) <= set(got)
    for n in names or want:
        g = got[n]
        w = np.asarray(want[n], dtype=g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=n)


@pytest.mark.parametrize("workload", [w[0] for w in example(
    "torch_search_engine").WORKLOADS])
def test_search_engine_answers_equal_the_references(workload, search_answers,
                                                    reference):
    got = search_answers["answers"][workload]
    want = reference["search"][workload]
    assert set(got) == set(want)
    assert_leaves_equal(got, want)


def test_search_engine_runs_the_references_workloads(search_answers,
                                                     reference):
    assert list(search_answers["answers"]) == list(reference["search"])
    # the OR workloads and the positional ones find documents
    for name in ("DR/OR", "DR/OR·16", "BM25/OR", "PHRASE", "NEAR/8"):
        assert search_answers["answers"][name]["n_found"].sum() > 0


@pytest.mark.parametrize("search", ["dr-or", "dr-and", "drb-and"])
def test_distributed_answers_equal_the_reference_and_the_single_engine(
        search, sharded_answers, reference):
    got = sharded_answers["sharded"][search]
    want = reference["distributed"][search]
    assert set(got) == set(want)
    assert_leaves_equal(got, want)
    single = sharded_answers["single"][search]
    for n in ("docs", "scores", "n_found"):
        np.testing.assert_array_equal(got[n], single[n], err_msg=n)


def test_examples_raise_without_a_card():
    """Neither example carries on on the CPU when asked for the card."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("torch_search_engine", "torch_distributed_retrieval"):
        with pytest.raises(RuntimeError):
            example(name).run(None, warm=False)
