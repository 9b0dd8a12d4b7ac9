"""The port's serving subsystem (``repro_torch.serve``) against ``repro.serve``
(CPU; the tests marked ``cuda`` run on the card and skip elsewhere).

* Snapshots: a bitwise round trip, versions, the format guard, and the
  shared format both ways — a snapshot the reference writes answers in the
  port, and one the port writes answers in the reference, bitwise equal to
  the other package's own build of the same corpus.  Sharded snapshots the
  same: the reference's 4-shard snapshot (written in a subprocess with 4
  simulated devices) answers in the port within the parity contract, the
  port's has the reference's manifest, CRCs included, and a 1-shard one
  answers in the reference.
* The server (on a single-index and on a sharded engine): rows bitwise
  equal to the port's direct ``engine.search``
  (the port's results are bitwise equal across batch shapes), and equal to
  the reference ``SearchServer``'s rows within the ROADMAP parity contract
  (tf-idf DR within 1 ulp at B = 1; DRB within Q/2 ulps, BM25 Q/2 + 2).
* The scheduler: cache replay, no executor built after warmup, shedding,
  coalescing, backpressure under a mixed flood, errors, admission checks,
  drain on stop and a 200-query smoke.

Every wait on a server carries a timeout.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.engine import EngineConfig as REngineConfig
from repro.engine import SearchEngine as RSearchEngine
from repro.serve import QueryProfile as RQueryProfile
from repro.serve import SearchServer as RSearchServer
from repro.serve import loadgen as r_loadgen
from repro.serve import snapshot as r_snapshot
from repro_torch.checkpoint import ckpt
from repro_torch.core import wtbc
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import backend
from repro_torch.serve import (LRUCache, QueryProfile, SearchServer,
                               ShedError, loadgen, snapshot)
from repro_torch.text import corpus
from test_torch_drb import assert_topk_close, aux_arrays, tolerance
from test_torch_index import model_arrays, reference_arrays

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = dict(n_docs=100, mean_doc_len=50, vocab_size=400, seed=11)
BLOCK = 512
WAIT = 60.0                     # seconds any single wait on a server may take


@pytest.fixture(scope="module")
def serve_corpus():
    return corpus.make_corpus(**SPEC)


@pytest.fixture(scope="module")
def serve_engine(serve_corpus):
    return SearchEngine.build(serve_corpus, EngineConfig(block=BLOCK),
                              device="cpu")


@pytest.fixture(scope="module")
def serve_queries(serve_engine):
    return loadgen.sample_queries(serve_engine, 24, 3, seed=5)


@pytest.fixture(scope="module")
def ref_engine(serve_corpus):
    eng = RSearchEngine.build(serve_corpus, REngineConfig(block=BLOCK))
    eng.aux                                       # build the tf bitmaps
    return eng


@pytest.fixture(scope="module")
def carried_engine(ref_engine):
    """A port engine over the reference's index, bitmaps, idf tables and
    mean document length — the parity contract's setting."""
    idf = {m: np.asarray(ref_engine._idf_table(ref_engine._resolve_measure(m)))
           for m in ("tfidf", "bm25")}
    return SearchEngine.from_arrays(
        reference_arrays(ref_engine.idx), model_arrays(ref_engine.model),
        idf=idf, config=EngineConfig(block=BLOCK),
        aux=aux_arrays(ref_engine.aux),
        avg_dl=float(np.asarray(ref_engine._avg_doc_len())), device="cpu")


def _assert_rows_bitwise(row, direct, b=0):
    np.testing.assert_array_equal(row.docs, direct.docs[b].cpu().numpy())
    np.testing.assert_array_equal(row.scores, direct.scores[b].cpu().numpy())
    assert row.n_found == int(direct.n_found[b])
    assert row.work == int(direct.work[b])
    for name, leaf in (("pops", "pops"), ("padded", "padded"),
                       ("overflowed", "overflowed")):
        want = getattr(direct, leaf)
        assert (getattr(row, name) is None) == (want is None), name
        if want is not None:
            assert getattr(row, name) == want[b].item(), name
    for name, leaf in (("certified", "certified"),
                       ("match_pos", "match_pos"), ("match_len", "match_len")):
        want = getattr(direct, leaf)
        assert (getattr(row, name) is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(getattr(row, name),
                                          want[b].cpu().numpy())


def test_query_samplers_match_the_references(serve_engine, serve_queries,
                                             ref_engine):
    """The same seeds draw the same words: band queries from the df table,
    n-grams decoded from the index (one batched decode in the port)."""
    assert serve_queries == r_loadgen.sample_queries(ref_engine, 24, 3,
                                                     seed=5)
    assert loadgen.sample_ngram_queries(serve_engine, 3, 3, seed=2) == \
        r_loadgen.sample_ngram_queries(ref_engine, 3, 3, seed=2)
    assert loadgen.zipf_workload(serve_queries, 50, seed=1) == \
        r_loadgen.zipf_workload(serve_queries, 50, seed=1)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

SNAPSHOT_COMBOS = [
    dict(mode="and", strategy="dr", measure="tfidf"),
    dict(mode="or", strategy="dr", measure="tfidf"),
    dict(mode="or", strategy="dr", measure="tfidf", mega=True),
    dict(mode="and", strategy="drb", measure="bm25"),
    dict(mode="or", strategy="drb", measure="bm25"),
    dict(mode="phrase", strategy="auto", measure="tfidf"),
    dict(mode="near", strategy="auto", measure="tfidf", window=6),
]
RESULT_LEAVES = ("docs", "scores", "n_found", "work", "pops", "overflowed",
                 "padded", "certified", "score_bound", "match_pos",
                 "match_len")


def _index_leaves(eng) -> dict:
    """Every index, bitmap and model array of a port engine, on the host."""
    idx, aux = eng.idx, eng.aux
    out = {f"level{i}.{f}": getattr(lv, f).cpu().numpy()
           for i, lv in enumerate(idx.levels) for f in ("data", "counts")}
    out.update({f"level{i}.length": lv.length
                for i, lv in enumerate(idx.levels)})
    out.update({f"offsets{i}": o.cpu().numpy()
                for i, o in enumerate(idx.offsets)})
    for f in ("cw", "cw_len", "node_off", "base_rank", "sep_pos", "df", "occ",
              "doc_len"):
        out[f] = getattr(idx, f).cpu().numpy()
    out.update(n=idx.n, n_docs=idx.n_docs, s=idx.s, c=idx.c,
               bv_words=aux.bv.words.cpu().numpy(),
               bv_counts=aux.bv.counts.cpu().numpy(), n_bits=aux.bv.n_bits,
               bit_off=aux.bit_off.cpu().numpy(),
               has_bm=aux.has_bm.cpu().numpy(), eps=aux.eps)
    for f in ("codes", "lens", "rank_of_word", "word_of_rank", "freqs"):
        out[f"model.{f}"] = getattr(eng.model, f)
    return out


def _assert_engines_equal(a, b):
    la, lb = _index_leaves(a), _index_leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_results_bitwise(a, b, msg):
    for name in RESULT_LEAVES:
        av, bv = getattr(a, name), getattr(b, name)
        assert (av is None) == (bv is None), f"{msg} {name}"
        if av is not None:
            np.testing.assert_array_equal(_np(av), _np(bv),
                                          err_msg=f"{msg} {name}")


def _search_all(eng, queries, phrase_qs):
    out = []
    for combo in SNAPSHOT_COMBOS:
        qs = phrase_qs if combo["mode"] in ("phrase", "near") else queries
        out.append(eng.search(qs, k=8, **combo))
    return out


def test_snapshot_roundtrip_bitwise(serve_engine, serve_queries, tmp_path):
    phrase_qs = loadgen.sample_ngram_queries(serve_engine, 4, 3, seed=3)
    snapshot.save(serve_engine, tmp_path)
    restored = snapshot.load(tmp_path, device="cpu")
    assert restored.n_docs == serve_engine.n_docs
    assert restored.config == serve_engine.config
    assert restored.content_tag == serve_engine.content_tag
    _assert_engines_equal(restored, serve_engine)
    for combo, a, b in zip(SNAPSHOT_COMBOS,
                           _search_all(serve_engine, serve_queries[:6],
                                       phrase_qs),
                           _search_all(restored, serve_queries[:6],
                                       phrase_qs)):
        _assert_results_bitwise(a, b, combo)
    res = restored.search(serve_queries[:2], k=3, mode="or")
    assert [[s.tolist() for s in row] for row in
            restored.snippets(res, length=5)] == \
        [[s.tolist() for s in row] for row in
         serve_engine.snippets(res, length=5)]
    # a lazy load (no CRC pass, memory-mapped leaves) answers the same
    lazy = snapshot.load(tmp_path, verify=False, device="cpu")
    _assert_results_bitwise(lazy.search(serve_queries[:4], k=8, mode="or"),
                            serve_engine.search(serve_queries[:4], k=8,
                                                mode="or"), "lazy")


def test_snapshot_versioning(serve_engine, tmp_path):
    p1 = snapshot.save(serve_engine, tmp_path)
    p2 = snapshot.save(serve_engine, tmp_path)
    assert (p1.name, p2.name) == ("step_00000001", "step_00000002")
    assert snapshot.list_versions(tmp_path) == [1, 2]
    old = snapshot.load(tmp_path, version=1, device="cpu")
    new = snapshot.load(tmp_path, device="cpu")
    assert old.n_docs == new.n_docs == serve_engine.n_docs


def test_snapshot_without_drb(tmp_path):
    docs = [np.arange(1, 9, dtype=np.int64) for _ in range(5)]
    eng = SearchEngine.build(docs, EngineConfig(with_drb=False),
                             vocab_size=16, device="cpu")
    snapshot.save(eng, tmp_path)
    man, _ = ckpt.read_manifest(tmp_path)
    assert not any(l["name"].startswith("['aux']") for l in man["leaves"])
    restored = snapshot.load(tmp_path, device="cpu")
    res = restored.search([[2, 3]], k=2, strategy="auto")
    assert res.strategy == "dr"
    with pytest.raises(ValueError, match="with_drb"):
        restored.search([[2, 3]], k=2, strategy="drb")
    # the reference loads it too
    ref = r_snapshot.load(tmp_path)
    np.testing.assert_array_equal(
        np.asarray(ref.search([[2, 3]], k=2).docs), res.docs.numpy())


def test_snapshot_format_and_config_guards(serve_engine, tmp_path):
    d = snapshot.save(serve_engine, tmp_path)
    man = json.loads((d / "MANIFEST.json").read_text())
    assert man["user_meta"]["config"]["kernel_backend"] == "auto"

    def rewrite(**meta):
        m = json.loads(json.dumps(man))
        for k, v in meta.items():
            if k == "kernel_backend":
                m["user_meta"]["config"][k] = v
            else:
                m["user_meta"][k] = v
        (d / "MANIFEST.json").write_text(json.dumps(m))

    rewrite(snapshot_format=999)
    with pytest.raises(ValueError, match="format"):
        snapshot.load(tmp_path, device="cpu")
    rewrite(kernel_backend="tpu")
    with pytest.raises(ValueError, match="kernel_backend"):
        snapshot.load(tmp_path, device="cpu")
    rewrite(backend="replicated")
    with pytest.raises(ValueError, match="backend"):
        snapshot.load(tmp_path, device="cpu")
    # sharded snapshots load now: a single index's leaves are not a
    # sharded one's
    rewrite(backend="sharded", n_shards=4, shard_axes="shards")
    with pytest.raises(KeyError, match="no leaf"):
        snapshot.load(tmp_path, device="cpu")


def test_reference_snapshot_answers_in_the_port(serve_engine, serve_queries,
                                                ref_engine, tmp_path):
    """The reference writes, the port reads: the loaded index equals the
    port's own build of the corpus leaf for leaf, so every answer is bitwise
    the port's own."""
    phrase_qs = loadgen.sample_ngram_queries(serve_engine, 4, 3, seed=3)
    r_snapshot.save(ref_engine, tmp_path)
    loaded = snapshot.load(tmp_path, device="cpu")
    assert loaded.config == serve_engine.config
    _assert_engines_equal(loaded, serve_engine)
    for combo, a, b in zip(SNAPSHOT_COMBOS,
                           _search_all(loaded, serve_queries[:6], phrase_qs),
                           _search_all(serve_engine, serve_queries[:6],
                                       phrase_qs)):
        _assert_results_bitwise(a, b, combo)


def test_port_snapshot_answers_in_the_reference(serve_engine, serve_queries,
                                                ref_engine, tmp_path):
    """The port writes, the reference reads: the manifest equals the one the
    reference writes for the same corpus (leaf names, dtypes, shapes, CRCs
    and metadata), and the reference answers as its own engine does."""
    snapshot.save(serve_engine, tmp_path / "port")
    r_snapshot.save(ref_engine, tmp_path / "ref")
    mp, _ = ckpt.read_manifest(tmp_path / "port")
    mr, _ = ckpt.read_manifest(tmp_path / "ref")
    assert mp["user_meta"] == mr["user_meta"]
    assert [(l["name"], l["dtype"], l["shape"], l["crc32"])
            for l in mp["leaves"]] == \
        [(l["name"], l["dtype"], l["shape"], l["crc32"]) for l in mr["leaves"]]
    loaded = r_snapshot.load(tmp_path / "port")
    assert loaded.config == ref_engine.config
    for combo in (SNAPSHOT_COMBOS[0], SNAPSHOT_COMBOS[4]):
        a = loaded.search(serve_queries[:4], k=8, **combo)
        b = ref_engine.search(serve_queries[:4], k=8, **combo)
        for name in ("docs", "scores", "n_found", "work"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)),
                                          err_msg=f"{combo} {name}")


# ---------------------------------------------------------------------------
# sharded snapshots (the reference at 4 shards runs in one subprocess: its
# simulated device count locks when JAX starts)
# ---------------------------------------------------------------------------

SHARDED_COMBOS = [dict(mode="and", strategy="dr", measure="tfidf"),
                  dict(mode="or", strategy="dr", measure="tfidf"),
                  dict(mode="or", strategy="drb", measure="bm25"),
                  dict(mode="and", strategy="drb", measure="tfidf")]
REFERENCE_SHARDED = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.engine import EngineConfig, SearchEngine
    from repro.serve import snapshot
    from repro.text import corpus

    snap, out, queries = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    cp = corpus.make_corpus(**{spec!r})
    eng = SearchEngine.shard(cp, n_shards=4,
                             config=EngineConfig(block={block}))
    snapshot.save(eng, snap)
    res = {{}}
    for m in ("tfidf", "bm25"):
        res["idf/" + m] = np.asarray(eng._idf_table(eng._resolve_measure(m)))
    for i, combo in enumerate({combos!r}):
        r = eng.search(queries, k=8, **combo)
        for name in ("docs", "scores", "n_found", "work", "pops",
                     "overflowed", "padded", "certified", "score_bound"):
            v = getattr(r, name)
            if v is not None:
                res[f"{{i}}/{{name}}"] = np.asarray(v)
    np.savez(out, **res)
    print("OK")
""")


@pytest.fixture(scope="module")
def sharded_engine(serve_corpus):
    return SearchEngine.shard(serve_corpus, 4, EngineConfig(block=BLOCK),
                              device="cpu")


@pytest.fixture(scope="module")
def reference_sharded(sharded_engine, tmp_path_factory):
    """The reference's 4-shard engine of the same corpus, written as a
    snapshot, and its answers to the same queries."""
    d = tmp_path_factory.mktemp("ref_sharded")
    queries = loadgen.sample_queries(sharded_engine, 6, 3, seed=8)
    script = REFERENCE_SHARDED.format(spec=SPEC, block=BLOCK,
                                      combos=SHARDED_COMBOS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", script, str(d / "snap"),
                        str(d / "ref.npz"), json.dumps(queries)], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, \
        f"stdout:\n{r.stdout}\nstderr:\n{r.stderr[-3000:]}"
    return d / "snap", np.load(d / "ref.npz"), queries


def test_reference_sharded_snapshot_answers_in_the_port(sharded_engine,
                                                        reference_sharded):
    """The reference writes a 4-shard snapshot, the port loads it: every
    answer is bitwise the port's own sharded build's, and, with the
    reference's idf tables, the reference's within the parity contract
    (DR bitwise at B = 6, Q = 4; DRB within Q/2 (+2 for BM25) ulps)."""
    snap, ref, queries = reference_sharded
    loaded = snapshot.load(snap, device="cpu")
    assert loaded.backend == "sharded" and loaded.config == \
        sharded_engine.config
    assert [i.n_docs for i in loaded.idx] == \
        [i.n_docs for i in sharded_engine.idx]
    assert loaded.content_tag == sharded_engine.content_tag
    for combo in SHARDED_COMBOS:
        _assert_results_bitwise(loaded.search(queries, k=8, **combo),
                                sharded_engine.search(queries, k=8, **combo),
                                combo)
    for m in ("tfidf", "bm25"):
        loaded._idf_tables[m] = torch.from_numpy(np.array(ref["idf/" + m]))
    for i, combo in enumerate(SHARDED_COMBOS):
        got = loaded.search(queries, k=8, **combo)
        for name in ("n_found", "work", "pops", "overflowed", "padded",
                     "certified"):
            key = f"{i}/{name}"
            assert (getattr(got, name) is None) == (key not in ref.files)
            if key in ref.files:
                np.testing.assert_array_equal(_np(getattr(got, name)),
                                              ref[key], err_msg=name)
        tol = 0 if combo["strategy"] == "dr" else \
            tolerance(combo["measure"], 4)
        assert_topk_close(got.docs.numpy(), got.scores.numpy(),
                          ref[f"{i}/docs"], ref[f"{i}/scores"], tol)
        if combo["strategy"] == "dr":
            np.testing.assert_array_equal(got.docs.numpy(), ref[f"{i}/docs"])
        np.testing.assert_array_equal(got.score_bound.numpy(),
                                      ref[f"{i}/score_bound"])


def test_port_sharded_snapshot_manifest_equals_the_references(
        serve_corpus, sharded_engine, reference_sharded, tmp_path):
    """The port writes its own 4-shard build: leaf names, dtypes, shapes,
    CRCs and metadata equal the reference's snapshot of the same corpus;
    the port loads it back bitwise."""
    snap, _, queries = reference_sharded
    snapshot.save(sharded_engine, tmp_path)
    mp, _ = ckpt.read_manifest(tmp_path)
    mr, _ = ckpt.read_manifest(snap)
    assert mp["user_meta"] == mr["user_meta"]
    assert [(l["name"], l["dtype"], l["shape"], l["crc32"])
            for l in mp["leaves"]] == \
        [(l["name"], l["dtype"], l["shape"], l["crc32"]) for l in mr["leaves"]]
    back = snapshot.load(tmp_path, device="cpu", devices=["cpu"] * 4)
    res = back.search(queries, k=8, mode="or")
    _assert_results_bitwise(res, sharded_engine.search(queries, k=8,
                                                       mode="or"), "or")
    for b, row in enumerate(back.snippets(res, length=4)):
        for (d, _), words in zip(res.hits(b), row):
            np.testing.assert_array_equal(words,
                                          serve_corpus.doc_tokens[d][:4])


def test_port_sharded_snapshot_answers_in_the_reference(serve_corpus,
                                                        tmp_path):
    """One shard, so the reference can load it on this process's single
    device: the reference answers as its own sharded engine does."""
    port = SearchEngine.shard(serve_corpus, 1, EngineConfig(block=BLOCK),
                              device="cpu")
    ref = RSearchEngine.shard(serve_corpus, n_shards=1,
                              config=REngineConfig(block=BLOCK))
    snapshot.save(port, tmp_path)
    loaded = r_snapshot.load(tmp_path)
    assert loaded.backend == "sharded"
    queries = loadgen.sample_queries(port, 4, 3, seed=2)
    for combo in (SHARDED_COMBOS[0], SHARDED_COMBOS[2]):
        a = loaded.search(queries, k=8, **combo)
        b = ref.search(queries, k=8, **combo)
        for name in ("docs", "scores", "n_found", "work"):
            np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                          np.asarray(getattr(b, name)),
                                          err_msg=f"{combo} {name}")


@pytest.mark.parametrize("which", range(4))
def test_server_rows_on_a_sharded_engine_match_direct(sharded_engine,
                                                      which):
    """The server takes a sharded engine as it takes a single one: coalesced
    rows bitwise equal to a direct search, cache replays included."""
    queries = loadgen.sample_queries(sharded_engine, 10, 3, seed=6)
    profile = _profiles(sharded_engine, queries)[which]
    server = SearchServer(sharded_engine, max_batch=8, max_wait_ms=5.0,
                          cache_size=16)
    server.warmup(queries, profile)
    traces = sum(sharded_engine.stats["traces"].values())
    with server:
        rep = loadgen.closed_loop(server, queries * 2, n_workers=8,
                                  profile=profile, timeout_s=WAIT)
        rows = {tuple(q): server.search(q, profile, timeout=WAIT)
                for q in queries}
    assert rep.n_ok == len(queries) * 2
    assert rep.server_stats["errors"] == 0
    assert sum(sharded_engine.stats["traces"].values()) == traces
    for q, row in rows.items():
        _assert_rows_bitwise(row, sharded_engine.search(
            [list(q)], **profile.search_kwargs()))


# ---------------------------------------------------------------------------
# LRU cache
# ---------------------------------------------------------------------------

def test_lru_eviction_order():
    c = LRUCache(2)
    c.put("a", 1), c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)                           # evicts "b" (least recent)
    assert c.get("b") is None
    assert c.get("a") == 1 and c.get("c") == 3
    assert c.stats["hits"] == 3 and c.stats["misses"] == 1
    assert len(c) == 2


def test_lru_disabled_at_zero_capacity():
    c = LRUCache(0)
    c.put("a", 1)
    assert c.get("a") is None
    assert c.stats == {"hits": 0, "misses": 1, "hit_rate": 0.0,
                       "size": 0, "capacity": 0}
    with pytest.raises(ValueError):
        LRUCache(-1)


# ---------------------------------------------------------------------------
# the server on the port's engine
# ---------------------------------------------------------------------------

def _profiles(engine, queries):
    return [
        QueryProfile(mode="and", strategy="dr", k=6),
        QueryProfile(mode="or", strategy="dr", k=6, mega=True),
        QueryProfile(mode="or", strategy="drb", measure="bm25", k=6,
                     df_cap=engine.suggested_df_cap(queries)),
        QueryProfile(mode="and", strategy="drb", measure="tfidf", k=6),
    ]


@pytest.mark.parametrize("which", range(4))
def test_server_results_bitwise_match_direct(serve_engine, serve_queries,
                                             which):
    """Coalesced concurrent traffic == direct single-query search, bitwise,
    on every result leaf (DR heap and mega, DRB or and and)."""
    profile = _profiles(serve_engine, serve_queries)[which]
    queries = serve_queries[:12]
    server = SearchServer(serve_engine, max_batch=8, max_wait_ms=5.0,
                          cache_size=0)
    server.warmup(queries, profile)
    with server:
        rep = loadgen.closed_loop(server, queries * 2, n_workers=8,
                                  profile=profile, timeout_s=WAIT)
        rows = {tuple(q): server.search(q, profile, timeout=WAIT)
                for q in queries}
    assert rep.n_ok == len(queries) * 2
    assert rep.server_stats["errors"] == 0
    assert max(rep.server_stats["batch_hist"]) > 1       # it did coalesce
    for q, row in rows.items():
        _assert_rows_bitwise(row, serve_engine.search(
            [list(q)], **profile.search_kwargs()))


@pytest.mark.parametrize("which", range(4))
def test_server_rows_match_the_reference_server(carried_engine, ref_engine,
                                                serve_queries, which):
    """The port's server and the reference's, each over its package's engine
    of the same index: equal rows within the parity contract."""
    profile = _profiles(carried_engine, serve_queries)[which]
    rprofile = RQueryProfile(**{f: getattr(profile, f) for f in (
        "mode", "strategy", "measure", "k", "df_cap", "mega")})
    with SearchServer(carried_engine, max_batch=1, cache_size=0) as ours, \
            RSearchServer(ref_engine, max_batch=1, cache_size=0) as ref:
        for q in serve_queries[:8]:
            a = ours.search(q, profile, timeout=WAIT)
            b = ref.search(q, rprofile, timeout=WAIT)
            assert a.n_found == b.n_found and a.work == b.work
            assert (a.pops, a.overflowed) == (b.pops, b.overflowed)
            np.testing.assert_array_equal(a.certified, b.certified)
            tol = 1 if profile.strategy == "dr" else \
                tolerance(profile.measure, 4)
            assert_topk_close(a.docs[None], a.scores[None], b.docs[None],
                              b.scores[None], tol)


def test_server_positional_profile(serve_engine, ref_engine):
    """phrase/near profiles serve through the same frontend with their match
    payloads; the reference's server agrees on every integer leaf."""
    qs = loadgen.sample_ngram_queries(serve_engine, 4, 2, seed=9)
    for profile in (QueryProfile(mode="phrase", k=5),
                    QueryProfile(mode="near", k=5, window=4)):
        rprofile = RQueryProfile(mode=profile.mode, k=5,
                                 window=profile.window)
        with SearchServer(serve_engine, max_batch=4, cache_size=0) as server, \
                RSearchServer(ref_engine, max_batch=4, cache_size=0) as ref:
            for q in qs:
                row = server.search(q, profile, timeout=WAIT)
                _assert_rows_bitwise(row, serve_engine.search(
                    [q], **profile.search_kwargs()))
                want = ref.search(q, rprofile, timeout=WAIT)
                assert row.n_found == want.n_found > 0
                np.testing.assert_array_equal(row.match_len, want.match_len)
                assert_topk_close(row.docs[None], row.scores[None],
                                  want.docs[None], want.scores[None],
                                  tolerance("tfidf", 2) + 1)


def test_server_cache_replays_identical_rows(serve_engine, serve_queries):
    profile = QueryProfile(mode="and", strategy="dr", k=5)
    with SearchServer(serve_engine, max_batch=4, cache_size=64) as server:
        first = [server.search(q, profile, timeout=WAIT)
                 for q in serve_queries[:8]]
        h0 = server.cache.stats["hits"]
        again = [server.search(q, profile, timeout=WAIT)
                 for q in serve_queries[:8]]
        assert server.cache.stats["hits"] == h0 + 8
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a.docs, b.docs)
            np.testing.assert_array_equal(a.scores, b.scores)
        other = QueryProfile(mode="or", strategy="dr", k=5)
        row = server.search(serve_queries[0], other, timeout=WAIT)
        _assert_rows_bitwise(row, serve_engine.search(
            [serve_queries[0]], **other.search_kwargs()))


def test_server_zero_retraces_after_warmup(serve_engine, serve_queries):
    profile = QueryProfile(mode="or", strategy="drb", measure="bm25", k=5,
                           df_cap=serve_engine.suggested_df_cap(serve_queries))
    server = SearchServer(serve_engine, max_batch=8, max_wait_ms=2.0,
                          cache_size=0)
    server.warmup(serve_queries, profile)
    before = sum(serve_engine.stats["traces"].values())
    with server:
        rep = loadgen.closed_loop(server, serve_queries * 3, n_workers=8,
                                  profile=profile, timeout_s=WAIT)
    assert rep.n_ok == len(serve_queries) * 3
    assert sum(serve_engine.stats["traces"].values()) == before


def _dummy_engine(delay_s: float = 0.0):
    """A stand-in with a controllable service time and tensor results."""
    def search(queries, **kw):
        if delay_s:
            time.sleep(delay_s)
        B = len(queries)
        k = kw.get("k") or 3
        return types.SimpleNamespace(
            docs=torch.arange(k, dtype=torch.int32).repeat(B, 1),
            scores=torch.zeros((B, k)),
            n_found=torch.full((B,), k, dtype=torch.int32),
            work=torch.ones(B, dtype=torch.int32),
            pops=None, overflowed=None, match_pos=None, match_len=None,
            k=k, mode=kw.get("mode", "and"), strategy="dr", measure="tfidf")
    return types.SimpleNamespace(
        search=search, model=types.SimpleNamespace(vocab_size=100),
        stats={"executors": 0, "traces": {}},
        warmup=lambda *a, **kw: 0)


def test_server_sheds_when_queue_full():
    with SearchServer(_dummy_engine(delay_s=0.05), max_batch=1,
                      max_wait_ms=0.0, queue_depth=2, cache_size=0) as server:
        tickets, shed = [], 0
        for i in range(40):
            try:
                tickets.append(server.submit([1 + i % 9]))
            except ShedError:
                shed += 1
        assert shed > 0
        for t in tickets:
            t.result(timeout=WAIT)
        assert server.stats["shed"] == shed
        assert server.stats["served"] == len(tickets)


def test_server_coalesces_burst_into_buckets():
    with SearchServer(_dummy_engine(delay_s=0.02), max_batch=4,
                      max_wait_ms=10.0, queue_depth=64,
                      cache_size=0) as server:
        tickets = [server.submit([1, 2]) for _ in range(12)]
        for t in tickets:
            t.result(timeout=WAIT)
    hist = server.stats["batch_hist"]
    assert sum(b * n for b, n in hist.items()) == 12
    assert max(hist) == 4
    assert server.stats["dispatches"] < 12


def test_mixed_profile_flood_keeps_backpressure_bounded():
    depth = 8
    with SearchServer(_dummy_engine(delay_s=0.02), max_batch=4,
                      max_wait_ms=50.0, queue_depth=depth,
                      cache_size=0) as server:
        pa, pb = QueryProfile(k=3), QueryProfile(k=4)
        tickets, shed = [], 0
        for i in range(200):
            try:
                tickets.append(server.submit([1 + i % 9], pa if i % 2 else pb))
            except ShedError:
                shed += 1
        assert shed > 0
        assert len(server._batcher._pending) <= depth
        for t in tickets:
            t.result(timeout=WAIT)
        assert server.stats["served"] == len(tickets)


def test_loadgen_reports_errors_not_fake_latencies():
    def boom(queries, **kw):
        raise RuntimeError("engine exploded")
    eng = _dummy_engine()
    eng.search = boom
    with SearchServer(eng, max_batch=4, cache_size=0) as server:
        rep = loadgen.closed_loop(server, [[3]] * 12, n_workers=3,
                                  timeout_s=WAIT)
    assert rep.n_ok == 0 and rep.n_err == 12
    with SearchServer(eng, max_batch=4, cache_size=0) as server:
        rep = loadgen.open_loop(server, [[3]] * 10, target_qps=500.0,
                                timeout_s=10.0)
    assert rep.n_ok == 0 and rep.n_err == 10
    assert "err" in rep.summary()


def test_ngram_sampler_queries_actually_match(serve_engine):
    qs = loadgen.sample_ngram_queries(serve_engine, 6, 3, seed=2)
    res = serve_engine.search(qs, k=3, mode="phrase")
    assert all(int(n) > 0 for n in res.n_found)


def test_server_rejects_bad_requests_at_admission(serve_engine):
    with SearchServer(serve_engine, cache_size=0) as server:
        with pytest.raises(ValueError, match="word ids"):
            server.submit([0])
        with pytest.raises(ValueError, match="empty"):
            server.submit([])
        with pytest.raises(ValueError, match="one flat query"):
            server.submit([[1, 2], [3, 4]])
        heavy = int(serve_engine.model.word_of_rank[1])
        narrow = QueryProfile(mode="or", strategy="drb", measure="bm25",
                              df_cap=4)
        with pytest.raises(ValueError, match="wider profile"):
            server.submit([heavy], narrow)
    with pytest.raises(RuntimeError, match="not started"):
        SearchServer(serve_engine).submit([1])


def test_server_drains_on_stop():
    server = SearchServer(_dummy_engine(delay_s=0.01), max_batch=2,
                          max_wait_ms=0.0, queue_depth=64,
                          cache_size=0).start()
    tickets = [server.submit([5]) for _ in range(10)]
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    stopper.join(timeout=WAIT)
    assert not stopper.is_alive()
    assert all(t.done() for t in tickets)
    assert server.stats["served"] == 10


def test_serving_smoke_200_queries(serve_engine, serve_queries):
    """200 queries through the batcher at low load: every one answered,
    finite p99, zero shed, no executor built after warmup, cache hits."""
    profile = QueryProfile(mode="or", strategy="drb", measure="bm25", k=5,
                           df_cap=serve_engine.suggested_df_cap(serve_queries))
    server = SearchServer(serve_engine, max_batch=8, max_wait_ms=2.0,
                          cache_size=128)
    server.warmup(serve_queries, profile)
    before = sum(serve_engine.stats["traces"].values())
    workload = loadgen.zipf_workload(serve_queries, 200, seed=1)
    with server:
        rep = loadgen.closed_loop(server, workload, n_workers=4,
                                  profile=profile, timeout_s=WAIT)
    assert rep.n_ok == 200 and rep.n_shed == 0 and rep.n_timeout == 0
    assert np.isfinite(rep.p99_ms)
    assert rep.server_stats["errors"] == 0
    assert sum(serve_engine.stats["traces"].values()) == before
    assert rep.server_stats["cache"]["hits"] > 0


# ---------------------------------------------------------------------------
# on the card (skip elsewhere)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")


@pytest.mark.cuda
def test_server_on_card_launches_from_its_worker_thread(serve_corpus,
                                                        serve_engine,
                                                        serve_queries,
                                                        monkeypatch):
    """Served rows on the card are bitwise equal to direct search on the
    card and on the CPU, and every kernel of a served batch is launched from
    the server's dispatch thread."""
    _need_card()
    eng = SearchEngine.build(serve_corpus, EngineConfig(block=BLOCK),
                             device="cuda")
    phrase_qs = loadgen.sample_ngram_queries(eng, 8, 2, seed=4)
    assert phrase_qs == loadgen.sample_ngram_queries(serve_engine, 8, 2,
                                                     seed=4)
    threads = []
    for k in backend.KERNELS:
        orig = k.launch

        def launch(*args, _orig=orig, _name=k.name):
            threads.append((_name, threading.current_thread().name))
            return _orig(*args)
        monkeypatch.setattr(k, "launch", launch)
    profiles = _profiles(eng, serve_queries) + [QueryProfile(mode="phrase",
                                                             k=5)]
    for profile in profiles:
        qs = phrase_qs if profile.mode == "phrase" else serve_queries
        server = SearchServer(eng, max_batch=8, max_wait_ms=5.0, cache_size=0)
        server.warmup(qs, profile)
        threads.clear()
        with server:
            rep = loadgen.closed_loop(server, qs * 2, n_workers=8,
                                      profile=profile, timeout_s=WAIT)
            rows = {tuple(q): server.search(q, profile, timeout=WAIT)
                    for q in qs}
        assert rep.n_ok == 2 * len(qs) and rep.server_stats["errors"] == 0
        assert threads and {t for _, t in threads} == \
            {"search-server-dispatch"}, profile
        for q, row in rows.items():
            kw = profile.search_kwargs()
            _assert_rows_bitwise(row, eng.search([list(q)], **kw))
            _assert_rows_bitwise(row, serve_engine.search([list(q)], **kw))


@pytest.mark.cuda
def test_snapshot_loads_onto_the_card(serve_engine, serve_queries, tmp_path):
    _need_card()
    snapshot.save(serve_engine, tmp_path)
    on_card = snapshot.load(tmp_path)
    assert on_card.device.type == "cuda"
    phrase_qs = loadgen.sample_ngram_queries(serve_engine, 4, 3, seed=3)
    for combo, a, b in zip(SNAPSHOT_COMBOS,
                           _search_all(on_card, serve_queries[:6], phrase_qs),
                           _search_all(serve_engine, serve_queries[:6],
                                       phrase_qs)):
        _assert_results_bitwise(a, b, combo)


@pytest.mark.cuda
def test_kernels_build_and_launch_from_two_threads_at_once(tmp_path,
                                                           monkeypatch):
    """Two threads launch the same kernel at once against an empty build
    directory: one ``nvcc`` runs, both launches count, both results equal
    the plain version."""
    _need_card()
    monkeypatch.setattr(backend, "BUILD_DIR", tmp_path / "build")
    k = backend.WAVELET_COUNT
    monkeypatch.setattr(k, "_fn", None)
    idx = SearchEngine.build([np.arange(1, 40)] * 30, EngineConfig(block=512),
                             device="cuda").idx
    rng = np.random.default_rng(0)
    M = 256
    w = torch.from_numpy(rng.integers(1, idx.vocab_size, M).astype(np.int32))
    lo = torch.from_numpy(rng.integers(0, idx.n // 2, M).astype(np.int32))
    hi = lo + torch.from_numpy(rng.integers(0, idx.n // 2, M).astype(np.int32))
    w, lo, hi = w.cuda(), lo.cuda(), hi.cuda()
    want = wtbc.count_range_batch(idx, w, lo, hi, kernel_backend="ref")
    before = k.launches
    out, errors = [None, None], []
    barrier = threading.Barrier(2)

    def worker(i):
        try:
            barrier.wait(timeout=WAIT)
            out[i] = wtbc.count_range_batch(idx, w, lo, hi)
            torch.cuda.synchronize()
        except Exception as e:                    # reported below
            errors.append(e)
    ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts) and not errors, errors
    assert k.launches == before + 2
    assert list((tmp_path / "build").glob("wavelet_descent-*.so"))
    for got in out:
        assert torch.equal(got, want)
