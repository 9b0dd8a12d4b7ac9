"""The paper's deployment in the port (``configs/wtbc_paper.py``) and the
query generators it draws from (``text/corpus.py``) against ``repro``
(CPU).

* ``abstract_sharded`` equals the reference's leaf for leaf (names as the
  stacked form gives them, shapes, dtypes, static fields) at 1, 4 and 256
  shards, full and smoke configs; ``sharded_specs`` equals its specs.
* ``make_query_fn``'s four methods on the port's own 4-shard build equal the
  reference's ``make_query_fn`` over a 4-device CPU mesh (one subprocess for
  the file, ``XLA_FLAGS`` set there) under the ROADMAP parity contract
  (``test_torch_distributed.assert_parity``: DR at P = 1 bitwise, DRB scores
  within Q/2 ulps with every integer leaf and the bound bitwise), on a
  256-document corpus at the smoke config's block (512) and at the
  deployment's (32,768, one block a level).
* ``sample_ngram_queries`` and ``zipf_real_queries`` are bitwise the
  reference's for the same seed.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import wtbc_paper as r_wtbc_paper
from repro.text import corpus as r_corpus
from repro_torch.configs import registry, wtbc_paper
from repro_torch.core import distributed
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.dryrun import leaves_with_specs
from repro_torch.text import corpus
from test_torch_distributed import LEAVES, assert_parity, query_arrays
from test_torch_dryrun import _dtype, _wtbc_name

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPEC = dict(n_docs=256, mean_doc_len=120, vocab_size=500, seed=11)
BLOCKS = (512, 32768)
ARCH = wtbc_paper.ARCH


def _static(node, out: dict, name: str = ""):
    """Non-tensor fields of the stacked form, by name."""
    if isinstance(node, dict):
        for k, v in node.items():
            _static(v, out, f"{name}[{k!r}]")
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _static(v, out, f"{name}[{i}]")
    elif not isinstance(node, torch.Tensor):
        out[name] = node
    return out


@pytest.mark.parametrize("n_shards", [1, 4, 256])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_abstract_sharded_equals_reference(smoke, n_shards):
    cfg, rcfg = ARCH.config(smoke), r_wtbc_paper.ARCH.config(smoke)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    got = wtbc_paper.abstract_sharded(cfg, n_shards)
    want = r_wtbc_paper.abstract_sharded(rcfg, n_shards)
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    ref = {_wtbc_name(jax.tree_util.keystr(p)): (tuple(l.shape), str(l.dtype))
           for p, l in leaves}
    port = {}
    for n, t, _ in leaves_with_specs(got, ARCH.sharded_specs(got, ("data",))):
        assert t.device.type == "meta"
        port[n] = (tuple(t.shape), _dtype(t))
    assert port == ref
    st = _static(got, {})
    assert st["['n_shards']"] == want.n_shards == n_shards
    assert st["['idx']['s']"] == want.idx.s and st["['idx']['c']"] == want.idx.c
    assert st["['aux']['eps']"] == want.aux.eps
    assert [st[f"['idx']['levels'][{i}]['block']"] for i in range(3)] == \
        [lv.block for lv in want.idx.levels]


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model"),
                                  ("data",)])
def test_sharded_specs_equal_reference(axes):
    cfg = ARCH.config()
    got = ARCH.sharded_specs(wtbc_paper.abstract_sharded(cfg, 4), axes)
    rsh = r_wtbc_paper.abstract_sharded(r_wtbc_paper.ARCH.config(), 4)
    rspecs = r_wtbc_paper.ARCH.sharded_specs(rsh, axes)
    names = [_wtbc_name(jax.tree_util.keystr(p))
             for p, _ in jax.tree_util.tree_flatten_with_path(rsh)[0]]
    ref = dict(zip(names, (tuple(s) for s in jax.tree.leaves(
        rspecs, is_leaf=lambda x: isinstance(x, P)))))
    port = {n: s for n, _, s in leaves_with_specs(
        wtbc_paper.abstract_sharded(cfg, 4), got)}
    assert port == ref


def test_registry_serves_the_deployment():
    arch = registry.get("wtbc")
    assert arch is ARCH and arch.family == "retrieval"
    assert [c.shape for c in arch.cells()] == list(wtbc_paper.SHAPES)
    inp = arch.abstract_inputs(arch.config(), "queries_dr_or")
    assert inp["words"].shape == (64, 4) and inp["wmask"].dtype == torch.bool
    with pytest.raises(NotImplementedError):
        arch.make_step(arch.config(), "serve")
    with pytest.raises(NotImplementedError):
        arch.init_params(arch.config())


# ---------------------------------------------------------------------------
# corpus generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_zipf_real_queries_bitwise_reference(seed):
    cp = corpus.make_corpus(n_docs=300, mean_doc_len=60, vocab_size=2000,
                            seed=seed)
    df = cp.doc_freqs()
    got = corpus.zipf_real_queries(df, 32, 4, seed=seed)
    want = r_corpus.zipf_real_queries(df, 32, 4, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"df_cap": 20},
                                {"random_prob": 0.3, "vocab_size": 2000}],
                         ids=["plain", "df_cap", "random"])
def test_sample_ngram_queries_bitwise_reference(kw):
    cp = corpus.make_corpus(n_docs=300, mean_doc_len=60, vocab_size=2000,
                            seed=3)
    if "df_cap" in kw:
        kw = dict(kw, df=cp.doc_freqs())
    got = corpus.sample_ngram_queries(cp.doc_tokens, 40, 3, seed=5, **kw)
    want = r_corpus.sample_ngram_queries(cp.doc_tokens, 40, 3, seed=5, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="no documents"):
        corpus.sample_ngram_queries([np.arange(2)], 1, 3)


# ---------------------------------------------------------------------------
# the deployment's query against the reference's on 4 devices
# ---------------------------------------------------------------------------

REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import wtbc_paper
    from repro.core import distributed
    from repro.text import corpus

    inputs, out = sys.argv[1], sys.argv[2]
    cp = corpus.make_corpus(**{spec!r})
    arch = wtbc_paper.ARCH
    cfg = arch.config(smoke=True)
    mesh = jax.make_mesh((4,), ("data",))
    x = np.load(inputs)
    res = {{}}
    for block in {blocks!r}:
        sh, _ = distributed.build_sharded(cp.doc_tokens, cp.vocab_size,
                                          n_shards=4, block=block)
        for shape, method in wtbc_paper.SHAPES.items():
            mode = method.split("-")[1]
            w = jnp.asarray(x["words_" + mode])
            q = arch.make_query_fn(cfg, shape, mesh, ("data",))
            r = q(sh, w, jnp.ones(w.shape, bool))
            for name in {leaves!r}:
                v = getattr(r, name)
                if v is not None:
                    res[f"{{block}}/{{shape}}/{{name}}"] = np.asarray(v)
    np.savez(out, **res)
    print("OK")
""")


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """(the corpus, the queries, the running reference process, its output
    path); the port's builds are made while the reference runs."""
    cp = corpus.make_corpus(**SPEC)
    _, model = distributed.build_sharded(cp.doc_tokens, cp.vocab_size, 4,
                                         block=BLOCKS[0], with_drb=False,
                                         device="cpu")
    words = query_arrays(cp, model, seed=21)
    d = tmp_path_factory.mktemp("deployment")
    np.savez(d / "inputs.npz", words_and=words["and"], words_or=words["or"])
    script = REFERENCE_SCRIPT.format(spec=SPEC, blocks=BLOCKS, leaves=LEAVES)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(d / "inputs.npz"),
         str(d / "ref.npz")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield cp, words, proc, d / "ref.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_builds(deployment):
    cp = deployment[0]
    return {b: distributed.build_sharded(cp.doc_tokens, cp.vocab_size, 4,
                                         block=b, device="cpu")[0]
            for b in BLOCKS}


@pytest.fixture(scope="module")
def reference(deployment):
    _, _, proc, path = deployment
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    return np.load(path)


@pytest.mark.parametrize("shape", list(wtbc_paper.SHAPES))
@pytest.mark.parametrize("block", BLOCKS)
def test_make_query_fn_matches_reference(deployment, port_builds, reference,
                                         block, shape):
    _, words, _, _ = deployment
    method = wtbc_paper.SHAPES[shape]
    cfg = ARCH.config(smoke=True)
    psh = port_builds[block]
    assert psh.idx[0].levels[0].block == block
    w = torch.from_numpy(np.array(words[method.split("-")[1]]))
    q = ARCH.make_query_fn(cfg, shape, ["cpu"] * 4)
    got = q(psh, w, torch.ones(w.shape, dtype=torch.bool))
    want = {n: reference[f"{block}/{shape}/{n}"] for n in LEAVES
            if f"{block}/{shape}/{n}" in reference}
    assert got.docs.shape == (w.shape[0], cfg.k)
    assert_parity(got, want, (method, "tfidf", 1, None))


def test_make_query_fn_checks_the_shards_devices(port_builds):
    psh = port_builds[BLOCKS[0]]
    q = ARCH.make_query_fn(ARCH.config(smoke=True), "queries_dr_or",
                           ["cpu"] * 3)
    w = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="the shards lie on"):
        q(psh, w, torch.ones(w.shape, dtype=torch.bool))


def test_local_mesh_describes_the_cpu_when_asked():
    assert mesh_lib.make_local_mesh("cpu") == mesh_lib.MeshShape(("data",),
                                                                 (1,))
    with pytest.raises(ValueError):
        mesh_lib.make_local_mesh("meta")
