"""The port's recsys towers (``repro_torch.models.recsys``,
``repro_torch.configs.{recsys_common,fm,xdeepfm,sasrec,dlrm_mlperf}``)
against the reference (``repro.models.recsys``, ``repro.configs``) on the
CPU.

Both sides hold the same weights: the reference's ``init_params`` tree is
carried across by ``convert.recsys_params_from_jax``; inputs are numpy
draws from fixed seeds.  The reference's functions are ``jax.jit``-ed.

Tolerances.  float32 outputs within ``REL`` = 1e-5 of the output's scale
(max |reference|): the two sides differ only by the order of float32 sums
inside matmuls and reductions.  SASRec retrieval (``SASREC_REL`` = 1e-6):
the port's K6 forms each dot left to right over d, XLA's matvec adds in
another order; scores within 1e-6 x max|score|, indices equal wherever the
reference's adjacent top-k scores lie further apart than that, and the
returned rows, rescored in float64, a float64 top-k within that tolerance.
Integer leaves are compared bitwise.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import recsys_common as rrc
from repro.models import recsys as R
from repro_torch import convert
from repro_torch.configs import recsys_common as prc
from repro_torch.kernels import ref as kref
from repro_torch.models import recsys as P

torch.set_num_threads(2)
RULES = rbase.make_rules(())          # no mesh on the CPU
REL = 1e-5
SASREC_REL = 1e-6

CONFIGS = ["fm", "xdeepfm", "dlrm_mlperf", "sasrec"]
TABULAR = ["fm", "xdeepfm", "dlrm_mlperf"]

ref_forward = jax.jit(R.forward, static_argnums=(2, 3))
ref_loss = jax.jit(R.loss_fn, static_argnums=(2, 3))
ref_serve = jax.jit(R.serve, static_argnums=(2, 3))


def archs(mod: str):
    return (importlib.import_module(f"repro.configs.{mod}").ARCH,
            importlib.import_module(f"repro_torch.configs.{mod}").ARCH)


def close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, (err, scale)


def pair(mod: str, seed: int = 0):
    """(reference cfg, port cfg, reference params, port params on the CPU)."""
    ra, pa = archs(mod)
    rc, pc = ra.config(smoke=True), pa.config(smoke=True)
    rp = R.init_params(jax.random.PRNGKey(seed), rc)
    pp = convert.recsys_params_from_jax(jax.tree.map(np.asarray, rp), pc,
                                        device="cpu")
    return rc, pc, rp, pp


def batch_np(cfg, B: int, seed: int, *, train: bool = True) -> dict:
    """A numpy batch: ids in range (and a few past the tables, which both
    sides clip), dense features, labels; SASRec's pos / neg with padding 0."""
    rng = np.random.default_rng(seed)
    if cfg.interaction == "self-attn-seq":
        b = {"seq": rng.integers(1, cfg.n_items + 8, (B, cfg.seq_len))}
        if train:
            b["pos"] = rng.integers(0, cfg.n_items, (B, cfg.seq_len))
            b["pos"][:, :2] = 0                       # masked positions
            b["neg"] = rng.integers(1, cfg.n_items, (B, cfg.seq_len))
        return {k: v.astype(np.int32) for k, v in b.items()}
    rows = np.array(cfg.rows())
    b = {"sparse": (rng.random((B, cfg.n_sparse)) * (rows + 16)).astype(np.int32)}
    if cfg.n_dense:
        b["dense"] = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
    if train:
        b["label"] = (rng.random(B) < 0.25).astype(np.int32)
    return b


def to_ref(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_port(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "empty_bags", "before_first"])
def test_embedding_bag_matches_reference(case):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, 40)
    offsets = {"plain": [0, 5, 17, 30],
               "empty_bags": [0, 0, 12, 12, 12, 39],
               "before_first": [3, 10, 20]}[case]
    offsets = np.array(offsets, np.int32)
    n = len(offsets)
    want = R.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                           jnp.asarray(offsets), n)
    got = P.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                          torch.from_numpy(offsets), n)
    close(got, want)


def test_fm_interaction_matches_reference():
    v = np.random.default_rng(2).standard_normal((7, 39, 10)).astype(np.float32)
    close(P.fm_interaction(torch.from_numpy(v)), R.fm_interaction(jnp.asarray(v)))


@pytest.mark.parametrize("f", [2, 6, 27])
def test_dot_interaction_matches_reference(f):
    v = np.random.default_rng(3).standard_normal((5, f, 8)).astype(np.float32)
    got = P.dot_interaction(torch.from_numpy(v))
    assert got.shape == (5, f * (f - 1) // 2)
    close(got, R.dot_interaction(jnp.asarray(v)))
    # the pair order is tril_indices(f, -1)'s, row by row
    iu, ju = np.tril_indices(f, k=-1)
    np.testing.assert_allclose(got.numpy(), (v[:, iu] * v[:, ju]).sum(-1),
                               rtol=1e-5, atol=1e-5)


def test_cin_layers_matches_reference():
    rng = np.random.default_rng(4)
    x0 = rng.standard_normal((6, 7, 10)).astype(np.float32)
    dims = (7, 12, 9)
    ws = [rng.standard_normal((dims[i + 1], dims[i], 7)).astype(np.float32) * 0.1
          for i in range(2)]
    got = P.cin_layers_apply([torch.from_numpy(w) for w in ws],
                             torch.from_numpy(x0))
    assert got.shape == (6, 21)
    close(got, R.cin_layers_apply([jnp.asarray(w) for w in ws], jnp.asarray(x0)))


def test_lookup_clips_ids_per_table():
    tables = [torch.arange(12.0).reshape(6, 2), torch.arange(20.0).reshape(10, 2)]
    ids = torch.tensor([[-3, 99], [5, 9], [2, 10]], dtype=torch.int32)
    v = P._lookup(tables, ids)
    assert v[:, 0, 0].tolist() == [0.0, 10.0, 4.0]
    assert v[:, 1, 0].tolist() == [18.0, 18.0, 18.0]


# ---------------------------------------------------------------------------
# forward, serve, loss, retrieval of the smoke configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", CONFIGS)
def test_forward_matches_reference(mod):
    rc, pc, rp, pp = pair(mod, seed=5)
    b = batch_np(rc, 9, 6, train=False)
    want = ref_forward(rp, to_ref(b), rc, RULES)
    got = P.forward(pp, to_port(b), pc)
    assert got.dtype == torch.float32
    close(got, want)


@pytest.mark.parametrize("mod", CONFIGS)
def test_serve_matches_reference(mod):
    ra, pa = archs(mod)
    rc, pc, rp, pp = pair(mod, seed=7)
    b = batch_np(rc, 16, 8, train=False)
    want = ra.make_step(rc, "serve", RULES)(rp, to_ref(b))
    got = pa.make_step(pc, "serve")(pp, to_port(b))
    close(got, want)
    if pc.interaction == "self-attn-seq":
        assert got.shape == (16, pc.embed_dim)
    else:
        assert got.shape == (16,) and bool(((got >= 0) & (got <= 1)).all())
    close(P.serve(pp, to_port(b), pc), ref_serve(rp, to_ref(b), rc, RULES))


@pytest.mark.parametrize("mod", CONFIGS)
def test_loss_value_matches_reference(mod):
    rc, pc, rp, pp = pair(mod, seed=9)
    b = batch_np(rc, 12, 10)
    wl, wm = ref_loss(rp, to_ref(b), rc, RULES)
    gl, gm = P.loss_fn(pp, to_port(b), pc)
    assert gl.dtype == torch.float32 and gl.dim() == 0
    close(gl, wl)
    close(gm["nll"], wm["nll"])


def test_sasrec_loss_all_masked_is_zero():
    rc, pc, rp, pp = pair("sasrec", seed=11)
    b = batch_np(rc, 3, 12)
    b["pos"][:] = 0
    wl, _ = ref_loss(rp, to_ref(b), rc, RULES)
    gl, _ = P.loss_fn(pp, to_port(b), pc)
    assert float(gl) == float(wl) == 0.0


def retrieval_batch(cfg, n_cand: int, seed: int) -> dict:
    b = batch_np(cfg, 1, seed, train=False)
    hi = cfg.n_items if cfg.interaction == "self-attn-seq" else cfg.rows()[0]
    rng = np.random.default_rng(seed + 1)
    b["candidates"] = rng.permutation(hi)[:n_cand].astype(np.int32)
    return b


@pytest.mark.parametrize("mod", TABULAR)
def test_tabular_retrieval_matches_reference(mod):
    ra, pa = archs(mod)
    rc, pc, rp, pp = pair(mod, seed=13)
    b = retrieval_batch(rc, 700, 14)
    ws, wi = ra.make_step(rc, "retrieval", RULES)(rp, to_ref(b))
    gs, gi = pa.make_step(pc, "retrieval")(pp, to_port(b))
    assert gs.shape == gi.shape == (100,)
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    close(gs, ws)
    ws, wi = np.asarray(ws), np.asarray(wi)
    scale = float(np.abs(ws).max())
    gap = np.diff(ws)                                 # <= 0
    apart = np.ones(100, bool)
    apart[1:] &= -gap > REL * scale
    apart[:-1] &= -gap > REL * scale
    assert np.array_equal(gi.numpy()[apart], wi[apart])
    # all scores too, and the top-k of the port's own scores
    full = P.candidate_scores(pp, to_port(b), pc)
    rb = {"sparse": np.broadcast_to(b["sparse"], (700, rc.n_sparse)).copy()}
    rb["sparse"][:, 0] = b["candidates"]
    if rc.n_dense:
        rb["dense"] = np.broadcast_to(b["dense"], (700, rc.n_dense)).copy()
    close(full, ref_forward(rp, to_ref(rb), rc, RULES))
    s, i = P.top_k(full, 100)
    assert torch.equal(s, gs) and torch.equal(i, gi)


def sasrec_case(seed: int, n_cand: int):
    ra, pa = archs("sasrec")
    rc, pc, rp, pp = pair("sasrec", seed=seed)
    b = retrieval_batch(rc, n_cand, seed + 1)
    return ra, pa, rc, pc, rp, pp, b


@pytest.mark.parametrize("seed", [15, 17])
def test_sasrec_retrieval_matches_reference(seed):
    """Through the plain K6 on the CPU, under the SASRec parity rule."""
    ra, pa, rc, pc, rp, pp, b = sasrec_case(seed, 480)
    ws, wi = ra.make_step(rc, "retrieval", RULES)(rp, to_ref(b))
    gs, gi = pa.make_step(pc, "retrieval")(pp, to_port(b))
    assert gs.dtype == torch.float32 and gi.dtype == torch.int32
    assert gs.shape == gi.shape == (100,)
    ws, wi = np.asarray(ws), np.asarray(wi)
    scale = float(np.abs(ws).max())
    assert float(np.abs(gs.numpy() - ws).max()) <= SASREC_REL * scale
    gap = -np.diff(ws)
    apart = np.ones(100, bool)
    apart[1:] &= gap > SASREC_REL * scale
    apart[:-1] &= gap > SASREC_REL * scale
    assert apart.sum() > 50
    assert np.array_equal(gi.numpy()[apart], wi[apart])
    # the returned rows rescored in float64 are a float64 top-k
    h = P.serve(pp, {"seq": torch.from_numpy(b["seq"])}, pc)[0].double().numpy()
    emb = pp["item_emb"].double().numpy()
    s64 = emb[np.clip(b["candidates"], 0, pc.n_items - 1)] @ h
    want64 = np.sort(s64)[::-1][:100]
    got64 = np.sort(s64[gi.numpy()])[::-1]
    assert float(np.abs(got64 - want64).max()) <= SASREC_REL * scale
    # the port's own scores are the plain K6's, and its order the rule's
    cands = pp["item_emb"][torch.from_numpy(b["candidates"]).long()]
    rs, ri = kref.scored_topk_ref(cands, torch.from_numpy(h.astype(np.float32)),
                                  k=100)
    assert torch.equal(ri, gi)


def test_sasrec_retrieval_ties_take_the_lower_index():
    """Every candidate id appears twice: each score has an equal twin, and
    the earlier position comes first (``lax.top_k``'s order)."""
    ra, pa, rc, pc, rp, pp, b = sasrec_case(19, 150)
    b["candidates"] = np.concatenate([b["candidates"], b["candidates"]])
    gs, gi = P.retrieval_scores(pp, to_port(b), pc, k=100)
    g = gi.numpy()
    assert (np.diff(gs.numpy()) <= 0).all()
    for j in range(0, 100, 2):
        assert gs[j] == gs[j + 1]
        assert g[j + 1] == g[j] + 150 and g[j] < 150
    ws, wi = ra.make_step(rc, "retrieval", RULES)(rp, to_ref(b))
    wi = np.asarray(wi)
    # the reference keeps the same tie rule: within each equal pair, the
    # earlier position first
    for j in range(0, 100, 2):
        assert wi[j + 1] == wi[j] + 150


def test_top_k_order_and_ties():
    s = torch.tensor([1.0, 3.0, 3.0, -1.0, 3.0, 2.0])
    v, i = P.top_k(s, 4)
    assert i.tolist() == [1, 2, 4, 5] and v.tolist() == [3.0, 3.0, 3.0, 2.0]
    assert i.dtype == torch.int32
    wv, wi = jax.lax.top_k(jnp.asarray(s.numpy()), 4)
    assert np.array_equal(np.asarray(wi), i.numpy())
    with pytest.raises(ValueError):
        P.top_k(s, 7)


@pytest.mark.parametrize("mod", TABULAR)
def test_tabular_retrieval_is_chunk_invariant(mod):
    """At one chunk size a candidate's score is the same whatever its
    neighbours, its position and C: shuffled and cut candidate lists give
    bitwise the same scores; chunk sizes agree within the tolerance and on
    the top-k."""
    _, pc, _, pp = pair(mod, seed=21)
    b = to_port(retrieval_batch(pc, 600, 22))
    base = P.candidate_scores(pp, b, pc, chunk=64)
    perm = torch.from_numpy(np.random.default_rng(23).permutation(600))
    shuf = P.candidate_scores(pp, {**b, "candidates": b["candidates"][perm]},
                              pc, chunk=64)
    assert torch.equal(shuf, base[perm])
    cut = P.candidate_scores(pp, {**b, "candidates": b["candidates"][37:101]},
                             pc, chunk=64)
    assert torch.equal(cut, base[37:101])
    one = P.candidate_scores(pp, {**b, "candidates": b["candidates"][5:6]},
                             pc, chunk=64)
    assert torch.equal(one, base[5:6])
    default = P.candidate_scores(pp, b, pc)
    close(default, base.numpy())
    assert torch.equal(P.retrieval_scores(pp, b, pc, k=50)[1],
                       P.top_k(default, 50)[1])


def test_retrieval_chunk_sizes():
    from repro_torch.configs import dlrm_mlperf, fm, xdeepfm
    assert P.retrieval_chunk(xdeepfm.FULL) == 1024
    assert P.retrieval_chunk(fm.FULL) == P.MAX_CHUNK
    assert P.retrieval_chunk(dlrm_mlperf.FULL) == P.MAX_CHUNK
    for cfg in (xdeepfm.FULL, fm.FULL, dlrm_mlperf.FULL):
        n = P.retrieval_chunk(cfg)
        assert n & (n - 1) == 0


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", CONFIGS)
def test_configs_and_cells_match_reference(mod):
    ra, pa = archs(mod)
    assert pa.name == ra.name and pa.family == ra.family == "recsys"
    got = [(c.arch, c.shape, c.kind, c.skip, c.cell_id) for c in pa.cells()]
    want = [(c.arch, c.shape, c.kind, c.skip, c.cell_id) for c in ra.cells()]
    assert got == want
    assert prc.SHAPES == rrc.SHAPES and list(prc.SHAPES) == list(rrc.SHAPES)
    assert prc.N_CANDIDATES == rrc.N_CANDIDATES
    for smoke in (False, True):
        rc, pc = ra.config(smoke), pa.config(smoke)
        for f in dataclasses.fields(rc):
            if f.name != "dtype":
                assert getattr(pc, f.name) == getattr(rc, f.name), f.name
        assert pc.dtype == torch.float32 and jnp.dtype(rc.dtype) == jnp.float32
        assert pc.rows() == rc.rows()
    assert P.CRITEO_1TB_ROWS == R.CRITEO_1TB_ROWS
    mods = {m: importlib.import_module(f"repro_torch.configs.{m}") for m in [mod]}
    refm = importlib.import_module(f"repro.configs.{mod}")
    for name in ("FULL", "SMOKE"):
        a, b = getattr(mods[mod], name), getattr(refm, name)
        assert dataclasses.asdict(a).keys() == dataclasses.asdict(b).keys()


def _sd(t):
    if isinstance(t, torch.Tensor):
        assert t.is_meta
        return (tuple(t.shape), str(t.dtype).split(".")[-1])
    return (tuple(t.shape), jnp.dtype(t.dtype).name)


def _shapes(tree):
    return jax.tree.map(_sd, tree, is_leaf=lambda t: isinstance(
        t, (torch.Tensor, jax.ShapeDtypeStruct)))


@pytest.mark.parametrize("mod", CONFIGS)
def test_abstract_inputs_and_params_match_eval_shape(mod):
    ra, pa = archs(mod)
    for smoke in (False, True):
        rc, pc = ra.config(smoke), pa.config(smoke)
        for shape in rrc.SHAPES:
            assert _shapes(pa.abstract_inputs(pc, shape)) == \
                _shapes(ra.abstract_inputs(rc, shape)), shape
        assert _shapes(pa.abstract_params(pc)) == \
            _shapes(ra.abstract_params(rc))


def test_make_step_kinds():
    _, pa = archs("fm")
    pc = pa.config(smoke=True)
    assert callable(pa.make_step(pc, "train"))    # tests/test_torch_train.py
    with pytest.raises(ValueError):
        pa.make_step(pc, "prefill")
    assert callable(pa.make_step(pc, "serve"))
    assert callable(pa.make_step(pc, "retrieval"))


@pytest.mark.parametrize("mod", CONFIGS)
def test_init_params_defaults_to_the_card_and_draws_from_the_seed(mod):
    _, pa = archs(mod)
    pc = pa.config(smoke=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pa.init_params(pc, seed=0)
    a = pa.init_params(pc, seed=3, device="cpu")
    b = pa.init_params(pc, seed=3, device="cpu")
    c = pa.init_params(pc, seed=4, device="cpu")
    la = jax.tree.leaves(a, is_leaf=lambda t: isinstance(t, torch.Tensor))
    lb = jax.tree.leaves(b, is_leaf=lambda t: isinstance(t, torch.Tensor))
    lc = jax.tree.leaves(c, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert any(not torch.equal(x, y) for x, y in zip(la, lc) if x.numel() > 1)
    first = a["item_emb"] if pc.interaction == "self-attn-seq" \
        else a["tables"][0]
    std = 0.02 if pc.interaction == "self-attn-seq" else pc.embed_dim ** -0.5
    assert abs(float(first.std()) - std) < 0.1 * std


def test_convert_rejects_a_wrong_key_or_shape():
    rc, pc, rp, _ = pair("xdeepfm", seed=25)
    tree = jax.tree.map(np.asarray, rp)
    bad = dict(tree)
    bad["cin"] = [np.zeros((3, 3, 3), np.float32)] + list(tree["cin"][1:])
    with pytest.raises(ValueError, match=r"cin\[0\]: shape"):
        convert.recsys_params_from_jax(bad, pc, device="cpu")
    bad = {k: v for k, v in tree.items() if k != "dnn"}
    with pytest.raises(ValueError, match="keys"):
        convert.recsys_params_from_jax(bad, pc, device="cpu")
    bad = dict(tree, tables=list(tree["tables"][:-1]))
    with pytest.raises(ValueError, match="entries"):
        convert.recsys_params_from_jax(bad, pc, device="cpu")
    _, fm_cfg, _, _ = pair("fm", seed=26)
    with pytest.raises(ValueError):
        convert.recsys_params_from_jax(tree, fm_cfg, device="cpu")
    if not torch.cuda.is_available():          # the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.recsys_params_from_jax(tree, pc)
