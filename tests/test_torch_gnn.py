"""The port's EGNN (``repro_torch.models.gnn``, ``repro_torch.configs.egnn``)
and neighbour sampler (``repro_torch.data.graph_sampler``) against the
reference (``repro.models.gnn``, ``repro.configs.egnn``,
``repro.data.graph_sampler``) on the CPU.

Both sides hold the same weights (``convert.gnn_params_from_jax``); graphs
are numpy draws from fixed seeds.  The reference's functions are
``jax.jit``-ed.

Tolerances.  float32 outputs within ``REL`` = 1e-5 of the output's scale
(max |reference|): the two sides differ by the order of float32 sums inside
matmuls; the segmented sums add in the reference's order (each node's edges
from zero, in edge order), and ``layers.segment_sum`` is held to the
reference's ``segment_sum`` bitwise.  The sampler's output and every integer
leaf are compared bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import egnn as regnn
from repro.data import graph_sampler as RS
from repro.data import pipeline
from repro.models import gnn as RG
from repro_torch import convert
from repro_torch.configs import egnn as pegnn
from repro_torch.data import graph_sampler as PS
from repro_torch.models import gnn as PG
from repro_torch.models import layers as PL

torch.set_num_threads(2)
RULES = rbase.make_rules(())
REL = 1e-5

ref_forward = jax.jit(RG.forward, static_argnums=(2, 3))
ref_loss = jax.jit(RG.loss_fn, static_argnums=(2, 3))


def close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, (err, scale)


def pair(shape: str, seed: int = 0):
    rc = regnn.ARCH.config_for(shape, smoke=True)
    pc = pegnn.ARCH.config_for(shape, smoke=True)
    rp = RG.init_params(jax.random.PRNGKey(seed), rc)
    pp = convert.gnn_params_from_jax(jax.tree.map(np.asarray, rp), pc,
                                     device="cpu")
    return rc, pc, rp, pp


def graph(shape: str, cfg, seed: int) -> dict:
    """numpy graphs: a padded random graph, or a molecule batch whose 8 pad
    nodes belong to no graph (id n_graphs: dropped by the readout)."""
    if shape == "molecule":
        b = pipeline.molecule_batch(seed, n_graphs=cfg.n_graphs, nodes_per=6,
                                    edges_per=10, d_feat=cfg.d_feat,
                                    n_classes=cfg.n_classes)
        b = {k: np.asarray(v) for k, v in b.items()}
        pad = 8
        b["feats"] = np.concatenate([b["feats"], np.zeros((pad, cfg.d_feat),
                                                          np.float32)])
        b["coords"] = np.concatenate([b["coords"], np.ones((pad, 3),
                                                           np.float32)])
        b["graph_ids"] = np.concatenate([b["graph_ids"],
                                         np.full(pad, cfg.n_graphs, np.int32)])
        return b
    b = pipeline.random_graph(seed, 90, 400, cfg.d_feat, cfg.n_classes,
                              pad_nodes=96, pad_edges=448)
    return {k: np.asarray(v) for k, v in b.items()}


def to_port(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def to_ref(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# segment sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["rows", "vector", "out_of_range", "empty"])
def test_segment_sum_matches_reference_bitwise(case):
    rng = np.random.default_rng(1)
    E, n = (0, 5) if case == "empty" else (3000, 97)
    data = rng.standard_normal((E, 16) if case != "vector" else (E,))
    data = (data * np.exp(rng.uniform(-8, 8, data.shape))).astype(np.float32)
    ids = rng.integers(0, n, E)
    if case == "out_of_range":
        ids[::7] = -1
        ids[3::11] = n + 4
    want = jax.jit(lambda d, i: jax.ops.segment_sum(d, i, num_segments=n))(
        jnp.asarray(data), jnp.asarray(ids.astype(np.int32)))
    got = PL.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_segments_reused_over_several_sums():
    """One ``Segments`` serves every sum over the same ids (EGNN's layers):
    its counts include the dropped rows, and each sum equals
    ``segment_sum``'s."""
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(-3, 40, 500))
    seg = PL.segments(ids, 40)
    assert int(seg.lengths[-1]) == int((ids < 0).sum())
    assert int(seg.lengths.sum()) == 500
    for width in ((3,), (), (2, 4)):
        data = torch.from_numpy(rng.standard_normal((500,) + width)
                                .astype(np.float32))
        assert torch.equal(seg.sum(data), PL.segment_sum(data, ids, 40))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_egnn_layer_matches_reference():
    rc, pc, rp, pp = pair("full_graph_sm", seed=3)
    b = graph("full_graph_sm", rc, 4)
    b = {k: np.array(v) for k, v in b.items()}
    rng = np.random.default_rng(5)
    h = rng.standard_normal((96, rc.d_hidden)).astype(np.float32)
    wh, wx = RG.egnn_layer(rp["layers"][0], jnp.asarray(h),
                           jnp.asarray(b["coords"]), jnp.asarray(b["edges"]),
                           96, RULES)
    gh, gx = PG.egnn_layer(pp["layers"][0], torch.from_numpy(h),
                           torch.from_numpy(b["coords"]),
                           torch.from_numpy(b["edges"]), 96)
    close(gh, wh)
    close(gx, wx)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_forward_matches_reference(shape):
    rc, pc, rp, pp = pair(shape, seed=6)
    b = graph(shape, rc, 7)
    want = ref_forward(rp, to_ref(b), rc, RULES)
    got = PG.forward(pp, to_port(b), pc)
    assert got.dtype == torch.float32
    n = rc.n_graphs if rc.graph_readout else 96
    assert got.shape == (n, rc.n_classes)
    close(got, want)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
@pytest.mark.parametrize("masked", [True, False])
def test_loss_value_matches_reference(shape, masked):
    rc, pc, rp, pp = pair(shape, seed=8)
    b = graph(shape, rc, 9)
    if not masked:
        del b["label_mask"]
    wl, wm = ref_loss(rp, to_ref(b), rc, RULES)
    gl, gm = PG.loss_fn(pp, to_port(b), pc)
    assert gl.dim() == 0 and gl.dtype == torch.float32
    close(gl, wl)
    close(gm["nll"], wm["nll"])


def test_minibatch_sample_forward_matches_reference():
    rc, pc, rp, pp = pair("minibatch_lg", seed=10)
    g = RS.CSRGraph.random(n_nodes=400, avg_deg=6, d_feat=rc.d_feat,
                           n_classes=rc.n_classes, seed=11)
    b = RS.sample_subgraph(g, np.arange(0, 400, 25), fanout=(4, 3),
                           pad_nodes=384, pad_edges=320, seed=12)
    close(PG.forward(pp, to_port(b), pc), ref_forward(rp, to_ref(b), rc, RULES))
    wl, _ = ref_loss(rp, to_ref(b), rc, RULES)
    gl, _ = PG.loss_fn(pp, to_port(b), pc)
    close(gl, wl)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_equivariance(shape):
    """E(n): a rotation and a translation of the coordinates leave the
    logits unchanged (the reference's own test's tolerance, 2e-4)."""
    _, pc, _, pp = pair(shape, seed=13)
    b = to_port(graph(shape, pc, 14))
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((3, 3)))
    moved = dict(b, coords=b["coords"] @ torch.from_numpy(q.astype(np.float32))
                 + 5.0)
    np.testing.assert_allclose(PG.forward(pp, moved, pc).numpy(),
                               PG.forward(pp, b, pc).numpy(),
                               rtol=2e-4, atol=2e-4)


def test_forward_does_not_depend_on_edge_order_within_a_node():
    """The port sorts edges by destination stably, so only the relative
    order of a node's own edges matters: moving other nodes' edges around
    changes nothing, bitwise."""
    _, pc, _, pp = pair("full_graph_sm", seed=15)
    b = to_port(graph("full_graph_sm", pc, 16))
    dst = b["edges"][:, 1]
    by_dst = torch.sort(dst, stable=True).indices
    got = PG.forward(pp, b, pc)
    assert torch.equal(PG.forward(pp, dict(b, edges=b["edges"][by_dst]), pc),
                       got)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,deg,seeds,fanout,seed", [
    (500, 8, np.arange(0, 500, 17), (15, 10), 0),
    (300, 2, np.array([5, 5, 7, 299, 0]), (3, 2, 2), 1),      # repeats, 3 hops
    (1000, 30, np.arange(64) * 13, (15, 10), 2),
    (50, 0, np.arange(10), (5,), 3)])                          # no edges
def test_sample_subgraph_bitwise(n, deg, seeds, fanout, seed):
    rg = RS.CSRGraph.random(n, deg, d_feat=5, n_classes=4, seed=seed)
    pg = PS.CSRGraph.random(n, deg, d_feat=5, n_classes=4, seed=seed)
    for f in dataclasses.fields(rg):
        a, b = getattr(rg, f.name), getattr(pg, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert pg.n_nodes == rg.n_nodes == n
    pad_n, pad_e = 4096, 8192
    want = RS.sample_subgraph(rg, seeds, fanout, pad_n, pad_e, seed=seed + 7)
    got = PS.sample_subgraph(pg, seeds, fanout, pad_n, pad_e, seed=seed + 7)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_sample_subgraph_padding_and_mask():
    g = PS.CSRGraph.random(2000, 12, d_feat=4, n_classes=3, seed=4)
    seeds = np.arange(0, 2000, 40)
    s = PS.sample_subgraph(g, seeds, (15, 10), 4096, 8192, seed=5)
    e = s["edges"]
    real = ~((e[:, 0] == 4095) & (e[:, 1] == 4095))
    assert real.sum() > 0 and (e[~real] == 4095).all()
    assert int(s["label_mask"].sum()) == len(seeds)
    with pytest.raises(AssertionError):
        PS.sample_subgraph(g, seeds, (15, 10), 64, 64, seed=5)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_cells_and_configs_match_reference():
    ra, pa = regnn.ARCH, pegnn.ARCH
    assert (pa.name, pa.family) == (ra.name, ra.family) == ("egnn", "gnn")
    got = [(c.arch, c.shape, c.kind, c.skip, c.cell_id) for c in pa.cells()]
    want = [(c.arch, c.shape, c.kind, c.skip, c.cell_id) for c in ra.cells()]
    assert got == want and len(got) == 4
    assert pegnn.SHAPES == regnn.SHAPES and pegnn.PAD == regnn.PAD
    for shape in regnn.SHAPES:
        for smoke in (False, True):
            rc, pc = ra.config_for(shape, smoke), pa.config_for(shape, smoke)
            for f in dataclasses.fields(rc):
                if f.name != "dtype":
                    assert getattr(pc, f.name) == getattr(rc, f.name), f.name
            assert pc.dtype == torch.float32
    assert pa.config(True) == pa.config_for("full_graph_sm", True)


def _sd(t):
    if isinstance(t, torch.Tensor):
        assert t.is_meta
        return (tuple(t.shape), str(t.dtype).split(".")[-1])
    return (tuple(t.shape), jnp.dtype(t.dtype).name)


def _shapes(tree):
    return jax.tree.map(_sd, tree, is_leaf=lambda t: isinstance(
        t, (torch.Tensor, jax.ShapeDtypeStruct)))


@pytest.mark.parametrize("shape", list(regnn.SHAPES))
def test_abstract_inputs_and_params_match_eval_shape(shape):
    ra, pa = regnn.ARCH, pegnn.ARCH
    for smoke in (False, True):
        rc, pc = ra.config_for(shape, smoke), pa.config_for(shape, smoke)
        assert _shapes(pa.abstract_inputs(pc, shape)) == \
            _shapes(ra.abstract_inputs(rc, shape))
        assert _shapes(pa.abstract_params(pc)) == \
            _shapes(ra.abstract_params(rc))


def test_make_step_and_init_defaults():
    pa = pegnn.ARCH
    pc = pa.config(smoke=True)
    assert callable(pa.make_step(pc, "train"))    # tests/test_torch_train.py
    with pytest.raises(ValueError):
        pa.make_step(pc, "serve")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pa.init_params(pc, seed=0)
    a = pa.init_params(pc, seed=1, device="cpu")
    b = pa.init_params(pc, seed=1, device="cpu")
    assert torch.equal(a["embed_in"], b["embed_in"])
    assert abs(float(a["embed_in"].std()) - pc.d_feat ** -0.5) < 0.2 * pc.d_feat ** -0.5


def test_convert_rejects_a_wrong_key_or_shape():
    rc, pc, rp, _ = pair("molecule", seed=17)
    tree = jax.tree.map(np.asarray, rp)
    bad = dict(tree, head=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="head: shape"):
        convert.gnn_params_from_jax(bad, pc, device="cpu")
    bad = dict(tree, layers=[dict(tree["layers"][0], phi_q=[])]
               + list(tree["layers"][1:]))
    with pytest.raises(ValueError, match="keys"):
        convert.gnn_params_from_jax(bad, pc, device="cpu")
    bad = dict(tree, layers=list(tree["layers"][:1]))
    with pytest.raises(ValueError, match="entries"):
        convert.gnn_params_from_jax(bad, pc, device="cpu")
    full = pegnn.ARCH.config_for("molecule")
    with pytest.raises(ValueError, match="shape"):
        convert.gnn_params_from_jax(tree, full, device="cpu")


def test_r10_padding_edges_land_on_a_real_node_when_a_sample_fills_its_pad():
    """R10, a fault of the reference kept on purpose: ``sample_subgraph``
    pads the edge list with (pad_nodes - 1, pad_nodes - 1).  When a sample
    holds exactly ``pad_nodes`` nodes that node is a real one, and every
    padding edge adds a self-message to it.  The port's sampler does the
    same, bitwise; the cells' pads (172,032 for at most 169,984 nodes) never
    reach it."""
    rg = RS.CSRGraph.random(300, 6, d_feat=8, n_classes=3, seed=20)
    pg = PS.CSRGraph.random(300, 6, d_feat=8, n_classes=3, seed=20)
    seeds = np.arange(0, 300, 30)
    probe = PS.sample_subgraph(pg, seeds, (4, 3), 4096, 4096, seed=21)
    e = int((probe["edges"][:, 0] != 4095).sum())
    n = int(probe["edges"][:e].max()) + 1
    want = RS.sample_subgraph(rg, seeds, (4, 3), n, e + 40, seed=21)
    got = PS.sample_subgraph(pg, seeds, (4, 3), n, e + 40, seed=21)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert (got["edges"][e:] == n - 1).all()           # 40 padding edges ...
    assert got["feats"][n - 1].any()                    # ... on a real node
    pc = pegnn.ARCH.config_for("minibatch_lg", smoke=True)      # d_feat 8
    pp = PG.init_params(pc, seed=23, device="cpu")
    b = to_port(got)
    clean = PG.forward(pp, dict(b, edges=b["edges"][:e]), pc)
    padded = PG.forward(pp, b, pc)
    assert not torch.allclose(padded[n - 1], clean[n - 1])
