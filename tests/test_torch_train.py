"""The port's training path (``ArchDef.train_wrapper``, ``make_step(cfg,
"train")``, the models' gradients) against the reference's on the CPU: every
smoke config of the ten assigned architectures (five LMs at their smoke
dtype, float32; FM, xDeepFM, DLRM, SASRec; EGNN on a node-level and a
graph-level batch).

Both sides hold the same weights (``convert.*_params_from_jax``) and, for
the train steps, the same optimizer state (``convert.adamw_state_from_jax``);
the batches are numpy draws from fixed seeds.

Tolerances.
* ``GRAD_REL`` (1e-4 of each leaf's largest |gradient|): the two sides add
  float32 products in different orders inside matmuls and reductions (a few
  ulps, ~1e-7 relative), grown through a backward pass of up to 8 layers;
  the largest difference measured here is ~3e-6.
* Losses and metrics within ``VAL_REL`` (1e-5 relative), the learning rate
  within ``test_torch_optim.SCHEDULE`` (1 ulp of ``cos``, amplified).
* Parameters after the steps: AdamW's first steps move every element by
  about ``lr x sign(g)``, so an element whose gradient lies within float32
  noise of 0 may move either way on the two sides, and one whose gradient
  is small against its leaf's largest carries that leaf's gradient noise
  into ``m / sqrt(v)``.  So 99.9% of all the parameters' elements are held
  within 1e-3 x lr of the reference (plus 1e-6 of the value; measured after
  three steps: 99.9% within 1.8e-4 x lr, the largest 0.03 x lr), and every
  element within AdamW's bound on a step's size, 2 x lr x (1 +
  weight_decay x |p|) per step.  The optimizer alone is held much tighter
  in ``test_torch_optim``.
* remat on against off: bitwise (the CPU recomputes each layer exactly).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import egnn as regnn
from repro.data import pipeline as rpipe
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import base as pbase
from repro_torch.configs import egnn as pegnn
from repro_torch.models import gnn as PG
from repro_torch.models import moe as PM
from repro_torch.models import recsys as PR
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA

torch.set_num_threads(2)
RULES = rbase.make_rules(())          # no mesh on the CPU
GRAD_REL = 1e-4
VAL_REL = 1e-5
SCHEDULE = dict(rtol=5e-7, atol=0)

LMS = ["qwen3_1p7b", "granite_3_8b", "gemma2_9b", "qwen3_moe_235b_a22b",
       "llama4_scout_17b_a16e"]
RECSYS = ["fm", "xdeepfm", "dlrm_mlperf", "sasrec"]
GNN = ["full_graph_sm", "molecule"]
CASES = [("lm", m) for m in LMS] + [("recsys", m) for m in RECSYS] + \
    [("gnn", s) for s in GNN]
IDS = [m for _, m in CASES]

ref_grad = {
    "lm": jax.jit(jax.value_and_grad(RT.loss_fn, has_aux=True),
                  static_argnums=(2, 3)),
    "recsys": jax.jit(jax.value_and_grad(RR.loss_fn, has_aux=True),
                      static_argnums=(2, 3)),
    "gnn": jax.jit(jax.value_and_grad(RG.loss_fn, has_aux=True),
                   static_argnums=(2, 3)),
}
port_loss = {"lm": PT.loss_fn, "recsys": PR.loss_fn, "gnn": PG.loss_fn}


@dataclasses.dataclass
class Case:
    fam: str
    ra: object      # reference ArchDef
    pa: object      # port ArchDef
    rc: object
    pc: object
    rp: dict
    pp: dict

    def batch(self, seed: int) -> dict:
        return batch_np(self.fam, self.rc, seed)


def make_case(fam: str, name: str, seed: int = 0, rc=None, pc=None) -> Case:
    if fam == "gnn":
        ra, pa = regnn.ARCH, pegnn.ARCH
        rc = rc or ra.config_for(name, smoke=True)
        pc = pc or pa.config_for(name, smoke=True)
        rp = RG.init_params(jax.random.PRNGKey(seed), rc)
        pp = convert.gnn_params_from_jax(jax.tree.map(np.asarray, rp), pc,
                                         device="cpu")
        return Case(fam, ra, pa, rc, pc, rp, pp)
    ra = importlib.import_module(f"repro.configs.{name}").ARCH
    pa = importlib.import_module(f"repro_torch.configs.{name}").ARCH
    rc = rc or ra.config(smoke=True)
    pc = pc or pa.config(smoke=True)
    if fam == "lm":
        rp = RT.init_params(jax.random.PRNGKey(seed), rc)
        pp = convert.lm_params_from_jax(jax.tree.map(np.asarray, rp), pc,
                                        device="cpu")
    else:
        rp = RR.init_params(jax.random.PRNGKey(seed), rc)
        pp = convert.recsys_params_from_jax(jax.tree.map(np.asarray, rp), pc,
                                            device="cpu")
    return Case(fam, ra, pa, rc, pc, rp, pp)


def batch_np(fam: str, cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    if fam == "lm":
        toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if fam == "gnn":
        if cfg.graph_readout:
            b = rpipe.molecule_batch(seed, n_graphs=cfg.n_graphs, nodes_per=5,
                                     edges_per=9, d_feat=cfg.d_feat,
                                     n_classes=cfg.n_classes)
        else:
            b = rpipe.random_graph(seed, 90, 400, cfg.d_feat, cfg.n_classes,
                                   pad_nodes=96, pad_edges=448)
        return {k: np.asarray(v) for k, v in b.items()}
    B = 12
    if cfg.interaction == "self-attn-seq":
        b = {"seq": rng.integers(1, cfg.n_items, (B, cfg.seq_len)),
             "pos": rng.integers(0, cfg.n_items, (B, cfg.seq_len)),
             "neg": rng.integers(1, cfg.n_items, (B, cfg.seq_len))}
        b["pos"][:, :2] = 0                       # masked positions
        return {k: v.astype(np.int32) for k, v in b.items()}
    rows = np.array(cfg.rows())
    # a few ids repeat within a column, so embedding rows sum several grads
    b = {"sparse": (rng.random((B, cfg.n_sparse)) * np.minimum(rows, 9))
         .astype(np.int32),
         "label": (rng.random(B) < 0.25).astype(np.int32)}
    if cfg.n_dense:
        b["dense"] = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
    return b


def to_ref(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_port(b: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def named(tree_ref, tree_port):
    """Leaf pairs matched by name: the reference's ``keystr`` names equal
    the port's flattener's."""
    r = [(jax.tree_util.keystr(p), np.asarray(l)) for p, l in
         jax.tree_util.tree_flatten_with_path(tree_ref)[0]]
    p = ckpt.flatten_with_names(tree_port)
    assert [n for n, _ in r] == [n for n, _ in p]
    return [(n, a, b.detach().numpy()) for (n, a), (_, b) in zip(r, p)]


def grads_close(tree_ref, tree_port, rel=GRAD_REL):
    worst = 0.0
    for name, want, got in named(tree_ref, tree_port):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.astype(np.float64) - want).max()) / scale
        assert err <= rel, (name, err, scale)
        worst = max(worst, err)
    return worst


def val_close(got, want, rel=VAL_REL):
    """Within ``rel`` of the value, or of 1 for a value below 1 (an
    auxiliary loss may be 0)."""
    g, w = float(got), float(want)
    assert abs(g - w) <= rel * max(abs(w), 1.0), (g, w)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam,name", CASES, ids=IDS)
def test_gradients_match_reference(fam, name):
    c = make_case(fam, name, seed=1)
    b = c.batch(2)
    (wl, wm), wg = ref_grad[fam](c.rp, to_ref(b), c.rc, RULES)
    gg, gl, gm = pbase.gradients(port_loss[fam], c.pp, to_port(b), c.pc)
    val_close(gl, wl)
    assert set(gm) == set(wm)
    for k in wm:
        val_close(gm[k], wm[k])
    grads_close(wg, gg)
    # the caller's parameters are left as they were: no grad, no graph
    assert all(not t.requires_grad and t.grad is None
               for t in ckpt.tree_leaves(c.pp))


def _moe_variant(name: str, variant: str):
    """A MoE smoke config with copies past capacity ("drop": capacity
    factor 0.5 keeps 8 slots an expert for 32 tokens x K copies) or with
    every router logit 0 ("tie": every probability 1/E, so top-k takes the
    lowest experts, and they overflow)."""
    c = make_case("lm", name, seed=3)
    if variant == "drop":
        rc = dataclasses.replace(c.rc, moe=dataclasses.replace(
            c.rc.moe, capacity_factor=0.5))
        pc = dataclasses.replace(c.pc, moe=dataclasses.replace(
            c.pc.moe, capacity_factor=0.5))
        return make_case("lm", name, seed=3, rc=rc, pc=pc)
    for i, blk in enumerate(c.rp["blocks"]):
        blk["moe"]["router"] = jnp.zeros_like(blk["moe"]["router"])
        c.pp["blocks"][i]["moe"]["router"].zero_()
    return c


@pytest.mark.parametrize("variant", ["drop", "tie"])
@pytest.mark.parametrize("name", ["qwen3_moe_235b_a22b",
                                  "llama4_scout_17b_a16e"])
def test_moe_gradients_with_dropped_copies_and_ties(name, variant):
    """The backward of the dense dispatch: the reference's four custom-VJP
    ops only pin shardings on their cotangents, so their gradient is the
    plain gather / scatter gradient that autograd gives the port's ops."""
    c = _moe_variant(name, variant)
    b = c.batch(4)
    T = b["tokens"].size
    C = PM.capacity(T, c.pc.moe)
    x = torch.randn(T, c.pc.d_model, generator=torch.Generator().manual_seed(0))
    if variant == "tie":
        probs = torch.full((T, c.pc.moe.n_experts), 1 / c.pc.moe.n_experts)
        assert C < T          # every token's first pick is expert 0: drops
    else:
        _, eidx, probs, _ = PM._router(
            {"router": c.pp["blocks"][0]["moe"]["router"][0]}, x, c.pc.moe)
        load = torch.bincount(eidx.reshape(-1), minlength=c.pc.moe.n_experts)
        assert int(load.max()) > C, (load, C)
    (wl, _), wg = ref_grad["lm"](c.rp, to_ref(b), c.rc, RULES)
    gg, gl, _ = pbase.gradients(PT.loss_fn, c.pp, to_port(b), c.pc)
    val_close(gl, wl)
    grads_close(wg, gg)


def test_moe_apply_gradient_matches_reference_on_the_layer():
    """One MoE layer alone, a loss weighting every output element: the
    gradient with respect to the tokens, the router and each expert's
    weights, with copies dropped past capacity (the reference's
    ``_moe_dense_dispatch`` under ``jax.grad``)."""
    from repro.models import moe as RM
    rc = RM.MoEConfig(n_experts=4, top_k=2, d_ff=24, n_shared=1,
                      capacity_factor=0.5)
    pc = PM.MoEConfig(**dataclasses.asdict(rc))
    rp = RM.init_moe(jax.random.PRNGKey(5), 32, rc)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((40, 32)).astype(np.float32)
    w = rng.standard_normal((40, 32)).astype(np.float32)

    def ref_loss(p, x):
        out, aux = RM.moe_apply(p, x, rc, RULES)
        return jnp.sum(out * w) + 0.5 * aux

    wgp, wgx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(pp)]
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = PM.moe_apply(pp, xt, pc)
    loss = (out * torch.from_numpy(w)).sum() + 0.5 * aux
    grads = torch.autograd.grad(loss, leaves + [xt])
    for want, got in zip(jax.tree.leaves(wgp) + [wgx], grads):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= GRAD_REL * scale


@pytest.mark.parametrize("name", ["qwen3_1p7b", "gemma2_9b",
                                  "llama4_scout_17b_a16e"])
def test_remat_gives_the_same_gradients(name):
    """``cfg.remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``): the gradients equal those without it,
    bitwise, and the forward values too."""
    c = make_case("lm", name, seed=7)
    on = dataclasses.replace(c.pc, remat=True)
    off = dataclasses.replace(c.pc, remat=False)
    b = to_port(c.batch(8))
    g_on, l_on, m_on = pbase.gradients(PT.loss_fn, c.pp, b, on)
    g_off, l_off, m_off = pbase.gradients(PT.loss_fn, c.pp, b, off)
    assert torch.equal(l_on, l_off)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_on)
    for (n, a), (_, b_) in zip(ckpt.flatten_with_names(g_on),
                               ckpt.flatten_with_names(g_off)):
        assert torch.equal(a, b_), n


def test_remat_keeps_only_the_layer_inputs():
    """With remat on, autograd saves no activation inside a layer: the
    graph holds fewer saved tensors than without it."""
    c = make_case("lm", "qwen3_1p7b", seed=9)
    b = to_port(c.batch(10))
    counts = {}
    for remat in (True, False):
        cfg = dataclasses.replace(c.pc, remat=remat)
        n = [0]

        def pack(t):
            n[0] += 1
            return t
        params = jax.tree.map(lambda t: t.detach().requires_grad_(True), c.pp)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            PT.loss_fn(params, b, cfg)
        counts[remat] = n[0]
    assert counts[True] < counts[False] / 2, counts


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=50)


def _params_close(ref_before, ref_after, port_after, lrs, wd: float):
    tight = 1e-3 * max(lrs)
    bound = 2 * sum(lrs)
    n_ok = n_all = 0
    for (n, b0, pa_), (_, b1, _) in zip(named(ref_before, port_after),
                                        named(ref_after, port_after)):
        err = np.abs(pa_.astype(np.float64) - b1)
        n_ok += int((err <= tight + 1e-6 * np.abs(b1)).sum())
        n_all += err.size
        assert bool((err <= bound * (1 + wd * np.abs(b0).max())).all()), n
    assert n_ok >= 0.999 * n_all, (n_ok, n_all)


@pytest.mark.parametrize("fam,name", CASES, ids=IDS)
def test_three_train_steps_match_reference(fam, name, monkeypatch):
    """``make_step(cfg, "train")`` three times on both sides from the same
    parameters and optimizer state (carried across by
    ``convert.adamw_state_from_jax``) and batches: loss, metrics,
    grad_norm and lr each step, the parameters after each step and the
    state's step counter."""
    c = make_case(fam, name, seed=11)
    rcfg, pcfg = RA.AdamWConfig(**OCFG), PA.AdamWConfig(**OCFG)
    monkeypatch.setattr(c.ra, "optimizer_cfg", lambda: rcfg)
    monkeypatch.setattr(c.pa, "optimizer_cfg", lambda: pcfg)
    rstep = jax.jit(c.ra.make_step(c.rc, "train", RULES))
    pstep = c.pa.make_step(c.pc, "train")
    rp, ropt = c.rp, RA.init_state(c.rp)
    pp = c.pp
    popt = convert.adamw_state_from_jax(jax.tree.map(np.asarray, ropt),
                                        device="cpu")
    lrs = []
    for k in range(3):
        b = c.batch(20 + k)
        before = jax.tree.map(np.asarray, rp)
        rp, ropt, rm = rstep(rp, ropt, to_ref(b))
        pp, popt, pm = pstep(pp, popt, to_port(b))
        assert set(pm) == set(rm)
        val_close(pm["loss"], rm["loss"])
        val_close(pm["grad_norm"], rm["grad_norm"], rel=1e-4)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   **SCHEDULE)
        assert int(popt.step) == int(ropt.step) == k + 1
        lrs.append(float(rm["lr"]))
        _params_close(before, rp, pp, lrs, pcfg.weight_decay)


def test_train_step_from_a_reference_optimizer_state():
    """A reference state after two steps, carried across, gives the port's
    third step the reference's third step (``adamw_state_from_jax`` keeps
    the moments and the step bitwise)."""
    c = make_case("recsys", "fm", seed=13)
    rstep = jax.jit(c.ra.make_step(c.rc, "train", RULES))
    rp, ropt = c.rp, RA.init_state(c.rp)
    for k in range(2):
        rp, ropt, _ = rstep(rp, ropt, to_ref(c.batch(30 + k)))
    popt = convert.adamw_state_from_jax(jax.tree.map(np.asarray, ropt),
                                        device="cpu")
    assert int(popt.step) == 2
    for n, want, got in named(ropt.m, popt.m):
        np.testing.assert_array_equal(got, want, err_msg=n)
    pp = convert.recsys_params_from_jax(jax.tree.map(np.asarray, rp), c.pc,
                                        device="cpu")
    before = jax.tree.map(np.asarray, rp)
    rp, ropt, rm = rstep(rp, ropt, to_ref(c.batch(32)))
    pp, popt, pm = c.pa.make_step(c.pc, "train")(pp, popt,
                                                 to_port(c.batch(32)))
    val_close(pm["loss"], rm["loss"])
    _params_close(before, rp, pp, [float(rm["lr"])],
                  PA.AdamWConfig().weight_decay)
    with pytest.raises(ValueError, match="step"):
        convert.adamw_state_from_jax(ropt._replace(step=np.zeros(2)),
                                     device="cpu")


def test_train_step_metrics_and_in_place_update():
    """The train step returns the loss's metrics, loss, grad_norm and lr as
    0-d tensors; it updates the parameters and moments in place and
    leaves them without autograd state."""
    c = make_case("gnn", "molecule", seed=15)
    step = c.pa.make_step(c.pc, "train")
    opt = PA.init_state(c.pp)
    leaf = c.pp["head"]
    before = leaf.clone()
    params, opt2, m = step(c.pp, opt, to_port(c.batch(16)))
    assert set(m) == {"nll", "loss", "grad_norm", "lr"}
    assert all(v.dim() == 0 and not v.requires_grad for v in m.values())
    assert params["head"] is leaf and not torch.equal(leaf, before)
    assert not leaf.requires_grad and leaf.grad is None
    assert opt2.m is opt.m and int(opt2.step) == 1
    assert float(m["lr"]) == float(PA.schedule(PA.AdamWConfig(), 1))
