"""The port's expert-parallel MoE (``repro_torch.models.moe.moe_apply_ep``
over a device list) against the reference's ``_moe_ep_shardmap`` on 4
simulated XLA devices (CPU).

* ``moe_apply`` under the meshes (data, model) = (1, 4), (2, 2), (4, 1),
  (1, 2) and (pod, data, model) = (2, 1, 2), top-k 1 and 2, with and
  without a shared expert (every pairing on (1, 4) and (2, 2); top-1 with
  it and top-2 without it on the others): output, aux and the gradient of every MoE leaf
  against the reference's under ``jax.set_mesh``; and a batch whose busiest
  expert overflows the dense capacity but not EP's doubled one, where EP
  must differ from the dense dispatch.
* The choice between the paths: where the tokens do not split into the
  blocks, the experts do not split into the shards, or the mesh has no
  ``model`` axis, the reference's output under the mesh is bitwise its
  dense dispatch's and the port's bitwise its own dense dispatch's.
* ``forward``, ``prefill`` and three ``decode_step``s of the llama4-scout
  and qwen3-moe smoke configs under (1, 4) and (2, 2), weights carried over
  by ``convert.lm_params_from_jax`` (the reference's prefill is its
  ``forward`` with the caches collected); qwen3-moe's decode at B = 3
  under (2, 2) takes the dense dispatch on both sides (3 tokens do not
  split into 2 blocks).
* The port alone: placed experts (``place_experts``) equal views bitwise,
  and one train step of both smoke configs under (1, 4) on placed experts
  equals the step on the unplaced layers (the router is one leaf, updated
  once with the gradient of every shard's copies).  AdamW's global norm
  sums the placed slices' squares leaf by leaf, so the two steps agree
  within ``rtol = 1e-5, atol = 1e-7`` rather than bitwise.

The reference runs in ONE subprocess started with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` by the first test,
while the tests of the port alone run (the device count locks when JAX starts; ``with mesh:`` breaks
``jax.grad`` through ``shard_map``, ``jax.set_mesh`` does not).

Tolerances: float32 on both sides; the port sums the shards' partials in
shard order while the reference's ``psum`` adds in its own order, and the
matmuls' float32 sums differ in order: output and aux within
``rtol = atol = 1e-5``, gradients within 1e-4 of each leaf's largest
entry plus 1e-5 (under top-1 the renormalized gate is 1, so the router's
gradient is a difference of terms a hundred times its size), LM logits and caches within ``rtol = atol = 1e-4`` (as
``test_torch_models.py``).
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

from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as PA
from test_torch_models import archs

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
D, F_, T = 32, 16, 64
MESHES = {"d1m4": (("data", "model"), (1, 4)),
          "d2m2": (("data", "model"), (2, 2)),
          "d4m1": (("data", "model"), (4, 1)),
          "d1m2": (("data", "model"), (1, 2)),
          "p2d1m2": (("pod", "data", "model"), (2, 1, 2))}
# (mesh, top_k, n_shared, tokens, experts, batch kind): top-k 1 and 2 with
# and without the shared expert on (1, 4) and (2, 2), two of those on the
# other meshes, and the overflow batch
EP_CASES = [(m, k, s, T, 8, "random") for m in ("d1m4", "d2m2")
            for k in (1, 2) for s in (0, 1)] + \
    [(m, k, s, T, 8, "random") for m in ("d4m1", "d1m2", "p2d1m2")
     for k, s in ((1, 1), (2, 0))] + [("d1m4", 2, 0, T, 8, "overflow")]
DENSE_CASES = {"tokens_split_unevenly": ("d2m2", 2, 1, 63, 8),
               "experts_split_unevenly": ("d1m4", 2, 0, T, 6),
               "no_model_axis": ("data4", 2, 1, T, 8)}
LM_MODS = ("qwen3_moe_235b_a22b", "llama4_scout_17b_a16e")
# (config, mesh, decode batch): forward / prefill of (2, 16) tokens, three
# decode steps at the batch
LM_CASES = [(mod, m, 2) for mod in LM_MODS for m in ("d1m4", "d2m2")] + \
    [(LM_MODS[0], "d2m2", 3)]
LM_S, LM_STEPS = 16, 3
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL, GRAD_ABS = 1e-4, 1e-5
LM_TOL = dict(rtol=1e-4, atol=1e-4)


def ep_id(case) -> str:
    m, k, s, _, _, kind = case
    return f"{m}-top{k}-shared{s}-{kind}"


def lm_id(case) -> str:
    return f"{case[0].split('_')[0]}-{case[1]}-B{case[2]}"


def mesh_of(name: str) -> MeshShape:
    if name == "data4":
        return MeshShape(("data",), (4,))
    return MeshShape(*MESHES[name])


def moe_inputs(i: int, K: int, n_shared: int, n_tokens: int, E: int,
               kind: str) -> dict:
    """The reference's layer (``init_moe`` from seed ``i``) and a batch as
    numpy; ``overflow``: 30 of the 64 tokens lean to expert 0."""
    rc = RM.MoEConfig(n_experts=E, top_k=K, d_ff=F_, n_shared=n_shared)
    p = jax.tree.map(np.asarray, RM.init_moe(jax.random.PRNGKey(i), D, rc))
    rng = np.random.default_rng(100 + i)
    x = rng.standard_normal((n_tokens, D)).astype(np.float32)
    if kind == "overflow":
        p["router"] = (rng.standard_normal((D, E)) * 0.1).astype(np.float32)
        p["router"][0, 0] = 5.0
        x[:, 0] = -1.0
        x[:30, 0] = 5.0
    cot = rng.standard_normal((n_tokens, D)).astype(np.float32)
    return {"cfg": rc, "params": p, "x": x, "cot": cot}


def flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    sys.path.insert(0, {tests!r})
    from repro.configs import base as rbase
    from repro.models import moe as RM
    from repro.models import transformer as RT
    from test_torch_moe_ep import (EP_CASES, DENSE_CASES, LM_CASES, LM_S,
                                   LM_STEPS, MESHES, flat, moe_inputs,
                                   lm_inputs)

    def mesh_of(name):
        axes, shape = (("data",), (4,)) if name == "data4" else MESHES[name]
        n = int(np.prod(shape))
        return jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
                                 axes)

    out = {{}}
    # no sharding constraints: they move no value, and some of the smoke
    # widths do not split over the meshes' axes (the EP decision reads the
    # mesh, not the rules)
    rules = rbase.make_rules(())

    def moe_case(tag, i, mesh, K, ns, n, E, kind):
        case = moe_inputs(i, K, ns, n, E, kind)
        rc, x, cot = case["cfg"], jnp.asarray(case["x"]), case["cot"]
        p = jax.tree.map(jnp.asarray, case["params"])
        def f(p, x):
            o, a = RM.moe_apply(p, x, rc, rules)
            return (o * cot).sum() + a, (o, a)
        with jax.set_mesh(mesh):
            (_, (o, a)), g = jax.jit(jax.value_and_grad(f, has_aux=True))(
                p, x)
        dense, _ = jax.jit(lambda p, x: RM._moe_dense_dispatch(
            p, x, rc, rules))(p, x)
        out[tag + "/out"] = np.asarray(o)
        out[tag + "/aux"] = np.asarray(a)
        out[tag + "/dense"] = np.asarray(dense)
        for k, v in flat(g).items():
            out[tag + "/grad/" + k] = np.asarray(v)

    for i, (m, K, ns, n, E, kind) in enumerate(EP_CASES):
        moe_case(f"ep{{i}}", i, mesh_of(m), K, ns, n, E, kind)
    for name, (m, K, ns, n, E) in DENSE_CASES.items():
        moe_case(name, 50, mesh_of(m), K, ns, n, E, "random")

    fwd = jax.jit(RT.forward, static_argnums=(2, 3, 4))
    dec = jax.jit(RT.decode_step, static_argnums=(4, 5))
    for i, (mod, m, B) in enumerate(LM_CASES):
        mesh = mesh_of(m)
        rc, rp, toks, steps = lm_inputs(mod, B)
        with jax.set_mesh(mesh):
            # the reference's prefill is this forward's logits and caches
            logits, aux, pc = fwd(rp, jnp.asarray(toks), rc, rules, True)
            caches = RT.init_cache(rc, B, LM_S)
            for t in range(LM_STEPS):
                lg, caches = dec(rp, caches, jnp.asarray(steps[:, t]),
                                 jnp.int32(t), rc, rules)
                out[f"lm{{i}}/decode{{t}}"] = np.asarray(lg)
        out[f"lm{{i}}/forward"] = np.asarray(logits)
        out[f"lm{{i}}/aux"] = np.asarray(aux)
        for j, (k, v) in enumerate(pc):
            out[f"lm{{i}}/prefill_k{{j}}"] = np.asarray(k)
            out[f"lm{{i}}/prefill_v{{j}}"] = np.asarray(v)
        for j, (k, v) in enumerate(caches):
            out[f"lm{{i}}/cache_k{{j}}"] = np.asarray(k)
            out[f"lm{{i}}/cache_v{{j}}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
    print("OK")
""")


def lm_inputs(mod: str, B: int):
    """(reference smoke config, its parameters, (2, 16) tokens, (B, 3)
    decode tokens) of ``mod``; the same in both processes."""
    ra, _ = archs(mod)
    rc = ra.config(smoke=True)
    rp = RT.init_params(jax.random.PRNGKey(7), rc)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, rc.vocab, (2, LM_S)).astype(np.int32)
    steps = rng.integers(0, rc.vocab, (B, LM_STEPS)).astype(np.int32)
    return rc, rp, toks, steps


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_ep") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         REFERENCE_SCRIPT.format(tests=str(ROOT / "tests")), str(path)],
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
    return np.load(path)


def port_layer(case: dict, *, grad: bool = False):
    """The port's config and the case's layer as CPU tensors (leaves that
    require grad when ``grad``)."""
    pc = PM.MoEConfig(**dataclasses.asdict(case["cfg"]))

    def leaf(a):
        return torch.from_numpy(np.array(a)).requires_grad_(grad)
    p = {k: ({kk: leaf(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else leaf(v)) for k, v in case["params"].items()}
    return pc, p


def assert_grads(grads: dict, want: dict, prefix: str):
    for k, g in grads.items():
        w = want[prefix + k]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * scale + GRAD_ABS, (k, err, scale)


# ---------------------------------------------------------------------------
# the port alone (the reference starts first and runs meanwhile)
# ---------------------------------------------------------------------------

def test_capacity_and_blocks_follow_the_reference_rule(reference_run):
    cfg = PM.MoEConfig(n_experts=128, top_k=8, d_ff=1536)
    assert PM.ep_capacity(8192, cfg, 4) == 1280        # 2 x 640
    assert PM.ep_capacity(8, cfg, 16) == 8             # max(8, 0 * 2)
    assert PM.ep_capacity(65536, cfg, 16) == 10240
    scout = PM.MoEConfig(n_experts=16, top_k=1, d_ff=8192, n_shared=1)
    assert PM.ep_capacity(8192, scout, 4) == 1280
    assert PM.token_blocks(MeshShape(("pod", "data", "model"), (2, 16, 16))) \
        == 32
    assert PM.token_blocks(MeshShape(("model",), (4,))) == 1
    assert PM.use_ep(128, cfg, MeshShape(("data", "model"), (16, 16)))
    assert not PM.use_ep(1, cfg, MeshShape(("data", "model"), (16, 16)))
    assert not PM.use_ep(128, cfg, None)


def test_placed_experts_equal_views(reference_run):
    case = moe_inputs(60, 2, 1, T, 8, "random")
    pc, p = port_layer(case)
    x = torch.from_numpy(case["x"])
    mesh = mesh_of("d2m2")
    want = PM.moe_apply(p, x, pc, mesh)
    placed = PM.place_experts(p, 2, ["cpu", "cpu"])
    assert [t.shape[0] for t in placed["wi_gate"]] == [4, 4]
    # on the layer's own device a shard's experts are views, not copies,
    # and the replicated router stays one leaf
    assert placed["wo"][1].data_ptr() == p["wo"][4:].data_ptr()
    assert placed["router"] is p["router"]
    got = PM.moe_apply(placed, x, pc, mesh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="placed on 2 shards"):
        PM.moe_apply(placed, x, pc, mesh_of("d1m4"))
    with pytest.raises(ValueError, match="3 devices for 2 shards"):
        PM.place_experts(p, 2, ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PM.place_experts(p, 2)


@pytest.mark.parametrize("mod", LM_MODS)
def test_train_step_on_placed_experts_equals_unplaced(reference_run, mod):
    """One train step under (1, 4): the placed tree's experts, concatenated,
    its router and its moments equal the unplaced tree's after the step."""
    _, pa = archs(mod)
    pc = pa.config(smoke=True)
    mesh = mesh_of("d1m4")
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, pc.vocab, (2, LM_S + 1)
                                         ).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = pa.make_step(pc, "train", mesh=mesh)
    # placed slices are views: each side gets tensors of its own
    plain = pa.init_params(pc, seed=5, device="cpu")
    placed = PT.place_experts(pa.init_params(pc, seed=5, device="cpu"), pc,
                              4, ["cpu"] * 4)
    plain, popt, pm = step(plain, PA.init_state(plain), batch)
    placed, qopt, qm = step(placed, PA.init_state(placed), batch)
    assert torch.equal(pm["loss"], qm["loss"])
    torch.testing.assert_close(qm["grad_norm"], pm["grad_norm"], rtol=1e-6,
                               atol=0)

    def joined(tree):
        return [dict(blk["moe"], **{k: torch.cat(blk["moe"][k], dim=-3)
                                    for k in ("wi_gate", "wi_up", "wo")})
                for blk in tree["blocks"]]
    for want_tree, got_tree in ((plain, placed), (popt.m, qopt.m),
                                (popt.v, qopt.v)):
        for want, got in zip([b["moe"] for b in want_tree["blocks"]],
                             joined(got_tree)):
            for k in want:
                torch.testing.assert_close(got[k], want[k], rtol=1e-5,
                                           atol=1e-7)
        torch.testing.assert_close(got_tree["embed"], want_tree["embed"],
                                   rtol=1e-5, atol=1e-7)


def test_ep_runs_on_meta_with_autograd(reference_run):
    cfg = PM.MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1)
    p = PM.init_moe(None, 32, cfg, device="meta")
    p = {k: ({kk: vv.requires_grad_() for kk, vv in v.items()}
             if isinstance(v, dict) else v.requires_grad_())
         for k, v in p.items()}
    x = torch.empty((64, 32), device="meta")
    out, aux = PM.moe_apply(p, x, cfg, mesh_of("p2d1m2"))
    assert out.shape == (64, 32) and out.device.type == "meta"
    g = torch.autograd.grad(out.sum() + aux, [p["wi_gate"], p["router"]])
    assert g[0].shape == p["wi_gate"].shape and g[1].shape == (32, 8)


@pytest.mark.parametrize("mod", LM_MODS)
def test_lm_without_a_mesh_is_unchanged_and_ep_differs(reference_run, mod):
    """No mesh (or a mesh without a ``model`` axis): bitwise the dense path;
    under (1, 4) the forward takes EP, which differs from it."""
    _, pa = archs(mod)
    pc = pa.config(smoke=True)
    pp = pa.init_params(pc, seed=3, device="cpu")
    t = torch.from_numpy(np.random.default_rng(4).integers(
        0, pc.vocab, (2, LM_S)).astype(np.int32))
    dense = PT.forward(pp, t, pc)[0]
    assert torch.equal(PT.forward(pp, t, pc, mesh=mesh_of("data4"))[0], dense)
    ep = PT.forward(pp, t, pc, mesh=mesh_of("d1m4"))[0]
    assert torch.isfinite(ep).all() and not torch.equal(ep, dense)
    placed = PT.place_experts(pp, pc, 4, ["cpu"] * 4)
    assert torch.equal(PT.forward(placed, t, pc, mesh=mesh_of("d1m4"))[0], ep)


# ---------------------------------------------------------------------------
# moe_apply under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(EP_CASES)),
                         ids=[ep_id(c) for c in EP_CASES])
def test_ep_matches_reference(reference, i):
    m, K, ns, n, E, kind = EP_CASES[i]
    case = moe_inputs(i, K, ns, n, E, kind)
    mesh = mesh_of(m)
    pc, p = port_layer(case, grad=True)
    x = torch.from_numpy(case["x"])
    assert PM.use_ep(n, pc, mesh)
    out, aux = PM.moe_apply(p, x, pc, mesh)
    np.testing.assert_allclose(out.detach().numpy(), reference[f"ep{i}/out"],
                               **OUT_TOL)
    np.testing.assert_allclose(aux.detach().numpy(), reference[f"ep{i}/aux"],
                               **OUT_TOL)
    loss = (out * torch.from_numpy(case["cot"])).sum() + aux
    leaves = flat(p)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert_grads(grads, reference, f"ep{i}/grad/")
    if kind == "overflow":
        # the busiest expert overflows the dense capacity but not EP's
        # doubled one, so EP keeps copies the dense dispatch drops
        load = np.bincount(PM._router(p, x, pc)[1].numpy().ravel(),
                           minlength=E)
        M = mesh.shape["model"]
        T_loc = n // PM.token_blocks(mesh)
        assert PM.capacity(n, pc) < load.max() <= PM.ep_capacity(T_loc, pc, M)
        dense = PM.moe_apply_dense(p, x, pc)[0].detach().numpy()
        np.testing.assert_allclose(dense, reference[f"ep{i}/dense"], **OUT_TOL)
        assert np.abs(reference[f"ep{i}/out"] - reference[f"ep{i}/dense"]
                      ).max() > 0.1
        assert np.abs(out.detach().numpy() - dense).max() > 0.1


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_path_choice_falls_back_to_dense_as_the_reference(reference, name):
    m, K, ns, n, E = DENSE_CASES[name]
    case = moe_inputs(50, K, ns, n, E, "random")
    pc, p = port_layer(case)
    mesh = mesh_of(m)
    x = torch.from_numpy(case["x"])
    assert not PM.use_ep(n, pc, mesh)
    # the reference under the mesh took its dense dispatch, bitwise
    assert np.array_equal(reference[f"{name}/out"], reference[f"{name}/dense"])
    got, aux = PM.moe_apply(p, x, pc, mesh)
    want, want_aux = PM.moe_apply_dense(p, x, pc)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    np.testing.assert_allclose(got.numpy(), reference[f"{name}/out"],
                               **OUT_TOL)


# ---------------------------------------------------------------------------
# the transformer under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(LM_CASES)),
                         ids=[lm_id(c) for c in LM_CASES])
def test_lm_entry_points_under_a_mesh_match_reference(reference, i):
    mod, m, B = LM_CASES[i]
    mesh = mesh_of(m)
    _, pa = archs(mod)
    pc = pa.config(smoke=True)
    rc, rp, toks, steps = lm_inputs(mod, B)
    pp = convert.lm_params_from_jax(jax.tree.map(np.asarray, rp), pc,
                                    device="cpu")
    # the paths each side takes at these token counts
    assert PM.use_ep(2 * LM_S, pc.moe, mesh)
    assert PM.use_ep(B, pc.moe, mesh) == (B % PM.token_blocks(mesh) == 0)
    t = torch.from_numpy(toks)
    logits, aux = PT.forward(pp, t, pc, mesh=mesh)
    np.testing.assert_allclose(logits.numpy(), reference[f"lm{i}/forward"],
                               **LM_TOL)
    np.testing.assert_allclose(aux.numpy(), reference[f"lm{i}/aux"], **LM_TOL)
    pl, pcache = pa.make_step(pc, "prefill", mesh=mesh)(pp, t)
    np.testing.assert_allclose(pl.numpy(), reference[f"lm{i}/forward"],
                               **LM_TOL)
    for j, (k, v) in enumerate(pcache):
        np.testing.assert_allclose(k.numpy(), reference[f"lm{i}/prefill_k{j}"],
                                   **LM_TOL)
        np.testing.assert_allclose(v.numpy(), reference[f"lm{i}/prefill_v{j}"],
                                   **LM_TOL)
    step = pa.make_step(pc, "decode", mesh=mesh)
    caches = PT.init_cache(pc, B, LM_S, device="cpu")
    for s in range(LM_STEPS):
        lg, caches = step(pp, caches, torch.from_numpy(steps[:, s]), s)
        np.testing.assert_allclose(lg.numpy(), reference[f"lm{i}/decode{s}"],
                                   **LM_TOL)
    for j, (k, v) in enumerate(caches):
        np.testing.assert_allclose(k.numpy(), reference[f"lm{i}/cache_k{j}"],
                                   **LM_TOL)
        np.testing.assert_allclose(v.numpy(), reference[f"lm{i}/cache_v{j}"],
                                   **LM_TOL)
