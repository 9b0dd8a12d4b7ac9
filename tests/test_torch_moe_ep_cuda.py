"""Expert-parallel MoE on the card against the CPU (float32, TF32 off: the
two differ only by the order of float32 sums inside matmuls, held within
1e-4 as ``test_torch_models_cuda.py``).  Card only (the ``cuda`` marker);
this file does not import JAX, so it runs wherever the port does
(``--noconftest``)."""
import importlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import MeshShape
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

MODS = ["qwen3_moe_235b_a22b", "llama4_scout_17b_a16e"]
MESHES = {"(1, 4)": (1, 4), "(2, 2)": (2, 2)}
TOL = dict(rtol=1e-4, atol=1e-4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _close(a, b):
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mod", MODS)
def test_ep_smoke_config_on_card_matches_cpu(mod, mesh):
    """forward, prefill and three decode steps under the mesh, the four
    shards on ``cuda:0`` (placed once, as views), against the CPU."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
    cfg = arch.config(smoke=True)
    ms = MeshShape(("data", "model"), MESHES[mesh])
    cpu = arch.init_params(cfg, seed=0, device="cpu")
    card = T.place_experts(pytree.tree_map(lambda t: t.cuda(), cpu), cfg,
                           ms.shape["model"], ["cuda:0"] * ms.shape["model"])
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    la, aa = T.forward(card, toks.cuda(), cfg, mesh=ms)
    lb, ab = T.forward(cpu, toks, cfg, mesh=ms)
    _close(la, lb)
    _close(aa, ab)
    pa = T.prefill(card, toks.cuda(), cfg, mesh=ms)[1]
    pb = T.prefill(cpu, toks, cfg, mesh=ms)[1]
    for x, y in zip(pa, pb):
        _close(x[0], y[0])
        _close(x[1], y[1])
    ca = T.init_cache(cfg, 2, 12, device="cuda")
    cb = T.init_cache(cfg, 2, 12, device="cpu")
    for i in range(3):
        da, ca = T.decode_step(card, ca, toks[:, i].cuda(), i, cfg, mesh=ms)
        db, cb = T.decode_step(cpu, cb, toks[:, i], i, cfg, mesh=ms)
        _close(da, db)


@pytest.mark.cuda
def test_place_experts_defaults_to_the_cards():
    """Without devices, shard m goes to ``cuda:{m % device_count}``; on the
    layer's own card a shard's experts are views."""
    _need_card()
    cfg = M.MoEConfig(n_experts=8, top_k=2, d_ff=16)
    p = M.init_moe(torch.Generator("cuda").manual_seed(0), 32, cfg)
    placed = M.place_experts(p, 4)
    n = torch.cuda.device_count()
    assert [t.device.index for t in placed["wi_up"]] == [m % n
                                                          for m in range(4)]
    if n == 1:
        assert placed["wi_up"][2].data_ptr() == p["wi_up"][4:].data_ptr()
    x = torch.randn((64, 32), device="cuda")
    mesh = MeshShape(("data", "model"), (2, 4))
    _close(M.moe_apply(placed, x, cfg, mesh)[0],
           M.moe_apply({k: v.cpu() for k, v in p.items()}, x.cpu(), cfg,
                       mesh)[0])
