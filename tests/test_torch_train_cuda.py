"""The training path on the card: one train step of every smoke config (five
LMs, FM, xDeepFM, DLRM, SASRec, EGNN on a node-level and a graph-level
batch) on the card against the same step on the CPU, and a step repeated
on the card, bitwise.  Card only (the ``cuda`` marker); this file does not
import JAX.

Every test runs under ``torch.use_deterministic_algorithms(True)``: an op
of the backward pass with no deterministic implementation on the card
raises instead of passing by chance.

Tolerances: float32 with TF32 off.  Losses, metrics and gradients within
``REL`` (1e-5 of the value or of the leaf's largest |gradient|: the order
of float32 sums inside matmuls and reductions).  The parameters after a
step as ``test_torch_train`` holds them against the reference: 99.9% of all
elements within 1e-3 x lr (plus 1e-6 of the value), every element within
AdamW's bound of 2 x lr x (1 + weight_decay |p|) (an element whose gradient
is float32 noise around 0 may step either way).
"""
import dataclasses
import importlib
import os

import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import ckpt
from repro_torch.configs import base, egnn
from repro_torch.data import pipeline
from repro_torch.optim import adamw

REL = 1e-5
LMS = ["qwen3_1p7b", "granite_3_8b", "gemma2_9b", "qwen3_moe_235b_a22b",
       "llama4_scout_17b_a16e"]
RECSYS = ["fm", "xdeepfm", "dlrm_mlperf", "sasrec"]
CASES = LMS + RECSYS + ["egnn:full_graph_sm", "egnn:molecule"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    yield torch.device("cuda")
    torch.use_deterministic_algorithms(False)


def setup(case: str, dtype=None):
    """(arch, cfg, loss_fn, params on the CPU, batch on the CPU)."""
    if case.startswith("egnn:"):
        shape = case.split(":")[1]
        arch = egnn.ARCH
        cfg = arch.config_for(shape, smoke=True)
        if cfg.graph_readout:
            b = pipeline.molecule_batch(3, cfg.n_graphs, 5, 9, cfg.d_feat,
                                        cfg.n_classes, device="cpu")
        else:
            b = pipeline.random_graph(3, 90, 400, cfg.d_feat, cfg.n_classes,
                                      pad_nodes=96, pad_edges=448,
                                      device="cpu")
        from repro_torch.models import gnn as fam
    else:
        arch = importlib.import_module(f"repro_torch.configs.{case}").ARCH
        cfg = arch.config(smoke=True)
        if arch.family == "lm":
            if dtype is not None:
                cfg = dataclasses.replace(cfg, dtype=dtype)
            b = pipeline.lm_batch(3, 0, 2, 32, cfg.vocab, device="cpu")
            from repro_torch.models import transformer as fam
        else:
            b = pipeline.recsys_batch(3, 0, 24, cfg, device="cpu")
            from repro_torch.models import recsys as fam
    return arch, cfg, fam.loss_fn, arch.init_params(cfg, seed=1,
                                                    device="cpu"), b


def _to(tree, device):
    return pytree.tree_map(lambda t: t.to(device, copy=True), tree)


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_train_step_on_card_matches_cpu(card, case):
    arch, cfg, loss_fn, cpu, b = setup(case)
    dev = _to(cpu, card)
    gc, lc, _ = base.gradients(loss_fn, cpu, b, cfg)
    gd, ld, _ = base.gradients(loss_fn, dev, _to(b, card), cfg)
    assert _rel(ld, lc) <= REL
    for (n, x), (_, y) in zip(ckpt.flatten_with_names(gd),
                              ckpt.flatten_with_names(gc)):
        assert x.device.type == card.type and _rel(x, y) <= REL, n
    before = pytree.tree_map(lambda t: t.clone(), cpu)
    step = arch.make_step(cfg, "train")
    cpu, oc, mc = step(cpu, adamw.init_state(cpu), b)
    dev, od, md = step(dev, adamw.init_state(dev), _to(b, card))
    assert set(md) == set(mc)
    for k in mc:
        assert abs(float(md[k]) - float(mc[k])) <= REL * max(abs(float(mc[k])),
                                                             1.0), k
    assert float(md["lr"]) == float(mc["lr"])
    assert int(od.step) == int(oc.step) == 1
    lr = float(mc["lr"])
    wd = adamw.AdamWConfig().weight_decay
    n_ok = n_all = 0
    for (n, x), (_, y), (_, p0) in zip(ckpt.flatten_with_names(dev),
                                       ckpt.flatten_with_names(cpu),
                                       ckpt.flatten_with_names(before)):
        err = (x.double().cpu() - y.double()).abs()
        n_ok += int((err <= 1e-3 * lr + 1e-6 * y.double().abs()).sum())
        n_all += err.numel()
        assert float(err.max()) <= 2 * lr * (1 + wd * float(p0.abs().max())), n
    assert n_ok >= 0.999 * n_all, (n_ok, n_all)


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [(c, None) for c in CASES]
                         + [("qwen3_1p7b", torch.bfloat16),
                            ("qwen3_moe_235b_a22b", torch.bfloat16)])
def test_train_step_repeats_bitwise_on_card(card, case, dtype):
    """Two steps from copies of one state on the card: every parameter,
    moment and metric bitwise equal (no atomics in any backward op on the
    path: the deterministic-algorithms mode would raise on one)."""
    arch, cfg, _, cpu, b = setup(case, dtype)
    b = _to(b, card)
    step = arch.make_step(cfg, "train")
    outs = []
    for _ in range(2):
        p = _to(cpu, card)
        st = adamw.init_state(p)
        for _k in range(2):
            p, st, m = step(p, st, b)
        outs.append((p, st, m))
    (p1, s1, m1), (p2, s2, m2) = outs
    for (n, x), (_, y) in zip(ckpt.flatten_with_names((p1, s1.m, s1.v)),
                              ckpt.flatten_with_names((p2, s2.m, s2.v))):
        assert torch.equal(x, y), n
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
