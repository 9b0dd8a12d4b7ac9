"""The LM serving path on the card against the same weights on the CPU
(float32, TF32 off: the two differ only by the order of float32 sums inside
matmuls, held within 1e-4).  Card only (the ``cuda`` marker); this file does
not import JAX, so it runs wherever the port does."""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.models import transformer as T

CONFIGS = ["qwen3_1p7b", "granite_3_8b", "gemma2_9b", "qwen3_moe_235b_a22b",
           "llama4_scout_17b_a16e"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _close(a, b):
    np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mod", CONFIGS)
def test_smoke_config_on_card_matches_cpu(mod):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
    cfg = arch.config(smoke=True)
    cpu = arch.init_params(cfg, seed=0, device="cpu")
    card = _to(cpu, "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    la, ca = T.prefill(card, toks.cuda(), cfg)
    lb, cb = T.prefill(cpu, toks, cfg)
    _close(la, lb)
    for pa, pb in zip(ca, cb):
        for x, y in zip(pa, pb):
            _close(x, y)
    ra = T.init_cache(cfg, 2, 8)                 # the card by default
    rb = T.init_cache(cfg, 2, 8, device="cpu")
    assert ra[0][0].is_cuda
    for t in range(12):                          # rings of 8 slots wrap
        da, ra = T.decode_step(card, ra, toks[:, t].cuda(), t, cfg)
        db, rb = T.decode_step(cpu, rb, toks[:, t], t, cfg)
        _close(da, db)


@pytest.mark.cuda
def test_default_init_is_on_the_card_and_bf16_runs():
    _need_card()
    arch = importlib.import_module("repro_torch.configs.qwen3_1p7b").ARCH
    cfg = arch.config(smoke=True)
    import dataclasses
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    params = arch.init_params(cfg, seed=1)
    assert params["embed"].is_cuda and params["embed"].dtype == torch.bfloat16
    toks = torch.randint(0, cfg.vocab, (2, 2048), device="cuda")
    logits, caches = arch.make_step(cfg, "prefill")(params, toks)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert caches[0][0].shape == (cfg.n_groups, 2, 2048, 2, 16)
