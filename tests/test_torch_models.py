"""The port's LM serving path (``repro_torch.models``, ``repro_torch.configs``)
against the reference (``repro.models``, ``repro.configs``) on the CPU.

Both sides hold the same weights: the reference's ``init_params`` tree is
carried across by ``convert.lm_params_from_jax``; other inputs are numpy
draws from fixed seeds.

Tolerances.  float32: ``FP32`` (rtol = atol = 1e-4) on activations, logits
and caches — the two sides differ only by the order of float32 sums inside
matmuls (each a few ulps, ~1e-7 relative), grown through at most 8 layers
at d_model 64.  bfloat16: ``BF16`` (rtol = atol = 0.05) — bf16 keeps 8
mantissa bits (relative step 2^-8 ≈ 0.004), and one rounding that lands on
the other side of a step in an early layer moves the logits by a few such
steps.  Routing choices (expert ids) and integer leaves are compared
bitwise.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import base as rbase
from repro.configs import lm_common as rlm
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import transformer as RT
from repro_torch import convert
from repro_torch.configs import base as pbase
from repro_torch.configs import lm_common as plm
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import moe as PM
from repro_torch.models import transformer as PT

torch.set_num_threads(2)
RULES = rbase.make_rules(())          # no mesh on the CPU
FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)

CONFIGS = ["qwen3_1p7b", "granite_3_8b", "gemma2_9b", "qwen3_moe_235b_a22b",
           "llama4_scout_17b_a16e"]


def archs(mod: str):
    return (importlib.import_module(f"repro.configs.{mod}").ARCH,
            importlib.import_module(f"repro_torch.configs.{mod}").ARCH)


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def close(got, want, tol=FP32):
    np.testing.assert_allclose(np_(got), np_(want), **tol)


def pair(mod: str, *, dtype=None, seed: int = 0):
    """(reference cfg, port cfg, reference params, port params on the CPU)."""
    ra, pa = archs(mod)
    rc, pc = ra.config(smoke=True), pa.config(smoke=True)
    if dtype == "bf16":
        rc = dataclasses.replace(rc, dtype=jnp.bfloat16)
        pc = dataclasses.replace(pc, dtype=torch.bfloat16)
    rp = RT.init_params(jax.random.PRNGKey(seed), rc)
    pp = convert.lm_params_from_jax(jax.tree.map(np.asarray, rp), pc,
                                    device="cpu")
    return rc, pc, rp, pp


# the reference's steps, compiled once per config (eager ``lax.scan`` would
# trace again at every call)
ref_forward = jax.jit(RT.forward, static_argnums=(2, 3))
ref_decode = jax.jit(RT.decode_step, static_argnums=(4, 5))


def tokens(seed: int, shape, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32) * 0.1
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = RL.rms_norm(jnp.asarray(x, jd), jnp.asarray(s, jd))
    got = PL.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(s).to(td))
    assert got.dtype == td
    close(got, want, FP32 if dtype == "f32" else dict(rtol=8e-3, atol=8e-3))


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap_matches_reference(cap):
    x = np.linspace(-200, 200, 1001, dtype=np.float32)
    close(PL.softcap(torch.from_numpy(x), cap),
          RL.softcap(jnp.asarray(x), cap), dict(rtol=1e-6, atol=1e-5))


@pytest.mark.parametrize("dtype,theta", [("f32", 1e4), ("f32", 1e6),
                                         ("bf16", 5e5)])
def test_rope_matches_reference(dtype, theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(1000, 1040)]).astype(np.int32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = RL.rope(jnp.asarray(x, jd), jnp.asarray(pos), theta)
    got = PL.rope(torch.from_numpy(x).to(td), torch.from_numpy(pos), theta)
    assert got.dtype == td
    # angles up to ~1e3 rad: sin/cos of float32 arguments differ by ulps
    close(got, want, dict(rtol=1e-4, atol=2e-4) if dtype == "f32"
          else dict(rtol=8e-3, atol=8e-3))


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply_matches_reference(gated):
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wi_gate", (64, 96)), ("wi_up", (64, 96)),
                      ("wo", (96, 64)))}
    x = rng.standard_normal((7, 64)).astype(np.float32)
    want = RL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), gated=gated)
    got = PL.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), gated=gated)
    close(got, want)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    want = RL.cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                            jnp.asarray(labels))
    got = PL.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                           torch.from_numpy(labels))
    close(got, want, dict(rtol=1e-6, atol=1e-6))


def test_init_dense_distribution_and_meta():
    g = torch.Generator().manual_seed(0)
    w = PL.init_dense(g, 256, 512, torch.bfloat16, lead=(3,), device="cpu")
    assert w.shape == (3, 256, 512) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - (1 / 256) ** 0.5) < 2e-3
    assert abs(float(w.float().mean())) < 1e-3
    m = PL.init_dense(None, 256, 512, lead=(3,), device="meta")
    assert m.is_meta and m.shape == (3, 256, 512)
    again = PL.init_dense(torch.Generator().manual_seed(0), 256, 512,
                          torch.bfloat16, lead=(3,), device="cpu")
    assert torch.equal(w, again)


INIT_HELPERS = {
    "normal": lambda g, **kw: PL.normal(g, (4, 8), 0.02, torch.float32, **kw),
    "init_dense": lambda g, **kw: PL.init_dense(g, 4, 8, **kw),
    "init_attn": lambda g, **kw: PA.init_attn(
        g, 16, PA.AttnConfig(n_heads=2, n_kv_heads=1, d_head=8, qk_norm=True),
        **kw),
    "init_moe": lambda g, **kw: PM.init_moe(
        g, 16, PM.MoEConfig(n_experts=2, top_k=1, d_ff=8, n_shared=1), **kw),
}


@pytest.mark.parametrize("name", list(INIT_HELPERS))
def test_init_helpers_default_to_the_card(name):
    """With no ``device`` the init helpers resolve to the card, as every
    other entry point of the port does: without a card they raise
    ``resolve_device``'s error.  ``device="cpu"`` and ``"meta"`` still work."""
    make = INIT_HELPERS[name]
    leaves = lambda t: (pytree.tree_leaves(t) if isinstance(t, dict) else [t])
    if torch.cuda.is_available():
        out = make(torch.Generator(device="cuda").manual_seed(0))
        assert all(t.is_cuda for t in leaves(out))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(torch.Generator().manual_seed(0))
    cpu = make(torch.Generator().manual_seed(0), device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(cpu))
    again = make(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(cpu), leaves(again)))
    meta = make(None, device="meta")
    assert all(t.is_meta for t in leaves(meta))
    assert [t.shape for t in leaves(meta)] == [t.shape for t in leaves(cpu)]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_pair(seed, *, qk_norm, softcap, window, d_model=64, H=4, KV=2,
              Dh=16, theta=1e4):
    rc = RA.AttnConfig(n_heads=H, n_kv_heads=KV, d_head=Dh, qk_norm=qk_norm,
                       softcap=softcap, rope_theta=theta, window=window)
    pc = PA.AttnConfig(**dataclasses.asdict(rc))
    rp = RA.init_attn(jax.random.PRNGKey(seed), d_model, rc)
    if qk_norm:     # non-zero norms, so the scale is exercised
        rng = np.random.default_rng(seed)
        rp["q_norm"] = jnp.asarray(rng.standard_normal(Dh) * 0.2, jnp.float32)
        rp["k_norm"] = jnp.asarray(rng.standard_normal(Dh) * 0.2, jnp.float32)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    return rc, pc, rp, pp


PREFILL_CASES = [(pat, qk, cap) for pat in RA.PATTERNS
                 for qk, cap in ((False, None), (True, None), (False, 50.0),
                                 (True, 50.0))]


@pytest.mark.parametrize("pattern,qk_norm,cap", PREFILL_CASES)
def test_attend_dense_prefill_matches_reference(pattern, qk_norm, cap):
    rc, pc, rp, pp = attn_pair(5, qk_norm=qk_norm, softcap=cap, window=4)
    x = np.random.default_rng(6).standard_normal((2, 19, 64)).astype(np.float32)
    pid = RA.PATTERNS.index(pattern)
    want, (wk, wv) = RA.attend(rp, jnp.asarray(x), rc, jnp.int32(pid),
                               rules=RULES)
    got, (gk, gv) = PA.attend(pp, torch.from_numpy(x), pc, pid)
    close(got, want)
    close(gk, wk)
    close(gv, wv)


@pytest.mark.parametrize("pattern,S,qk_norm,cap", [
    ("global", 2048, False, None), ("local", 2048, True, 50.0),
    ("chunked", 2048, False, 50.0), ("global", 2080, True, None),
    ("local", 2080, False, None), ("chunked", 2080, True, 50.0)])
def test_attend_blockwise_prefill_matches_reference(pattern, S, qk_norm, cap):
    """S >= 2048 takes the online softmax over KV blocks of 1024; S = 2080
    ends in a short block (the reference pads it).  At window 600 the first
    block of the local and chunked layers' late rows is wholly masked."""
    assert S >= PA.FLASH_THRESHOLD == RA.FLASH_THRESHOLD
    rc, pc, rp, pp = attn_pair(7, qk_norm=qk_norm, softcap=cap, window=600)
    x = np.random.default_rng(8).standard_normal((1, S, 64)).astype(np.float32)
    pid = RA.PATTERNS.index(pattern)
    want, _ = RA.attend(rp, jnp.asarray(x), rc, jnp.int32(pid), rules=RULES)
    got, _ = PA.attend(pp, torch.from_numpy(x), pc, pid)
    close(got, want)


def test_flash_and_dense_paths_agree_in_the_port():
    """The blockwise path equals the dense one on the same inputs, including
    rows whose first block is wholly masked (local window < block)."""
    _, pc, _, _ = attn_pair(9, qk_norm=False, softcap=None, window=300)
    rng = np.random.default_rng(10)
    q5 = torch.from_numpy(rng.standard_normal((1, 2100, 2, 2, 16))
                          .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2100, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2100, 2, 16)).astype(np.float32))
    pos = torch.arange(2100, dtype=torch.int32)
    for pid in range(3):
        dense = PA._dense_attend(q5, k, v, PA._mask(pid, pos, pos, 300), None,
                                 0.25)
        flash = PA._flash_attend(q5, k, v, pid, 300, None, 0.25, 1024)
        close(flash, dense, dict(rtol=1e-5, atol=1e-5))


DECODE_CASES = [
    # (pattern, window, S_kv, cache_len): ring unwrapped / wrapped, S_kv > window
    ("local", 8, 8, 5), ("local", 8, 8, 13), ("chunked", 8, 8, 21),
    ("local", 8, 32, 20), ("chunked", 8, 32, 19), ("global", 0, 32, 0),
    ("global", 0, 32, 31), ("global", 8, 32, 17)]


@pytest.mark.parametrize("pattern,window,S_kv,cache_len", DECODE_CASES)
@pytest.mark.parametrize("use_rope", [True, False])
def test_attend_decode_matches_reference(pattern, window, S_kv, cache_len,
                                         use_rope):
    rc, pc, rp, pp = attn_pair(11, qk_norm=True, softcap=50.0, window=window)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    ck = rng.standard_normal((3, S_kv, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((3, S_kv, 2, 16)).astype(np.float32)
    pid = RA.PATTERNS.index(pattern)
    want, (wk, wv) = RA.attend(rp, jnp.asarray(x), rc, jnp.int32(pid),
                               rules=RULES, use_rope=use_rope,
                               kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
                               cache_len=jnp.int32(cache_len))
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, (gk, gv) = PA.attend(pp, torch.from_numpy(x), pc, pid,
                              use_rope=use_rope, kv_cache=(tk, tv),
                              cache_len=cache_len)
    close(got, want)
    close(gk, wk)
    close(gv, wv)
    assert gk is tk and gv is tv            # written in place
    slot = cache_len % S_kv
    others = np.arange(S_kv) != slot
    assert np.array_equal(tk.numpy()[:, others], ck[:, others])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_pair(seed, *, E=4, K=2, n_shared=0, router=None, D=32, F_=24):
    rc = RM.MoEConfig(n_experts=E, top_k=K, d_ff=F_, n_shared=n_shared)
    pc = PM.MoEConfig(**dataclasses.asdict(rc))
    rp = RM.init_moe(jax.random.PRNGKey(seed), D, rc)
    if router is not None:
        rp["router"] = jnp.asarray(router, jnp.float32)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    return rc, pc, rp, pp


def route_both(rc, pc, rp, pp, x):
    wg, we, waux = RM._router(rp, jnp.asarray(x), rc)
    gg, ge, _, gaux = PM._router(pp, torch.from_numpy(x), pc)
    return (wg, we, waux), (gg, ge, gaux)


MOE_CASES = {
    "random": dict(),
    "overflow": dict(bias=True),             # most copies to expert 2
    "tie": dict(router="zeros"),             # every probability 1/E
    "shared_top1": dict(K=1, n_shared=1),
    "top8_of_16": dict(E=16, K=8),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    opt = MOE_CASES[case]
    E, K, D = opt.get("E", 4), opt.get("K", 2), 32
    rng = np.random.default_rng(13)
    x = rng.standard_normal((40, D)).astype(np.float32)
    router = None
    if opt.get("router") == "zeros":
        router = np.zeros((D, E), np.float32)
    elif opt.get("bias"):
        router = rng.standard_normal((D, E)).astype(np.float32) * 0.1
        x[:, 0] = 4.0
        router[0, 2] = 3.0
    rc, pc, rp, pp = moe_pair(14, E=E, K=K, n_shared=opt.get("n_shared", 0),
                              router=router, D=D)
    (wg, we, waux), (gg, ge, gaux) = route_both(rc, pc, rp, pp, x)
    assert np.array_equal(ge.numpy(), np.asarray(we))      # bitwise choices
    close(gg, wg, dict(rtol=1e-6, atol=1e-7))
    close(gaux, waux, dict(rtol=1e-6, atol=1e-7))
    C = PM.capacity(40, pc)
    load = np.bincount(np.asarray(we).ravel(), minlength=E)
    if case in ("overflow", "tie"):
        assert load.max() > C, (load, C)    # copies past capacity are dropped
    if case == "tie":
        assert (np.asarray(we) == np.arange(K)).all()   # lower expert first
    want, _ = RM.moe_apply(rp, jnp.asarray(x), rc, RULES)
    got, _ = PM.moe_apply(pp, torch.from_numpy(x), pc)
    close(got, want, dict(rtol=1e-5, atol=1e-5))


def test_moe_dropped_copies_contribute_nothing():
    """At capacity 8 with every token routed to experts 0 and 1, tokens past
    the eighth of each expert get only the shared expert's output (zero
    here)."""
    D, E = 16, 4
    rc, pc, rp, pp = moe_pair(15, E=E, K=2, router=np.zeros((D, E)), D=D)
    x = np.random.default_rng(16).standard_normal((6, D)).astype(np.float32)
    assert PM.capacity(6, pc) == 8          # 6 tokens x 2 copies fit
    got, _ = PM.moe_apply(pp, torch.from_numpy(x), pc)
    assert bool((got.abs().sum(-1) > 0).all())
    x = np.random.default_rng(16).standard_normal((20, D)).astype(np.float32)
    assert PM.capacity(20, pc) == 12
    got, _ = PM.moe_apply(pp, torch.from_numpy(x), pc)
    assert bool((got[12:] == 0).all()) and bool((got[:12] != 0).any())
    want, _ = RM.moe_apply(rp, jnp.asarray(x), rc, RULES)
    close(got, want, dict(rtol=1e-5, atol=1e-5))


# ---------------------------------------------------------------------------
# the transformer: forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", CONFIGS)
def test_forward_matches_reference(mod):
    rc, pc, rp, pp = pair(mod, seed=1)
    toks = tokens(2, (2, 16), rc.vocab)
    wl, waux = ref_forward(rp, jnp.asarray(toks), rc, RULES)
    gl, gaux = PT.forward(pp, torch.from_numpy(toks), pc)
    assert gl.dtype == torch.float32 and gl.shape == (2, 16, rc.vocab)
    close(gl, wl)
    close(gaux, waux)
    wloss, wm = RT.loss_fn(rp, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(toks[:, ::-1])},
                           rc, RULES)
    gloss, gm = PT.loss_fn(pp, {"tokens": torch.from_numpy(toks),
                                "labels": torch.from_numpy(toks[:, ::-1].copy())},
                           pc)
    close(gloss, wloss)
    close(gm["nll"], wm["nll"])


@pytest.mark.parametrize("mod", CONFIGS)
def test_prefill_matches_reference(mod):
    rc, pc, rp, pp = pair(mod, seed=3)
    toks = tokens(4, (2, 12), rc.vocab)
    wl, wc = RT.prefill(rp, jnp.asarray(toks), rc, RULES)
    gl, gc = PT.prefill(pp, torch.from_numpy(toks), pc)
    close(gl, wl)
    assert len(gc) == len(wc) == len(rc.pattern)
    for (gk, gv), (wk, wv) in zip(gc, wc):
        assert tuple(gk.shape) == tuple(wk.shape) == (
            rc.n_groups, 2, 12, rc.n_kv_heads, rc.head_dim)
        close(gk, wk)
        close(gv, wv)


@pytest.mark.parametrize("mod", CONFIGS)
def test_decode_steps_match_reference(mod):
    """8 decode steps from empty caches of 16 slots (rings of 8 for the
    windowed layers, so they wrap)... and a final step whose caches are
    compared too."""
    rc, pc, rp, pp = pair(mod, seed=5)
    toks = tokens(6, (2, 10), rc.vocab)
    wc = RT.init_cache(rc, 2, 16)
    gc = PT.init_cache(pc, 2, 16, device="cpu")
    for t in range(10):
        wl, wc = ref_decode(rp, wc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                rc, RULES)
        gl, gc = PT.decode_step(pp, gc, torch.from_numpy(toks[:, t]), t, pc)
        assert gl.shape == (2, rc.vocab)
        close(gl, wl)
    for (gk, gv), (wk, wv) in zip(gc, wc):
        close(gk, wk)
        close(gv, wv)


@pytest.mark.parametrize("mod", ["qwen3_1p7b", "gemma2_9b"])
def test_bf16_forward_and_decode_match_reference(mod):
    rc, pc, rp, pp = pair(mod, dtype="bf16", seed=7)
    assert pp["embed"].dtype == torch.bfloat16
    toks = tokens(8, (2, 12), rc.vocab)
    wl, _ = ref_forward(rp, jnp.asarray(toks), rc, RULES)
    gl, _ = PT.forward(pp, torch.from_numpy(toks), pc)
    close(gl, wl, BF16)
    wc, gc = RT.init_cache(rc, 2, 16), PT.init_cache(pc, 2, 16, device="cpu")
    for t in range(8):
        wl, wc = ref_decode(rp, wc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                rc, RULES)
        gl, gc = PT.decode_step(pp, gc, torch.from_numpy(toks[:, t]), t, pc)
        close(gl, wl, BF16)
    assert gc[0][0].dtype == torch.bfloat16


@pytest.mark.parametrize("mod", CONFIGS)
def test_prefill_then_decode_consistency(mod):
    """The port alone, as the reference's own test: decoding 8 tokens one by
    one gives the full forward's logits at every position, and a prefill's
    caches placed into decode rings (slot = pos % S_kv) continue it."""
    _, pc, _, pp = pair(mod, seed=9)
    toks = torch.from_numpy(tokens(10, (1, 8), pc.vocab))
    full, _ = PT.forward(pp, toks, pc)
    caches = PT.init_cache(pc, 1, 16, device="cpu")
    for t in range(8):
        logits, caches = PT.decode_step(pp, caches, toks[:, t], t, pc)
        close(logits[0], full[0, t], dict(rtol=2e-4, atol=2e-4))
    _, pre = PT.prefill(pp, toks[:, :6], pc)
    rings = PT.init_cache(pc, 1, 16, device="cpu")
    for (pk, pv), (rk, rv) in zip(pre, rings):
        for pos in range(6):
            rk[:, :, pos % rk.shape[2]] = pk[:, :, pos]
            rv[:, :, pos % rv.shape[2]] = pv[:, :, pos]
    for t in (6, 7):
        logits, rings = PT.decode_step(pp, rings, toks[:, t], t, pc)
        close(logits[0], full[0, t], dict(rtol=2e-4, atol=2e-4))


def test_r9_chunked_decode_is_a_sliding_window_like_the_reference():
    """R9, a fault of the reference kept on purpose: a chunked layer's decode
    ring holds ``window`` slots and, once full, attends to the last
    ``window`` positions, while the forward attends within the aligned
    chunk.  The port's decode equals the reference's at every step; both
    equal the forward before the first chunk boundary (8, the smoke window)
    and both differ from it past the boundary."""
    rc, pc, rp, pp = pair("llama4_scout_17b_a16e", seed=11)
    assert rc.window == pc.window == 8 and "chunked" in pc.pattern
    toks = tokens(12, (1, 14), rc.vocab)
    full, _ = PT.forward(pp, torch.from_numpy(toks), pc)
    wc, gc = RT.init_cache(rc, 1, 32), PT.init_cache(pc, 1, 32, device="cpu")
    assert gc[0][0].shape[2] == 8           # the chunked layers' ring
    past = []
    for t in range(14):
        wl, wc = ref_decode(rp, wc, jnp.asarray(toks[:, t]), jnp.int32(t),
                                rc, RULES)
        gl, gc = PT.decode_step(pp, gc, torch.from_numpy(toks[:, t]), t, pc)
        close(gl, wl)                               # port == reference
        gap = float((gl[0] - full[0, t]).abs().max())
        if t < 8:
            assert gap < 2e-4, (t, gap)             # == forward in chunk 0
        else:
            past.append(gap)
    assert min(past[1:]) > 1e-3, past               # != forward past it


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", CONFIGS)
def test_cells_and_counts_match_reference(mod):
    ra, pa = archs(mod)
    assert pa.name == ra.name and pa.family == ra.family == "lm"
    got = [(c.arch, c.shape, c.kind, c.skip, c.cell_id) for c in pa.cells()]
    want = [(c.arch, c.shape, c.kind, c.skip, c.cell_id) for c in ra.cells()]
    assert got == want
    assert list(plm.LM_SHAPES) == list(rlm.LM_SHAPES)
    assert plm.LM_SHAPES == rlm.LM_SHAPES
    for smoke in (False, True):
        rc, pc = ra.config(smoke), pa.config(smoke)
        assert pc.param_count() == rc.param_count()
        assert pc.active_param_count() == rc.active_param_count()
        assert pa.flops_note(pc) == ra.flops_note(rc)
        for f in dataclasses.fields(rc):
            if f.name not in ("dtype", "moe"):
                assert getattr(pc, f.name) == getattr(rc, f.name), f.name
        assert str(pc.dtype).split(".")[-1] == jnp.dtype(rc.dtype).name
        if rc.moe:
            assert dataclasses.asdict(pc.moe) == dataclasses.asdict(rc.moe)


def _shapes(tree, leaf):
    return jax.tree.map(lambda t: leaf(t), tree,
                        is_leaf=lambda t: isinstance(t, (torch.Tensor,
                                                         jax.ShapeDtypeStruct)))


def _sd(t):
    if isinstance(t, torch.Tensor):
        assert t.is_meta
        return (tuple(t.shape), str(t.dtype).split(".")[-1])
    return (tuple(t.shape), jnp.dtype(t.dtype).name)


@pytest.mark.parametrize("mod", CONFIGS)
def test_abstract_inputs_and_params_match_eval_shape(mod):
    ra, pa = archs(mod)
    rc, pc = ra.config(), pa.config()
    for shape in rlm.LM_SHAPES:
        want = _shapes(ra.abstract_inputs(rc, shape), _sd)
        got = _shapes(pa.abstract_inputs(pc, shape), _sd)
        if "caches" in want:        # the reference lists pairs as tuples
            want["caches"] = [tuple(p) for p in want["caches"]]
            got["caches"] = [tuple(p) for p in got["caches"]]
        assert got == want, shape
    want = _shapes(ra.abstract_params(rc), _sd)
    got = _shapes(pa.abstract_params(pc), _sd)
    assert got == want


def test_make_step_kinds():
    ra, pa = archs("qwen3_1p7b")
    pc = pa.config(smoke=True)
    assert callable(pa.make_step(pc, "train"))    # tests/test_torch_train.py
    with pytest.raises(ValueError):
        pa.make_step(pc, "serve")
    rc, pc, rp, pp = pair("qwen3_1p7b", seed=13)
    toks = tokens(14, (2, 8), rc.vocab)
    logits, caches = pa.make_step(pc, "prefill")(pp, torch.from_numpy(toks))
    wl, _ = ra.make_step(rc, "prefill", RULES)(rp, jnp.asarray(toks))
    close(logits, wl)
    gc = PT.init_cache(pc, 2, 8, device="cpu")
    gl, _ = pa.make_step(pc, "decode")(pp, gc, torch.from_numpy(toks[:, 0]),
                                       torch.tensor(0, dtype=torch.int32))
    wl, _ = ra.make_step(rc, "decode", RULES)(
        rp, RT.init_cache(rc, 2, 8), jnp.asarray(toks[:, 0]), jnp.int32(0))
    close(gl, wl)
    assert pbase.pad_to(49155, 256) == rbase.pad_to(49155, 256) == 49408


def test_port_init_params_follows_the_reference_distributions():
    _, pa = archs("qwen3_moe_235b_a22b")
    pc = pa.config(smoke=True)
    p = pa.init_params(pc, seed=3, device="cpu")
    assert torch.equal(p["embed"], pa.init_params(pc, seed=3,
                                                  device="cpu")["embed"])
    assert abs(float(p["embed"].std()) - 0.02) < 1e-3
    assert abs(float(p["lm_head"].std()) - 0.02) < 1e-3
    assert bool((p["final_norm"] == 0).all())
    blk = p["blocks"][0]
    assert bool((blk["norm1"] == 0).all()) and bool((blk["attn"]["q_norm"] == 0).all())
    assert blk["moe"]["router"].dtype == torch.float32
    assert abs(float(blk["attn"]["wq"].std()) - (1 / 64) ** 0.5) < 0.01
    assert abs(float(blk["moe"]["wo"].std()) - (1 / 64) ** 0.5) < 0.01
    logits, _ = PT.forward(p, torch.from_numpy(tokens(15, (1, 6), pc.vocab)), pc)
    assert bool(torch.isfinite(logits).all())


def test_convert_rejects_a_tree_of_another_config():
    rc, pc, rp, _ = pair("qwen3_1p7b")
    tree = jax.tree.map(np.asarray, rp)
    other = dataclasses.replace(pc, d_ff=96)
    with pytest.raises(ValueError, match="wi_gate"):
        convert.lm_params_from_jax(tree, other, device="cpu")
    del tree["blocks"][0]["norm2"]
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params_from_jax(tree, pc, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    _, pa = archs("qwen3_1p7b")
    pc = pa.config(smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pa.init_params(pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.init_cache(pc, 1, 8)
    rc, _, rp, _ = pair("qwen3_1p7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_jax(jax.tree.map(np.asarray, rp), pc)
