"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
(``repro.optim.adamw``) on the CPU: the counterparts of
``tests/test_optim.py``'s five cases, then the schedule, the global norm and
several ``apply_updates`` steps on the same float32 and bf16 trees.

Tolerances.  Both sides run the same float32 operations in the same order
per element; the only reductions are the per-leaf sums of squares and
their sum, in the reference's leaf order.  Two things still differ:

* ``SCHEDULE`` (rtol 5e-7): XLA's and PyTorch's float32 ``cos`` differ by
  1 ulp on about 5% of arguments; near the end of the decay
  ``0.5 (1 + cos)`` is small against ``min_lr_frac``'s term, which turns
  that ulp into up to ~3 ulps of the learning rate.
* ``NORM`` (rtol 1e-6): XLA and PyTorch add a leaf's squares in different
  orders (a float32 sum of n terms moves by a few ulps).

So the updates are held to float32 within ``UPDATE`` (rtol 2e-6 of the
value: the moments and parameters inherit the two relative errors above, a
few ulps each; atol 1e-8 = 1e-6 x the tests' lr of 1e-2: a parameter near
0 carries the few-ulp error of its update, ~1e-2, not of its own value),
and bf16 parameters within 1 bf16 ulp (the
float32 result may round to either neighbour when it lands within a few
float32 ulps of a bf16 midpoint).  The reference's own five cases are run
as they are written there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as R
from repro_torch.optim import adamw as P

torch.set_num_threads(2)
SCHEDULE = dict(rtol=5e-7, atol=0)
NORM = dict(rtol=1e-6, atol=0)
UPDATE = dict(rtol=2e-6, atol=1e-8)


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def tree_np(seed: int) -> dict:
    """A nested tree (dict keys out of order, a list) of float32 leaves."""
    rng = np.random.default_rng(seed)
    return {"z": rng.standard_normal((6, 5)).astype(np.float32),
            "a": [rng.standard_normal(7).astype(np.float32),
                  rng.standard_normal((2, 3, 4)).astype(np.float32)],
            "m": {"k": np.float32(rng.standard_normal()) * np.ones((), np.float32)}}


def to_ref(tree, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def to_port(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def same(got, want):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_array_equal(np_(g), np_(w))


def close(got, want, tol=UPDATE):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        if isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16:
            assert bf16_ulps(g, w) <= 1
        else:
            np.testing.assert_allclose(np_(g), np_(w), **tol)


def bf16_ulps(got: torch.Tensor, want) -> int:
    """The largest distance in bf16 steps between two bf16 arrays of
    finite values of one sign per element (their bit patterns' distance)."""
    a = got.detach().view(torch.int16).numpy().astype(np.int64)
    b = np.asarray(want).view(np.int16).astype(np.int64)
    return int(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# the reference's five cases
# ---------------------------------------------------------------------------

def test_adamw_descends_quadratic():
    cfg = P.AdamWConfig(lr=0.05, warmup_steps=1, total_steps=200,
                        weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = P.init_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = P.apply_updates(params, state, grads, cfg)
    assert float(params["w"].abs().max()) < 0.2
    assert int(state.step) == 150


def test_schedule_shape():
    cfg = P.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    lrs = [float(P.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))
    assert lrs[-1] >= 0.1 - 1e-6


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 10.0), "b": torch.full((3,), -10.0)}
    clipped, norm = P.clip_by_global_norm(grads, 1.0)
    assert abs(float(P.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 1.0
    rc, rn = R.clip_by_global_norm({k: jnp.asarray(v.numpy())
                                    for k, v in grads.items()}, 1.0)
    np.testing.assert_allclose(float(norm), float(rn), **NORM)
    close(clipped, rc)


def test_ef_int8_compression_unbiased_over_time():
    rng = np.random.default_rng(0)
    g_true = [torch.from_numpy(rng.standard_normal(32).astype(np.float32))
              for _ in range(50)]
    ef = P.ef_init({"w": g_true[0]})
    acc_deq = torch.zeros(32)
    acc_true = torch.zeros(32)
    for g in g_true:
        deq, ef = P.ef_compress_tree({"w": g}, ef)
        acc_deq = acc_deq + deq["w"]
        acc_true = acc_true + g
    err = float((acc_deq - acc_true).abs().max())
    gmax = max(float(g.abs().max()) for g in g_true)
    assert err <= 3 * gmax / 127.0 + 1e-5, (err, gmax)


def test_ef_payload_is_int8_sized():
    g = {"w": torch.ones((1000,), dtype=torch.float32)}
    deq, ef = P.ef_compress_tree(g, P.ef_init(g))
    assert deq["w"].dtype == torch.float32
    np.testing.assert_allclose(deq["w"].numpy(), 1.0, rtol=0.02)
    assert ef.residual["w"].shape == (1000,)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 10), (0, 5),
                                          (100, 10_000)])
def test_schedule_matches_reference(warmup, total):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total,
              min_lr_frac=0.1)
    rc, pc = R.AdamWConfig(**kw), P.AdamWConfig(**kw)
    steps = np.arange(0, total + 20, max(1, total // 37)).astype(np.int32)
    want = np.array([np.float32(R.schedule(rc, jnp.int32(s))) for s in steps])
    got = np.array([np.float32(P.schedule(pc, torch.tensor(s)))
                    for s in steps])
    got_int = np.array([np.float32(P.schedule(pc, int(s))) for s in steps])
    np.testing.assert_allclose(got, want, **SCHEDULE)
    np.testing.assert_array_equal(got_int, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_global_norm_matches_reference(dtype):
    tree = tree_np(3)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    want = R.global_norm(to_ref(tree, jd))
    got = P.global_norm(to_port(tree, td))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **NORM)


def test_init_state_tree_and_dtypes():
    params = to_port(tree_np(4), torch.bfloat16)
    st = P.init_state(params)
    rst = R.init_state(to_ref(tree_np(4), jnp.bfloat16))
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    assert [t.shape for t in jax.tree.leaves(st.m)] == \
        [tuple(t.shape) for t in jax.tree.leaves(rst.m)]
    assert all(t.dtype == torch.float32 and not t.any()
               for t in jax.tree.leaves((st.m, st.v)))


@pytest.mark.parametrize("dtype,clip", [("f32", 1.0), ("f32", 100.0),
                                        ("bf16", 1.0)])
def test_apply_updates_matches_reference(dtype, clip):
    """Five steps from the same parameters on the same gradients (float32,
    clipped and not): parameters and moments within ``UPDATE`` (bf16
    parameters within 1 bf16 ulp), grad_norm within ``NORM``, lr within
    ``SCHEDULE``, the step bitwise, on every step.  The bf16 tree keeps bf16
    parameters (updated in float32 and rounded to nearest) and float32
    moments."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, clip_norm=clip)
    rc, pc = R.AdamWConfig(**kw), P.AdamWConfig(**kw)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    rp, pp = to_ref(tree_np(5), jd), to_port(tree_np(5), td)
    rs, ps = R.init_state(rp), P.init_state(pp)
    rng = np.random.default_rng(6)
    for _ in range(5):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 3)
                         .astype(np.float32), tree_np(5))
        rp, rs, rm = R.apply_updates(rp, rs, to_ref(g), rc)
        pp, ps, pm = P.apply_updates(pp, ps, to_port(g), pc)
        assert jax.tree.leaves(pp)[0].dtype == td
        close(pp, rp)
        close((ps.m, ps.v), (rs.m, rs.v))
        assert int(ps.step) == int(rs.step)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), **NORM)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   **SCHEDULE)


def test_apply_updates_is_in_place_and_reads_bf16_grads():
    params = to_port(tree_np(7))
    before = jax.tree.map(lambda t: t.clone(), params)
    st = P.init_state(params)
    m_leaf = jax.tree.leaves(st.m)[0]
    grads = to_port(tree_np(8), torch.bfloat16)
    out, st2, _ = P.apply_updates(params, st, grads, P.AdamWConfig(
        warmup_steps=1))
    assert out is params and st2.m is st.m
    assert jax.tree.leaves(st2.m)[0] is m_leaf and bool(m_leaf.any())
    assert any(not torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(params), jax.tree.leaves(before)))
    assert int(st.step) == 0 and int(st2.step) == 1
    with pytest.raises(ValueError, match="gradients"):
        P.apply_updates(params, st2, {"z": grads["z"]}, P.AdamWConfig())


def test_ef_compress_tree_matches_reference():
    rng = np.random.default_rng(9)
    tree = tree_np(10)
    ref_ef, ef = R.ef_init(to_ref(tree)), P.ef_init(to_port(tree))
    for _ in range(4):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                         .astype(np.float32), tree)
        rd, ref_ef = R.ef_compress_tree(to_ref(g), ref_ef)
        pd, ef = P.ef_compress_tree(to_port(g), ef)
        same(pd, rd)
        same(ef.residual, ref_ef.residual)
