"""The port's fault-tolerant training (``repro_torch.runtime.fault_tolerance``:
``train_loop``, ``run_with_restarts``), its checkpoints of training state
(bfloat16 leaves, ``AdamWState``, ``restore(device=...)``) against the
reference's ``repro.checkpoint.ckpt``, the ``--arch`` registry and the
training CLI (``python -m repro_torch.launch.train --device cpu``), on the
CPU.

Checkpoints are compared bitwise (a checkpoint stores bytes), and so are
loss curves across restarts: a restart restores the exact state and the
counter -> batch pipeline gives the exact batch, and the CPU repeats a step
exactly.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as r_ckpt
from repro.configs import registry as r_registry
from repro.optim import adamw as RA
from repro_torch.checkpoint import ckpt
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.optim import adamw as PA
from repro_torch.runtime import fault_tolerance as ft

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# restart continuity
# ---------------------------------------------------------------------------

def test_restart_continuity(tmp_path):
    """Loss trajectory with injected failures == the uninterrupted one (the
    reference's ``tests/test_checkpoint.py`` case on the port)."""
    def step_fn(params, opt, batch):
        g = batch["x"]
        params = {"w": params["w"] - 0.1 * g}
        return params, opt + 1, {"loss": (params["w"] ** 2).sum()}

    def batch_fn(step):
        return {"x": torch.tensor(step % 3 - 1, dtype=torch.float32)}

    init = {"params": {"w": torch.ones(4)}, "opt": torch.tensor(0)}
    log_clean, log_faulty = [], []
    ft.run_with_restarts(init, 30, step_fn, batch_fn, tmp_path / "clean",
                         ckpt_every=7, metrics_log=log_clean)
    out = ft.run_with_restarts(init, 30, step_fn, batch_fn,
                               tmp_path / "faulty", ckpt_every=7,
                               failures=(11, 23), metrics_log=log_faulty)
    clean = {s: m["loss"] for s, m in log_clean}
    faulty = {s: m["loss"] for s, m in log_faulty}
    assert set(clean) == set(faulty) == set(range(30))
    assert clean == faulty
    # steps 7-11 and 21-23 ran twice (since the checkpoints at 7 and 21)
    assert len(log_faulty) == 30 + 5 + 3
    assert int(out["opt"]) == 30
    assert ckpt.list_steps(tmp_path / "faulty")[-1] == 30


def _lm_job(arch_name="qwen3-1.7b", seed=0):
    arch = registry.get(arch_name)
    cfg = arch.config(smoke=True)
    params = arch.init_params(cfg, seed=seed, device="cpu")
    init = {"params": params, "opt": PA.init_state(params)}
    return arch, cfg, init


def test_train_loop_on_a_smoke_lm(tmp_path):
    arch, cfg, init = _lm_job()
    step = arch.make_step(cfg, "train")
    log, wd = [], ft.StragglerWatchdog()
    state = ft.train_loop(init, 12, step,
                          lambda s: pipeline.lm_batch(0, s, 4, 32, cfg.vocab,
                                                      device="cpu"),
                          str(tmp_path), ckpt_every=5, metrics_log=log,
                          watchdog=wd)
    assert [s for s, _ in log] == list(range(12))
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for _, m in log)
    assert {"loss", "nll", "aux", "grad_norm", "lr"} <= set(log[0][1])
    assert [m["lr"] for _, m in log] == \
        [float(PA.schedule(PA.AdamWConfig(), s + 1)) for s in range(12)]
    assert ckpt.list_steps(tmp_path) == [5, 10, 12]
    assert int(state["opt"].step) == 12
    restored, s = ckpt.restore(tmp_path, state, device="cpu")
    assert s == 12
    for (n, a), (_, b) in zip(ckpt.flatten_with_names(state),
                              ckpt.flatten_with_names(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    assert wd.ewma is not None


@pytest.mark.parametrize("arch_name,dtype", [("qwen3-1.7b", "f32"),
                                             ("qwen3-1.7b", "bf16"),
                                             ("sasrec", "f32")])
def test_run_with_restarts_reproduces_the_loss_curve_bitwise(tmp_path,
                                                             arch_name, dtype):
    """Two injected failures, one before the first checkpoint: every step's
    metrics equal the uninterrupted run's, bitwise, the final parameters
    too, and the caller's initial state is left as it was."""
    import dataclasses
    arch = registry.get(arch_name)
    cfg = arch.config(smoke=True)
    if dtype == "bf16":
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    step = arch.make_step(cfg, "train")
    if arch.family == "lm":
        batch_fn = lambda s: pipeline.lm_batch(1, s, 2, 16, cfg.vocab,  # noqa: E731
                                               device="cpu")
    else:
        batch_fn = lambda s: pipeline.recsys_batch(1, s, 8, cfg,  # noqa: E731
                                                   device="cpu")
    params = arch.init_params(cfg, seed=2, device="cpu")
    init = {"params": params, "opt": PA.init_state(params)}
    keep = ckpt.tree_map(lambda t: t.clone(), init)
    runs = {}
    for label, failures in (("clean", ()), ("faulty", (2, 8))):
        log = []
        final = ft.run_with_restarts(init, 11, step, batch_fn,
                                     str(tmp_path / label), ckpt_every=4,
                                     failures=failures, metrics_log=log)
        runs[label] = (dict(log), log, final)
    clean, faulty = runs["clean"], runs["faulty"]
    assert clean[0] == faulty[0]                     # the last value per step
    assert len(faulty[1]) == 11 + 3 + 1              # steps 0-2 and 8 again
    for (n, a), (_, b) in zip(ckpt.flatten_with_names(clean[2]),
                              ckpt.flatten_with_names(faulty[2])):
        assert a.dtype == b.dtype and torch.equal(a, b), n
    for (n, a), (_, b) in zip(ckpt.flatten_with_names(init),
                              ckpt.flatten_with_names(keep)):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# checkpoints of training state
# ---------------------------------------------------------------------------

def _train_state(seed=0):
    """A port training state: bf16 and float32 parameters, their AdamW
    moments after one step, the step counter."""
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(5, 3, generator=g).to(torch.bfloat16),
              "blocks": [{"b": torch.randn(4, generator=g)}]}
    st = PA.init_state(params)
    grads = {"w": torch.randn(5, 3, generator=g),
             "blocks": [{"b": torch.randn(4, generator=g)}]}
    params, st, _ = PA.apply_updates(params, st, grads, PA.AdamWConfig(
        warmup_steps=1))
    return {"params": params, "opt": st}


def test_bf16_and_adamw_state_roundtrip_in_the_port(tmp_path):
    state = _train_state()
    ckpt.save(tmp_path, 3, state)
    manifest, _ = ckpt.read_manifest(tmp_path)
    by_name = {l["name"]: l for l in manifest["leaves"]}
    assert by_name["['params']['w']"]["dtype"] == "bfloat16"
    assert by_name["['opt'].step"]["dtype"] == "int32"
    assert by_name["['opt'].m['w']"]["dtype"] == "float32"
    restored, step = ckpt.restore(tmp_path, state)
    assert step == 3
    w = restored["params"]["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16
    assert torch.equal(w, state["params"]["w"])
    assert isinstance(restored["opt"], PA.AdamWState)
    np.testing.assert_array_equal(restored["opt"].m["w"],
                                  state["opt"].m["w"].numpy())
    saver = ckpt.AsyncCheckpointer(tmp_path / "async")
    saver.save_async(4, state)
    state["params"]["w"].zero_()                     # after the copy
    saver.wait()
    again, _ = ckpt.restore(tmp_path / "async", state)
    assert torch.equal(again["params"]["w"], w)


def _manifest_leaves(d):
    manifest, _ = ckpt.read_manifest(d)
    return [(l["name"], l["dtype"], l["shape"], l["crc32"])
            for l in manifest["leaves"]]


@pytest.mark.parametrize("fmt", ["npz", "npy"])
def test_port_bf16_checkpoint_restores_in_the_reference(tmp_path, fmt):
    """A port checkpoint with bf16 and ``AdamWState`` leaves restores in
    the reference bitwise, and the reference saving what it restored
    writes the same manifest (names, dtypes, shapes, CRCs)."""
    state = _train_state(1)
    ckpt.save(tmp_path / "port", 5, state, fmt=fmt)
    like = {"params": {"w": jnp.zeros((5, 3), jnp.bfloat16),
                       "blocks": [{"b": jnp.zeros(4)}]},
            "opt": RA.AdamWState(step=jnp.int32(0),
                                 m={"w": jnp.zeros((5, 3)),
                                    "blocks": [{"b": jnp.zeros(4)}]},
                                 v={"w": jnp.zeros((5, 3)),
                                    "blocks": [{"b": jnp.zeros(4)}]})}
    restored, step = r_ckpt.restore(tmp_path / "port", like)
    assert step == 5
    w = np.asarray(restored["params"]["w"])
    assert w.dtype.itemsize == 2
    np.testing.assert_array_equal(
        w.view(np.int16), state["params"]["w"].view(torch.int16).numpy())
    np.testing.assert_array_equal(restored["opt"].v["w"],
                                  state["opt"].v["w"].numpy())
    as_ref = jax.tree.map(np.asarray, restored)
    as_ref["params"]["w"] = w.view(ml_dtypes.bfloat16)
    r_ckpt.save(tmp_path / "ref", 5, as_ref, fmt=fmt)
    assert _manifest_leaves(tmp_path / "ref") == \
        _manifest_leaves(tmp_path / "port")


@pytest.mark.parametrize("fmt", ["npz", "npy"])
def test_reference_bf16_checkpoint_restores_in_the_port(tmp_path, fmt):
    """A reference checkpoint of bf16 parameters and an ``AdamWState``
    restores in the port as ``torch.bfloat16`` and float32 tensors
    bitwise, and the port saving them writes the same manifest."""
    p = {"w": jax.random.normal(jax.random.PRNGKey(0), (6, 2)
                                ).astype(jnp.bfloat16),
         "blocks": [{"b": jnp.arange(3, dtype=jnp.float32)}]}
    st = RA.init_state(p)
    p, st, _ = RA.apply_updates(p, st, jax.tree.map(
        lambda a: jnp.ones(a.shape, jnp.float32), p), RA.AdamWConfig(
            warmup_steps=1))
    ref_state = {"params": p, "opt": st}
    r_ckpt.save(tmp_path / "ref", 9, ref_state, fmt=fmt)
    like = {"params": {"w": 0, "blocks": [{"b": 0}]},
            "opt": PA.AdamWState(step=0, m={"w": 0, "blocks": [{"b": 0}]},
                                 v={"w": 0, "blocks": [{"b": 0}]})}
    restored, step = ckpt.restore(tmp_path / "ref", like, mmap=fmt == "npy")
    assert step == 9
    w = restored["params"]["w"]
    assert isinstance(w, torch.Tensor) and w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                  np.asarray(p["w"]).view(np.int16))
    np.testing.assert_array_equal(restored["opt"].m["w"], np.asarray(st.m["w"]))
    assert int(restored["opt"].step) == 1
    ckpt.save(tmp_path / "port", 9, restored, fmt=fmt)
    assert _manifest_leaves(tmp_path / "port") == \
        _manifest_leaves(tmp_path / "ref")


def test_restore_places_every_leaf_on_the_device(tmp_path):
    """``device=``: one device for the whole tree, or a tree of devices
    matching ``tree_like``; bf16, float32, int32 and 0-d leaves alike."""
    state = _train_state(2)
    ckpt.save(tmp_path, 1, state)
    one, _ = ckpt.restore(tmp_path, state, device="cpu")
    for (n, a), (_, b) in zip(ckpt.flatten_with_names(one),
                              ckpt.flatten_with_names(state)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu", n
        assert a.dtype == b.dtype and torch.equal(a, b), n
    devices = ckpt.tree_map(lambda _: torch.device("cpu"), state)
    tree, _ = ckpt.restore(tmp_path, state, device=devices)
    assert all(isinstance(t, torch.Tensor) for t in ckpt.tree_leaves(tree))
    assert tree["opt"].step.dtype == torch.int32 and tree["opt"].step.dim() == 0
    if torch.cuda.is_available():
        on_card, _ = ckpt.restore(tmp_path, state, device="cuda")
        assert all(t.is_cuda for t in ckpt.tree_leaves(on_card))


# ---------------------------------------------------------------------------
# the registry and the CLI
# ---------------------------------------------------------------------------

def test_registry_holds_the_ten_assigned_architectures():
    assert list(registry.ARCHS) == list(r_registry.ARCHS)
    assert registry.ASSIGNED == r_registry.ASSIGNED
    for paper in (False, True):
        want = [(c.arch, c.shape, c.kind, c.skip)
                for c in r_registry.all_cells(include_paper=paper)]
        got = [(c.arch, c.shape, c.kind, c.skip)
               for c in registry.all_cells(include_paper=paper)]
        assert got == want
    assert registry.get("wtbc").family == "retrieval"
    with pytest.raises(KeyError, match="available"):
        registry.get("gpt-5")
    for name in registry.ARCHS:
        assert registry.get(name).name == name


def _train(*args, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu", "--ckpt-dir", "ck", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("arch_name", ["qwen3-1.7b", "egnn"])
def test_train_cli_runs_and_resumes(tmp_path, arch_name):
    first = _train("--arch", arch_name, "--steps", "12", "--ckpt-every", "5",
                   cwd=tmp_path)
    assert first.returncode == 0, first.stdout + first.stderr[-3000:]
    lines = first.stdout.splitlines()
    assert lines[-1] == "done"
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == \
        ["0", "5", "10", "11"]
    assert ckpt.list_steps(tmp_path / "ck" / arch_name) == [5, 10, 12]
    # a longer run resumed from step 12 continues the same curve
    second = _train("--arch", arch_name, "--steps", "16", "--resume",
                    cwd=tmp_path)
    assert second.returncode == 0, second.stdout + second.stderr[-3000:]
    assert second.stdout.splitlines()[0] == "resumed from step 12"
    assert second.stdout.splitlines()[-1] == "done"
    straight = _train("--arch", arch_name, "--steps", "16", "--ckpt-dir",
                      "ck2", cwd=tmp_path)
    tail = lambda out: [ln.split()[2] for ln in out.splitlines()  # noqa: E731
                        if ln.startswith("step") and ln.split()[1] == "15"]
    assert tail(second.stdout) == tail(straight.stdout) != []


def test_train_cli_rejects_an_unknown_arch(tmp_path):
    r = _train("--arch", "gpt-5", "--steps", "1", cwd=tmp_path)
    assert r.returncode != 0 and "unknown --arch 'gpt-5'" in r.stderr
    # the paper's deployment is known but has no train step
    r = _train("--arch", "wtbc", "--steps", "1", cwd=tmp_path)
    assert r.returncode != 0 and "use make_query_fn" in r.stderr
