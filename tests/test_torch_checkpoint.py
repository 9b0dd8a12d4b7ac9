"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) and straggler
watchdog against ``repro.checkpoint.ckpt`` and its watchdog (CPU).

The on-disk format is shared: leaf names are the reference's
``jax.tree_util.keystr`` names, so a tree saved by either package restores
in the other with equal names and values.
"""
import json
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as r_ckpt
from repro.runtime import fault_tolerance as r_ft
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import Attrs
from repro_torch.runtime import fault_tolerance as ft


def make_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 4)).astype(np.float32),
            "nested": {"b": np.arange(7, dtype=np.int32),
                       "c": np.float32(3.5)},
            "t": torch.from_numpy(rng.integers(0, 9, 5).astype(np.int64))}


def _leaves(tree):
    return [np.asarray(l) if not isinstance(l, torch.Tensor) else l.numpy()
            for _, l in ckpt.flatten_with_names(tree)]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_roundtrip(tmp_path):
    tree = make_tree()
    ckpt.save(tmp_path, 5, tree)
    restored, step = ckpt.restore(tmp_path, tree)
    assert step == 5
    _assert_trees_equal(tree, restored)


def test_npy_roundtrip_with_mmap_and_meta(tmp_path):
    tree = make_tree(4)
    ckpt.save(tmp_path, 7, tree, fmt="npy", meta={"backend": "single", "v": 1})
    manifest, step = ckpt.read_manifest(tmp_path)
    assert step == 7
    assert manifest["format"] == "npy"
    assert manifest["user_meta"] == {"backend": "single", "v": 1}
    restored, _ = ckpt.restore(tmp_path, tree, mmap=True, verify_crc=False)
    _assert_trees_equal(tree, restored)
    assert any(isinstance(l, np.memmap)
               for _, l in ckpt.flatten_with_names(restored))
    restored2, _ = ckpt.restore(tmp_path, tree, verify_crc=True)
    _assert_trees_equal(tree, restored2)


def test_mmap_requires_npy(tmp_path):
    tree = make_tree()
    ckpt.save(tmp_path, 1, tree)                     # default npz
    with pytest.raises(ValueError, match="npy"):
        ckpt.restore(tmp_path, tree, mmap=True)
    with pytest.raises(ValueError, match="format"):
        ckpt.save(tmp_path, 2, tree, fmt="pickle")


def test_restore_picks_latest_committed(tmp_path):
    ckpt.save(tmp_path, 1, make_tree(1))
    ckpt.save(tmp_path, 9, make_tree(9))
    (tmp_path / "step_00000099.tmp").mkdir()         # a torn write
    restored, step = ckpt.restore(tmp_path, make_tree())
    assert step == 9
    _assert_trees_equal(make_tree(9), restored)


def test_crc_detects_corruption(tmp_path):
    tree = make_tree()
    d = ckpt.save(tmp_path, 3, tree)
    man = json.loads((d / "MANIFEST.json").read_text())
    man["leaves"][0]["crc32"] ^= 0xDEAD
    (d / "MANIFEST.json").write_text(json.dumps(man))
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(tmp_path, tree)


def test_async_checkpointer(tmp_path):
    saver = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    for s in (10, 20, 30):
        saver.save_async(s, make_tree(s))
    saver.wait()
    assert ckpt.list_steps(tmp_path) == [20, 30]     # GC keeps the last 2
    restored, _ = ckpt.restore(tmp_path, make_tree())
    _assert_trees_equal(make_tree(30), restored)


def test_async_checkpointer_snapshots_on_caller_thread_and_reports(tmp_path):
    """The tree is copied when ``save_async`` returns (a later in-place
    update does not reach the file), and a failed write is raised."""
    saver = ckpt.AsyncCheckpointer(tmp_path / "ok", keep=2)
    tree = make_tree(2)
    want = make_tree(2)
    saver.save_async(1, tree)
    tree["a"][:] = 0.0
    tree["t"].zero_()
    saver.wait()
    restored, _ = ckpt.restore(tmp_path / "ok", make_tree())
    _assert_trees_equal(want, restored)
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = ckpt.AsyncCheckpointer(blocker, keep=2)
    bad.save_async(1, make_tree())
    with pytest.raises(OSError):
        bad.wait()


class _Pair(NamedTuple):
    a: object
    b: object


def test_leaf_names_are_the_references_keystr():
    """Every node kind the port's flattener knows names its leaves as
    ``jax.tree_util.keystr`` does; ``Attrs`` stands for a dataclass node."""
    ones = np.ones(2, np.float32)
    tree = {"z": [ones, (ones, None)], "a": _Pair(ones, {"q": ones})}
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [n for n, _ in ckpt.flatten_with_names(tree)] == want
    attrs = Attrs(levels=[Attrs(data=ones)], n=ones)
    assert [n for n, _ in ckpt.flatten_with_names({"idx": attrs})] == \
        ["['idx'].levels[0].data", "['idx'].n"]


@pytest.mark.parametrize("fmt", ["npz", "npy"])
def test_reference_checkpoint_restores_in_port(tmp_path, fmt):
    tree = {k: v for k, v in make_tree(3).items() if k != "t"}
    r_ckpt.save(tmp_path, 4, tree, fmt=fmt, meta={"from": "repro"})
    manifest, step = ckpt.read_manifest(tmp_path)
    assert step == 4 and manifest["user_meta"] == {"from": "repro"}
    assert [l["name"] for l in manifest["leaves"]] == \
        [n for n, _ in ckpt.flatten_with_names(tree)]
    restored, _ = ckpt.restore(tmp_path, tree, mmap=fmt == "npy")
    _assert_trees_equal(tree, restored)


@pytest.mark.parametrize("fmt", ["npz", "npy"])
def test_port_checkpoint_restores_in_reference(tmp_path, fmt):
    tree = make_tree(5)
    ckpt.save(tmp_path, 6, tree, fmt=fmt)
    like = jax.tree.map(np.asarray, {k: v for k, v in tree.items()
                                     if k != "t"} | {"t": tree["t"].numpy()})
    restored, step = r_ckpt.restore(tmp_path, like)
    assert step == 6
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(restored)[0]]
    assert names == [n for n, _ in ckpt.flatten_with_names(tree)]
    for a, b in zip(jax.tree.leaves(like), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_straggler_watchdog_matches_reference():
    ours = ft.StragglerWatchdog(alpha=0.5, threshold=2.0)
    ref = r_ft.StragglerWatchdog(alpha=0.5, threshold=2.0)
    for step, dt in enumerate([0.1] * 5 + [1.0, 0.1, 0.3, 0.05, 0.9]):
        assert ours.observe(step, dt) == ref.observe(step, dt)
        assert ours.ewma == ref.ewma
    assert ours.flagged == ref.flagged and ours.flagged
    assert ours.flagged[0] == (5, 1.0)             # 10x the EWMA -> flagged
