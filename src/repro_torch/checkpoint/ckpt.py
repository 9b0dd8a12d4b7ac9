"""Crash-safe checkpoints of trees of arrays (the port's ``repro.checkpoint``).

Layout, shared with the reference so either package restores the other's
checkpoints:

    <dir>/step_000123/
        shard_00000.npz            (fmt="npz": every leaf in one archive)
        leaf_0.npy ... leaf_N.npy  (fmt="npy": one raw array per leaf)
        MANIFEST.json              (written LAST = commit point)

* Writes go to ``step_X.tmp/``; the leaves and then the manifest (with a
  CRC32 per leaf) are fsync'd, and the directory is renamed into place — a
  crash mid-write can never leave a manifest-bearing but incomplete
  checkpoint; restore picks the newest directory that has a manifest.
* ``AsyncCheckpointer`` copies the tree to host memory on the caller's
  thread and writes it on a background thread.
* **bfloat16** leaves are written as the reference writes them (numpy has
  no bfloat16 kind; the reference's arrays are ``ml_dtypes.bfloat16``):
  their 2-byte words as ``V2`` records, ``"dtype": "bfloat16"`` in the
  manifest, the CRC over those bytes.  ``restore`` gives them back as
  ``torch.bfloat16`` tensors.
* ``restore(..., device=...)`` places every leaf as a tensor on a device
  (one device, or a tree of them matching ``tree_like``): the reference's
  elastic restore (``shardings=``) on the port's single-device placement.

**Trees and leaf names.**  A tree is built from ``dict`` (children named
``['key']``, in sorted key order), :class:`Attrs` (children named ``.key``,
in insertion order), ``NamedTuple`` (``.field``), ``list`` / ``tuple``
(``[i]``) and ``None`` (no leaves); anything else is a leaf (a numpy array,
a tensor or a number).  These are the names ``jax.tree_util.keystr`` gives
the same structure, which is what the manifest stores.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import zlib
from typing import Any, Callable

import numpy as np
import torch


class Attrs(dict):
    """A tree node whose children are named like attributes (``.name``) in
    insertion order — how the reference names the fields of a dataclass or
    NamedTuple node."""


def _map(node, fn: Callable[[str, Any], Any], prefix: str = ""):
    """The tree with every leaf replaced by ``fn(name, leaf)``, visiting the
    leaves in the order their names are listed."""
    if node is None:
        return None
    if isinstance(node, Attrs):
        return Attrs((k, _map(v, fn, f"{prefix}.{k}"))
                     for k, v in node.items())
    if isinstance(node, dict):
        return {k: _map(node[k], fn, f"{prefix}[{k!r}]") for k in sorted(node)}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map(getattr(node, f), fn, f"{prefix}.{f}")
                            for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_map(v, fn, f"{prefix}[{i}]")
                          for i, v in enumerate(node))
    return fn(prefix, node)


def flatten_with_names(tree) -> list[tuple[str, Any]]:
    """``(name, leaf)`` pairs in the order the manifest lists them."""
    out: list[tuple[str, Any]] = []
    _map(tree, lambda name, leaf: out.append((name, leaf)))
    return out


def tree_leaves(tree) -> list:
    """The leaves in the manifest's order: ``jax.tree.leaves``'s order for
    the same structure (dict keys sorted)."""
    return [leaf for _, leaf in flatten_with_names(tree)]


def tree_map(fn: Callable[[Any], Any], tree):
    """The tree with every leaf replaced by ``fn(leaf)``, the leaves visited
    in ``tree_leaves``'s order."""
    return _map(tree, lambda _, leaf: fn(leaf))


BF16 = np.dtype("V2")        # a bfloat16 leaf's records on disk


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array; a ``torch.bfloat16`` tensor as its
    2-byte words (``BF16`` records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16)
        return t.numpy()
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _fsync(path: pathlib.Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save(ckpt_dir: str | pathlib.Path, step: int, tree, *, fmt: str = "npz",
         meta: dict | None = None) -> pathlib.Path:
    """Synchronous crash-safe save of a tree.

    fmt:  "npz" packs every leaf into one zipped archive; "npy" writes one
          raw ``.npy`` per leaf, which ``restore`` can memory-map (the
          serving snapshots' load path).
    meta: JSON-serializable caller metadata committed atomically with the
          arrays (``read_manifest`` returns it).
    """
    if fmt not in ("npz", "npy"):
        raise ValueError(f"unknown checkpoint format {fmt!r}")
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)

    named = flatten_with_names(tree)
    arrays = {f"leaf_{i}": _host(l) for i, (_, l) in enumerate(named)}
    if fmt == "npz":
        files = [tmp / "shard_00000.npz"]
        np.savez(files[0], **arrays)
    else:
        files = []
        for key, arr in arrays.items():
            files.append(tmp / f"{key}.npy")
            np.save(files[-1], arr)
    manifest = {
        "step": step,
        "format": fmt,
        "leaves": [{"name": n, "key": key,
                    "shape": list(arrays[key].shape),
                    "dtype": ("bfloat16" if arrays[key].dtype == BF16
                              else str(arrays[key].dtype)),
                    "crc32": _crc(arrays[key])}
                   for (n, _), key in zip(named, arrays)],
        "n_shards": 1,
        "user_meta": meta or {},
    }
    mpath = tmp / "MANIFEST.json"
    with open(mpath, "w") as f:
        f.write(json.dumps(manifest, indent=1))
        f.flush()
        os.fsync(f.fileno())
    for p in files:
        _fsync(p)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic commit
    _fsync(ckpt_dir)
    return final


class AsyncCheckpointer:
    """Copy to host on the caller's thread; write on a daemon thread.  A
    failed write is raised by the next :meth:`wait` (or ``save_async``)."""

    def __init__(self, ckpt_dir: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree):
        self.wait()                              # one outstanding write max
        host_tree = _map(tree, lambda _, l: np.array(_host(l)))  # copy now

        def work():
            try:
                save(self.dir, step, host_tree)
                self._gc()
            except BaseException as e:           # handed to wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(list_steps(self.dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)


def list_steps(ckpt_dir: str | pathlib.Path) -> list[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    out = []
    if not ckpt_dir.exists():
        return out
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "MANIFEST.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def read_manifest(ckpt_dir: str | pathlib.Path,
                  step: int | None = None) -> tuple[dict, int]:
    """The committed manifest (and resolved step) without loading any
    arrays — snapshot loaders read ``user_meta`` first to build the skeleton
    tree ``restore`` fills in."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    return json.loads((d / "MANIFEST.json").read_text()), step


def _bf16_tensor(arr: np.ndarray) -> torch.Tensor:
    """A ``torch.bfloat16`` tensor (CPU) from a leaf's 2-byte records."""
    return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)


def _placed(leaf, device) -> torch.Tensor:
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.from_numpy(np.array(leaf))
    return leaf.to(device)


def restore(ckpt_dir: str | pathlib.Path, tree_like, step: int | None = None,
            verify_crc: bool = True, mmap: bool = False, device=None):
    """Restore into the structure of ``tree_like`` (leaves matched by name);
    returns ``(tree, step)`` with numpy leaves, except that a bfloat16 leaf
    comes back as a ``torch.bfloat16`` tensor.

    ``mmap``: memory-map leaves instead of reading them (``fmt="npy"``
    checkpoints only) — the arrays alias the files, so nothing is read until
    a consumer touches the pages.  Combine with ``verify_crc=False`` for a
    lazy load: CRC verification reads every page.
    ``device``: place every leaf as a tensor on a device — one device (or
    name) for the whole tree, or a tree of them with ``tree_like``'s
    structure (the reference's ``shardings=`` elastic restore: a leaf goes
    where the caller runs now, whatever wrote it).
    """
    manifest, step = read_manifest(ckpt_dir, step)
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    fmt = manifest.get("format", "npz")
    if mmap and fmt != "npy":
        raise ValueError(f"mmap restore needs an fmt='npy' checkpoint, "
                         f"found {fmt!r}")
    if fmt == "npz":
        data = np.load(d / "shard_00000.npz")
        fetch = lambda key: data[key]                       # noqa: E731
    else:
        fetch = lambda key: np.load(d / f"{key}.npy",       # noqa: E731
                                    mmap_mode="r" if mmap else None)
    by_name = {l["name"]: l for l in manifest["leaves"]}

    def load(name, _):
        if name not in by_name:
            raise KeyError(f"checkpoint step {step} has no leaf {name}")
        meta = by_name[name]
        arr = fetch(meta["key"])
        if verify_crc:
            crc = _crc(arr)
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint corruption on leaf {name} "
                              f"(crc {crc} != {meta['crc32']})")
        if meta["dtype"] == "bfloat16":
            return _bf16_tensor(arr)
        return arr

    restored = _map(tree_like, load)
    if device is None:
        return restored, step
    if isinstance(device, (str, torch.device)):
        return tree_map(lambda leaf: _placed(leaf, device), restored), step
    where = dict(flatten_with_names(device))
    return _map(restored, lambda name, leaf: _placed(leaf, where[name])), step
