"""Versioned on-disk snapshots of a built
:class:`repro_torch.engine.SearchEngine`.

The compressed index is the only thing the system keeps, so a server starts
from it directly instead of rebuilding it from a corpus on every boot.  A
snapshot holds what a query needs:

    WTBCIndex            — the compressed self-index (or the stacked
                           ShardedWTBC of a document-sharded engine)
    DRBAux               — the tf bitmaps, when the engine may use them
    SCDCModel arrays     — word id <-> rank, codewords, frequencies
    EngineConfig + structural metadata — to reassemble the same engine

The format is the reference's (``repro.serve.snapshot``, format 1): the
arrays ride :mod:`repro_torch.checkpoint.ckpt` in its ``fmt="npy"`` layout,
one ``.npy`` per leaf named as the reference names its pytree leaves, and the
structure (static ``(s, c)``, block sizes, ``eps``) travels in the manifest's
``user_meta``.  A snapshot written by either package loads into the other:

* the port's host integers (``ByteMap.length``, ``WTBCIndex.n`` and
  ``n_docs``, ``BitVec.n_bits``) are written as the reference's 0-d int32
  leaves, the bitmap words as uint32, and read back as integers;
* the port's ``EngineConfig`` has no ``kernel_backend``: ``save`` writes the
  reference's ``"auto"``, and ``load`` accepts only that value (another one
  names a lowering of the reference's own kernels);
* the arrays go through :mod:`repro_torch.convert`, the same mapping that
  ``SearchEngine.from_arrays`` uses.

* a sharded engine (``backend="sharded"``) is written as the reference's
  stacked ``ShardedWTBC`` (``ShardedWTBC.stack``: ragged leaves padded to
  the largest shard) with ``n_shards`` and ``shard_axes`` (the reference's
  default mesh axis, ``"shards"``) in the metadata; ``load`` trims each
  shard back and places it by ``distributed.resolve_devices``'s rule, or
  on ``devices``.

``load`` memory-maps the leaves and makes one host -> device copy per leaf.

    snapshot.save(engine, "snap/")                 # -> version 1
    engine = snapshot.load("snap/")                # newest, on the card
    engine = snapshot.load("snap/", device="cpu")
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from repro_torch import convert
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import Attrs
from repro_torch.core import drb, wtbc
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import backend

SNAPSHOT_FORMAT = 1
# the reference's EngineConfig.kernel_backend: every value but "auto" forces
# a lowering of the reference's Pallas kernels, which the port does not have
REFERENCE_KERNEL_BACKEND = "auto"
MODEL_FIELDS = ("codes", "lens", "rank_of_word", "word_of_rank", "freqs")
# the reference's default mesh axis of a sharded engine
SHARD_AXES = "shards"
INDEX_FIELDS = ("cw", "cw_len", "node_off", "base_rank", "sep_pos", "df",
                "occ", "doc_len", "n", "n_docs")
GLOBAL_FIELDS = ("doc_base", "global_df", "global_idf", "global_avg_dl")


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _index_tree(idx: wtbc.WTBCIndex) -> Attrs:
    return Attrs(
        levels=[Attrs(data=lv.data, counts=lv.counts,
                      length=np.int32(lv.length)) for lv in idx.levels],
        offsets=list(idx.offsets),
        cw=idx.cw, cw_len=idx.cw_len, node_off=idx.node_off,
        base_rank=idx.base_rank, sep_pos=idx.sep_pos, df=idx.df, occ=idx.occ,
        doc_len=idx.doc_len, n=np.int32(idx.n), n_docs=np.int32(idx.n_docs))


def _aux_tree(aux: drb.DRBAux) -> Attrs:
    words = aux.bv.words.cpu().numpy().view(np.uint32)
    return Attrs(bv=Attrs(words=words, counts=aux.bv.counts,
                          n_bits=np.int32(aux.bv.n_bits)),
                 bit_off=aux.bit_off, has_bm=aux.has_bm)


def _stacked_tree(st: dict) -> Attrs:
    """``ShardedWTBC.stack()``'s arrays as the reference's ``ShardedWTBC``
    tree (its field order; ``s``, ``c``, ``block``, ``eps`` and
    ``n_shards`` are metadata, not leaves)."""
    a = st["idx"]
    idx = Attrs(levels=[Attrs(data=lv["data"], counts=lv["counts"],
                              length=lv["length"]) for lv in a["levels"]],
                offsets=list(a["offsets"]),
                **{f: a[f] for f in INDEX_FIELDS})
    x = st["aux"]
    aux = None if x is None else Attrs(
        bv=Attrs(words=x["words"], counts=x["counts"], n_bits=x["n_bits"]),
        bit_off=x["bit_off"], has_bm=x["has_bm"])
    return Attrs(idx=idx, aux=aux, **{f: st[f] for f in GLOBAL_FIELDS})


def _structure_meta(engine: SearchEngine, aux) -> dict:
    idx = engine.idx[0] if engine.backend == "sharded" else engine.idx
    aux = aux[0] if isinstance(aux, tuple) else aux
    config = dataclasses.asdict(engine.config)
    config["kernel_backend"] = REFERENCE_KERNEL_BACKEND
    meta = {
        "snapshot_format": SNAPSHOT_FORMAT,
        "backend": engine.backend,
        "n_docs": int(engine.n_docs),
        "config": config,
        "model": {"s": engine.model.s, "c": engine.model.c},
        "index": {"s": idx.s, "c": idx.c,
                  "blocks": [lv.block for lv in idx.levels],
                  "n_levels": len(idx.levels)},
        "has_aux": aux is not None,
        "aux_eps": None if aux is None else aux.eps,
    }
    if engine.backend == "sharded":
        meta["n_shards"] = engine.sharded.n_shards
        meta["shard_axes"] = SHARD_AXES
    return meta


def save(engine: SearchEngine, snap_dir: str | pathlib.Path,
         version: int | None = None) -> pathlib.Path:
    """Persist ``engine`` as a new snapshot version (committed atomically).

    An engine that may use DRB (``config.with_drb``) gets its tf bitmaps
    built first: no raw tokens survive a load, so the snapshot must hold
    them."""
    snap_dir = pathlib.Path(snap_dir)
    if version is None:
        existing = ckpt.list_steps(snap_dir)
        version = (existing[-1] + 1) if existing else 1
    aux = engine.aux if engine.config.with_drb else None
    model = {f: getattr(engine.model, f) for f in MODEL_FIELDS}
    if engine.backend == "sharded":
        state = {"sharded": _stacked_tree(engine.sharded.stack()),
                 "model": model}
    else:
        state = {"idx": _index_tree(engine.idx),
                 "aux": None if aux is None else _aux_tree(aux),
                 "model": model}
    return ckpt.save(snap_dir, version, state, fmt="npy",
                     meta=_structure_meta(engine, aux))


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _skeleton(meta: dict) -> dict:
    """The saved tree's structure with placeholder leaves; ``ckpt.restore``
    fills in the arrays by name."""
    n_levels = meta["index"]["n_levels"]
    idx = Attrs(levels=[Attrs(data=0, counts=0, length=0)
                        for _ in range(n_levels)],
                offsets=[0] * n_levels, **{f: 0 for f in INDEX_FIELDS})
    aux = Attrs(bv=Attrs(words=0, counts=0, n_bits=0), bit_off=0,
                has_bm=0) if meta["has_aux"] else None
    model = {f: 0 for f in MODEL_FIELDS}
    if meta["backend"] == "sharded":
        return {"sharded": Attrs(idx=idx, aux=aux,
                                 **{f: 0 for f in GLOBAL_FIELDS}),
                "model": model}
    return {"idx": idx, "aux": aux, "model": model}


def _config(meta: dict) -> EngineConfig:
    fields = dict(meta["config"])
    kb = fields.pop("kernel_backend", REFERENCE_KERNEL_BACKEND)
    if kb != REFERENCE_KERNEL_BACKEND:
        raise ValueError(f"snapshot config kernel_backend={kb!r} names a "
                         "lowering of the reference's kernels; the port "
                         f"loads only {REFERENCE_KERNEL_BACKEND!r}")
    return EngineConfig(**fields)


def list_versions(snap_dir: str | pathlib.Path) -> list[int]:
    """Committed snapshot versions, oldest first."""
    return ckpt.list_steps(snap_dir)


def load(snap_dir: str | pathlib.Path, version: int | None = None, *,
         verify: bool = True, mmap: bool = True,
         device=None, devices=None) -> SearchEngine:
    """Reassemble a ready-to-query engine from a snapshot (newest version by
    default) — no corpus, no index build, no bitmap build.

    verify:  CRC-check every leaf against the manifest (reads every page).
    mmap:    memory-map the arrays instead of reading them eagerly.
    device:  where the engine runs — the card by default, "cpu" for the
             plain PyTorch path.  A sharded snapshot's shard ``s`` goes to
             ``cuda:{s % device_count}`` (or every shard to the CPU).
    devices: sharded snapshots only — one device per shard.
    """
    manifest, version = ckpt.read_manifest(snap_dir, version)
    meta = manifest.get("user_meta") or {}
    fmt = meta.get("snapshot_format")
    if fmt != SNAPSHOT_FORMAT:
        raise ValueError(f"snapshot format {fmt!r} not supported "
                         f"(this build reads format {SNAPSHOT_FORMAT})")
    if meta["backend"] not in ("single", "sharded"):
        raise ValueError(f"unknown snapshot backend {meta['backend']!r}")
    config = _config(meta)
    state, _ = ckpt.restore(snap_dir, _skeleton(meta), step=version,
                            verify_crc=verify, mmap=mmap)
    tree = state["sharded"] if meta["backend"] == "sharded" else state
    im = meta["index"]
    index_arrays = dict(tree["idx"], s=im["s"], c=im["c"])
    index_arrays["levels"] = [dict(lv, block=b) for lv, b in
                              zip(tree["idx"]["levels"], im["blocks"])]
    model_arrays = dict(state["model"], s=meta["model"]["s"],
                        c=meta["model"]["c"])
    aux = None
    if meta["has_aux"]:
        a = tree["aux"]
        aux = dict(a["bv"], bit_off=a["bit_off"], has_bm=a["has_bm"],
                   eps=meta["aux_eps"])
    if meta["backend"] == "single":
        if devices is not None:
            raise ValueError("devices= applies to sharded snapshots only")
        return SearchEngine.from_arrays(
            index_arrays, model_arrays, config=config, aux=aux,
            device=backend.resolve_device(device))
    sharded = convert.sharded_from_reference(
        dict(tree, idx=index_arrays, aux=aux, n_shards=meta["n_shards"]),
        device=device, devices=devices)
    return SearchEngine.from_sharded(
        sharded, convert.model_from_arrays(model_arrays), config)
