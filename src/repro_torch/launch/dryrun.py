"""Dry run: every (architecture x input-shape) cell accounted for per device
on a mesh, without a compiler.  The port's counterpart of
``repro.launch.dryrun``.

The port has no compiler and no placeholder devices: where the reference
lowers and compiles each cell with XLA's SPMD partitioner on 512 simulated
host devices and reads the compiled module's memory, cost and collectives,
nothing here partitions a step.  For each cell on a :class:`MeshShape` it
writes one JSON record holding:

* **argument bytes per device** — parameters, the AdamW state on ``train``
  cells, and the step's inputs, each leaf from its shape, dtype and spec:
  every sharded dimension ceil-divided by the product of the mesh axes its
  spec names (XLA pads a dimension that does not divide the same way).
  This number is exact.
* **counted FLOPs** — ``torch.utils.flop_counter.FlopCounterMode`` over the
  step run once on ``meta`` tensors at full width: a global total, and per
  device under an even-split assumption.  The counter sees matmul-like ops
  only (an FM tower counts almost nothing).
* **the MoE layers' program** — the step is built with the cell's mesh
  (``make_step(cfg, kind, mesh=...)``), so where the reference lowers a MoE
  layer through expert parallelism (a mesh with a ``model`` axis, the
  tokens splitting into its ``pod`` x ``data`` blocks, the experts into its
  shards) the port counts its own EP path (``models/moe.moe_apply_ep``):
  per-block capacity, doubled, E/M experts a shard.  Each device runs one
  (block, shard) pair a layer, all of one shape, so for the expert part
  ``per_device = global / mesh.size`` is exact; the router runs once a
  block (the reference's M shards of a block each run the same routing,
  1/M of it here).  Running every pair on ``meta`` takes minutes a layer
  at full width, so the count runs the first b blocks' first m shards'
  pairs of every layer for (b, m) = (1, 1), (2, 1), (1, 2), (2, 2), the
  other pairs returning zeros (``_pairs_run``), and extrapolates: the
  counts are bilinear in (b, m) — pair work b x m, each shard's gradient
  taken back to its experts' (E, ...) leaf m times, the gates' and the
  block's gradients gathered over the m shards b times.
  An EP cell is counted with the rematerialized replay's early stop off
  (``torch.utils.checkpoint.set_checkpoint_early_stop``): each replay then
  runs its whole layer, as the reference's remat does, and visits every
  pair, so the pairs line up; with early stop on, a replay ends where the
  last pairs return zeros.  ``test_torch_dryrun.py`` holds the
  extrapolation equal to running every pair on a small mesh, FLOPs and
  bytes exactly, with remat and without.  Such a record's ``"moe"`` entry gives the layout
  and one pair's forward FLOPs (the experts' ``3 x 2 x E_loc x C x D x
  F``) beside the router's on a block.
* **counted bytes** — a ``TorchDispatchMode`` that sums every aten op's input
  and output bytes (views excluded): the traffic of the eager, unfused
  step, global and per device (even split).
* **model FLOPs** — ``analysis/roofline.model_flops_for`` (the reference's
  analytic formulas).
* **collectives: null** — with no partitioner there are no collective bytes
  to count.  Real counts would come from DTensor placements over a fake
  process group under ``CommDebugMode`` (ROADMAP).  On an EP cell the note
  names the first term to count: the ``psum`` of each MoE layer's (T_loc,
  D) partials, ``2 x T_loc x D x bytes`` per device.

Three cells need help to run on ``meta``: decode gets the shape's cache
length as a Python int (``seq - 1``, the last slot of the cache); SASRec's
``retrieval_cand`` counts the gather and the user's step on ``meta`` and adds
K6's work from ``kernels/topk_score.work`` (its kernel runs on the card
only); the tabular towers' ``retrieval_cand`` counts one chunk of
``recsys.retrieval_chunk`` rows and multiplies by the number of chunks
(every chunk has the same size by design), then counts the top-k once.

``wtbc`` cells hold the per-device bytes of ``wtbc_paper.abstract_sharded``
plus the replicated global tables and the queries; their FLOPs and bytes are
null, because the search loops are data-dependent.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single   # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi    # 2x16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh local [--device cpu]

Artifacts: ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``
(existing ones are kept unless ``--force``); ``analysis/roofline.py``
reads them.  The run exits 1 if any cell that is not skipped failed.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils import checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline
from repro_torch.configs import base, recsys_common, registry, wtbc_paper
from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.kernels import topk_score
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import moe, recsys
from repro_torch.optim import adamw

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"

KIND_ARGS = {
    "train": ("batch",),
    "prefill": ("tokens",),
    "decode": ("caches", "tokens", "cache_len"),
    "serve": ("batch",),
    "retrieval": ("batch",),
}

EVEN_SPLIT = ("global count / devices: an even split of the whole step "
              "over the mesh, not a partitioned count")
FLOPS_NOTE = ("torch.utils.flop_counter over the eager step on meta tensors; "
              "matmul-like ops only")
BYTES_NOTE = ("every aten op's input and output bytes, views excluded: the "
              "eager, unfused step's traffic")
NO_COLLECTIVES = ("no partitioner: nothing partitions the step, so no "
                  "collective bytes are counted (ROADMAP: DTensor placements "
                  "over a fake process group under CommDebugMode)")
EP_COLLECTIVES = ("; EP's psum of each MoE layer's (T_loc, D) partial "
                  "outputs, 2 x T_loc x D x bytes per device a layer (the "
                  "record's moe.psum_bytes_per_layer), is the first term to "
                  "count (ROADMAP Queue 1 item 8)")
EP_COUNT = ("the pairs of the first b blocks' first m shards counted for "
            "(b, m) = (1, 1), (2, 1), (1, 2), (2, 2) and extrapolated "
            "bilinearly to every pair; the router runs once a block")


# ---------------------------------------------------------------------------
# argument bytes
# ---------------------------------------------------------------------------

def leaves_with_specs(tree, specs, name: str = "") -> list[tuple]:
    """``(name, tensor, spec)`` of every tensor leaf of ``tree``, its spec
    read from the same place in ``specs`` (a tuple of mesh-axis entries);
    names as ``checkpoint.ckpt`` (``jax.tree_util.keystr``) gives them.
    Non-tensor leaves (static fields) are skipped."""
    if isinstance(tree, torch.Tensor):
        return [(name, tree, tuple(specs))]
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_specs(tree[k], specs[k], f"{name}[{k!r}]")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += leaves_with_specs(getattr(tree, f), getattr(specs, f),
                                     f"{name}.{f}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, (t, s) in enumerate(zip(tree, specs, strict=True)):
            out += leaves_with_specs(t, s, f"{name}[{i}]")
        return out
    return []


def device_bytes(t: torch.Tensor, spec: tuple, mesh: MeshShape) -> int:
    """Bytes of ``t``'s block on one device: every dimension ceil-divided by
    the product of the mesh axes its spec entry names (an entry past the
    spec's length, or None, leaves the dimension whole)."""
    if len(spec) > t.dim():
        raise ValueError(f"spec {spec} has more entries than {t.dim()} dims")
    sizes = mesh.shape
    n = 1
    for i, dim in enumerate(t.shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (entry,) if isinstance(entry, str) \
            else tuple(entry)
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n * t.element_size()


def cell_config(arch, cell: base.Cell, cfg_override=None):
    cfg = arch.config_for(cell.shape)
    return cfg if cfg_override is None else cfg_override(cfg)


def argument_trees(arch, cell: base.Cell, cfg, rules,
                   inputs: dict | None = None) -> list[tuple[str, object, object]]:
    """``(group, meta tree, spec tree)`` of the step's arguments in call
    order: ``params``, ``opt_state`` (train), then the kind's inputs
    (``inputs`` overrides ``arch.abstract_inputs``)."""
    params = arch.abstract_params(cfg)
    pspecs = arch.param_specs(cfg, rules)
    inputs = arch.abstract_inputs(cfg, cell.shape) if inputs is None \
        else inputs
    ispecs = arch.input_specs(cfg, cell.shape, rules)
    out = [("params", params, pspecs)]
    if cell.kind == "train":
        out.append(("opt_state", adamw.init_state(params),
                    adamw.state_specs(pspecs)))
    out += [(n, inputs[n], ispecs[n]) for n in KIND_ARGS[cell.kind]]
    return out


def wtbc_arguments(arch, cell: base.Cell, cfg, mesh: MeshShape
                   ) -> list[tuple[str, object, object]]:
    """``(group, meta tree, spec tree)`` of a wtbc cell: the shards (one per
    device of the mesh), the replicated global tables and the queries."""
    sh = wtbc_paper.abstract_sharded(cfg, mesh.size)
    specs = arch.sharded_specs(sh, mesh.axis_names)
    glob = wtbc_paper.GLOBAL_LEAVES
    inputs = arch.abstract_inputs(cfg, cell.shape)
    ispecs = arch.input_specs(cfg, cell.shape, None)
    return [("index", {k: v for k, v in sh.items() if k not in glob},
             {k: v for k, v in specs.items() if k not in glob}),
            ("global_tables", {k: sh[k] for k in glob},
             {k: specs[k] for k in glob}),
            ("inputs", inputs, ispecs)]


def argument_leaves(arch, cell: base.Cell, mesh: MeshShape, *,
                    cfg_override=None, inputs: dict | None = None
                    ) -> list[tuple[str, str, int]]:
    """``(group, leaf name, bytes on one device)`` of every argument leaf of
    ``cell`` on ``mesh`` (``inputs`` overrides the shape's abstract
    inputs, e.g. a cut batch)."""
    rules = base.make_rules(mesh.axis_names, cell)
    cfg = cell_config(arch, cell, cfg_override)
    groups = wtbc_arguments(arch, cell, cfg, mesh) if arch.name == "wtbc" \
        else argument_trees(arch, cell, cfg, rules, inputs)
    return [(g, n, device_bytes(t, s, mesh))
            for g, tree, specs in groups
            for n, t, s in leaves_with_specs(tree, specs)]


def argument_bytes(leaves: list[tuple[str, str, int]]) -> dict[str, int]:
    """Per-group sums of ``argument_leaves`` and their ``total``."""
    out: dict[str, int] = {}
    for g, _, b in leaves:
        out[g] = out.get(g, 0) + b
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# counting on meta tensors
# ---------------------------------------------------------------------------

class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs (view
    ops, which move nothing, excluded)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for x in tree_flatten((args, kwargs, out))[0]:
                if isinstance(x, torch.Tensor):
                    self.bytes += x.numel() * x.element_size()
        return out


class Counts:
    """FLOPs and bytes of one cell, summed over the calls ``run`` counts."""

    def __init__(self):
        self.flops = 0
        self.bytes = 0

    def run(self, fn, *args, times: int = 1):
        """``fn(*args)`` once under both counters; its counts added
        ``times`` times."""
        fc, bc = FlopCounterMode(display=False), ByteCounter()
        with fc, bc:
            out = fn(*args)
        self.flops += times * fc.get_total_flops()
        self.bytes += times * bc.bytes
        return out

    def add(self, flops: int, nbytes: int):
        self.flops += flops
        self.bytes += nbytes


def step_tokens(cell: base.Cell) -> int | None:
    """Tokens a MoE layer of an LM cell's step sees (B x S, or B for
    decode); None for other families."""
    m = LM_SHAPES.get(cell.shape)
    if m is None:
        return None
    return m["batch"] * (1 if cell.kind == "decode" else m["seq"])


def ep_layout(arch, cell: base.Cell, cfg, mesh: MeshShape | None
              ) -> dict | None:
    """How the cell's MoE layers split over ``mesh`` where they take
    expert parallelism (``moe.use_ep``), else None."""
    if arch.family != "lm" or cfg.moe is None or mesh is None:
        return None
    T = step_tokens(cell)
    if not moe.use_ep(T, cfg.moe, mesh):
        return None
    blocks, M = moe.token_blocks(mesh), mesh.shape["model"]
    t_loc = T // blocks
    return {"path": "ep", "tokens": T, "blocks": blocks, "shards": M,
            "pairs": blocks * M, "tokens_per_block": t_loc,
            "experts_per_shard": cfg.moe.n_experts // M,
            "capacity": moe.ep_capacity(t_loc, cfg.moe, M),
            "moe_layers": cfg.n_layers,
            # the reference's psum of the (T_loc, D) partials: a ring
            # all-reduce moves about twice the tensor a device
            "psum_bytes_per_layer": 2 * t_loc * cfg.d_model * torch.empty(
                (), dtype=cfg.dtype).element_size()}


def ep_pair_flops(cfg, layout: dict) -> dict:
    """One (block, shard) pair's forward FLOPs on ``meta``: the experts'
    batched matmuls (``3 x 2 x E_loc x C x D x F``); and the router's on a
    block, which each device of the reference runs."""
    p = moe.init_moe(None, cfg.d_model, cfg.moe, cfg.dtype, device="meta")
    x = base.meta((layout["tokens_per_block"], cfg.d_model), cfg.dtype)
    with FlopCounterMode(display=False) as router:
        gates, eidx, _, _ = moe._router(p, x, cfg.moe)
    shard = moe._shard_params(p, cfg.moe, 0, layout["shards"])
    with FlopCounterMode(display=False) as experts:
        moe._ep_shard(shard, x, gates, eidx, 0, layout["capacity"])
    return {"expert_flops_per_device_per_layer": experts.get_total_flops(),
            "router_flops_per_device_per_layer": router.get_total_flops()}


@contextlib.contextmanager
def _pairs_run(blocks: int, shards: int, layout: dict):
    """Inside, every EP layer runs only the pairs of its first ``blocks``
    blocks' first ``shards`` shards; every other pair returns zeros.
    ``moe_apply_ep`` visits a layer's pairs block by block, shard by shard,
    each layer (and, with early stop off, each rematerialized replay) all
    of them, so the call count places each call."""
    real, calls = moe._ep_shard, itertools.count()

    def pair(ps, xb, gates, eidx, m, C):
        b, s = divmod(next(calls) % layout["pairs"], layout["shards"])
        if b < blocks and s < shards:
            return real(ps, xb, gates, eidx, m, C)
        return torch.zeros_like(xb)
    moe._ep_shard = pair
    try:
        yield
    finally:
        moe._ep_shard = real


def count_step(arch, cell: base.Cell, cfg, mesh: MeshShape | None = None,
               *, every_pair: bool = False) -> Counts:
    """The cell's step run on ``meta`` tensors at ``cfg``'s widths under
    the counters (module docstring), built with ``mesh`` for the LM
    family.  Where its MoE layers take expert parallelism, the pairs of
    one and two blocks and shards are counted and the rest extrapolated
    (module docstring); ``every_pair`` runs every pair instead."""
    layout = ep_layout(arch, cell, cfg, mesh)
    if layout is None:
        return _count_once(arch, cell, cfg, mesh)
    with checkpoint.set_checkpoint_early_stop(False):
        if every_pair or layout["pairs"] < 2:
            return _count_once(arch, cell, cfg, mesh)
        B, M = layout["blocks"], layout["shards"]
        c = {}
        for b, m in {(1, 1), (min(B, 2), 1), (1, min(M, 2)),
                     (min(B, 2), min(M, 2))}:
            with _pairs_run(b, m, layout):
                got = _count_once(arch, cell, cfg, mesh)
            c[b, m] = (got.flops, got.bytes)

    def extrapolate(i: int) -> int:
        # f(b, m) = f11 + alpha (m - 1) + delta (b - 1) + beta (b m - 1)
        f11 = c[1, 1][i]
        if B == 1:
            return f11 + (M - 1) * (c[1, 2][i] - f11)
        if M == 1:
            return f11 + (B - 1) * (c[2, 1][i] - f11)
        beta = c[2, 2][i] - c[2, 1][i] - c[1, 2][i] + f11
        alpha = c[1, 2][i] - f11 - beta
        delta = c[2, 1][i] - f11 - beta
        return f11 + alpha * (M - 1) + delta * (B - 1) + beta * (B * M - 1)
    counts = Counts()
    counts.add(extrapolate(0), extrapolate(1))
    return counts


def _count_once(arch, cell: base.Cell, cfg, mesh) -> Counts:
    counts = Counts()
    params = arch.abstract_params(cfg)
    inputs = arch.abstract_inputs(cfg, cell.shape)
    step = arch.make_step(cfg, cell.kind, mesh=mesh) \
        if arch.family == "lm" else arch.make_step(cfg, cell.kind)
    if cell.kind == "train":
        counts.run(step, params, adamw.init_state(params), inputs["batch"])
    elif cell.kind == "prefill":
        counts.run(step, params, inputs["tokens"])
    elif cell.kind == "decode":
        counts.run(step, params, inputs["caches"], inputs["tokens"],
                   LM_SHAPES[cell.shape]["seq"] - 1)
    elif cell.kind == "serve":
        counts.run(step, params, inputs["batch"])
    elif cell.kind == "retrieval":
        _count_retrieval(counts, params, inputs["batch"], cfg)
    else:
        raise ValueError(cell.kind)
    return counts


def _count_retrieval(counts: Counts, params, batch: dict, cfg) -> None:
    C, k = batch["candidates"].shape[0], recsys_common.RETRIEVAL_K
    if cfg.interaction == "self-attn-seq":
        cands, h = counts.run(recsys.sasrec_candidates, params, batch, cfg)
        nbytes, ops = topk_score.work(1, C, h.shape[0], cands.element_size(),
                                      k, False)
        counts.add(ops, nbytes)
        return
    n = recsys.retrieval_chunk(cfg)
    one = dict(batch, candidates=base.meta((n,), base.I32))
    counts.run(recsys.candidate_scores, params, one, cfg, times=-(-C // n))
    counts.run(recsys.top_k, base.meta((C,), base.F32), k)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def lower_cell(arch, cell: base.Cell, mesh: MeshShape, mesh_name: str,
               cfg_override=None, counted: dict | None = None) -> dict:
    """One cell's record on ``mesh`` (module docstring); ``cfg_override``
    maps the shape's config to the one to account (e.g. the smoke widths).
    ``counted`` keeps each cell's global counts for the next mesh where
    they do not depend on it (an EP cell's do: its key holds the mesh)."""
    t0 = time.time()
    rules = base.make_rules(mesh.axis_names, cell)
    rec = {"cell": cell.cell_id, "kind": cell.kind, "mesh": mesh_name,
           "mesh_shape": mesh.shape, "rules": dict(rules.rules)}
    leaves = argument_leaves(arch, cell, mesh, cfg_override=cfg_override)
    rec["argument_bytes"] = argument_bytes(leaves)
    rec["argument_tensors"] = len(leaves)
    rec["argument_bytes_note"] = ("exact, per device: every sharded "
                                  "dimension ceil-divided by its mesh axes")
    if arch.name == "wtbc":
        rec.update(flops=None, bytes=None, model_flops=None,
                   counts_note="data-dependent search loops: not counted")
    else:
        cfg = cell_config(arch, cell, cfg_override)
        layout = ep_layout(arch, cell, cfg, mesh)
        key = cell.cell_id if layout is None else (cell.cell_id, mesh.sizes)
        counts = None if counted is None else counted.get(key)
        if counts is None:
            counts = count_step(arch, cell, cfg, mesh)
        if counted is not None:
            counted[key] = counts
        rec["flops"] = {"global": counts.flops,
                        "per_device": counts.flops / mesh.size,
                        "note": FLOPS_NOTE, "per_device_note": EVEN_SPLIT}
        rec["bytes"] = {"global": counts.bytes,
                        "per_device": counts.bytes / mesh.size,
                        "note": BYTES_NOTE, "per_device_note": EVEN_SPLIT}
        rec["model_flops"] = roofline.model_flops_for(cell.cell_id, cell.kind) \
            if cfg_override is None else None
        rec["flops_note"] = arch.flops_note(cfg)
        if layout is not None:
            rec["moe"] = {**layout, **ep_pair_flops(cfg, layout),
                          "count": EP_COUNT}
    rec.update({"ok": True, "collectives": None,
                "collectives_note": NO_COLLECTIVES + (
                    EP_COLLECTIVES if "moe" in rec else ""),
                "count_s": round(time.time() - t0, 2)})
    return rec


def mesh_for(name: str, device=None) -> MeshShape:
    if name == "local":
        return mesh_lib.make_local_mesh(device)
    return mesh_lib.make_production_mesh(multi_pod=name == "multi")


def run(mesh_name: str, arch_filter: str | None = None,
        shape_filter: str | None = None, force: bool = False,
        include_paper: bool = True, device=None,
        art: pathlib.Path = ART, counted: dict | None = None) -> int:
    """Every selected cell's record under ``art/<mesh_name>``; returns the
    number of cells that failed (``counted``: as ``lower_cell``'s)."""
    mesh = mesh_for(mesh_name, device)
    outdir = pathlib.Path(art) / mesh_name
    outdir.mkdir(parents=True, exist_ok=True)
    failures = 0
    for cell in registry.all_cells(include_paper=include_paper):
        if arch_filter and cell.arch != arch_filter:
            continue
        if shape_filter and cell.shape != shape_filter:
            continue
        path = outdir / f"{cell.arch}__{cell.shape}.json"
        if path.exists() and not force:
            print(f"[skip-cached] {cell.cell_id}")
            continue
        if cell.skip:
            rec = {"cell": cell.cell_id, "mesh": mesh_name, "ok": True,
                   "skipped": cell.skip}
            path.write_text(json.dumps(rec, indent=1))
            print(f"[skip-by-design] {cell.cell_id}: {cell.skip}")
            continue
        print(f"[count] {cell.cell_id} on {mesh_name} ...", flush=True)
        try:
            rec = lower_cell(registry.get(cell.arch), cell, mesh, mesh_name,
                             counted=counted)
            fl = rec["flops"]["global"] if rec["flops"] else float("nan")
            print(f"  ok: {rec['count_s']}s args/device "
                  f"{rec['argument_bytes']['total']:.4e} B flops {fl:.3e}",
                  flush=True)
        except Exception as e:   # a failed cell is recorded, the run goes on
            failures += 1
            rec = {"cell": cell.cell_id, "mesh": mesh_name, "ok": False,
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"  FAILED: {type(e).__name__}: {str(e)[:300]}", flush=True)
        path.write_text(json.dumps(rec, indent=1))
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry run of every cell: "
                                 "per-device argument bytes and counted work")
    ap.add_argument("--mesh", choices=("single", "multi", "both", "local"),
                    default="both")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--device", default=None,
                    help="--mesh local: the card (default) or cpu")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures, counted = 0, {}
    for m in meshes:
        failures += run(m, args.arch, args.shape, args.force,
                        device=args.device, counted=counted)
    print(f"dry-run complete; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
