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
* **collectives** — the reference's record, ``{kind: {"count", "bytes"},
  "total_bytes"}`` over ``COLLECTIVES``, per device, with its byte model:
  an all-reduce moves twice its payload, every other kind once; the payload
  is the op's largest tensor (a gather's output, a reduce-scatter's input).
  Where the counts come from:

  - **``wtbc`` cells** (the paper's deployment): the merge's own list,
    ``core/distributed.merge_collectives`` over the mesh's axes at the
    config's batch and k — per axis two all-gathers and one reduction per
    loop counter.  Exact.
  - **every other cell**: each argument placed as a ``DTensor`` by its spec
    (``place``) on a device mesh of the mesh's shape over a ``fake``
    process group (``fake_mesh``: one device's program, its collectives
    issued and not run), the step run on ``meta`` under
    ``implicit_replication`` (tensors the step makes are replicated),
    ``CommDebugMode`` and ``CollectiveLog``, which reads each functional
    collective's kind and payload, with two of ``DTensor``'s rules changed
    (``counting_rules``: a view that would split a dimension unevenly
    reshards instead of raising, and ``log_sigmoid_backward`` gets the
    pointwise rule it lacks).  The in-step constraints are the
    reference's, at its sites and by its logical names
    (``layers.constrain``), and they act: each pins its tensor's layout
    where the reference's code names one (``CONSTRAIN_NOTE``; the
    reference's own raise on its ``Explicit`` meshes and are skipped,
    ROADMAP R13).  Between them ``DTensor`` chooses each op's placements,
    and its rules change between torch releases, so the record names the
    release (``collectives_torch``).  Where ``DTensor`` has no sharding
    rule for an op of the step, or its propagation fails there, the
    record's ``collectives`` is null and ``collectives_stopped_at`` names
    the op.  These are ``DTensor``'s collectives for the port's program,
    not XLA's: the reference's partitioner and combiner choose others
    (``test_torch_collectives.py`` pins both).
  - **EP's ``psum``** (an EP cell's ``moe.psum``): one all-reduce of the
    (T_loc, D) partial outputs per MoE layer, 2 x T_loc x D x bytes, from
    the layout, the one source of the number.  The ``DTensor`` run stands
    in for each EP layer with one device's program of the reference's
    ``shard_map`` (``_ep_dtensor``), which issues that all-reduce where
    the layer's partial output becomes replicated
    (``test_torch_collectives.py`` holds the two equal).

  The reference's ``probe_groups`` is not ported: it compiles one and two
  layer groups because XLA's cost analysis counts a ``scan`` body once,
  and the port runs and counts every layer.

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
import re
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils import checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import roofline
from repro_torch.configs import base, recsys_common, registry, wtbc_paper
from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.core import distributed
from repro_torch.kernels import topk_score
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import layers as L
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
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
#: the functional collectives DTensor issues, by the reference's kinds
FUNCOL_KINDS = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_reduce_coalesced_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_out": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_out": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "isend": "collective-permute", "irecv": "collective-permute",
                "batch_p2p_ops": "collective-permute"}
#: functional ops that move nothing (the others raise: e.g. a broadcast
#: has no kind in ``COLLECTIVES``)
FUNCOL_QUIET = ("wait_tensor", "_wrap_tensor_autograd")
WTBC_COLLECTIVES = ("the merge's own collectives (core/distributed."
                    "merge_collectives): per shard axis an all-gather of the "
                    "documents and one of the scores, then one all-reduce per "
                    "loop counter; exact")
DTENSOR_COLLECTIVES = ("DTensor's collectives for one device of the mesh: "
                       "arguments placed by their specs over a fake process "
                       "group, the step run on meta under CommDebugMode")
CONSTRAIN_NOTE = ("the in-step constraints act (layers.constrain at the "
                  "reference's sites); the reference's own raise on its "
                  "Explicit jax.make_mesh axes and are skipped (ROADMAP R13)")
NO_RULE = "DTensor has no sharding rule for {op}: no collectives counted"
NO_PROPAGATION = ("DTensor's sharding propagation failed for {op} ({why}): "
                  "no collectives counted")
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


def ep_psum(cfg, layout: dict) -> dict:
    """EP's ``psum``: one all-reduce of the (T_loc, D) partial outputs per
    MoE layer, its bytes counted twice (``psum_bytes_per_layer``)."""
    n = layout["moe_layers"]
    return {"count": n, "bytes": n * layout["psum_bytes_per_layer"],
            "shape": [layout["tokens_per_block"], cfg.d_model],
            "dtype": str(cfg.dtype).removeprefix("torch.")}


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
# collectives
# ---------------------------------------------------------------------------

def collective_record(ops: list[dict]) -> dict:
    """The reference's record of a list of ops (each with its ``kind`` and
    its payload ``bytes``): per kind the count and the bytes, an all-reduce
    counted twice, and ``total_bytes``."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for op in ops:
        out[op["kind"]]["count"] += 1
        out[op["kind"]]["bytes"] += (2 if op["kind"] == "all-reduce" else 1) \
            * op["bytes"]
    out["total_bytes"] = sum(v["bytes"] for v in out.values())
    return out


def wtbc_collectives(arch, cell: base.Cell, cfg, mesh: MeshShape
                     ) -> list[dict]:
    """The ops of a ``wtbc`` cell's merge over every axis of ``mesh``
    (``distributed.merge_collectives``), each with its payload bytes."""
    ops = distributed.merge_collectives(
        cfg.query_batch, cfg.k, tuple(zip(mesh.axis_names, mesh.sizes)),
        has_pad=wtbc_paper.SHAPES[cell.shape] != "drb-or")
    for op in ops:
        op["bytes"] = math.prod(op["shape"]) * op["dtype"].itemsize
        op["dtype"] = str(op["dtype"]).removeprefix("torch.")
    return ops


@contextlib.contextmanager
def fake_mesh(mesh: MeshShape):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names over a ``fake``
    process group of ``mesh.size`` ranks (this process is rank 0: its
    collectives are issued, with their shapes, and not run).  The group is
    process-global: it is destroyed on the way out, and entering while
    another is up raises."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", mesh.sizes,
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def place(tree, specs, dm):
    """``tree`` with every tensor leaf a ``DTensor`` on ``dm``: its spec's
    placements (``layers.placements``), the local block this rank holds (a
    dimension its axes do not divide is cut as ``torch.chunk`` cuts it) on
    ``meta``.  Other leaves are kept."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    if isinstance(tree, torch.Tensor):
        pl = L.placements(tuple(specs), tuple(dm.mesh_dim_names), tree.dim())
        shape, _ = compute_local_shape_and_global_offset(tree.shape, dm, pl)
        local = torch.empty(shape, dtype=tree.dtype, device="meta")
        return DTensor.from_local(local, dm, pl, run_check=False,
                                  shape=tree.shape, stride=tree.stride())
    if isinstance(tree, dict):
        return {k: place(v, specs[k], dm) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(getattr(tree, f), getattr(specs, f), dm)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(t, s, dm)
                          for t, s in zip(tree, specs, strict=True))
    return tree


class CollectiveLog(TorchDispatchMode):
    """Every functional collective issued under it (``DTensor`` desugars its
    redistributions into them): its kind (``FUNCOL_KINDS``), the shape and
    dtype of its largest tensor and that tensor's bytes, the payload."""

    def __init__(self):
        super().__init__()
        self.ops: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor desugar first
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name not in FUNCOL_QUIET:
            if name not in FUNCOL_KINDS:
                raise NotImplementedError(f"collective {func} is not counted")
            big = max((x for x in tree_flatten((args, kwargs, out))[0]
                       if isinstance(x, torch.Tensor)),
                      key=lambda x: x.numel() * x.element_size())
            self.ops.append({"kind": FUNCOL_KINDS[name],
                             "shape": tuple(big.shape),
                             "dtype": str(big.dtype).removeprefix("torch."),
                             "bytes": big.numel() * big.element_size()})
        return out


def _ep_dtensor(params: dict, x, cfg, mesh=None):
    """One device's program of the reference's ``_moe_ep_shardmap`` on
    ``DTensor`` activations and weights over a device mesh with a ``model``
    axis (``moe.moe_apply_ep``'s signature; the ``MeshShape`` is read from
    ``x``'s mesh).  Its ``in_specs`` are redistributions — the tokens split
    over the mesh's ``pod`` x ``data`` axes and replicated over ``model``,
    the experts split over ``model`` only, the router and the shared expert
    replicated — and the pair runs ``moe._router`` and ``moe._ep_shard`` on
    the local blocks (``to_local``, whose gradients are partial over the
    axes the block is replicated on, as ``shard_map`` transposes them).
    The partial output comes back ``Partial`` over ``model``
    (``from_local``) and is made replicated there: the ``psum``
    (``_ep_psum``).  ``aux`` is the mean over every axis (the reference's
    ``pmean``s)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm = x.device_mesh
    names = tuple(dm.mesh_dim_names)
    tok = tuple(a for a in ("pod", "data") if a in names)
    M = dm.size(names.index("model"))
    T, D = x.shape
    T_loc = T // math.prod(dm.size(names.index(a)) for a in tok)
    entry = tok if len(tok) > 1 else (tok[0] if tok else None)
    tok_pl = L.placements((entry, None), names, 2)

    def local(t, spec):
        """``t`` redistributed to ``spec``, and its local block, whose
        gradient is partial over the axes the spec replicates it on."""
        pl = L.placements(spec, names, t.dim())
        grad_pl = [Partial() if isinstance(p, Replicate) else p for p in pl]
        t = t.redistribute(dm, pl)
        return t, t.to_local(grad_placements=grad_pl)

    xr, xb = local(x, (entry, None))
    ps = {k: local(params[k], ("model", None, None))[1]
          for k in ("wi_gate", "wi_up", "wo")}
    gates, eidx, _, aux = moe._router(
        {"router": local(params["router"], ())[1]}, xb, cfg)
    part = moe._ep_shard(ps, xb, gates, eidx, dm.get_local_rank("model"),
                         moe.ep_capacity(T_loc, cfg, M))
    summed = [Partial() if n == "model" else p for n, p in zip(names, tok_pl)]
    out = _ep_psum(part, dm, summed, tok_pl, (T, D))
    if cfg.n_shared:
        shared = {k: w.redistribute(dm, [Replicate()] * len(names))
                  for k, w in params["shared"].items()}
        out = out + L.mlp_apply(shared, xr)
    aux = DTensor.from_local(aux, dm, [Partial("avg")] * len(names),
                             shape=(), stride=())
    return out, aux.redistribute(dm, [Replicate()] * len(names))


def _ep_psum(part: torch.Tensor, dm, summed: list, out_pl: list,
             shape: tuple[int, int]):
    """EP's ``psum``: this device's partial output block as a ``DTensor``
    of ``shape``, ``Partial`` over ``model`` (``summed``), made ``out_pl``
    (replicated over ``model``): one all-reduce of (T_loc, D)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(part, dm, summed, shape=shape,
                              stride=(shape[1], 1)).redistribute(dm, out_pl)


@contextlib.contextmanager
def _dtensor_ep():
    """Inside, every EP layer runs ``_ep_dtensor`` (``moe.moe_apply`` takes
    ``moe.moe_apply_ep`` where the reference takes expert parallelism)."""
    real = moe.moe_apply_ep
    moe.moe_apply_ep = _ep_dtensor
    try:
        yield
    finally:
        moe.moe_apply_ep = real


def op_shapes(ops: list[dict]) -> list[dict]:
    """``ops`` grouped by (kind, shape, dtype): each group's count and
    payload bytes, in the order each group first appears."""
    out: dict[tuple, dict] = {}
    for op in ops:
        key = (op["kind"], op["shape"], op["dtype"])
        g = out.setdefault(key, {"kind": op["kind"], "shape": list(op["shape"]),
                                 "dtype": op["dtype"], "count": 0,
                                 "bytes": op["bytes"]})
        g["count"] += 1
    return list(out.values())


def run_placed(arch, cell: base.Cell, cfg, mesh: MeshShape, dm,
               log: CollectiveLog) -> list[dict]:
    """The ops of the cell's step on ``DTensor`` arguments over ``dm``
    (``place``), with the cell's rules.  A retrieval cell runs K6's
    function on the placed candidates — their scores, then the top-k — and
    a tabular one counts one chunk of ``recsys.retrieval_chunk`` rows (every
    chunk has its shape) once per chunk, then the top-k over every
    candidate's score."""
    rules = base.make_rules(mesh.axis_names, cell)
    if arch.family == "lm":
        step = arch.make_step(cfg, cell.kind, mesh=mesh, rules=rules)
    else:
        step = arch.make_step(cfg, cell.kind, rules=rules)
    groups = argument_trees(arch, cell, cfg, rules)
    args = [place(tree, specs, dm) for _, tree, specs in groups]
    if cell.kind == "decode":
        args[-1] = LM_SHAPES[cell.shape]["seq"] - 1
    if cell.kind != "retrieval":
        step(*args)
        return log.ops
    k = recsys_common.RETRIEVAL_K
    if cfg.interaction == "self-attn-seq":
        cands, h = recsys.sasrec_candidates(*args, cfg)
        recsys.top_k((cands.float() @ h.float())[None], k)
        return log.ops
    params, batch = args
    spec = tuple(groups[-1][2]["candidates"])
    C, n = batch["candidates"].shape[0], recsys.retrieval_chunk(cfg)
    # the chunk's rows, split as the candidates are: each candidate in
    # sparse slot 0 beside the user's features (``candidate_scores``)
    rows = {"sparse": base.meta((n, cfg.n_sparse), base.I32)}
    if cfg.n_dense:
        rows["dense"] = base.meta((n, cfg.n_dense), batch["dense"].dtype)
    recsys.forward(params, {k: place(v, spec + (None,), dm)
                            for k, v in rows.items()}, cfg, rules=rules)
    chunk = list(log.ops)
    recsys.top_k(place(base.meta((C,), base.F32), spec, dm)[None], k)
    return chunk * -(-C // n) + log.ops[len(chunk):]


@contextlib.contextmanager
def counting_rules():
    """Two of ``DTensor``'s sharding rules changed inside: ``view`` and
    ``_unsafe_view`` run by its ``reshape`` rule — where a view splits a
    dimension over shards that the split's leading size does not divide (a
    GQA projection or its gradient over more shards than heads), the input
    is redistributed where the view rule raises (XLA's partitioner
    reshards there too); and ``log_sigmoid_backward``, an elementwise op
    that ``DTensor`` has no rule for, gets its pointwise rule (its buffer
    has the input's shape on ``meta``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _pointwise_ops, _view_ops
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    views = (aten.view.default, aten._unsafe_view.default)
    saved = {op: prop.op_strategy_funcs[op] for op in views}
    pointwise = aten.log_sigmoid_backward.default
    # torch >= 2.12 registers pointwise rules per mesh dimension, earlier
    # releases as whole-mesh strategies
    single = getattr(_pointwise_ops, "_register_single_dim_pointwise", None)
    try:
        for op in views:
            _view_ops.register_op_strategy_map(
                op, torch.Tensor.view, schema_info=RuntimeSchemaInfo(1))
        if single is not None:
            single(pointwise)
        else:
            prop.register_op_strategy(pointwise,
                                      _pointwise_ops.pointwise_strategy)
        prop.propagate_op_sharding.cache_clear()
        yield
    finally:
        prop.op_strategy_funcs.update(saved)
        prop.op_strategy_funcs.pop(pointwise, None)
        for table in ("op_single_dim_strategy_funcs",
                      "op_to_schema_info_for_single_dim_strategy"):
            getattr(prop, table, {}).pop(pointwise, None)
        prop.propagate_op_sharding.cache_clear()


def count_collectives(arch, cell: base.Cell, cfg, mesh: MeshShape
                      ) -> tuple[list[dict] | None, str, str | None]:
    """The functional collectives of one device's program of the cell
    (``fake_mesh``, ``run_placed``), the note, and None; or None, a note
    and the op where ``DTensor`` has no sharding rule for an op of the step
    or its sharding propagation fails there (the rules differ between torch
    releases: the record names the release)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    with fake_mesh(mesh) as dm:
        log = CollectiveLog()
        try:
            with counting_rules(), _dtensor_ep(), implicit_replication(), \
                    CommDebugMode() as comm, log:
                ops = run_placed(arch, cell, cfg, mesh, dm, log)
        except NotImplementedError as e:
            op = re.search(r"Operator (\S+) does not have a sharding strategy",
                           str(e))
            if op is None:
                raise
            return None, NO_RULE.format(op=op.group(1)), op.group(1)
        except RuntimeError as e:
            op = re.search(r"Sharding propagation failed for ([\w.]+)\(",
                           str(e))
            if op is None:
                raise
            return None, NO_PROPAGATION.format(
                op=op.group(1), why=str(e).splitlines()[0][:120]), op.group(1)
    if comm.get_total_counts() != len(log.ops):
        raise RuntimeError(f"CommDebugMode counted {comm.get_total_counts()} "
                           f"collectives, the log {len(log.ops)}")
    return ops, DTENSOR_COLLECTIVES, None


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
        ops = wtbc_collectives(arch, cell, cell_config(arch, cell,
                                                       cfg_override), mesh)
        rec.update(collectives=collective_record(ops),
                   collectives_note=WTBC_COLLECTIVES, collective_ops=ops)
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
        ops, note, stopped = count_collectives(arch, cell, cfg, mesh)
        rec["collectives"] = None if ops is None else collective_record(ops)
        rec["collectives_note"] = note
        rec["collectives_torch"] = torch.__version__
        if stopped is not None:
            rec["collectives_stopped_at"] = stopped
        else:
            rec["collective_shapes"] = op_shapes(ops)
            rec["constrain_note"] = CONSTRAIN_NOTE
        if layout is not None:
            rec["moe"] = {**layout, **ep_pair_flops(cfg, layout),
                          "count": EP_COUNT, "psum": ep_psum(cfg, layout)}
    rec.update({"ok": True, "count_s": round(time.time() - t0, 2)})
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
