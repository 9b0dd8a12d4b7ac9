"""The port's mesh rules, specs, dry run and the roofline's model half
(``models/layers.MeshRules``, ``configs/base.make_rules``, the families'
``param_specs`` / ``input_specs``, ``optim/adamw.state_specs``,
``launch/mesh``, ``launch/dryrun``, ``analysis/roofline``) against
``repro`` (CPU).

* Every architecture's cells equal the reference's: arch, shape, kind, skip
  reason and rules overrides.
* Every leaf's spec tuple equals the reference's ``PartitionSpec`` as a
  tuple — parameters, AdamW state and inputs, full and smoke configs, on
  both production meshes and on ``make_rules(())`` — beside its name, shape
  and dtype.
* The dry run's per-device argument bytes equal a sum over the reference's
  ``jax.eval_shape`` shapes and specs, leaf by leaf, for every cell that is
  not skipped, on both production meshes (exact: integers).
* ``model_flops_for`` is bitwise the reference's for every cell.
* ``lower_cell`` runs on the smoke config of every family and on
  qwen3-1.7b's full ``prefill_32k`` cell, whose counted FLOPs are at least
  its model FLOPs and at most twice them: the port's blockwise attention
  computes the full S x S square (twice the causal count the model takes),
  and the embedding lookup (V x D of N) is a gather the counter does not
  count.  The count is held to that closed form exactly.
* MoE cells through expert parallelism: for every llama4-scout and
  qwen3-moe cell on both production meshes, one (block, shard) pair's
  expert FLOPs equal ``3 x 2 x E_loc x C x D x F`` with C from the EP rule
  (long_500k's one token takes the dense dispatch); counting the pairs of
  one and two blocks and shards and extrapolating equals running every
  pair of a (2, 4) mesh, FLOPs and bytes; cells without EP keep their
  earlier counts.
* The MoE dispatch runs on ``meta``; tabular retrieval counted as one chunk
  times the chunks equals the whole loop's FLOPs, and its bytes within 2%
  (the whole loop also copies the last chunk's padding rows).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.analysis import roofline as r_roofline
from repro.configs import base as r_base
from repro.configs import registry as r_registry
from repro.configs import wtbc_paper as r_wtbc_paper
from repro.optim import adamw as r_adamw
from repro_torch.analysis import roofline
from repro_torch.configs import base, egnn, registry
from repro_torch.configs.lm_common import LM_SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as M
from repro_torch.models import recsys
from repro_torch.optim import adamw

MESHES = {"single": mesh_lib.make_production_mesh(),
          "multi": mesh_lib.make_production_mesh(multi_pod=True)}
CELLS = [c for c in r_registry.all_cells() if not c.skip]


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _wtbc_name(keystr: str) -> str:
    """A reference ``ShardedWTBC`` leaf's name as the stacked form's:
    ``.idx.levels[0].data`` -> ``['idx']['levels'][0]['data']``, the
    bitmap's ``.aux.bv.words`` -> ``['aux']['words']``."""
    out = ""
    for part in keystr.replace(".bv.", ".").split("."):
        if not part:
            continue
        head, _, rest = part.partition("[")
        out += f"[{head!r}]" + (f"[{rest}" if rest else "")
    return out


def reference_leaves(name: str, shape: str, mesh_axes: tuple, n_devices: int,
                     smoke: bool = False) -> dict:
    """{group + leaf name: (shape, dtype, spec)} of the reference's
    arguments of a cell, as its ``lower_cell`` builds them."""
    arch = r_registry.get(name)
    cell = next(c for c in arch.cells() if c.shape == shape)
    rules = r_base.make_rules(mesh_axes, cell)
    if name == "wtbc":
        cfg = arch.config(smoke)
        sh = r_wtbc_paper.abstract_sharded(cfg, n_devices)
        groups = [("", sh, arch.sharded_specs(sh, mesh_axes))]
        inputs = arch.abstract_inputs(cfg, shape)
        groups.append(("inputs", inputs, arch.input_specs(cfg, shape, rules)))
    else:
        cfg = arch.config_for(shape, smoke)
        params = arch.abstract_params(cfg)
        pspecs = arch.param_specs(cfg, rules)
        groups = [("params", params, pspecs)]
        if cell.kind == "train":
            groups.append(("opt_state",
                           jax.eval_shape(r_adamw.init_state, params),
                           r_adamw.state_specs(pspecs)))
        inputs = arch.abstract_inputs(cfg, shape)
        ispecs = arch.input_specs(cfg, shape, rules)
        groups += [(n, inputs[n], ispecs[n])
                   for n in dryrun.KIND_ARGS[cell.kind]]
    out = {}
    for group, tree, specs in groups:
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        spec_leaves = jax.tree.leaves(specs,
                                      is_leaf=lambda x: isinstance(x, P))
        assert len(leaves) == len(spec_leaves), (group, len(leaves))
        for (path, leaf), spec in zip(leaves, spec_leaves):
            key = jax.tree_util.keystr(path)
            key = group + (_wtbc_name(key) if name == "wtbc" and not group
                           else key)
            out[key] = (tuple(leaf.shape), str(leaf.dtype), tuple(spec))
    return out


def port_leaves(name: str, shape: str, mesh: mesh_lib.MeshShape,
                smoke: bool = False) -> dict:
    """The same map for the port's arguments (``dryrun.argument_trees`` /
    ``wtbc_arguments``); the wtbc groups merged as the reference's one
    ``ShardedWTBC``."""
    arch = registry.get(name)
    cell = next(c for c in arch.cells() if c.shape == shape)
    rules = base.make_rules(mesh.axis_names, cell)
    cfg = arch.config(smoke) if name == "wtbc" else \
        arch.config_for(shape, smoke)
    groups = dryrun.wtbc_arguments(arch, cell, cfg, mesh) \
        if name == "wtbc" else dryrun.argument_trees(arch, cell, cfg, rules)
    out = {}
    for group, tree, specs in groups:
        prefix = "" if group in ("index", "global_tables") else group
        for n, t, s in dryrun.leaves_with_specs(tree, specs):
            out[prefix + n] = (tuple(t.shape), _dtype(t), s)
    return out


def _ref_device_bytes(shape, dtype: str, spec: tuple, sizes: dict) -> int:
    n = np.dtype(jax.numpy.dtype(dtype)).itemsize
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n *= -(-dim // int(np.prod([sizes[a] for a in axes])))
    return n


# ---------------------------------------------------------------------------
# cells, rules and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(r_registry.ARCHS))
def test_cells_equal_reference(name):
    def cells(reg):
        return [(c.arch, c.shape, c.kind, c.skip, c.rules_overrides)
                for c in reg.get(name).cells()]
    assert cells(registry) == cells(r_registry)


@pytest.mark.parametrize("axes", [("data", "model"), ("pod", "data", "model"),
                                  ("data",), ()])
def test_make_rules_equal_reference(axes):
    for cell in r_registry.all_cells():
        got = base.make_rules(axes, cell, extra={"table_dim": "data"})
        want = r_base.make_rules(axes, cell, extra={"table_dim": "data"})
        assert got.rules == want.rules
        for logical in (("batch", "seq"), ("kv_seq", None, "heads"),
                        ("rows", "table_dim"), ("nope",)):
            assert got.spec(*logical) == tuple(want.spec(*logical))


@pytest.mark.parametrize("mesh_name", ["single", "multi", "none"])
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", r_registry.ASSIGNED)
def test_specs_equal_reference(name, smoke, mesh_name):
    """Parameters, AdamW state and inputs of every cell: name, shape, dtype
    and spec tuple of every leaf (``none``: ``make_rules(())``, every
    entry None)."""
    mesh = MESHES.get(mesh_name, mesh_lib.MeshShape((), ()))
    for cell in registry.get(name).cells():
        want = reference_leaves(name, cell.shape, mesh.axis_names, mesh.size,
                                smoke)
        got = port_leaves(name, cell.shape, mesh, smoke)
        assert got == want, cell.cell_id


def test_state_specs_mirror_param_specs():
    specs = {"a": ("data", None), "b": [(), (None, "model")]}
    st = adamw.state_specs(specs)
    assert st.step == () and st.m is specs and st.v is specs
    ref = r_adamw.state_specs(specs)
    assert tuple(ref.step) == st.step


# ---------------------------------------------------------------------------
# per-device argument bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c.cell_id)
def test_argument_bytes_equal_reference_sum(cell, mesh_name):
    mesh = MESHES[mesh_name]
    want = reference_leaves(cell.arch, cell.shape, mesh.axis_names,
                            mesh.size)
    got = port_leaves(cell.arch, cell.shape, mesh)
    assert got == want
    arch = registry.get(cell.arch)
    pcell = next(c for c in arch.cells() if c.shape == cell.shape)
    leaves = dryrun.argument_leaves(arch, pcell, mesh)
    total = sum(_ref_device_bytes(s, d, sp, mesh.shape)
                for s, d, sp in want.values())
    assert dryrun.argument_bytes(leaves)["total"] == total
    assert len(leaves) == len(want)


def test_device_bytes_ceil_divides_each_dimension():
    mesh = mesh_lib.MeshShape(("data", "model"), (16, 16))
    t = base.meta((100, 30, 7), torch.bfloat16)
    assert dryrun.device_bytes(t, (("data", "model"), "model"), mesh) == \
        1 * 2 * 7 * 2
    assert dryrun.device_bytes(t, (), mesh) == 100 * 30 * 7 * 2
    with pytest.raises(ValueError, match="more entries"):
        dryrun.device_bytes(base.meta((3,), torch.float32), (None, None), mesh)


def test_local_mesh_on_the_cpu_holds_every_byte():
    mesh = mesh_lib.make_local_mesh("cpu")
    assert mesh.shape == {"data": 1} and mesh.size == 1
    arch = registry.get("qwen3-1.7b")
    cell = arch.cells()[0]
    cfg = arch.config()
    leaves = dryrun.argument_leaves(arch, cell, mesh)
    params = arch.abstract_params(cfg)
    n_param = sum(t.numel() * t.element_size()
                  for _, t, _ in dryrun.leaves_with_specs(
                      params, arch.param_specs(cfg, base.make_rules(("data",)))))
    got = dryrun.argument_bytes(leaves)
    assert got["params"] == n_param
    assert got["opt_state"] == 4 + 2 * 4 * sum(
        t.numel() for _, t, _ in dryrun.leaves_with_specs(
            params, arch.param_specs(cfg, base.make_rules(()))))
    assert got["batch"] == 2 * 256 * 4096 * 4


def test_production_meshes_keep_the_reference_shapes():
    assert MESHES["single"].shape == {"data": 16, "model": 16}
    assert MESHES["multi"].shape == {"pod": 2, "data": 16, "model": 16}
    assert MESHES["multi"].size == 512
    with pytest.raises(ValueError):
        mesh_lib.MeshShape(("data",), (2, 2))


# ---------------------------------------------------------------------------
# model FLOPs and counted work
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", list(r_registry.all_cells()),
                         ids=lambda c: c.cell_id)
def test_model_flops_bitwise_reference(cell):
    got = roofline.model_flops_for(cell.cell_id, cell.kind)
    want = r_roofline.model_flops_for(cell.cell_id, cell.kind)
    assert got == want and type(got) is type(want)


def smoke_config(arch, shape: str):
    """The smoke widths at a full shape (EGNN keeps the shape's feature
    width: its inputs come from the shape)."""
    if arch.name == "wtbc":
        return arch.config(True)
    cfg = arch.config_for(shape, True)
    if arch.name == "egnn":
        cfg = dataclasses.replace(cfg, d_feat=egnn.SHAPES[shape]["d_feat"])
    return cfg


#: the smoke cells whose count stops at an op without a DTensor rule: the
#: dense MoE dispatch (one token; 4 smoke experts on 16 model shards) and
#: EGNN's segment sums
NO_RULE_CELLS = {("llama4-scout-17b-a16e", "long_500k"):
                 "aten.searchsorted.Tensor",
                 ("qwen3-moe-235b-a22b", "train_4k"):
                 "aten.searchsorted.Tensor",
                 ("egnn", "molecule"): "aten.segment_reduce.default"}

SMOKE_CELLS = [("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
               ("qwen3-1.7b", "decode_32k"),
               ("qwen3-moe-235b-a22b", "train_4k"),
               ("llama4-scout-17b-a16e", "long_500k"),
               ("sasrec", "retrieval_cand"), ("fm", "retrieval_cand"),
               ("dlrm-mlperf", "train_batch"), ("xdeepfm", "serve_p99"),
               ("egnn", "molecule"), ("wtbc", "queries_drb_or")]


@pytest.mark.parametrize("name,shape", SMOKE_CELLS)
def test_lower_cell_runs_on_smoke_configs(name, shape, tmp_path):
    arch = registry.get(name)
    cell = next(c for c in arch.cells() if c.shape == shape)
    mesh = MESHES["single"]
    rec = dryrun.lower_cell(arch, cell, mesh, "single",
                            cfg_override=lambda cfg: smoke_config(arch, shape))
    assert rec["ok"]
    if rec["collectives"] is None:      # an op DTensor has no rule for
        assert rec["collectives_note"] == dryrun.NO_RULE.format(
            op=NO_RULE_CELLS[name, shape])
    else:
        assert rec["collectives"]["total_bytes"] == sum(
            rec["collectives"][k]["bytes"] for k in dryrun.COLLECTIVES)
    assert rec["argument_bytes"]["total"] > 0
    if name == "wtbc":
        assert rec["flops"] is None and rec["bytes"] is None
        return
    assert rec["flops"]["per_device"] == rec["flops"]["global"] / mesh.size
    assert rec["bytes"]["global"] > 0
    cfg = smoke_config(arch, shape)
    if name == "sasrec":            # K6's multiply-adds over C x d added
        assert rec["flops"]["global"] >= 2 * 1_000_000 * cfg.embed_dim
    if arch.family == "lm":
        mf = roofline.lm_model_flops(cfg, LM_SHAPES[shape], cell.kind)
        assert rec["flops"]["global"] > 0.3 * mf


def test_a_cell_without_a_collective_count_keeps_its_other_terms():
    """EGNN's count stops at an op without a DTensor rule: its row keeps
    compute_s, memory_s, the step time and the roofline fraction, and the
    table names the op where the collective term would be."""
    arch = registry.get("egnn")
    cell = next(c for c in arch.cells() if c.shape == "molecule")
    rec = dryrun.lower_cell(arch, cell, MESHES["single"], "single",
                            cfg_override=lambda _: smoke_config(arch,
                                                                "molecule"))
    assert rec["collectives"] is None
    op = rec["collectives_stopped_at"]
    assert rec["collectives_note"] == dryrun.NO_RULE.format(op=op)
    row = roofline.reduce_cell(rec, 1e9)
    assert row.collective_s is None and row.collectives_by == f"no rule: {op}"
    assert row.step_time() == row.compute_s + row.memory_s
    assert row.roofline_fraction() == \
        row.compute_s / max(row.compute_s, row.memory_s)
    assert row.dominant in ("compute", "memory")
    assert f"| — | no rule: {op} | **{row.dominant}** | " \
        f"{row.roofline_fraction():.3f} |" in roofline.markdown_table([row])


def test_full_prefill_counts_the_closed_form():
    """qwen3-1.7b ``prefill_32k`` at full width: counted = 2 (N - V D) T
    (every weight's matmul but the embedding's gather) + twice the model's
    causal attention (the blockwise attention computes the full square),
    so model <= counted <= 2 x model."""
    arch = registry.get("qwen3-1.7b")
    cell = next(c for c in arch.cells() if c.shape == "prefill_32k")
    rec = dryrun.lower_cell(arch, cell, MESHES["single"], "single")
    cfg = arch.config()
    B, S = LM_SHAPES["prefill_32k"]["batch"], LM_SHAPES["prefill_32k"]["seq"]
    closed = 2 * (cfg.param_count() - cfg.vocab * cfg.d_model) * B * S + \
        2 * roofline._lm_attn_flops(cfg, B, S)
    assert rec["flops"]["global"] == closed
    mf = rec["model_flops"]
    assert mf == r_roofline.model_flops_for(cell.cell_id, "prefill")
    assert mf <= rec["flops"]["global"] <= 2 * mf
    row = roofline.reduce_cell(rec, mf)
    assert row.dominant in ("compute", "memory", "collective")
    assert row.compute_s == rec["flops"]["per_device"] / mesh_lib.PEAK_FLOPS_BF16
    assert row.collective_s == \
        rec["collectives"]["total_bytes"] / mesh_lib.LINK_BW
    assert f"{row.collective_s:.2e} | torch {torch.__version__} |" in \
        roofline.markdown_table([row])


def test_tabular_retrieval_one_chunk_times_chunks_equals_the_loop():
    arch = registry.get("xdeepfm")
    cfg = arch.config(True)
    n = recsys.retrieval_chunk(cfg)
    C = 2 * n + n // 2
    params = arch.abstract_params(cfg)
    batch = {"sparse": base.meta((1, cfg.n_sparse), base.I32),
             "candidates": base.meta((C,), base.I32)}
    scaled = dryrun.Counts()
    dryrun._count_retrieval(scaled, params, batch, cfg)
    whole = dryrun.Counts()
    whole.run(recsys.retrieval_scores, params, batch, cfg, 100)
    assert scaled.flops == whole.flops > 0
    assert abs(scaled.bytes - whole.bytes) <= 0.02 * whole.bytes


def test_moe_dispatch_runs_on_meta_and_keeps_the_starts():
    cfg = M.MoEConfig(n_experts=8, top_k=2, d_ff=16, n_shared=1)
    p = M.init_moe(None, 32, cfg, device="meta")
    out, aux = M.moe_apply(p, base.meta((64, 32), torch.float32), cfg)
    assert out.shape == (64, 32) and out.device.type == "meta"
    assert aux.shape == ()
    rng = np.random.default_rng(0)
    for E in (1, 5, 8):
        e = torch.from_numpy(rng.integers(0, E, 300))
        e_sorted = torch.sort(e, stable=True).values
        counts = torch.bincount(e, minlength=E)
        want = torch.cumsum(counts, 0) - counts
        got = torch.searchsorted(e_sorted, torch.arange(E))
        assert torch.equal(got, want)


def test_dryrun_cli_writes_records_and_the_roofline_reads_them(tmp_path):
    fails = dryrun.run("single", "wtbc", None, force=True, art=tmp_path)
    fails += dryrun.run("single", "qwen3-1.7b", "long_500k", force=True,
                        art=tmp_path)
    assert fails == 0
    rows = roofline.load_all("single", art=tmp_path)
    assert [r.cell for r in rows] == ["qwen3-1.7b:long_500k"] + [
        f"wtbc:{s}" for s in sorted(("queries_dr_and", "queries_dr_or",
                                     "queries_drb_and", "queries_drb_or"))]
    assert rows[0].skipped.startswith("pure full-attention")
    wt = rows[1]
    assert wt.compute_s is None and wt.memory_s is None
    assert wt.collective_s > 0 and wt.dominant == "collective"
    table = roofline.markdown_table(rows)
    assert "| qwen3-1.7b:long_500k | skip |" in table and "H100" in table


# ---------------------------------------------------------------------------
# MoE cells through expert parallelism
# ---------------------------------------------------------------------------

MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
MOE_CELLS = [(c.arch, c.shape) for a in MOE_ARCHS
             for c in registry.get(a).cells() if not c.skip]
# the parent's global counts (flops, bytes) of cells that take no EP: dense LMs
# and a MoE cell whose one token does not split into the mesh's blocks
DENSE_RECORDS = {("qwen3-1.7b", "decode_32k"): (1402508148736, 2479578187836),
                 ("gemma2-9b", "long_500k"): (200280113152, 122190426928),
                 ("llama4-scout-17b-a16e", "long_500k"): (1701273272320,
                                                          253471591480)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name,shape", MOE_CELLS)
def test_moe_cells_count_expert_flops_per_device_through_ep(name, shape,
                                                             mesh_name):
    """Per device and MoE layer, the experts' forward FLOPs are
    ``3 x 2 x E_loc x C x D x F`` with C from the EP rule at T_loc =
    tokens / (pod x data); a cell whose tokens do not split takes the
    dense dispatch."""
    arch = registry.get(name)
    cell = next(c for c in arch.cells() if c.shape == shape)
    cfg, mesh = arch.config_for(shape), MESHES[mesh_name]
    m = LM_SHAPES[shape]
    T = m["batch"] * (1 if cell.kind == "decode" else m["seq"])
    blocks = mesh.shape["data"] * mesh.shape.get("pod", 1)
    layout = dryrun.ep_layout(arch, cell, cfg, mesh)
    if T % blocks:
        assert layout is None and shape == "long_500k"
        return
    M = mesh.shape["model"]
    E_loc, T_loc = cfg.moe.n_experts // M, T // blocks
    C = max(8, int(T_loc * cfg.moe.top_k * cfg.moe.capacity_factor
                   / E_loc / M) * 2)
    assert (layout["tokens_per_block"], layout["experts_per_shard"],
            layout["capacity"], layout["pairs"]) == (T_loc, E_loc, C,
                                                     mesh.size)
    flops = dryrun.ep_pair_flops(cfg, layout)
    assert flops["expert_flops_per_device_per_layer"] == \
        3 * 2 * E_loc * C * cfg.d_model * cfg.moe.d_ff
    # the replicated router: 2 x T_loc x D x E on every pair
    assert flops["router_flops_per_device_per_layer"] == \
        2 * T_loc * cfg.d_model * cfg.moe.n_experts
    assert layout["psum_bytes_per_layer"] == 2 * T_loc * cfg.d_model * 2


@pytest.mark.parametrize("name,shape,remat", [
    ("qwen3-moe-235b-a22b", "train_4k", False),
    ("qwen3-moe-235b-a22b", "train_4k", True),
    ("qwen3-moe-235b-a22b", "prefill_32k", False),
    ("qwen3-moe-235b-a22b", "decode_32k", False),
    ("llama4-scout-17b-a16e", "train_4k", False)])
def test_extrapolated_pairs_equal_every_pair_on_a_small_mesh(name, shape,
                                                             remat):
    """Counting the pairs of one and two blocks and shards and
    extrapolating equals running every pair of a (2, 4) mesh, FLOPs and
    bytes exactly, with remat (over two layers: each replay visits every
    pair) and without.  The record names the layout and the psum term."""
    arch = registry.get(name)
    cell = next(c for c in arch.cells() if c.shape == shape)
    smoke = arch.config(smoke=True)
    cfg = dataclasses.replace(smoke, remat=remat,
                              n_layers=len(smoke.pattern) * (1 + remat))
    mesh = mesh_lib.MeshShape(("data", "model"), (2, 4))
    some = dryrun.count_step(arch, cell, cfg, mesh)
    every = dryrun.count_step(arch, cell, cfg, mesh, every_pair=True)
    assert (some.flops, some.bytes) == (every.flops, every.bytes)
    assert every.flops > 0
    dense = dryrun.count_step(arch, cell, cfg)
    assert every.flops != dense.flops
    rec = dryrun.lower_cell(arch, cell, mesh, "small",
                            cfg_override=lambda _: cfg)
    assert rec["flops"]["global"] == some.flops
    assert rec["moe"]["pairs"] == 8 and rec["moe"]["shards"] == 4
    # EP's psum, one (T_loc, D) all-reduce a MoE layer, from the layout;
    # the DTensor count holds at least as many of its shape (the attention
    # output's partial sum, reduced where the layer takes its tokens, and
    # a train step's backward may add more)
    psum = rec["moe"]["psum"]
    assert psum["count"] == cfg.n_layers
    assert psum["bytes"] == cfg.n_layers * rec["moe"]["psum_bytes_per_layer"]
    if rec["collectives"] is not None:
        seen = sum(g["count"] for g in rec["collective_shapes"]
                   if (g["kind"], g["shape"], g["dtype"]) ==
                   ("all-reduce", psum["shape"], psum["dtype"]))
        assert seen >= psum["count"]


@pytest.mark.parametrize("name,shape", list(DENSE_RECORDS))
def test_cells_without_ep_keep_their_records(name, shape):
    arch = registry.get(name)
    cell = next(c for c in arch.cells() if c.shape == shape)
    counted = {}
    for mesh_name, mesh in MESHES.items():
        rec = dryrun.lower_cell(arch, cell, mesh, mesh_name, counted=counted)
        flops, nbytes = DENSE_RECORDS[(name, shape)]
        assert (rec["flops"]["global"], rec["bytes"]["global"]) == \
            (flops, nbytes)
        assert rec["flops"]["per_device"] == flops / mesh.size
        assert "moe" not in rec
        assert rec["collectives_note"] in (dryrun.DTENSOR_COLLECTIVES,
                                           dryrun.NO_RULE.format(
                                               op="aten.searchsorted.Tensor"))
