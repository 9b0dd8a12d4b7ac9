"""The dry run's collectives (``repro_torch.launch.dryrun``) against the
reference's own counts (``repro.launch.dryrun.parse_collectives`` over the
compiled HLO of ``lower_cell``), on a (2, 4) ("data", "model") mesh of 8
simulated XLA devices (``jax.make_mesh``, as the reference makes its
production meshes), and ``layers.constrain`` against the reference's.

The parity contract:

* **The paper's deployment (``wtbc`` cells), all four methods, at the
  config's batch and k.**  The all-gathers equal the reference's, count and
  bytes.  The all-reduces equal the reference's once folded by XLA's
  combiner rule, which the test applies (``fold``): per shard axis the
  merge's sums (``iters``, ``pops``, ``overflowed``, ``padded``) are one op
  and its max (``bound``) another — one op per (reduction, axis, program
  point), its payload the largest of its members.
* **EP's ``psum``** (the MoE smoke configs' prefill and decode at one layer
  group): the record's ``moe.psum`` (from the layout) and the all-reduces
  the ``DTensor`` run's EP stand-in issues for it (``dryrun._ep_psum``)
  both equal the reference's all-reduces of a (T_loc, D) tensor, count and
  bytes.
* **Dense LM, recsys and GNN smoke cells** (the LM configs at one layer
  group: the reference's HLO holds a scanned body once).  The reference's
  per-kind counts and bytes are pinned exactly (``PINNED``); so are the
  port's, on the torch release they were taken on (``PORT_RELEASE``:
  ``DTensor``'s sharding rules, and with them its choice of collectives,
  change between releases).  Every kind where the two differ names its
  causes, and each cause is a check on the live counts and shapes of both
  sides (``Cause.holds``), on any release.
* **``constrain``** returns the very object on plain tensors, redistributes
  a ``DTensor``, skips exactly where the reference's ``with_sharding_
  constraint`` raises on a mesh of ``Auto`` axes (its ``except`` branch),
  and raises on any other failure.  On the reference's own ``Explicit``
  mesh every constraint that names a mesh axis raises (ROADMAP R13): the
  port's dry run counts with its constraints acting, and the test shows
  that they change its counts.

The reference runs in ONE subprocess started with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` by the first test
(about 50 s), while the port's counts run here.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path
from typing import Callable

import pytest
import torch

from repro_torch.configs import base, egnn, registry
from repro_torch.core import distributed
from repro_torch.engine import SearchEngine
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import layers as L
from repro_torch.text import corpus

ROOT = Path(__file__).resolve().parents[1]
MESH = MeshShape(("data", "model"), (2, 4))
WTBC = [("wtbc", s) for s in ("queries_dr_and", "queries_dr_or",
                              "queries_drb_and", "queries_drb_or")]
EP = [("qwen3-moe-235b-a22b", "prefill_32k"),
      ("qwen3-moe-235b-a22b", "decode_32k")]
#: the torch release the port's pinned counts were taken on
PORT_RELEASE = "2.13"


def count(d: dict, kind: str) -> tuple[int, int]:
    return d.get(kind, (0, 0))


@dataclasses.dataclass(frozen=True)
class Cause:
    """Why the port's and the reference's counts of a kind differ, and the
    check that it does: ``holds(kind, ref, port, ref_ops, port_ops,
    inputs)`` on the per-kind {kind: (count, bytes)} and the op lists of
    both sides (each op's kind, shape and bytes), and the cell's abstract
    inputs."""
    text: str
    holds: Callable[..., bool]


def _cache_gathers(kind, ref, port, ref_ops, port_ops, inputs) -> bool:
    """Every layer's k and v caches gathered whole along kv_seq: as many
    all-gathers as cache layers, each the bytes of one layer's cache over
    the batch's shards (B / data x S_kv x KV x Dh); and more bytes than the
    reference's."""
    want = Counter(c[0].numel() * c.element_size() // MESH.shape["data"]
                   for pair in inputs["caches"] for c in pair
                   for _ in range(c.shape[0]))
    got = Counter(o["bytes"] for o in port_ops if o["kind"] == "all-gather")
    return all(got[b] >= n for b, n in want.items()) \
        and count(port, kind)[1] > count(ref, kind)[1]


def _id_gathers(kind, ref, port, ref_ops, port_ops, inputs) -> bool:
    """The batch's ids gathered (an integer all-gather); the reference
    gathers nothing."""
    return count(ref, kind) == (0, 0) and any(
        o["kind"] == "all-gather" and o["dtype"].startswith("int")
        for o in port_ops)


def _topk_gathers(kind, ref, port, ref_ops, port_ops, inputs) -> bool:
    """Two gathers of the scores where the reference has one, each its
    size."""
    (rc, rb), (pc, pb) = count(ref, kind), count(port, kind)
    sizes = {o["bytes"] for o in port_ops if o["kind"] == kind}
    return pc == 2 * rc and pb == 2 * rb and sizes == {rb // rc}


PARTITIONER = Cause(
    "XLA's partitioner reshards between layouts with all-to-all and "
    "collective-permute; DTensor issues neither kind",
    lambda k, r, p, *_: count(r, k)[0] > 0 and count(p, k)[0] == 0)
COMBINER = Cause(
    "XLA's combiner folds reductions into one op counted by its largest "
    "tensor; DTensor reduces each partial sum per mesh axis and per op, a "
    "train step's gradients to their parameters' placements",
    lambda k, r, p, *_: count(p, k)[0] > count(r, k)[0] > 0)
SCATTER = Cause(
    "DTensor reduce-scatters a partial sum where the next op takes a shard "
    "(XLA all-reduces it whole)",
    lambda k, r, p, *_: count(p, "reduce-scatter")[0] > 0
    and count(r, "reduce-scatter")[0] == 0
    and (k == "reduce-scatter" or count(p, k)[1] < count(r, k)[1]))
GATHER = Cause(
    "DTensor gathers whole what the port's constraints or its placements "
    "leave split where the next op needs it whole (sequence and hidden dims "
    "of the activations, GQA heads split finer than KV); XLA's partitioner "
    "moves less",
    lambda k, r, p, *_: count(p, k)[1] > count(r, k)[1] > 0)
CACHE = Cause(
    "on decode DTensor gathers each layer's k and v caches whole along "
    "kv_seq, which splits them, to write the step's slot in place; XLA "
    "updates the slot in its shard", _cache_gathers)
LOOKUP = Cause(
    "DTensor gathers a batch's ids and looked-up rows whole to index a "
    "row-split table; XLA keeps the lookup split", _id_gathers)
TOPK = Cause(
    "the port's top-k is a sort and a gather by index: DTensor gathers the "
    "split scores for each, XLA's top_k once", _topk_gathers)

LM_CAUSES = {"all-gather": (GATHER,), "reduce-scatter": (SCATTER,),
             "all-to-all": (PARTITIONER,),
             "collective-permute": (PARTITIONER,)}
DECODE_CAUSES = {**LM_CAUSES, "all-gather": (CACHE,)}

#: (arch, shape): the reference's and the port's {kind: (count, bytes)} on
#: MESH at smoke widths (LM: one layer group; the port's on PORT_RELEASE),
#: and the causes of each kind where they differ; a port entry that is a
#: string names the op DTensor has no sharding rule for
PINNED = {
    ("qwen3-1.7b", "train_4k"): (
        {"all-reduce": (12, 1099432016), "all-gather": (23, 1220820992),
         "all-to-all": (3, 16777216), "collective-permute": (6, 50331648)},
        {"all-reduce": (18, 191880), "all-gather": (29, 6260260864),
         "reduce-scatter": (11, 1476395008)},
        {**LM_CAUSES, "all-reduce": (COMBINER, SCATTER)}),
    ("qwen3-1.7b", "prefill_32k"): (
        {"all-reduce": (3, 541065216), "all-gather": (6, 270794752),
         "all-to-all": (3, 16777216), "collective-permute": (2, 16777216)},
        {"all-gather": (42, 3221356544), "reduce-scatter": (2, 268435456)},
        {**LM_CAUSES, "all-reduce": (SCATTER,)}),
    ("qwen3-1.7b", "decode_32k"): (
        {"all-reduce": (8, 168448), "all-gather": (6, 49152),
         "all-to-all": (3, 2048), "collective-permute": (2, 2048)},
        {"all-gather": (16, 570688256), "reduce-scatter": (6, 49920)},
        {**DECODE_CAUSES, "all-reduce": (SCATTER,)}),
    ("qwen3-moe-235b-a22b", "prefill_32k"): (
        {"all-reduce": (4, 809500672), "all-gather": (7, 2278400),
         "all-to-all": (3, 16777216), "collective-permute": (2, 16777216)},
        {"all-reduce": (4, 536870928), "all-gather": (12, 407159808),
         "reduce-scatter": (3, 1342177280)},
        {**LM_CAUSES, "all-reduce": (SCATTER,)}),
    ("qwen3-moe-235b-a22b", "decode_32k"): (
        {"all-reduce": (8, 168448), "all-gather": (11, 230400),
         "all-to-all": (3, 2048), "collective-permute": (2, 2048)},
        {"all-reduce": (3, 32784), "all-gather": (19, 570722048),
         "reduce-scatter": (5, 33536)},
        {**DECODE_CAUSES, "all-reduce": (SCATTER,)}),
    ("sasrec", "train_batch"): (
        {"all-reduce": (2, 64008)},
        {"all-reduce": (18, 26376), "all-gather": (7, 47217920)},
        {"all-reduce": (COMBINER,), "all-gather": (LOOKUP,)}),
    ("sasrec", "serve_p99"): ({}, {}, {}),
    ("sasrec", "retrieval_cand"): (
        {"all-gather": (1, 4000000)}, {"all-gather": (2, 8000000)},
        {"all-gather": (TOPK,)}),
    ("dlrm-mlperf", "train_batch"): (
        {"all-reduce": (1, 65536)},
        {"all-reduce": (5, 5568), "all-gather": (15, 5406720)},
        {"all-reduce": (COMBINER,), "all-gather": (LOOKUP,)}),
    ("dlrm-mlperf", "serve_p99"): ({}, {}, {}),
    ("dlrm-mlperf", "retrieval_cand"): (
        {"all-gather": (1, 4000000)}, {"all-gather": (2, 8000000)},
        {"all-gather": (TOPK,)}),
    ("egnn", "molecule"): (
        {"all-reduce": (10, 3166336), "collective-permute": (13, 1384448)},
        "aten.segment_reduce.default", {}),
}

#: constrain cases: (name, x's shape, rules ("filtered": make_rules over
#: the mesh's axes, else MeshRules.make(overrides)), logical names)
CONSTRAIN_CASES = [
    ("axis-not-in-mesh", (8, 16, 32), {}, ("batch", "seq", "embed")),
    ("batch-embed", (8, 16, 32), "filtered", ("batch", "seq", "embed")),
    ("duplicate", (8, 16, 4, 8), "filtered-seq-model",
     ("batch", "seq", "heads", None)),
    ("too-many-entries", (8, 16), "filtered", ("batch", None, None)),
    ("uneven", (3, 6), "filtered", ("batch", "heads")),
    ("unnamed", (8, 16), "filtered", (None, "embed")),
]


def case_rules(kind, make, make_rules):
    if kind == "filtered":
        return make_rules(("data", "model"))
    if kind == "filtered-seq-model":
        return make_rules(("data", "model"), extra={"seq": "model"})
    return make(kind)


REFERENCE_SCRIPT = textwrap.dedent("""
    import os, sys, json, re, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    sys.path.insert(0, {tests!r})
    from repro.configs import base as rbase, egnn as regnn, registry
    from repro.launch import dryrun as D
    from repro.models import layers as RL
    from test_torch_collectives import (CONSTRAIN_CASES, EP, PINNED, WTBC,
                                        case_rules)

    explicit = jax.make_mesh((2, 4), ("data", "model"))
    auto = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def ops_of(hlo):
        # parse_collectives' rule, op by op: (kind, largest tensor)
        out = []
        for line in hlo.splitlines():
            s = line.strip()
            hit = next((k for k in D.COLLECTIVES if re.search(
                rf"(?:^|[ (]){{k}}(?:-start)?\\(", s)), None)
            if hit is None or f"{{hit}}-done" in s:
                continue
            big = max(((D._tensor_bytes(t, d), t, d) for t, d in
                       re.findall(r"([a-z0-9]+)\\[([0-9,]*)\\]", s)),
                      default=(0, "", ""))
            out.append({{"kind": hit, "bytes": big[0], "dtype": big[1],
                        "shape": [int(x) for x in big[2].split(",") if x]}})
        return out

    def smoke(arch, shape):
        cfg = arch.config_for(shape, True)
        if arch.name == "egnn":
            cfg = dataclasses.replace(cfg, d_feat=regnn.SHAPES[shape]["d_feat"])
        if arch.family == "lm":
            cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
        return cfg

    out = {{"cells": {{}}, "constrain": {{}}}}
    parse = D.parse_collectives
    for name, shape in WTBC + EP + list(PINNED):
        arch = registry.get(name)
        cell = next(c for c in arch.cells() if c.shape == shape)
        seen = {{}}
        def spy(hlo):
            seen["ops"] = ops_of(hlo)
            return parse(hlo)
        D.parse_collectives = spy
        rec = D.lower_cell(arch, cell, explicit, "t", cfg_override=(
            lambda _c, a=arch, s=shape: smoke(a, s)))
        out["cells"][f"{{name}}:{{shape}}"] = {{
            "collectives": rec["collectives"], "ops": seen["ops"]}}
    D.parse_collectives = parse

    wsc = jax.lax.with_sharding_constraint
    for case, shape, kind, logical in CONSTRAIN_CASES:
        rules = case_rules(kind, RL.MeshRules.make, rbase.make_rules)
        for mname, mesh in (("explicit", explicit), ("auto", auto)):
            raised = []
            def spy(x, spec):
                try:
                    return wsc(x, spec)
                except Exception:
                    raised.append(True)
                    raise
            jax.lax.with_sharding_constraint = spy
            f = jax.jit(lambda x: RL.constrain(x, rules, *logical) * 2)
            with mesh:
                f.lower(jnp.zeros(shape)).compile()
            jax.lax.with_sharding_constraint = wsc
            out["constrain"][f"{{case}}/{{mname}}"] = bool(raised)
    with open(sys.argv[1], "w") as fh:
        json.dump(out, fh)
""")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    path = tmp_path_factory.mktemp("collectives") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-c",
         REFERENCE_SCRIPT.format(tests=str(ROOT / "tests")), str(path)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def reference(reference_run):
    proc, path = reference_run
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"stdout:\n{out}\nstderr:\n{err[-3000:]}"
    return json.loads(path.read_text())


def smoke_config(arch, shape: str):
    """The smoke widths at a full shape: EGNN keeps the shape's feature
    width, an LM one layer group."""
    cfg = arch.config_for(shape, True)
    if arch.name == "egnn":
        cfg = dataclasses.replace(cfg, d_feat=egnn.SHAPES[shape]["d_feat"])
    if arch.family == "lm":
        cfg = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    return cfg


def kinds(rec: dict) -> dict:
    """{kind: (count, bytes)} of the kinds a record counts."""
    return {k: (v["count"], v["bytes"]) for k, v in rec.items()
            if k != "total_bytes" and v["count"]}


def fold(ops: list[dict]) -> dict:
    """XLA's combiner on the merge's all-reduces: one op per (reduction,
    axis) — every reduction of an axis sits at one program point — whose
    payload is its members' largest; the record of the folded ops."""
    groups: dict[tuple, int] = {}
    for op in ops:
        if op["kind"] == "all-reduce":
            key = (op["op"], op["axis"])
            groups[key] = max(groups.get(key, 0), op["bytes"])
    return dryrun.collective_record(
        [{"kind": "all-reduce", "bytes": b} for b in groups.values()])


def cell_of(name: str, shape: str):
    arch = registry.get(name)
    return arch, next(c for c in arch.cells() if c.shape == shape)


def count_cell(arch, cell, cfg):
    """``dryrun.count_collectives`` of the cell on MESH, and the ops that
    EP's ``psum`` issued inside it (``dryrun._ep_psum``, each call under a
    log of its own)."""
    psums, real = [], dryrun._ep_psum

    def spy(*args):
        with dryrun.CollectiveLog() as log:
            out = real(*args)
        psums.extend(log.ops)
        return out
    dryrun._ep_psum = spy
    try:
        ops, note, stopped = dryrun.count_collectives(arch, cell, cfg, MESH)
    finally:
        dryrun._ep_psum = real
    return ops, note, stopped, psums


@pytest.fixture(scope="module")
def port(reference_run):
    """The port's records of every cell of the file (the reference runs
    meanwhile)."""
    out = {}
    for name, shape in WTBC:
        arch, cell = cell_of(name, shape)
        rec = dryrun.lower_cell(arch, cell, MESH, "small")
        out[name, shape] = (rec["collectives"], rec["collective_ops"])
    for name, shape in list(PINNED) + EP:
        arch, cell = cell_of(name, shape)
        cfg = smoke_config(arch, shape)
        out[name, shape] = (*count_cell(arch, cell, cfg), cfg)
    return out


@pytest.mark.parametrize("name,shape", WTBC)
def test_wtbc_gathers_equal_and_folded_reductions_equal(name, shape, port,
                                                        reference):
    rec, ops = port[name, shape]
    want = reference["cells"][f"{name}:{shape}"]["collectives"]
    assert rec["all-gather"] == want["all-gather"]
    assert rec["all-gather"]["count"] == 4          # 2 axes x (docs, scores)
    got = fold(ops)
    assert got["all-reduce"] == want["all-reduce"]
    assert got["total_bytes"] + rec["all-gather"]["bytes"] == \
        want["total_bytes"]
    # before the fold: one op per reduction and axis
    n_red = 3 if shape == "queries_drb_or" else 4
    assert rec["all-reduce"]["count"] == 2 * (n_red + 1)
    for k in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert rec[k] == want[k] == {"count": 0, "bytes": 0}


@pytest.mark.parametrize("name,shape", EP)
def test_ep_psum_equals_the_references_all_reduce(name, shape, port,
                                                  reference):
    ops, _, _, psums, cfg = port[name, shape]
    arch, cell = cell_of(name, shape)
    layout = dryrun.ep_layout(arch, cell, cfg, MESH)
    psum = dryrun.ep_psum(cfg, layout)
    T_loc = layout["tokens_per_block"]
    ref = [o for o in reference["cells"][f"{name}:{shape}"]["ops"]
           if o["kind"] == "all-reduce" and o["shape"] == [T_loc, cfg.d_model]]
    assert ref and psum["count"] == len(ref) == cfg.n_layers
    assert psum["bytes"] == 2 * sum(o["bytes"] for o in ref)
    # the DTensor run's psum: one all-reduce of (T_loc, D) a layer, also
    # in the cell's record
    assert [(o["kind"], o["shape"], o["dtype"]) for o in psums] == \
        [("all-reduce", (T_loc, cfg.d_model), psum["dtype"])] * psum["count"]
    assert 2 * sum(o["bytes"] for o in psums) == psum["bytes"]
    assert all(o in ops for o in psums)


def port_kinds(name, shape, port):
    ops, note, stopped, _, _ = port[name, shape]
    want_port = PINNED[name, shape][1]
    if isinstance(want_port, str):
        assert ops is None and stopped == want_port
        assert note == dryrun.NO_RULE.format(op=want_port)
        return None, None
    assert note == dryrun.DTENSOR_COLLECTIVES and stopped is None
    return kinds(dryrun.collective_record(ops)), ops


@pytest.mark.parametrize("name,shape", list(PINNED))
def test_smoke_cells_reference_counts_pinned(name, shape, reference):
    got = kinds(reference["cells"][f"{name}:{shape}"]["collectives"])
    assert got == PINNED[name, shape][0]


@pytest.mark.parametrize("name,shape", list(PINNED))
def test_smoke_cells_port_counts_pinned(name, shape, port):
    release = torch.__version__.split("+")[0]
    if not release.startswith(PORT_RELEASE + "."):
        pytest.skip(f"the port's counts are DTensor's choices on torch "
                    f"{PORT_RELEASE}, and its sharding rules differ on "
                    f"{release}; the causes still hold")
    got, _ = port_kinds(name, shape, port)
    want = PINNED[name, shape][1]
    assert got == (None if isinstance(want, str) else want)


@pytest.mark.parametrize("name,shape", list(PINNED))
def test_smoke_cells_differences_have_their_causes(name, shape, port,
                                                   reference):
    """Each kind where the two sides differ has its causes, each checked on
    the live counts and shapes; a kind where they agree has none."""
    _, want_port, causes = PINNED[name, shape]
    got_port, port_ops = port_kinds(name, shape, port)
    if got_port is None:
        return
    ref = reference["cells"][f"{name}:{shape}"]
    got_ref = kinds(ref["collectives"])
    differ = {k for k in set(got_ref) | set(got_port)
              if got_ref.get(k) != got_port.get(k)}
    assert differ == set(causes)
    arch, _ = cell_of(name, shape)
    inputs = arch.abstract_inputs(port[name, shape][-1], shape)
    for kind, why in causes.items():
        for cause in why:
            assert cause.holds(kind, got_ref, got_port, ref["ops"], port_ops,
                               inputs), f"{kind}: {cause.text}"


def test_the_constraints_change_the_counts(monkeypatch):
    """The reference's constraints act in the dry run's count: some
    redistribute, and with ``constrain`` made a no-op (what the reference's
    raise on its own Explicit meshes) the count differs."""
    arch, cell = cell_of("qwen3-1.7b", "prefill_32k")
    cfg = smoke_config(arch, "prefill_32k")
    real, moved = L.constrain, []

    def spy(x, rules, *logical):
        y = real(x, rules, *logical)
        moved.append(y is not x)
        return y
    monkeypatch.setattr(L, "constrain", spy)
    pinned, _, _ = dryrun.count_collectives(arch, cell, cfg, MESH)
    assert moved and any(moved)
    monkeypatch.setattr(L, "constrain", lambda x, rules, *logical: x)
    free, _, _ = dryrun.count_collectives(arch, cell, cfg, MESH)
    assert kinds(dryrun.collective_record(pinned)) != \
        kinds(dryrun.collective_record(free))


def test_wtbc_gathered_bytes_are_what_the_merge_takes_from_the_shards(
        monkeypatch):
    """On one axis of 4 shards the merge's all-gathers deliver the bytes
    ``merge_topk`` gathers from the shards: the numel x element size of the
    gathered documents and scores."""
    cp = corpus.make_corpus(n_docs=40, mean_doc_len=30, vocab_size=300,
                            seed=0)
    engine = SearchEngine.shard(cp, 4, device="cpu")
    seen = []
    real = distributed.gather_candidates

    def spy(results, bases, device):
        seen.append(real(results, bases, device))
        return seen[-1]
    monkeypatch.setattr(distributed, "gather_candidates", spy)
    B, k = 3, 5
    words = torch.tensor([[3, 4], [5, 6], [7, 8]], dtype=torch.int32)
    for method in distributed.METHODS:
        seen.clear()
        distributed.distributed_topk(engine.sharded, words,
                                     torch.ones_like(words, dtype=torch.bool),
                                     k=k, method=method)
        (all_d, all_s), = seen
        ops = distributed.merge_collectives(B, k, [("data", 4)],
                                            has_pad=method != "drb-or")
        gathers = [o for o in ops if o["kind"] == "all-gather"]
        want = sum(t.numel() * t.element_size() for t in (all_d, all_s))
        assert sum(o["dtype"].itemsize * torch.Size(o["shape"]).numel()
                   for o in gathers) == want
        assert [o["dtype"] for o in gathers] == [all_d.dtype, all_s.dtype]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_constrain_returns_a_plain_tensor_itself(device):
    x = torch.zeros((8, 16, 32), device=device)
    rules = base.make_rules(("data", "model"))
    assert L.constrain(x, rules, "batch", "seq", "embed") is x
    assert L.constrain(x, None, "batch") is x


@pytest.mark.parametrize("case,shape,kind,logical", CONSTRAIN_CASES,
                         ids=[c[0] for c in CONSTRAIN_CASES])
def test_constrain_skips_exactly_where_the_reference_does(
        case, shape, kind, logical, reference):
    from torch.distributed.tensor import DTensor
    rules = case_rules(kind, L.MeshRules.make, base.make_rules)
    skipped = reference["constrain"][f"{case}/auto"]
    spec = rules.spec(*logical)
    reason = L.constraint_skip(spec, len(shape), MESH.axis_names)
    assert (reason is not None) == skipped
    with dryrun.fake_mesh(MESH) as dm:
        x = dryrun.place(base.meta(shape, torch.float32),
                         (None,) * len(shape), dm)
        y = L.constrain(x, rules, *logical)
        if skipped:
            assert y is x
        else:
            assert isinstance(y, DTensor) and y is not x
            assert list(y.placements) == L.placements(spec, MESH.axis_names,
                                                      len(shape))


@pytest.mark.parametrize("case,shape,kind,logical", CONSTRAIN_CASES,
                         ids=[c[0] for c in CONSTRAIN_CASES])
def test_the_references_explicit_mesh_skips_every_named_axis(
        case, shape, kind, logical, reference):
    """ROADMAP R13: on ``jax.make_mesh``'s ``Explicit`` axes the
    reference's constraint raises wherever its spec names a mesh axis, so
    its dry run keeps none of them."""
    rules = case_rules(kind, L.MeshRules.make, base.make_rules)
    names_an_axis = any(L.spec_axes(e) for e in rules.spec(*logical))
    assert reference["constrain"][f"{case}/explicit"] == names_an_axis


def test_constrain_raises_on_any_other_failure():
    """A dimension split over mesh axes out of the mesh's order (the
    reference constrains it on an Auto mesh; DTensor cannot place it)."""
    rules = L.MeshRules.make({"batch": ("model", "data")})
    with dryrun.fake_mesh(MESH) as dm:
        x = dryrun.place(base.meta((8, 4), torch.float32), (None, None), dm)
        with pytest.raises(NotImplementedError, match="out of"):
            L.constrain(x, rules, "batch", None)


def test_the_counter_leaves_no_process_group_up():
    import torch.distributed as dist
    with dryrun.fake_mesh(MESH):
        assert dist.is_initialized()
        with pytest.raises(RuntimeError, match="already initialized"):
            with dryrun.fake_mesh(MESH):
                pass
    assert not dist.is_initialized()
