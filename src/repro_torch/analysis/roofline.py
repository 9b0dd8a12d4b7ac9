"""Roofline analysis: the model half over the dry run's records, and the
WTBC query-path memory roofline.  The port's counterpart of
``repro.analysis.roofline``.

**Cells** (``python -m repro_torch.analysis.roofline --mesh single``): three
terms per (arch x shape) from ``launch/dryrun.py``'s records, with the H100
SXM's data-sheet constants of ``launch/mesh.py`` (figures from NVIDIA's data
sheet, not measurements):

  compute_s    = max(model FLOPs, counted FLOPs) per device / 989e12  (bf16)
  memory_s     = counted bytes per device / 3.35e12                    (HBM3)
  collective_s = collective bytes per device / 450e9   (NVLink 4, one way)

and ``dominant`` is the largest of them.  The counted FLOPs and bytes are
the eager step's on ``meta`` tensors, split evenly over the mesh's devices;
the counter sees matmul-like ops only, and the bytes are every unfused op's
inputs and outputs.  The collective bytes are the record's ``total_bytes``
(an all-reduce counted twice); where the record has none (an op without a
``DTensor`` rule) the term is —, and ``dominant``, the step time and the
roofline fraction weigh the terms the record has.  A ``DTensor`` count
depends on the torch release (its sharding rules), which the table's
"collectives by" column prints.  An axis of 16 crosses hosts, so for it
the NVLink rate makes ``collective_s`` a floor.  MODEL_FLOPS (the useful-work
numerator) is analytic and the reference's exactly: 6·N·T for dense-LM
training (6·N_active·T for MoE) plus exact attention-window terms, 2·N·T
for inference; per-tower closed forms for recsys; per-layer closed forms
for EGNN.  The reference's two-point scan probe is not needed: an eager
count visits every layer.

**WTBC query path**: a gauge's model, not a kernel's bound: every popped
(and padded) beam lane descends every level for every query word, each
level two rank probes, each probe one counter-block tile plus its
superblock counter.  The engine facade attaches it to each observed search
(``SearchEngine._record_search``) so a scrape of ``/metrics`` shows the
modelled bytes per query and the achieved fraction of the device's memory
rate next to the serving counters.  The memory rates are keyed by the
device type of the engine's tensors.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib

from repro_torch import obs
from repro_torch.launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"


# ---------------------------------------------------------------------------
# analytic MODEL_FLOPS (the reference's formulas)
# ---------------------------------------------------------------------------

def _lm_attn_flops(cfg, B, S, decode=False):
    """Sum over layers of QK^T + PV flops (fwd)."""
    total = 0.0
    for i, pat in enumerate(cfg.pattern):
        n = cfg.n_layers // len(cfg.pattern)
        if decode:
            span = S if pat == "global" or cfg.window == 0 else min(cfg.window, S)
            total += n * 4.0 * B * span * cfg.n_heads * cfg.head_dim
        else:
            if pat == "global" or cfg.window == 0 or cfg.window >= S:
                span = S / 2
            elif pat == "local":
                span = cfg.window
            else:                       # chunked: average window/2
                span = cfg.window / 2
            total += n * 4.0 * B * S * span * cfg.n_heads * cfg.head_dim
    return total


def lm_model_flops(cfg, shape_meta: dict, kind: str) -> float:
    B, S = shape_meta["batch"], shape_meta["seq"]
    N_act = cfg.active_param_count()
    if kind == "train":
        T = B * S
        fwd = 2.0 * N_act * T + _lm_attn_flops(cfg, B, S)
        factor = 3.0 + (1.0 if cfg.remat else 0.0)   # fwd+2bwd (+refwd remat)
        return factor * fwd
    if kind == "prefill":
        return 2.0 * N_act * B * S + _lm_attn_flops(cfg, B, S)
    # decode: one token, full KV span
    return 2.0 * N_act * B + _lm_attn_flops(cfg, B, S, decode=True)


def recsys_model_flops(cfg, B: int, kind: str) -> float:
    d = cfg.embed_dim
    f = 0.0
    if cfg.interaction == "fm":
        f = 4.0 * B * cfg.n_sparse * d
    elif cfg.interaction == "cin":
        dims = (cfg.n_sparse,) + cfg.cin_layers
        for i in range(len(cfg.cin_layers)):
            f += 2.0 * B * dims[i + 1] * dims[i] * cfg.n_sparse * d \
                 + 2.0 * B * dims[i] * cfg.n_sparse * d
        flat = cfg.n_sparse * d
        f += 2.0 * B * (flat * 400 + 400 * 400 + flat)
    elif cfg.interaction == "dot":
        dims = (cfg.n_dense,) + cfg.bot_mlp
        f += 2.0 * B * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        nf = cfg.n_sparse + 1
        f += 2.0 * B * nf * nf * d
        n_inter = nf * (nf - 1) // 2
        tdims = (cfg.bot_mlp[-1] + n_inter,) + cfg.top_mlp
        f += 2.0 * B * sum(a * b for a, b in zip(tdims[:-1], tdims[1:]))
    elif cfg.interaction == "self-attn-seq":
        S = cfg.seq_len
        per_blk = 2.0 * B * S * d * d * 6 + 4.0 * B * S * S * d / 2
        f = cfg.n_blocks * per_blk
    if kind == "train":
        f *= 3.0
    return f


def egnn_model_flops(cfg, n_nodes: int, n_edges: int, kind: str) -> float:
    H = cfg.d_hidden
    per_layer = (2.0 * n_edges * ((2 * H + 1) * H + H * H)      # phi_e
                 + 2.0 * n_edges * (H * H + H)                  # phi_x
                 + 2.0 * n_nodes * (2 * H * H + H * H))         # phi_h
    f = cfg.n_layers * per_layer + 2.0 * n_nodes * cfg.d_feat * H
    return f * (3.0 if kind == "train" else 1.0)


def model_flops_for(cell_id: str, kind: str) -> float | None:
    from repro_torch.configs import egnn as egnn_cfg
    from repro_torch.configs import recsys_common, registry
    from repro_torch.configs.lm_common import LM_SHAPES
    arch_name, shape = cell_id.split(":")
    if arch_name == "wtbc":
        return None
    arch = registry.get(arch_name)
    cfg = arch.config_for(shape)
    if arch.family == "lm":
        return lm_model_flops(cfg, LM_SHAPES[shape], kind)
    if arch.family == "recsys":
        if shape == "retrieval_cand":
            return recsys_model_flops(cfg, recsys_common.N_CANDIDATES, "serve")
        B = recsys_common.SHAPES[shape]["batch"]
        return recsys_model_flops(cfg, B, kind)
    if arch.family == "gnn":
        m = egnn_cfg.SHAPES[shape]
        return egnn_model_flops(cfg, m["nodes"], m["edges"], kind)
    return None


# ---------------------------------------------------------------------------
# dry-run record reduction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellRoofline:
    cell: str
    kind: str
    chips: int
    counted_flops: float | None   # per device, even split; matmul-like ops
    counted_bytes: float | None   # per device, even split; unfused op I/O
    compute_s: float | None       # max(model, counted) FLOPs / device / peak
    memory_s: float | None
    collective_s: float | None    # collective bytes / device / NVLink rate
    dominant: str
    model_flops_per_chip: float | None
    arg_gb: float | None          # exact argument bytes per device / 2**30
    skipped: str | None = None
    # who counted the collectives: the torch release of a DTensor count,
    # "merge" for the wtbc merge's own list, "no rule: <op>" where DTensor
    # stopped (collective_s is then None)
    collectives_by: str | None = None

    def terms(self) -> list[float]:
        """The terms the record has."""
        return [t for t in (self.compute_s, self.memory_s, self.collective_s)
                if t is not None]

    def step_time(self) -> float | None:
        """No-overlap upper bound: the terms the record has, serialized
        (None without compute_s and memory_s)."""
        if self.compute_s is None or self.memory_s is None:
            return None
        return sum(self.terms())

    def roofline_fraction(self) -> float | None:
        """Useful-compute share of the binding resource: compute_s over the
        largest term the record has; 1.0 = bound by useful work."""
        if self.compute_s is None or self.memory_s is None:
            return None
        return self.compute_s / max(*self.terms(), 1e-30)


def reduce_cell(rec: dict, model_flops_total: float | None) -> CellRoofline:
    if rec.get("skipped"):
        return CellRoofline(cell=rec["cell"], kind="-", chips=0,
                            counted_flops=None, counted_bytes=None,
                            compute_s=None, memory_s=None, collective_s=None,
                            dominant="-",
                            model_flops_per_chip=None, arg_gb=None,
                            skipped=rec["skipped"])
    chips = math.prod(rec["mesh_shape"].values())
    flops = (rec.get("flops") or {}).get("per_device")
    hbm = (rec.get("bytes") or {}).get("per_device")
    mf = None if model_flops_total is None else model_flops_total / chips
    useful = [x for x in (mf, flops) if x is not None]
    compute_s = max(useful) / PEAK_FLOPS_BF16 if useful else None
    memory_s = None if hbm is None else hbm / HBM_BW
    coll = (rec.get("collectives") or {}).get("total_bytes")
    collective_s = None if coll is None else coll / LINK_BW
    terms = [(n, t) for n, t in (("compute", compute_s), ("memory", memory_s),
                                 ("collective", collective_s))
             if t is not None]
    dom = max(terms, key=lambda kv: kv[1])[0] if terms else "-"
    args = rec["argument_bytes"]["total"]
    if rec.get("collectives_stopped_at"):
        by = f"no rule: {rec['collectives_stopped_at']}"
    elif rec.get("collectives_torch"):
        by = "torch " + rec["collectives_torch"]
    else:
        by = None if rec.get("collectives") is None else "merge"
    return CellRoofline(
        cell=rec["cell"], kind=rec.get("kind", "?"), chips=chips,
        counted_flops=flops, counted_bytes=hbm, compute_s=compute_s,
        memory_s=memory_s, collective_s=collective_s, dominant=dom,
        model_flops_per_chip=mf,
        arg_gb=args / 2 ** 30, collectives_by=by)


def load_all(mesh_name: str = "single",
             art: pathlib.Path = ART) -> list[CellRoofline]:
    out = []
    for path in sorted((pathlib.Path(art) / mesh_name).glob("*.json")):
        rec = json.loads(path.read_text())
        if not rec.get("ok"):
            continue
        kind = rec.get("kind", "?")
        mf = model_flops_for(rec["cell"], kind) if ":" in rec["cell"] else None
        out.append(reduce_cell(rec, mf))
    return out


def _num(x: float | None, fmt: str = ".2e") -> str:
    return "—" if x is None else format(x, fmt)


def markdown_table(rows: list[CellRoofline]) -> str:
    hdr = ("| cell | kind | compute_s | memory_s | collective_s | "
           "collectives by | dominant | roofline frac | args GB / device |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if r.skipped:
            lines.append(f"| {r.cell} | skip | - | - | - | - | - | - | - |")
            continue
        lines.append(
            f"| {r.cell} | {r.kind} | {_num(r.compute_s)} | "
            f"{_num(r.memory_s)} | {_num(r.collective_s)} | "
            f"{r.collectives_by or '—'} | **{r.dominant}** | "
            f"{_num(r.roofline_fraction(), '.3f')} | {_num(r.arg_gb, '.3f')} |")
    note = ("\n\nH100 SXM data-sheet constants, not measurements (989e12 "
            "bf16 FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s NVLink 4 one way). A — "
            "is a count the cell does not have: compute_s and memory_s on "
            "wtbc (data-dependent loops), collective_s where DTensor has no "
            "rule for an op of the cell (\"no rule\"); dominant and the "
            "fraction then weigh the terms the cell has.  A DTensor count "
            "(\"torch <release>\") is DTensor's choice of collectives for "
            "the port's program with its constraints applied; its rules "
            "differ between torch releases, and so may the count.")
    return hdr + "\n".join(lines) + note


# ---------------------------------------------------------------------------
# WTBC query-path roofline
# ---------------------------------------------------------------------------

# Memory rate per device type: "cuda" is the H100 SXM's HBM3 (NVIDIA data
# sheet); "cpu" a single-socket DDR5 stream rate, deliberately conservative so
# the achieved fraction on the CPU path reads as an upper bound.
WTBC_MEM_BW: dict[str, float] = {
    "cuda": HBM_BW,
    "cpu": 4.1e10,
}

# Per-rank counter traffic: the kernels (and the plain versions) gather one
# 4-byte superblock counter next to each tile.
WTBC_COUNTER_BYTES: dict[str, float] = {"cuda": 4.0, "cpu": 4.0}


def wtbc_query_bytes(*, pops: float, padded: float, q: int, block: int,
                     levels: int = 3,
                     counter_bytes: float = 4.0) -> float:
    """Bytes the WTBC query path must move per query: ``2 * levels * q``
    rank probes per popped or padded lane, each one ``block``-byte tile plus
    ``counter_bytes`` of counters (the node-offset and codeword tables are
    shared across probes and amortize to ~0)."""
    ranks = 2.0 * levels * q * (pops + padded)
    return ranks * (block + counter_bytes)


@dataclasses.dataclass
class WTBCQueryRoofline:
    """Memory-roofline attachment for one measured search."""
    backend: str                  # device type the memory rate came from
    bytes_per_query: float
    model_us_per_query: float     # bytes / rate — the memory-bound floor
    measured_us_per_query: float
    achieved_frac: float          # model / measured; 1.0 = at the roofline


def wtbc_query_roofline(*, backend: str, measured_us_per_query: float,
                        pops: float, padded: float, q: int, block: int,
                        levels: int = 3) -> WTBCQueryRoofline:
    """Attach the bytes-per-query model to a measured per-query latency.
    ``pops`` / ``padded`` are per-query means; ``backend`` is the device
    type ("cuda" or "cpu"), which picks the memory rate."""
    cb = WTBC_COUNTER_BYTES.get(backend, 4.0)
    bpq = wtbc_query_bytes(pops=pops, padded=padded, q=q, block=block,
                           levels=levels, counter_bytes=cb)
    bw = WTBC_MEM_BW.get(backend, WTBC_MEM_BW["cpu"])
    model_us = bpq / bw * 1e6
    frac = model_us / max(measured_us_per_query, 1e-9)
    return WTBCQueryRoofline(backend=backend, bytes_per_query=bpq,
                             model_us_per_query=model_us,
                             measured_us_per_query=measured_us_per_query,
                             achieved_frac=frac)


def live_wtbc_gauges(rl: WTBCQueryRoofline, reg=None) -> None:
    """Export one measured roofline into a :mod:`repro_torch.obs` registry
    as live gauges labeled by device type."""
    reg = obs.resolve(reg)
    labels = {"backend": rl.backend}
    reg.gauge("repro_roofline_bytes_per_query", labels,
              "modelled WTBC bytes moved per query").set(rl.bytes_per_query)
    reg.gauge("repro_roofline_model_us_per_query", labels,
              "memory-bound latency floor (us/query)"
              ).set(rl.model_us_per_query)
    reg.gauge("repro_roofline_measured_us_per_query", labels,
              "measured latency (us/query)").set(rl.measured_us_per_query)
    reg.gauge("repro_roofline_achieved_frac", labels,
              "model floor / measured (1.0 = at the memory roofline)"
              ).set(rl.achieved_frac)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="roofline table of the dry "
                                 "run's records")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = load_all(args.mesh)
    print(markdown_table(rows))
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(
            [dataclasses.asdict(r) for r in rows], indent=1))


if __name__ == "__main__":
    main()
