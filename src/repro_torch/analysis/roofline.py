"""WTBC query-path memory roofline (the port's copy of the WTBC half of
``repro.analysis.roofline``).

A gauge's model, not a kernel's bound: every popped (and padded) beam lane
descends every level for every query word, each level two rank probes, each
probe one counter-block tile plus its superblock counter.  The engine facade
attaches it to each observed search (``SearchEngine._record_search``) so a
scrape of ``/metrics`` shows the modelled bytes per query and the achieved
fraction of the device's memory rate next to the serving counters.

The memory rates are keyed by the device type of the engine's tensors.
"""
from __future__ import annotations

import dataclasses

from repro_torch import obs

# Memory rate per device type: "cuda" is the H100 SXM's HBM3 (NVIDIA data
# sheet); "cpu" a single-socket DDR5 stream rate, deliberately conservative so
# the achieved fraction on the CPU path reads as an upper bound.
WTBC_MEM_BW: dict[str, float] = {
    "cuda": 3.35e12,
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
