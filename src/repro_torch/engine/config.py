"""Build-time configuration for the :class:`repro_torch.engine.SearchEngine`.

Everything here is a *build* knob; query-time knobs (k, mode, strategy,
measure, budget) are ``SearchEngine.search`` arguments.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import bytemap

# SLA classes, best to worst (the serving layer's shed rung is not here):
#   exact       — run to completion; budgets / deadlines are rejected
#   bounded     — honor an anytime budget / wall deadline; results carry
#                 per-slot certified bits + a score upper bound for the rest
#   best_effort — like bounded; a serving layer may shrink the budget
SLA_CLASSES = ("exact", "bounded", "best_effort")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for ``SearchEngine.build``.

    block:     rank-counter block size of every ByteMap level.  The CUDA
               kernels read tiles 16 bytes at a time, so on the card it must
               be a multiple of 16.
    eps:       DRB stopword threshold — words with idf < eps get no tf bitmap
               (paper: 1e-6 filters only near-universal words).
    with_drb:  whether the DRB tf bitmaps may be built.  They are built
               lazily, on the first DRB-routed query, so a DR-only
               deployment pays no bitmap space; ``with_drb=False`` forbids
               the build, and with it BM25 and ``strategy="drb"`` queries.
    default_k: results per query when ``search`` is called without ``k``.
    default_window: proximity width (tokens) when ``search(mode="near")`` is
               called without ``window``.
    default_beam_width: frontier width P of the DR loop when ``search`` is
               called without ``beam_width``; P=1 is the classical one-pop
               Algorithm 1.
    default_mega: route DR and/or queries through the pool-frontier
               megabatch core when ``search`` is called without ``mega``.
    default_sla: the SLA class ``search`` assumes when called without ``sla``
               and without any anytime knob; one of ``SLA_CLASSES``.
    """
    block: int = bytemap.DEFAULT_BLOCK
    eps: float = 1e-6
    with_drb: bool = True
    default_k: int = 10
    default_window: int = 8
    default_beam_width: int = 1
    default_mega: bool = False
    default_sla: str = "exact"

    def __post_init__(self):
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")
        if self.default_k <= 0:
            raise ValueError(f"default_k must be positive, got {self.default_k}")
        if self.default_window <= 0:
            raise ValueError(f"default_window must be positive, got "
                             f"{self.default_window}")
        if self.default_beam_width <= 0:
            raise ValueError(f"default_beam_width must be positive, got "
                             f"{self.default_beam_width}")
        if self.default_sla not in SLA_CLASSES:
            raise ValueError(f"default_sla must be one of {SLA_CLASSES}, "
                             f"got {self.default_sla!r}")
