"""repro_torch.serve — the online serving subsystem over
``repro_torch.engine`` (the port's copy of ``repro.serve``).

Layers (DESIGN.md §7):

    snapshot   versioned on-disk engine images (the reference's format);
               serve starts here, not from the raw corpus
    batcher    dynamic micro-batching onto power-of-two executor buckets
    cache      exact LRU result cache
    server     thread frontend: bounded queue -> batcher -> engine -> cache
    loadgen    closed/open-loop traffic + latency-percentile reports
    faults     seeded fault injection (stalls, errors, cache poison, swaps)
"""
from repro_torch.serve import loadgen, snapshot
from repro_torch.serve.batcher import MicroBatcher, QueryProfile
from repro_torch.serve.cache import LRUCache
from repro_torch.serve.server import (DEFAULT_PROFILE, RowResult,
                                      SearchServer, ShedError, Ticket)

__all__ = [
    "DEFAULT_PROFILE", "LRUCache", "MicroBatcher", "QueryProfile",
    "RowResult", "SearchServer", "ShedError", "Ticket", "loadgen", "snapshot",
]
