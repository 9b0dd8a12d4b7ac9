"""Query executors behind the :class:`repro_torch.engine.SearchEngine` facade.

One executor = one callable specialized on everything the search cores take
as a static choice.  PyTorch runs eagerly, so there is nothing to compile;
the facade still caches executors by key, and counts constructions in
``SearchEngine.stats["traces"]`` — the number stays flat after ``warmup``
exactly as the reference's jit-trace count does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

from repro_torch.core import distributed, drb, mega, positional, ranked


class ExecutorKey(NamedTuple):
    """Hashable cache key."""
    backend: str          # "single" | "sharded"
    strategy: str         # "dr" | "drb" (post-"auto" resolution)
    mode: str             # "and" | "or" | "phrase" | "near"
    measure: Any          # frozen scoring dataclass
    k: int
    batch_shape: tuple[int, int]   # (B, Q)
    budget: int | None    # DR max_pops / DRB-AND candidate budget
    df_cap: int | None    # DRB/OR gather width (pow2-bucketed); else None
    beam_width: int       # frontier width P of the heap core / DRB-AND walk
    mega: bool            # run the pool-frontier megabatch core


def make_single_dr(key: ExecutorKey, *, heap_cap: int, mega_cap: int, note):
    """(idx, words, wmask, idf) -> DRResult with (B, k) leaves."""
    note()
    conjunctive = key.mode == "and"
    if key.mega:
        def fn(idx, words, wmask, idf):
            return mega.topk_dr_mega(idx, words, wmask, idf, k=key.k,
                                     conjunctive=conjunctive, cap=mega_cap,
                                     max_pops=key.budget)
    else:
        def fn(idx, words, wmask, idf):
            return ranked.topk_dr_batch(idx, words, wmask, idf, k=key.k,
                                        conjunctive=conjunctive,
                                        heap_cap=heap_cap,
                                        max_pops=key.budget,
                                        beam_width=key.beam_width)
    return fn


def make_single_drb(key: ExecutorKey, *, note):
    """(idx, aux, words, wmask, idf, avg_dl) -> DRResult with (B, k)
    leaves."""
    note()
    measure = key.measure
    if key.mode == "and":
        def fn(idx, aux, words, wmask, idf, avg_dl):
            return drb.topk_drb_and(idx, aux, words, wmask, measure, k=key.k,
                                    idf=idf, avg_dl=avg_dl,
                                    beam_width=key.beam_width,
                                    max_pops=key.budget)
    else:
        def fn(idx, aux, words, wmask, idf, avg_dl):
            return drb.topk_drb_or(idx, aux, words, wmask, measure, k=key.k,
                                   max_df_cap=key.df_cap, idf=idf,
                                   avg_dl=avg_dl)
    return fn


def make_single_positional(key: ExecutorKey, *, note):
    """(idx, words, wmask, idf, window, avg_dl) -> PositionalResult with
    (B, k) leaves.  ``window`` is a plain int (ignored by phrase), so
    proximity widths share one executor."""
    note()
    phrase = key.mode == "phrase"
    measure = key.measure

    def fn(idx, words, wmask, idf, window, avg_dl):
        return positional.topk_positional_batch(
            idx, words, wmask, idf, k=key.k, phrase=phrase, measure=measure,
            window=window, avg_dl=avg_dl)
    return fn


def make_sharded(key: ExecutorKey, *, heap_cap: int, note):
    """(sharded, words, wmask, idf) -> DRResult with (B, k) leaves on the
    first shard's device.  ``idf`` is the measure's *global* table, one copy
    per shard device, so sharded scores match the single-index backend for
    every measure; the shards' devices ride on the ``ShardedWTBC``."""
    note()
    method = f"{key.strategy}-{key.mode}"

    def fn(sharded, words, wmask, idf):
        return distributed.distributed_topk(
            sharded, words, wmask, k=key.k, method=method, heap_cap=heap_cap,
            max_df_cap=key.df_cap or 2, max_pops=key.budget,
            measure=key.measure, idf=idf, beam_width=key.beam_width)
    return fn
