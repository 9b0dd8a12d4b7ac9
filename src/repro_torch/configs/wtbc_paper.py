"""wtbc: the paper's own system as a dry-run architecture.  The port's
counterpart of ``repro.configs.wtbc_paper``.

Production deployment posture: a 2-billion-token collection (~10 GB of
text, 10x the paper's corpus) document-sharded over every device of the
mesh; each shard holds a 4M-token WTBC (+ DRB bitmaps) built with the
*global* (s,c)-DC model; a batch of 64 queries is replicated, solved on
every shard and merged.

``abstract_sharded`` describes the deployment's shards as ``meta`` tensors
in the layout of ``core.distributed.ShardedWTBC.stack()`` (the reference's
stacked leaves: their names, shapes and dtypes, a leading shard axis), so
the dry run can say what each device holds.  ``WTBCPaperArch.make_query_fn``
gives the deployment's query for one of the four methods: the port's
``distributed_topk`` over a built ``ShardedWTBC`` with the reference's
heap and gather caps.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchDef, Cell, F32, I32, meta
from repro_torch.core import distributed
from repro_torch.core.wtbc import MAX_LEVELS
from repro_torch.kernels.bitmap_rank import WORDS_PER_BLOCK

U8 = torch.uint8
U32 = torch.uint32


@dataclasses.dataclass(frozen=True)
class WTBCDeployConfig:
    name: str = "wtbc"
    tokens_per_shard: int = 4_194_304      # 128 blocks of 32768
    docs_per_shard: int = 6750
    vocab: int = 718_691                   # the paper's ALL-corpus vocabulary
    s: int = 188
    c: int = 68
    block: int = 32768
    query_batch: int = 64
    words_per_query: int = 4
    k: int = 10
    # level-size ratios observed on Zipf corpora with (188,68) codes
    level1_frac: float = 0.5
    level2_frac: float = 0.125


SHAPES = {
    "queries_dr_and": "dr-and",
    "queries_dr_or": "dr-or",
    "queries_drb_and": "drb-and",
    "queries_drb_or": "drb-or",
}

# replicated on every device; every other leaf of ``abstract_sharded`` is
# split by shard (``sharded_specs``)
GLOBAL_LEAVES = ("global_df", "global_idf", "global_avg_dl")


def _abstract_bytemap(n: int, block: int, n_shards: int) -> dict:
    n_pad = max(1, -(-n // block)) * block
    return {"data": meta((n_shards, n_pad), U8),
            "counts": meta((n_shards, n_pad // block + 1, 256), I32),
            "length": meta((n_shards,), I32),
            "block": block}


def abstract_sharded(cfg: WTBCDeployConfig, n_shards: int) -> dict:
    """The deployment's ``ShardedWTBC.stack()`` as ``meta`` tensors: the
    reference's leaves (``abstract_sharded`` there) under the stacked
    form's names, level sizes from the config's level fractions."""
    n, V, D_ = cfg.tokens_per_shard, cfg.vocab, cfg.docs_per_shard

    def i32v(*shape):
        return meta((n_shards,) + shape, I32)

    lvl_sizes = [n, int(n * cfg.level1_frac), int(n * cfg.level2_frac)]
    idx = {
        "levels": [_abstract_bytemap(s, cfg.block, n_shards)
                   for s in lvl_sizes],
        "offsets": [i32v(2), i32v(cfg.c + 1), i32v(cfg.c ** 2 + 1)],
        "cw": meta((n_shards, V, MAX_LEVELS), U8), "cw_len": i32v(V),
        "node_off": i32v(V, MAX_LEVELS), "base_rank": i32v(V, MAX_LEVELS),
        "sep_pos": i32v(D_), "df": i32v(V), "occ": i32v(V),
        "doc_len": i32v(D_), "n": i32v(), "n_docs": i32v(),
        "s": cfg.s, "c": cfg.c}
    n_words = -(-n // 32)
    n_words = -(-n_words // WORDS_PER_BLOCK) * WORDS_PER_BLOCK
    aux = {"words": meta((n_shards, n_words), U32),
           "counts": i32v(n_words // WORDS_PER_BLOCK + 1),
           "n_bits": i32v(), "bit_off": i32v(V + 1),
           "has_bm": meta((n_shards, V), torch.bool), "eps": 1e-6}
    return {"idx": idx, "aux": aux, "doc_base": i32v(),
            "global_df": meta((V,), I32),            # replicated
            "global_idf": meta((V,), F32),           # replicated
            "global_avg_dl": meta((), F32),          # replicated
            "n_shards": n_shards}


class WTBCPaperArch(ArchDef):
    """family='retrieval' — the dry run handles it apart (no parameters: the
    index is built, and its leaves come from ``abstract_sharded``)."""
    family = "retrieval"
    name = "wtbc"

    def config(self, smoke: bool = False) -> WTBCDeployConfig:
        if smoke:
            return WTBCDeployConfig(name="wtbc-smoke", tokens_per_shard=8192,
                                    docs_per_shard=64, vocab=500, s=254, c=2,
                                    block=512, query_batch=2, k=5)
        return WTBCDeployConfig()

    def cells(self) -> list[Cell]:
        return [Cell("wtbc", s, "serve") for s in SHAPES]

    def init_params(self, cfg, *, seed: int = 0, device=None):
        raise NotImplementedError("the WTBC index is built, not initialized")

    def param_specs(self, cfg, rules):
        raise NotImplementedError("the WTBC index has no parameters")

    def abstract_inputs(self, cfg, shape: str) -> dict:
        B, Q = cfg.query_batch, cfg.words_per_query
        return {"words": meta((B, Q), I32), "wmask": meta((B, Q), torch.bool)}

    def input_specs(self, cfg, shape: str, rules) -> dict:
        return {"words": (), "wmask": ()}

    def make_step(self, cfg, kind: str):
        raise NotImplementedError("use make_query_fn(cfg, shape, devices)")

    def make_query_fn(self, cfg: WTBCDeployConfig, shape: str, devices):
        """``query(sharded, words, wmask) -> DRResult``: the shape's method
        over a ``ShardedWTBC`` whose shards lie on ``devices`` (one per
        shard), merged on the first, with the reference's caps: a heap of
        ``2 * docs_per_shard + 4`` and a DRB ``or`` gather of
        ``min(docs_per_shard, 2048)`` documents a word, which is exact only
        for words of no larger document frequency on any shard."""
        method = SHAPES[shape]
        want = [torch.device(d) for d in devices]
        heap_cap = 2 * cfg.docs_per_shard + 4

        def query(sharded, words, wmask):
            got = sharded.devices
            if len(got) != len(want) or any(
                    g.type != w.type or w.index not in (None, g.index)
                    for g, w in zip(got, want)):
                raise ValueError(f"the shards lie on {list(got)}, the query "
                                 f"was made for {want}")
            return distributed.distributed_topk(
                sharded, words, wmask, k=cfg.k, method=method,
                heap_cap=heap_cap, max_df_cap=min(cfg.docs_per_shard, 2048))
        return query

    def sharded_specs(self, sharded_abs: dict, shard_axes: tuple[str, ...]):
        """Per-leaf specs of ``abstract_sharded``: every stacked leaf split
        on its shard axis over all of ``shard_axes`` jointly, the global
        tables replicated; static fields kept as they are."""
        axes = tuple(shard_axes)
        entry = axes[0] if len(axes) == 1 else axes   # as a PartitionSpec's

        def stacked(node):
            if isinstance(node, torch.Tensor):
                return (entry,) + (None,) * (node.dim() - 1)
            if isinstance(node, dict):
                return {k: stacked(v) for k, v in node.items()}
            if isinstance(node, list):
                return [stacked(v) for v in node]
            return node
        return {k: () if k in GLOBAL_LEAVES else stacked(v)
                for k, v in sharded_abs.items()}


ARCH = WTBCPaperArch()
