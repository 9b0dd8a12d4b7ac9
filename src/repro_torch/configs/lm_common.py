"""Shared ArchDef for the five LM-family transformers.  The port's
counterpart of ``repro.configs.lm_common``.

Shapes (the assigned set — seq_len x global_batch):
  train_4k     S=4096   B=256   -> train_step
  prefill_32k  S=32768  B=32    -> prefill
  decode_32k   S=32768  B=128   -> serve_step (decode, KV cache of S)
  long_500k    S=524288 B=1     -> serve_step; needs sub-quadratic attention —
                                   runs only for archs with windowed/chunked
                                   layers (gemma2, llama4); skipped for pure
                                   full-attention archs
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import ArchDef, Cell, I32, meta
from repro_torch.models import transformer as T

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# long_500k: one sequence, its KV split over every mesh axis
LONG_RULES = (("batch", None), ("kv_seq", ("pod", "data", "model")))


class LMArch(ArchDef):
    family = "lm"

    def __init__(self, name: str, cfg_full: T.LMConfig, cfg_smoke: T.LMConfig,
                 long_ok: bool, extra_rules: tuple = ()):
        self.name = name
        self._full = cfg_full
        self._smoke = cfg_smoke
        self._long_ok = long_ok
        self._extra_rules = tuple(extra_rules)

    def config(self, smoke: bool = False) -> T.LMConfig:
        return self._smoke if smoke else self._full

    def cells(self) -> list[Cell]:
        out = []
        for shape, m in LM_SHAPES.items():
            skip = None
            rules = self._extra_rules
            if shape == "long_500k":
                rules = rules + LONG_RULES
                if not self._long_ok:
                    # the reference's reason, word for word
                    skip = ("pure full-attention arch: 500k decode has no "
                            "sub-quadratic path (DESIGN.md §5)")
            out.append(Cell(self.name, shape, m["kind"], skip=skip,
                            rules_overrides=rules))
        return out

    def init_params(self, cfg, *, seed: int = 0, device=None):
        return T.init_params(cfg, seed=seed, device=device)

    def param_specs(self, cfg, rules):
        return T.param_specs(cfg, rules)

    def abstract_inputs(self, cfg, shape: str) -> dict:
        m = LM_SHAPES[shape]
        B, S = m["batch"], m["seq"]
        if m["kind"] == "train":
            return {"batch": {"tokens": meta((B, S), I32),
                              "labels": meta((B, S), I32)}}
        if m["kind"] == "prefill":
            return {"tokens": meta((B, S), I32)}
        return {"caches": T.cache_shapes(cfg, B, S),
                "tokens": meta((B,), I32),
                "cache_len": meta((), I32)}

    def input_specs(self, cfg, shape: str, rules) -> dict:
        m = LM_SHAPES[shape]
        if m["kind"] == "train":
            tok = rules.spec("batch", "seq")
            return {"batch": {"tokens": tok, "labels": tok}}
        if m["kind"] == "prefill":
            return {"tokens": rules.spec("batch", "seq")}
        cache = (None, *rules.spec("batch", "kv_seq", "kv_heads", None))
        return {"caches": [(cache, cache) for _ in cfg.pattern],
                "tokens": rules.spec("batch"),
                "cache_len": ()}

    def make_step(self, cfg, kind: str, *, mesh=None, rules=None):
        """The cell's step; ``mesh`` (a ``launch/mesh.MeshShape``) goes to
        every MoE layer, which takes expert parallelism where the reference
        would (``models/moe.py``); ``rules`` to the reference's constraints
        (``layers.constrain``)."""
        if kind == "train":
            return self.train_wrapper(functools.partial(
                T.loss_fn, mesh=mesh, rules=rules), cfg)
        if kind == "prefill":
            def prefill_step(params, tokens):
                return T.prefill(params, tokens, cfg, mesh=mesh, rules=rules)
            return prefill_step
        if kind == "decode":
            def serve_step(params, caches, tokens, cache_len):
                return T.decode_step(params, caches, tokens, cache_len, cfg,
                                     mesh=mesh, rules=rules)
            return serve_step
        raise ValueError(kind)

    def flops_note(self, cfg) -> dict:
        return {"params": cfg.param_count(),
                "active_params": cfg.active_param_count()}


def smoke_lm(name: str, full: T.LMConfig) -> T.LMConfig:
    """Reduced same-family config: keeps pattern/features, shrinks dims."""
    moe = None
    if full.moe is not None:
        moe = dataclasses.replace(full.moe, n_experts=4,
                                  top_k=min(full.moe.top_k, 2), d_ff=64)
    return dataclasses.replace(
        full, name=name + "-smoke",
        n_layers=2 * len(full.pattern), d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
        window=min(full.window, 8) if full.window else 0,
        moe=moe, dtype=torch.float32, remat=False)
