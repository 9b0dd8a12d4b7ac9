"""Shared ArchDef for the four recsys towers.  The port's counterpart of
``repro.configs.recsys_common``.

Shapes (assigned set):
  train_batch     B=65,536                     -> train_step
  serve_p99       B=512                        -> online inference
  serve_bulk      B=262,144                    -> offline scoring
  retrieval_cand  B=1, n_candidates=1,000,000  -> top-k candidate scoring
                  (SASRec: one K6 ``scored_topk`` launch on the card;
                   tabular towers: chunked tower evaluation)
"""
from __future__ import annotations

import functools

from repro_torch.configs.base import ArchDef, Cell, F32, I32, meta
from repro_torch.models import recsys

N_CANDIDATES = 1_000_000
RETRIEVAL_K = 100

SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1),
}


class RecsysArch(ArchDef):
    family = "recsys"

    def __init__(self, name: str, full: recsys.RecsysConfig,
                 smoke: recsys.RecsysConfig):
        self.name = name
        self._full, self._smoke = full, smoke

    def config(self, smoke: bool = False) -> recsys.RecsysConfig:
        return self._smoke if smoke else self._full

    def cells(self) -> list[Cell]:
        return [Cell(self.name, s, m["kind"]) for s, m in SHAPES.items()]

    def init_params(self, cfg, *, seed: int = 0, device=None):
        return recsys.init_params(cfg, seed=seed, device=device)

    def param_specs(self, cfg, rules):
        return recsys.param_specs(cfg, rules)

    def _batch(self, cfg, B: int, train: bool) -> dict:
        if cfg.interaction == "self-attn-seq":
            b = {"seq": meta((B, cfg.seq_len), I32)}
            if train:
                b["pos"] = meta((B, cfg.seq_len), I32)
                b["neg"] = meta((B, cfg.seq_len), I32)
            return b
        b = {"sparse": meta((B, cfg.n_sparse), I32)}
        if cfg.n_dense:
            b["dense"] = meta((B, cfg.n_dense), F32)
        if train:
            b["label"] = meta((B,), I32)
        return b

    def abstract_inputs(self, cfg, shape: str) -> dict:
        m = SHAPES[shape]
        if m["kind"] == "retrieval":
            b = self._batch(cfg, 1, train=False)
            b["candidates"] = meta((N_CANDIDATES,), I32)
            return {"batch": b}
        return {"batch": self._batch(cfg, m["batch"], m["kind"] == "train")}

    def input_specs(self, cfg, shape: str, rules) -> dict:
        m = SHAPES[shape]
        if m["kind"] == "retrieval":
            specs = {k: () for k in self._batch(cfg, 1, train=False)}
            specs["candidates"] = rules.spec("batch")  # candidate axis sharded
            return {"batch": specs}
        b = self._batch(cfg, m["batch"], m["kind"] == "train")
        row, mat = rules.spec("batch"), rules.spec("batch", None)
        return {"batch": {k: mat if v.dim() == 2 else row
                          for k, v in b.items()}}

    def make_step(self, cfg, kind: str, *, rules=None):
        """The cell's step; ``rules``: the reference's constraints
        (``layers.constrain``) on the train and serve steps (the dry run
        counts a retrieval cell's collectives from ``forward``)."""
        if kind == "train":
            return self.train_wrapper(functools.partial(recsys.loss_fn,
                                                        rules=rules), cfg)
        if kind == "serve":
            def serve_step(params, batch):
                return recsys.serve(params, batch, cfg, rules=rules)
            return serve_step
        if kind == "retrieval":
            def retrieval_step(params, batch):
                return recsys.retrieval_scores(params, batch, cfg,
                                               k=RETRIEVAL_K)
            return retrieval_step
        raise ValueError(kind)
