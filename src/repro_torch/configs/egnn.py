"""egnn: 4 layers, d_hidden 64, E(n)-equivariant [arXiv:2102.09844].  The
port's counterpart of ``repro.configs.egnn``.

Four shapes, each with its own graph geometry (padded to 4096-multiples as
the reference pads them; padding nodes/edges are masked):

  full_graph_sm  Cora-like        N=2,708     E=10,556      d_feat=1,433
  minibatch_lg   Reddit-sampled   1024 seeds, fanout 15-10 (~170k nodes)
  ogb_products   full-batch-large N=2,449,029 E=61,859,140  d_feat=100
  molecule       128 graphs x 30 nodes x 64 edges, graph-level readout

Every cell is a train cell: ``make_step(cfg, "train")`` is
``loss_fn``'s gradient and one AdamW step (``base.train_wrapper``).
"""
from __future__ import annotations

import functools

from repro_torch.configs.base import ArchDef, Cell, F32, I32, meta, pad_to
from repro_torch.models import gnn

SHAPES = {
    "full_graph_sm": dict(nodes=2708, edges=10556, d_feat=1433, classes=7,
                          readout=False, n_graphs=0),
    "minibatch_lg": dict(nodes=1024 * (1 + 15 + 150), edges=1024 * (15 + 150),
                         d_feat=602, classes=41, readout=False, n_graphs=0),
    "ogb_products": dict(nodes=2_449_029, edges=61_859_140, d_feat=100,
                         classes=47, readout=False, n_graphs=0),
    "molecule": dict(nodes=128 * 30, edges=128 * 64, d_feat=16, classes=2,
                     readout=True, n_graphs=128),
}
PAD = 4096


class EGNNArch(ArchDef):
    family = "gnn"
    name = "egnn"

    def config(self, smoke: bool = False) -> gnn.EGNNConfig:
        return self.config_for("full_graph_sm", smoke)

    def config_for(self, shape: str, smoke: bool = False) -> gnn.EGNNConfig:
        m = SHAPES[shape]
        if smoke:
            return gnn.EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16,
                                  d_feat=8, n_classes=m["classes"],
                                  graph_readout=m["readout"])
        return gnn.EGNNConfig(name="egnn", n_layers=4, d_hidden=64,
                              d_feat=m["d_feat"], n_classes=m["classes"],
                              graph_readout=m["readout"])

    def cells(self) -> list[Cell]:
        return [Cell("egnn", s, "train") for s in SHAPES]

    def init_params(self, cfg, *, seed: int = 0, device=None):
        return gnn.init_params(cfg, seed=seed, device=device)

    def param_specs(self, cfg, rules):
        return gnn.param_specs(cfg, rules)

    def abstract_inputs(self, cfg, shape: str) -> dict:
        m = SHAPES[shape]
        N, E = pad_to(m["nodes"], PAD), pad_to(m["edges"], PAD)
        batch = {
            "feats": meta((N, m["d_feat"]), F32),
            "coords": meta((N, 3), F32),
            "edges": meta((E, 2), I32),
        }
        if m["readout"]:
            batch["graph_ids"] = meta((N,), I32)
            batch["labels"] = meta((m["n_graphs"],), I32)
            batch["label_mask"] = meta((m["n_graphs"],), F32)
        else:
            batch["labels"] = meta((N,), I32)
            batch["label_mask"] = meta((N,), F32)
        return {"batch": batch}

    def input_specs(self, cfg, shape: str, rules) -> dict:
        node = rules.spec("nodes")
        batch = {"feats": rules.spec("nodes", None),
                 "coords": rules.spec("nodes", None),
                 "edges": rules.spec("edges", None)}
        if SHAPES[shape]["readout"]:
            batch.update(graph_ids=node, labels=(), label_mask=())
        else:
            batch.update(labels=node, label_mask=node)
        return {"batch": batch}

    def make_step(self, cfg, kind: str, *, rules=None):
        """The train step; ``rules``: the reference's constraints
        (``layers.constrain``)."""
        if kind == "train":
            return self.train_wrapper(functools.partial(gnn.loss_fn,
                                                        rules=rules), cfg)
        raise ValueError(f"egnn has only train cells, not {kind!r}")


ARCH = EGNNArch()
