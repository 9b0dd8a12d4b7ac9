"""EGNN — E(n)-Equivariant Graph Neural Network [Satorras et al. 2102.09844].
The port's counterpart of ``repro.models.gnn``.

Message passing over an explicit edge list: messages are computed per edge
and aggregated into their destination nodes by a segmented sum
(``layers.Segments``).  ``forward`` sorts the edges by destination once
per batch and every layer's sums reuse that order; each node's sum adds
its edges from zero in their order in the batch, as the reference's
scatter-add does on the CPU.
On the card the sums are deterministic too (no atomics), so a run repeats
bitwise.

Layer (paper eqs. 3-6):
  m_ij  = phi_e(h_i, h_j, ||x_i - x_j||^2)
  x_i'  = x_i + C * sum_j (x_i - x_j) * phi_x(m_ij)      (equivariant update)
  h_i'  = phi_h(h_i, sum_j m_ij)

Node-classification head for the citation/products tasks; graph-level
readout (sum pool) for the `molecule` shape.  ``param_specs`` replicates
every parameter, as the reference does (d_hidden 64: they are tiny).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 1433
    d_coord: int = 3
    n_classes: int = 40
    graph_readout: bool = False       # molecule shape: sum-pool + graph head
    n_graphs: int = 128               # graphs per batch when graph_readout
    dtype: Any = torch.float32


def _mlp_init(gen, dims, dtype, device):
    return [L.init_dense(gen, i, o, dtype, device=device)
            for i, o in zip(dims[:-1], dims[1:])]


def _mlp(ws, x, act=F.silu, final_act=False):
    for i, w in enumerate(ws):
        x = x @ w
        if i < len(ws) - 1 or final_act:
            x = act(x)
    return x


def init_params(cfg: EGNNConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default: the card; ``"meta"`` describes them without
    allocating), with the reference's layout and distributions."""
    dev = L.param_device(device)
    gen = L.generator(seed, dev)
    H, dt = cfg.d_hidden, cfg.dtype
    layers = [{"phi_e": _mlp_init(gen, (2 * H + 1, H, H), dt, dev),
               "phi_x": _mlp_init(gen, (H, H, 1), dt, dev),
               "phi_h": _mlp_init(gen, (2 * H, H, H), dt, dev)}
              for _ in range(cfg.n_layers)]
    return {
        "embed_in": L.init_dense(gen, cfg.d_feat, H, dt, device=dev),
        "layers": layers,
        "head": L.init_dense(gen, H, cfg.n_classes, dt, device=dev),
    }


def param_specs(cfg: EGNNConfig, rules: L.MeshRules) -> dict:
    """EGNN parameters are tiny (d_hidden 64): every leaf replicated."""
    return tree_map(lambda _: (), init_params(cfg, device="meta"))


def egnn_layer(p: dict, h, x, edges, n_nodes: int,
               seg: L.Segments | None = None, rules=None):
    """h (N, H) features, x (N, D) coordinates, edges (E, 2) [src, dst];
    ``seg``: the edges' ``Segments`` by destination, when the caller made
    them once for every layer; ``rules``: the reference's constraint on the
    messages (``layers.constrain``)."""
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    if seg is None:
        seg = L.segments(dst, n_nodes)
    h_i, h_j = h[dst], h[src]
    x_i, x_j = x[dst], x[src]
    diff = x_i - x_j
    d2 = (diff * diff).sum(-1, keepdim=True)
    m = _mlp(p["phi_e"], torch.cat([h_i, h_j, d2], dim=-1), final_act=True)
    m = L.constrain(m, rules, "edges", None)

    # equivariant coordinate update (normalized by distance, +1 for stability)
    w = _mlp(p["phi_x"], m)
    upd = diff / (torch.sqrt(d2) + 1.0) * w
    x_new = x + seg.sum(upd)

    agg = seg.sum(m)
    h_new = h + _mlp(p["phi_h"], torch.cat([h, agg], dim=-1))
    return h_new, x_new


def forward(params: dict, batch: dict, cfg: EGNNConfig, *,
            rules=None) -> torch.Tensor:
    """batch: feats (N, F), coords (N, D), edges (E, 2), [graph_ids (N,)].
    Node logits (N, n_classes), or graph logits (n_graphs, n_classes) with
    ``graph_readout``.  The edges' stable sort by destination is made once
    and every layer's sums reuse it.  ``rules``: the reference's
    constraints on the embedded features and each layer's messages."""
    n_nodes = batch["feats"].shape[0]
    edges = batch["edges"]
    seg = L.segments(edges[:, 1], n_nodes)
    h = batch["feats"].to(cfg.dtype) @ params["embed_in"]
    x = batch["coords"].to(cfg.dtype)
    h = L.constrain(h, rules, "nodes", None)
    for p in params["layers"]:
        h, x = egnn_layer(p, h, x, edges, n_nodes, seg, rules)
    if cfg.graph_readout:
        pooled = L.segment_sum(h, batch["graph_ids"], cfg.n_graphs)
        return pooled @ params["head"]
    return h @ params["head"]


def loss_fn(params, batch, cfg: EGNNConfig, *, rules=None):
    """(nll, {"nll": nll}): mean cross entropy over the labels, weighted by
    ``label_mask`` when the batch has one.  Differentiable
    (``EGNNArch.make_step(cfg, "train")`` takes its gradient): the backward
    of a ``Segments`` sum is ``segment_reduce``'s, a gather per row, and the
    node gathers' backward accumulates by index."""
    logits = forward(params, batch, cfg, rules=rules).float()
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        nll = nll.mean()
    return nll, {"nll": nll}
