"""Neighbor sampler for minibatch GNN training (GraphSAGE-style fanout).
The port's own numpy copy of ``repro.data.graph_sampler``: given the same
seed its output is bitwise the reference's.

The ``minibatch_lg`` shape samples a 2-hop neighbourhood of 1024 seed nodes
at fanout (15, 10): the full graph lives host-side in CSR; each step samples
the neighbourhood, relabels it compactly, and pads it to the static shapes
of the cell.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray     # (N+1,)
    indices: np.ndarray    # (E,)
    feats: np.ndarray      # (N, F)
    labels: np.ndarray     # (N,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def random(cls, n_nodes: int, avg_deg: int, d_feat: int, n_classes: int,
               seed: int = 0) -> "CSRGraph":
        """Poisson(avg_deg) out-degrees, uniform neighbours, standard-normal
        float32 features and uniform labels, drawn in that order."""
        rng = np.random.default_rng(seed)
        deg = rng.poisson(avg_deg, n_nodes).astype(np.int64)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(deg, out=indptr[1:])
        indices = rng.integers(0, n_nodes, int(indptr[-1]))
        return cls(indptr=indptr, indices=indices,
                   feats=rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
                   labels=rng.integers(0, n_classes, n_nodes).astype(np.int64))


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanout: tuple[int, ...],
                    pad_nodes: int, pad_edges: int, seed: int = 0) -> dict:
    """Multi-hop fanout sampling -> compact relabeled, padded edge list.

    Returns a numpy dict matching the EGNN batch contract: feats/coords/
    edges/labels/label_mask (labels are masked to the seed nodes — the
    standard sampled-training loss).  Each hop keeps a node's neighbours when
    it has at most ``f`` of them, else ``f`` drawn without replacement; the
    random draws are the reference's, in its order.  Padding edges join the
    last padding node to itself.
    """
    rng = np.random.default_rng(seed)
    frontier = np.asarray(seeds, dtype=np.int64)
    all_nodes = [frontier]
    src_list, dst_list = [], []
    for f in fanout:
        next_frontier = []
        for u in frontier:
            nb = g.indices[g.indptr[u]:g.indptr[u + 1]]
            if len(nb) == 0:
                continue
            take = nb if len(nb) <= f else rng.choice(nb, f, replace=False)
            next_frontier.append(take)
            src_list.append(take)
            dst_list.append(np.full(len(take), u, np.int64))
        frontier = (np.unique(np.concatenate(next_frontier))
                    if next_frontier else np.zeros(0, np.int64))
        all_nodes.append(frontier)

    # compact labels: a node's position among the sorted distinct nodes
    nodes = np.unique(np.concatenate(all_nodes))

    def relabel(v) -> np.ndarray:
        return np.searchsorted(nodes, np.asarray(v, np.int64)).astype(np.int64)

    src = relabel(np.concatenate(src_list)) if src_list else np.zeros(0, np.int64)
    dst = relabel(np.concatenate(dst_list)) if dst_list else np.zeros(0, np.int64)

    n, e = len(nodes), len(src)
    assert n <= pad_nodes and e <= pad_edges, (n, e, pad_nodes, pad_edges)
    feats = np.zeros((pad_nodes, g.feats.shape[1]), np.float32)
    feats[:n] = g.feats[nodes]
    coords = rng.standard_normal((pad_nodes, 3)).astype(np.float32)
    edges = np.full((pad_edges, 2), pad_nodes - 1, np.int32)
    edges[:e, 0] = src
    edges[:e, 1] = dst
    labels = np.zeros(pad_nodes, np.int32)
    labels[:n] = g.labels[nodes]
    mask = np.zeros(pad_nodes, np.float32)
    mask[relabel(seeds)] = 1.0            # loss only on seed nodes
    return {"feats": feats, "coords": coords, "edges": edges,
            "labels": labels, "label_mask": mask}
