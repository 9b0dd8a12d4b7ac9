"""Deterministic, stateless data pipelines (counter -> sample).  The port's
counterpart of ``repro.data.pipeline``.

Every batch is a pure function of (seed, step, family config): a restart
after a failure resumes exactly where it left off, with O(1) skip-ahead and
no iterator state to checkpoint (``runtime.fault_tolerance``).

* ``lm_batch`` and ``recsys_batch`` draw from a CPU ``torch.Generator``
  seeded from ``(seed, step, salt)`` (salts 1, 2 and 3, the reference's) and
  move the batch to ``device``, so a (seed, step) gives the same batch on
  the CPU and on the card.  They keep the reference's shapes, dtypes,
  ranges and its squared-uniform skew toward low token ids, but not its
  values: the reference draws with JAX's threefry, which the port cannot
  reproduce without JAX.
* ``random_graph`` and ``molecule_batch`` draw with numpy in the reference
  too; they are copied here and give the reference's arrays bitwise.

``device`` defaults to the card (``resolve_device``); pass ``"cpu"`` for
the plain path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def _generator(seed: int, step: int, salt: int = 0) -> torch.Generator:
    """A CPU generator whose state is a function of (seed, step, salt)
    alone (the three mixed by numpy's ``SeedSequence``)."""
    state = np.random.SeedSequence([seed, step, salt]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & ((1 << 63) - 1))


def _int32(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(torch.int32).to(device)


# ---------------------------------------------------------------------------
# LM: synthetic token streams (Zipf-ish via squared uniform)
# ---------------------------------------------------------------------------

def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int, *,
             device=None) -> dict:
    """{"tokens", "labels"}: (batch, seq) int32 in [0, vocab - 1), labels
    the tokens shifted by one; ids ``floor(u^2 (vocab - 1))`` of a float32
    uniform ``u``, skewed toward low ids."""
    dev = resolve_device(device)
    u = torch.rand((batch, seq + 1), generator=_generator(seed, step, 1))
    toks = (u * u * (vocab - 1)).to(torch.int32)
    return {"tokens": toks[:, :-1].contiguous().to(dev),
            "labels": toks[:, 1:].contiguous().to(dev)}


# ---------------------------------------------------------------------------
# recsys: CTR batches / SASRec sequences
# ---------------------------------------------------------------------------

def recsys_batch(seed: int, step: int, batch: int, cfg, *,
                 device=None) -> dict:
    """SASRec: {"seq", "pos", "neg"} (batch, seq_len) int32 item ids in
    [1, n_items), ``pos`` the sequence shifted by one with a fresh last id.
    Tabular towers: {"sparse"} (batch, n_sparse) int32, column f in
    [0, rows()[f]); {"label"} (batch,) int32, 1 with probability 0.25; and
    {"dense"} (batch, n_dense) float32 normal when the tower has dense
    features."""
    dev = resolve_device(device)
    if cfg.interaction == "self-attn-seq":
        g = _generator(seed, step, 2)
        seq = torch.randint(1, cfg.n_items, (batch, cfg.seq_len), generator=g)
        nxt = torch.randint(1, cfg.n_items, (batch, 1), generator=g)
        neg = torch.randint(1, cfg.n_items, (batch, cfg.seq_len), generator=g)
        return {"seq": _int32(seq, dev),
                "pos": _int32(torch.cat([seq[:, 1:], nxt], 1), dev),
                "neg": _int32(neg, dev)}
    g = _generator(seed, step, 3)
    rows = cfg.rows()
    sparse = torch.stack([torch.randint(0, rows[f], (batch,), generator=g)
                          for f in range(cfg.n_sparse)], dim=1)
    label = torch.rand((batch,), generator=g) < 0.25
    out = {"sparse": _int32(sparse, dev), "label": _int32(label, dev)}
    if cfg.n_dense:
        out["dense"] = torch.randn((batch, cfg.n_dense), generator=g).to(dev)
    return out


# ---------------------------------------------------------------------------
# GNN: synthetic graphs (numpy, the reference's draws)
# ---------------------------------------------------------------------------

def random_graph(seed: int, n_nodes: int, n_edges: int, d_feat: int,
                 n_classes: int, pad_nodes: int | None = None,
                 pad_edges: int | None = None, *, device=None) -> dict:
    """Host-side synthetic graph with degree skew, padded and masked: the
    reference's arrays bitwise, as tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pn = pad_nodes or n_nodes
    pe = pad_edges or n_edges
    # preferential-attachment-flavoured endpoints (skewed degrees)
    src = (rng.random(n_edges) ** 2 * n_nodes).astype(np.int64)
    dst = rng.integers(0, n_nodes, n_edges)
    edges = np.zeros((pe, 2), np.int32)
    edges[:n_edges, 0] = src
    edges[:n_edges, 1] = dst
    edges[n_edges:] = pn - 1          # padding edges hit the last (pad) node
    feats = np.zeros((pn, d_feat), np.float32)
    feats[:n_nodes] = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    coords = np.zeros((pn, 3), np.float32)
    coords[:n_nodes] = rng.standard_normal((n_nodes, 3)).astype(np.float32)
    labels = np.zeros((pn,), np.int64)
    labels[:n_nodes] = rng.integers(0, n_classes, n_nodes)
    mask = np.zeros((pn,), np.float32)
    mask[:n_nodes] = 1.0
    return _tensors({"feats": feats, "coords": coords, "edges": edges,
                     "labels": labels.astype(np.int32), "label_mask": mask},
                    dev)


def molecule_batch(seed: int, n_graphs: int, nodes_per: int, edges_per: int,
                   d_feat: int, n_classes: int, *, device=None) -> dict:
    """Block-diagonal batch of small graphs with a graph-level label: the
    reference's arrays bitwise, as tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes_per
    E = n_graphs * edges_per
    base = np.repeat(np.arange(n_graphs), edges_per) * nodes_per
    src = rng.integers(0, nodes_per, E) + base
    dst = rng.integers(0, nodes_per, E) + base
    return _tensors({
        "feats": rng.standard_normal((N, d_feat)).astype(np.float32),
        "coords": rng.standard_normal((N, 3)).astype(np.float32),
        "edges": np.stack([src, dst], 1).astype(np.int32),
        "graph_ids": np.repeat(np.arange(n_graphs), nodes_per).astype(np.int32),
        "labels": rng.integers(0, n_classes, n_graphs).astype(np.int32),
        "label_mask": np.ones((n_graphs,), np.float32),
    }, dev)


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
