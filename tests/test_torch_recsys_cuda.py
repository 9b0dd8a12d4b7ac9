"""The recsys towers and EGNN on the card against the same weights on the
CPU, and K6 at SASRec's retrieval shape.  Card only (the ``cuda`` marker);
this file does not import JAX, so it runs wherever the port does.

Tolerances: float32 with TF32 off, card against CPU within 1e-5 of the
output's scale (the order of float32 sums inside matmuls); K6 against its
plain version bitwise; EGNN's segmented sums card against CPU bitwise (both
add each node's edges from zero in edge order).
"""
import importlib

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import egnn
from repro_torch.kernels import backend, ops
from repro_torch.models import gnn
from repro_torch.models import layers as L
from repro_torch.models import recsys

REL = 1e-5
RECSYS = ["fm", "xdeepfm", "dlrm_mlperf", "sasrec"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _batch(cfg, B: int, seed: int, n_cand: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.interaction == "self-attn-seq":
        b = {"seq": rng.integers(1, cfg.n_items, (B, cfg.seq_len))}
        hi = cfg.n_items
    else:
        rows = np.array(cfg.rows())
        b = {"sparse": (rng.random((B, cfg.n_sparse)) * rows).astype(np.int64)}
        if cfg.n_dense:
            b["dense"] = rng.standard_normal((B, cfg.n_dense)).astype(np.float32)
        hi = cfg.rows()[0]
    if n_cand:
        b["candidates"] = rng.permutation(hi)[:n_cand]
    return {k: torch.from_numpy(v.astype(np.float32 if v.dtype == np.float32
                                         else np.int32)) for k, v in b.items()}


def _to(tree, device):
    return pytree.tree_map(lambda t: t.to(device), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("mod", RECSYS)
def test_smoke_config_on_card_matches_cpu(card, mod):
    arch = importlib.import_module(f"repro_torch.configs.{mod}").ARCH
    cfg = arch.config(smoke=True)
    cpu = arch.init_params(cfg, seed=0, device="cpu")
    dev = _to(cpu, card)
    b = _batch(cfg, 16, 1)
    serve = arch.make_step(cfg, "serve")
    assert _rel(serve(dev, _to(b, card)), serve(cpu, b)) <= REL
    r = _batch(cfg, 1, 2, n_cand=400)
    step = arch.make_step(cfg, "retrieval")
    backend.reset_launch_counts()
    gs, gi = step(dev, _to(r, card))
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    want = {"scored_topk": 1} if mod == "sasrec" else {}
    assert {k: v for k, v in counts.items() if v} == want
    ws, wi = step(cpu, r)
    assert gs.is_cuda and gi.dtype == torch.int32
    assert _rel(gs, ws) <= REL
    ws = ws.double()
    gap = (ws[:-1] - ws[1:]) > REL * float(ws.abs().max())
    apart = torch.ones(100, dtype=torch.bool)
    apart[1:] &= gap
    apart[:-1] &= gap
    assert torch.equal(gi.cpu()[apart], wi[apart])


@pytest.mark.cuda
def test_sasrec_retrieval_on_card_is_k6_bitwise(card):
    """SASRec's step on the card equals the plain K6 on the card."""
    arch = importlib.import_module("repro_torch.configs.sasrec").ARCH
    cfg = arch.config(smoke=True)
    p = arch.init_params(cfg, seed=3, device=card)
    r = _to(_batch(cfg, 1, 4, n_cand=500), card)
    a = recsys.retrieval_scores(p, r, cfg, k=100)
    b = recsys.retrieval_scores(p, r, cfg, k=100, kernel_backend="ref")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_k6_at_sasrec_shape_bitwise(card, offset):
    """C = 10^6 rows of d = 50 float32 (200-byte rows: the unstaged path;
    ``offset`` 1 also leaves the base unaligned), k = 100 (the shared-list
    path over many blocks), ties included."""
    g = torch.Generator(device=card).manual_seed(5)
    emb = torch.randn((1_000_000 + offset, 50), generator=g, device=card)
    cands = emb[offset:]
    q = torch.randn(50, generator=g, device=card)
    cands[3] = q * 4                          # a tied pair of sure winners
    cands[900_001] = q * 4
    s, i = ops.scored_topk(cands, q, k=100)
    rs, ri = ops.scored_topk(cands, q, k=100, kernel_backend="ref")
    assert torch.equal(s, rs) and torch.equal(i, ri)
    assert i[:2].tolist() == [3, 900_001]


@pytest.mark.cuda
def test_tabular_retrieval_chunk_invariant_on_card(card):
    arch = importlib.import_module("repro_torch.configs.xdeepfm").ARCH
    cfg = arch.config(smoke=True)
    p = arch.init_params(cfg, seed=6, device=card)
    b = _to(_batch(cfg, 1, 7, n_cand=900), card)
    base = recsys.candidate_scores(p, b, cfg, chunk=128)
    perm = torch.randperm(900, device=card)
    shuf = recsys.candidate_scores(p, {**b, "candidates": b["candidates"][perm]},
                                   cfg, chunk=128)
    assert torch.equal(shuf, base[perm])


def _graph(cfg, n: int, e: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    b = {"feats": rng.standard_normal((n, cfg.d_feat)).astype(np.float32),
         "coords": rng.standard_normal((n, 3)).astype(np.float32),
         "edges": rng.integers(0, n, (e, 2)).astype(np.int32),
         "labels": rng.integers(0, cfg.n_classes,
                                cfg.n_graphs if cfg.graph_readout else n
                                ).astype(np.int32)}
    if cfg.graph_readout:
        b["graph_ids"] = np.sort(rng.integers(0, cfg.n_graphs + 1, n)
                                 ).astype(np.int32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_egnn_on_card_matches_cpu_and_repeats(card, shape):
    cfg = egnn.ARCH.config_for(shape, smoke=True)
    cpu = egnn.ARCH.init_params(cfg, seed=8, device="cpu")
    dev = _to(cpu, card)
    b = _graph(cfg, 600, 5000, 9)
    got = gnn.forward(dev, _to(b, card), cfg)
    assert torch.equal(got, gnn.forward(dev, _to(b, card), cfg))   # no atomics
    assert _rel(got, gnn.forward(cpu, b, cfg)) <= REL
    assert _rel(gnn.loss_fn(dev, _to(b, card), cfg)[0],
                gnn.loss_fn(cpu, b, cfg)[0]) <= REL


@pytest.mark.cuda
def test_segment_sum_on_card_equals_cpu_bitwise(card):
    rng = np.random.default_rng(10)
    data = torch.from_numpy((rng.standard_normal((20000, 64))
                             * np.exp(rng.uniform(-6, 6, (20000, 64))))
                            .astype(np.float32))
    ids = torch.from_numpy(rng.integers(-5, 3000, 20000))
    want = L.segment_sum(data, ids, 2990)
    got = L.segment_sum(data.to(card), ids.to(card), 2990)
    assert torch.equal(got.cpu(), want)
