"""Recsys towers: FM, xDeepFM (CIN), DLRM (dot interaction), SASRec.  The
port's counterpart of ``repro.models.recsys``.

Common skeleton: huge sparse embedding tables -> feature interaction ->
small MLP -> CTR logit (or next-item scores for SASRec).

``embedding_bag`` is a gather and a segmented sum (``layers.segment_sum``);
single-valued Criteo-style lookups are the special case ``_lookup``.
``param_specs`` gives the reference's sharding: tables of 100,000 rows or
more split by rows, everything else replicated.

Retrieval (``retrieval_scores``, the ``retrieval_cand`` cells) scores one
query against C candidates and keeps the top k:

* **SASRec** gathers the candidates' item embeddings in plain PyTorch and
  ranks them against the user state with ``ops.scored_topk`` — one launch of
  the hand-written K6 kernel on the card (``csrc/topk_score.cu``), the plain
  ``scored_topk_ref`` on the CPU.  Scores are float32 dots formed left to
  right over d; the reference's XLA matvec adds in another order, so scores
  agree within ~1e-6 of max|score|, not bitwise.
* **Tabular towers** run ``forward`` over the candidates with the candidate
  id in sparse slot 0 (the item slot), in chunks of ``chunk`` rows
  (``retrieval_chunk``: xDeepFM's CIN outer product alone is 312 KB a row).
  Every chunk, the last one too, is padded to exactly ``chunk`` rows: a
  matmul's result for a row depends on how many rows it has (a measured
  fact of the CPU's GEMMs), and with one shape a candidate's score does not
  depend on C, on its neighbours or on the chunk it lands in.

Top-k order is ``lax.top_k``'s: score descending, the lower index first
among equal scores (a stable descending sort; ``torch.topk`` promises no
tie order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.kernels import ops
from repro_torch.models import layers as L

# Criteo-1TB per-feature cardinalities (MLPerf DLRM reference)
CRITEO_1TB_ROWS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36)

# a retrieval chunk's largest intermediate stays under this many bytes
CHUNK_BYTES = 1 << 30
MAX_CHUNK = 8192


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    interaction: str                  # 'fm' | 'cin' | 'dot' | 'self-attn-seq'
    n_sparse: int = 39
    embed_dim: int = 10
    n_dense: int = 0
    table_rows: tuple[int, ...] = ()  # per-feature cardinality (len n_sparse)
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    cin_layers: tuple[int, ...] = ()
    # sasrec
    seq_len: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    n_items: int = 0
    dtype: Any = torch.float32

    def rows(self) -> tuple[int, ...]:
        """Per-feature cardinalities, padded to 512-row multiples as the
        reference pads them (pad rows are never addressed)."""
        base = self.table_rows or tuple([1_000_000] * self.n_sparse)
        return tuple(-(-r // 512) * 512 for r in base)


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------

def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor, n_bags: int) -> torch.Tensor:
    """sum-mode EmbeddingBag: ids (L,) flat indices, offsets (n_bags,)
    starts; (n_bags, d).  An id before the first offset is dropped, as the
    reference's ``segment_sum`` drops its bag -1."""
    pos = torch.arange(ids.shape[0], device=ids.device, dtype=offsets.dtype)
    bags = torch.searchsorted(offsets.contiguous(), pos, right=True) - 1
    return L.segment_sum(table[ids.long()], bags, n_bags)


def _mlp_init(gen, dims, dtype, device):
    return [L.init_dense(gen, i, o, dtype, device=device)
            for i, o in zip(dims[:-1], dims[1:])]


def _mlp(ws, x, act=F.relu, final_act=False):
    for i, w in enumerate(ws):
        x = x @ w
        if i < len(ws) - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def init_params(cfg: RecsysConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default: the card; ``"meta"`` describes them without
    allocating), with the reference's layout and distributions."""
    dev = L.param_device(device)
    gen = L.generator(seed, dev)
    dt = cfg.dtype
    p: dict = {}
    if cfg.interaction == "self-attn-seq":
        d = cfg.embed_dim
        p["item_emb"] = L.normal(gen, (cfg.n_items, d), 0.02, dt, dev)
        p["pos_emb"] = L.normal(gen, (cfg.seq_len, d), 0.02, dt, dev)
        p["blocks"] = [
            {**{name: L.init_dense(gen, d, d, dt, device=dev)
                for name in ("wq", "wk", "wv", "wo", "ff1", "ff2")},
             "norm1": torch.zeros((d,), dtype=dt, device=dev),
             "norm2": torch.zeros((d,), dtype=dt, device=dev)}
            for _ in range(cfg.n_blocks)]
        return p

    # tabular towers: one table per sparse feature
    p["tables"] = [L.normal(gen, (rows, cfg.embed_dim),
                            (1.0 / cfg.embed_dim) ** 0.5, dt, dev)
                   for rows in cfg.rows()]
    if cfg.interaction == "fm":
        p["linear"] = [L.normal(gen, (rows, 1), 0.01, dt, dev)
                       for rows in cfg.rows()]
        p["bias"] = torch.zeros((), dtype=dt, device=dev)
    if cfg.bot_mlp:
        p["bot"] = _mlp_init(gen, (cfg.n_dense,) + cfg.bot_mlp, dt, dev)
    if cfg.interaction == "cin":
        dims = (cfg.n_sparse,) + cfg.cin_layers
        p["cin"] = [
            L.normal(gen, (dims[i + 1], dims[i], cfg.n_sparse),
                     (1.0 / (dims[i] * cfg.n_sparse)) ** 0.5, dt, dev)
            for i in range(len(cfg.cin_layers))]
        # DNN branch of xDeepFM
        flat = cfg.n_sparse * cfg.embed_dim
        p["dnn"] = _mlp_init(gen, (flat, 400, 400), dt, dev)
        p["out"] = L.init_dense(gen, sum(cfg.cin_layers) + 400 + 1, 1, dt,
                                device=dev)
        p["linear_w"] = _mlp_init(gen, (flat, 1), dt, dev)
    if cfg.interaction == "dot":
        n_f = cfg.n_sparse + 1
        n_inter = n_f * (n_f - 1) // 2
        p["top"] = _mlp_init(gen, (cfg.bot_mlp[-1] + n_inter,) + cfg.top_mlp,
                             dt, dev)
    return p


def param_specs(cfg: RecsysConfig, rules: L.MeshRules) -> dict:
    """Spec tree matching ``init_params``: the big embedding tables
    (``tables``, ``linear``, ``item_emb`` of 100,000 rows or more) split by
    rows, the rest (towers are tiny) replicated."""
    def spec_of(key):
        def spec(leaf):
            if key in ("tables", "linear", "item_emb") and \
                    leaf.shape[0] >= 100_000:
                return rules.spec("rows", None)
            return ()
        return spec
    return {k: tree_map(spec_of(k), v)
            for k, v in init_params(cfg, device="meta").items()}


# ---------------------------------------------------------------------------
# interactions
# ---------------------------------------------------------------------------

def fm_interaction(v: torch.Tensor) -> torch.Tensor:
    """v (B, F, d): 0.5 * ((sum_i v_i)^2 - sum_i v_i^2), summed over d.
    The O(F d) sum-square trick (Rendle ICDM'10)."""
    s = v.sum(1)
    s2 = (v * v).sum(1)
    return 0.5 * (s * s - s2).sum(-1, keepdim=True)


def dot_interaction(v: torch.Tensor) -> torch.Tensor:
    """v (B, F, d): all pairwise dots, the strict lower triangle flattened
    row by row (``tril_indices(f, -1)``'s order, as the reference's)."""
    g = torch.einsum("bfd,bgd->bfg", v, v)
    f = v.shape[1]
    iu, ju = torch.tril_indices(f, f, offset=-1, device=v.device)
    return g[:, iu, ju]


def cin_layers_apply(ws, x0: torch.Tensor) -> torch.Tensor:
    """Compressed Interaction Network (xDeepFM eq. 6): x^{k+1}_h = sum_{ij}
    W_{h,i,j} (x^k_i * x^0_j); sum-pool each level over d."""
    xk = x0
    pooled = []
    for w in ws:
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)
        xk = torch.einsum("bhmd,nhm->bnd", z, w)
        pooled.append(xk.sum(-1))
    return torch.cat(pooled, dim=-1)    # (B, sum(H_k))


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _take(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``t`` at ``ids`` clipped into the table."""
    return t[ids.long().clamp(0, t.shape[0] - 1)]


def _lookup(tables: Sequence[torch.Tensor], sparse_ids: torch.Tensor,
            rules=None) -> torch.Tensor:
    """sparse_ids (B, F) -> (B, F, d).  One gather per table (sizes
    differ), each id clipped into its table; constrained by ``rules`` as
    the reference constrains it (``layers.constrain``)."""
    v = torch.stack([_take(t, sparse_ids[:, f])
                     for f, t in enumerate(tables)], dim=1)
    return L.constrain(v, rules, "batch", None, None)


def forward(params: dict, batch: dict, cfg: RecsysConfig, *,
            rules=None) -> torch.Tensor:
    """Returns CTR logits (B,) for tabular towers, or (B, S, d) hidden states
    for SASRec (scored against item embeddings by the callers).  ``rules``:
    the reference's constraint on the looked-up embeddings."""
    if cfg.interaction == "self-attn-seq":
        return _sasrec_forward(params, batch["seq"], cfg)

    sparse = batch["sparse"]
    v = _lookup(params["tables"], sparse, rules)               # (B, F, d)
    if cfg.interaction == "fm":
        lin = sum(_take(t, sparse[:, f])
                  for f, t in enumerate(params["linear"]))     # (B, 1)
        return (fm_interaction(v) + lin + params["bias"])[:, 0]
    if cfg.interaction == "cin":
        cin_out = cin_layers_apply(params["cin"], v)
        flat = v.reshape(v.shape[0], -1)
        dnn_out = _mlp(params["dnn"], flat, final_act=True)
        lin = _mlp(params["linear_w"], flat)
        out = torch.cat([cin_out, dnn_out, lin], dim=-1)
        return _mlp([params["out"]], out)[:, 0]
    if cfg.interaction == "dot":
        dense = _mlp(params["bot"], batch["dense"].to(cfg.dtype),
                     final_act=True)                           # (B, d)
        feats = torch.cat([dense[:, None, :], v], dim=1)
        inter = dot_interaction(feats)
        top_in = torch.cat([dense, inter], dim=-1)
        return _mlp(params["top"], top_in)[:, 0]
    raise ValueError(cfg.interaction)


def _sasrec_forward(params, seq, cfg: RecsysConfig) -> torch.Tensor:
    """seq (B, S) item ids -> (B, S, d) hidden states (causal self-attn).
    The reference's constants: the embedding scale ``sqrt(d)`` rounded to
    float32 and cast to the hidden dtype, the logits divided by ``sqrt(d)``
    in float32 (a tensor on the device: never a host scalar, which the card
    may turn into a multiply by its reciprocal), masked with ``-1e30``."""
    B, S = seq.shape
    d = cfg.embed_dim
    dev = seq.device
    root = torch.tensor(math.sqrt(float(d)), dtype=torch.float32, device=dev)
    h = _take(params["item_emb"], seq)
    h = h * root.to(h.dtype) + params["pos_emb"][None, :S]
    mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    for blk in params["blocks"]:
        q = L.rms_norm(h, blk["norm1"])
        att = torch.einsum("bqd,bkd->bqk", q @ blk["wq"], q @ blk["wk"])
        att = att / root.to(att.dtype)
        att = torch.where(mask[None], att.float(), -1e30)
        w = torch.softmax(att, dim=-1).to(h.dtype)
        h = h + (torch.einsum("bqk,bkd->bqd", w, q @ blk["wv"]) @ blk["wo"])
        f = L.rms_norm(h, blk["norm2"])
        h = h + F.relu(f @ blk["ff1"]) @ blk["ff2"]
    return h


def loss_fn(params, batch, cfg: RecsysConfig, *, rules=None):
    """(loss, {"nll": loss}), differentiable (``RecsysArch.make_step(cfg,
    "train")`` takes its gradient: embedding rows gather their gradients by
    the index's backward, a sorted accumulation on the card).  SASRec: BCE
    of the positive against one sampled negative per position, masked where
    ``pos`` is 0; tabular: mean BCE of the CTR logit."""
    if cfg.interaction == "self-attn-seq":
        h = _sasrec_forward(params, batch["seq"], cfg)         # (B, S, d)
        pos_v = _take(params["item_emb"], batch["pos"])
        neg_v = _take(params["item_emb"], batch["neg"])
        s_pos = (h * pos_v).sum(-1).float()
        s_neg = (h * neg_v).sum(-1).float()
        m = (batch["pos"] > 0).float()
        nll = -(F.logsigmoid(s_pos) + F.logsigmoid(-s_neg)) * m
        loss = nll.sum() / torch.clamp(m.sum(), min=1.0)
        return loss, {"nll": loss}
    logits = forward(params, batch, cfg, rules=rules).float()
    y = batch["label"].float()
    loss = (-(y * F.logsigmoid(logits)
              + (1 - y) * F.logsigmoid(-logits))).mean()
    return loss, {"nll": loss}


def serve(params, batch, cfg: RecsysConfig, *, rules=None) -> torch.Tensor:
    """Online/offline scoring: sigmoid CTR (tabular) / next-item hidden (seq)."""
    if cfg.interaction == "self-attn-seq":
        h = _sasrec_forward(params, batch["seq"], cfg)
        return h[:, -1, :]                    # (B, d) user state
    return torch.sigmoid(forward(params, batch, cfg, rules=rules))


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def retrieval_chunk(cfg: RecsysConfig) -> int:
    """Rows per chunk of a tabular retrieval: the largest power of two (at
    most ``MAX_CHUNK``) whose widest intermediate — the (F, d) embeddings
    and for CIN the (H, F, d) outer product and its permuted copy, the (F+1)^2
    Gram matrix, the widest MLP layer — stays under ``CHUNK_BYTES``."""
    fd = cfg.n_sparse * cfg.embed_dim
    widest = max((fd, 400) + cfg.bot_mlp + cfg.top_mlp)
    row = 4 * (2 * fd * (1 + max(cfg.cin_layers, default=0))
               + (cfg.n_sparse + 1) ** 2 + 4 * widest)
    rows = max(1, CHUNK_BYTES // row)
    return min(MAX_CHUNK, 1 << (rows.bit_length() - 1))


def candidate_scores(params, batch, cfg: RecsysConfig, *,
                     chunk: int | None = None) -> torch.Tensor:
    """(C,) float32 scores of a tabular tower for ``batch["candidates"]``:
    ``forward`` with each candidate in sparse slot 0 and the user's other
    features (and dense features) broadcast, in chunks of exactly ``chunk``
    rows (default ``retrieval_chunk(cfg)``; the last chunk padded with the
    first candidate and its pad rows dropped)."""
    cands = batch["candidates"]
    C = cands.shape[0]
    n = chunk or retrieval_chunk(cfg)
    user = batch["sparse"].reshape(1, cfg.n_sparse)
    dense = batch.get("dense") if cfg.n_dense else None
    out = torch.empty(C, dtype=torch.float32, device=cands.device)
    for lo in range(0, C, n):
        part = cands[lo:lo + n]
        m = part.shape[0]
        if m < n:
            part = torch.cat([part, part[:1].expand(n - m)])
        sparse = user.expand(n, cfg.n_sparse).clone()
        sparse[:, 0] = part
        b = {"sparse": sparse}
        if dense is not None:
            b["dense"] = dense.reshape(1, cfg.n_dense).expand(n, cfg.n_dense)
        out[lo:lo + m] = forward(params, b, cfg).float()[:m]
    return out


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, int32 indices), score
    descending, the lower index first among equal scores."""
    if not 0 < k <= scores.shape[-1]:
        raise ValueError(f"top_k: k={k} must be in [1, {scores.shape[-1]}]")
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    return scores.gather(-1, idx), idx.to(torch.int32)


def retrieval_scores(params, batch, cfg: RecsysConfig, k: int = 100, *,
                     kernel_backend: str = "auto"):
    """Score 1 query against n_candidates, return the top k (exact):
    ((k,) float32 scores, (k,) int32 positions in ``batch["candidates"]``).

    SASRec: the user state of ``batch["seq"]`` (1, S) against the gathered
    candidate item embeddings, ranked by ``ops.scored_topk`` (one K6 launch
    on the card; ``kernel_backend="ref"`` asks for its plain version there).
    Tabular: ``candidate_scores`` (chunked), then ``top_k``."""
    if cfg.interaction == "self-attn-seq":
        cands, h = sasrec_candidates(params, batch, cfg)
        return ops.scored_topk(cands, h, k=k, kernel_backend=kernel_backend)
    return top_k(candidate_scores(params, batch, cfg), k)


def sasrec_candidates(params, batch, cfg: RecsysConfig
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """What SASRec's retrieval hands K6: the gathered candidate item
    embeddings (C, d) and the user state of ``batch["seq"]`` (1, S) as (d,)."""
    h = _sasrec_forward(params, batch["seq"], cfg)[:, -1, :]     # (1, d)
    return _take(params["item_emb"], batch["candidates"]), h[0]
