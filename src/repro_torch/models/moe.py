"""Mixture-of-Experts FFN: top-k token-choice routing, sort-based dispatch.
The port's counterpart of ``repro.models.moe`` on one device.

The (T·K) routed copies are sorted by expert id (a stable sort), each copy's
slot inside its expert comes from exclusive-cumsum arithmetic, and the copies
are scattered into a capacity-bounded (E, C, D) buffer; the expert FFN is
then two batched einsums.  top-k gates are renormalized over the selected
experts (Qwen3-MoE's ``norm_topk_prob``); ``n_shared`` adds always-on shared
experts (Llama-4), added after the combine.

Where the port must match the reference exactly:

* **Ties.**  ``lax.top_k`` puts the lower expert first among equal
  probabilities; the port orders by (probability desc, expert asc) with a
  stable descending sort.
* **Capacity.**  ``C = max(8, int(T*K*capacity_factor/E))``.  A copy whose
  slot is at or past C is dropped from the scatter and reads back as 0
  (the reference's ``mode="drop"`` / ``mode="fill"``): such copies write a
  spill row past the buffer's E x C rows, which is never read, and are
  masked to 0 when the experts' outputs are gathered back.  No step needs
  a data-dependent shape, so the layer also runs on ``meta`` tensors.
* **Combine order.**  The reference's ``out.at[tok].add(y)`` adds a token's K
  weighted copies to zeros one after another in the sorted order, i.e. by
  expert ascending.  The port adds them in that order too, left to right
  from zeros, in the activation dtype — no atomics (``index_add_`` on CUDA
  adds in no fixed order).

Left out: the reference's expert-parallel ``_moe_ep_shardmap`` (a
``shard_map`` over a mesh's ``model`` axis) waits for a multi-card slice, and
its custom-VJP dispatch ops are plain forward gathers and scatters here.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    n_shared: int = 0              # always-on shared experts (fused as one MLP)
    capacity_factor: float = 1.25


def init_moe(generator, d_model: int, cfg: MoEConfig, dtype=torch.float32,
             *, lead: tuple = (), device=None) -> dict:
    """The layer's weights on ``device`` (default: the card; ``"meta"``
    allocates nothing); the router stays float32."""
    device = L.param_device(device)
    E, F_ = cfg.n_experts, cfg.d_ff
    scale = (1.0 / d_model) ** 0.5
    p = {
        "router": L.init_dense(generator, d_model, E, torch.float32,
                               lead=lead, device=device),   # float32 router
        "wi_gate": L.normal(generator, (*lead, E, d_model, F_), scale, dtype,
                            device),
        "wi_up": L.normal(generator, (*lead, E, d_model, F_), scale, dtype,
                          device),
        "wo": L.normal(generator, (*lead, E, F_, d_model), (1.0 / F_) ** 0.5,
                       dtype, device),
    }
    if cfg.n_shared:
        Fs = F_ * cfg.n_shared
        kw = dict(lead=lead, device=device)
        p["shared"] = {
            "wi_gate": L.init_dense(generator, d_model, Fs, dtype, **kw),
            "wi_up": L.init_dense(generator, d_model, Fs, dtype, **kw),
            "wo": L.init_dense(generator, Fs, d_model, dtype, **kw),
        }
    return p


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    return max(8, int(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))


def _router(params, x, cfg: MoEConfig):
    """Routing: (gates (T,K), eidx (T,K) int64, probs (T,E), aux ())."""
    E, K = cfg.n_experts, cfg.top_k
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: probability desc, the lower expert first among ties
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :K], eidx[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(0)
    ce = F.one_hot(eidx[:, 0], E).float().mean(0)
    return gates, eidx, probs, E * (me * ce).sum()


def moe_apply(params: dict, x: torch.Tensor,
              cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) flattened tokens.  Returns (out (T, D), aux_loss ()).

    The reference's single-device path (``_moe_dense_dispatch``)."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg)
    gates, eidx, _, aux = _router(params, x, cfg)

    # ---- sort-based dispatch -------------------------------------------------
    tok_ids = torch.arange(T, device=x.device).repeat_interleave(K)   # (T*K,)
    e_flat = eidx.reshape(-1)
    g_flat = gates.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted, tok_sorted, g_sorted = e_flat[order], tok_ids[order], g_flat[order]
    # each expert's first sorted copy (the exclusive cumsum of the experts'
    # counts), from ops that need no data-dependent shape, so the dispatch
    # also runs on ``meta`` tensors
    starts = torch.searchsorted(e_sorted, torch.arange(
        E, dtype=e_sorted.dtype, device=x.device))
    slot = torch.arange(T * K, device=x.device) - starts[e_sorted]
    keep = slot < C                       # past capacity: dropped, reads 0
    # a kept copy's row of the (E*C, D) buffer; every dropped copy writes the
    # spill row E*C, which is never read
    row = torch.where(keep, e_sorted * C + slot, E * C)

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[row] = x[tok_sorted]
    buf = buf[:E * C].view(E, C, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, params["wi_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, params["wi_up"])
    out_buf = torch.einsum("ecf,efd->ecd", h, params["wo"])

    y = torch.where(keep[:, None],
                    out_buf.reshape(E * C, D)[row.clamp(max=E * C - 1)], 0)
    y = y * g_sorted[:, None].to(x.dtype)
    # combine: each token's K copies, expert ascending, added left to right
    # from zeros (the sorted order the reference's scatter-add visits)
    y_tk = torch.empty_like(y)
    y_tk[order] = y                                       # back to (t, k) order
    y_tk = y_tk.reshape(T, K, D)
    by_expert = torch.argsort(eidx, dim=-1, stable=True)  # (T, K)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + torch.gather(
            y_tk, 1, by_expert[:, j, None, None].expand(T, 1, D))[:, 0]

    if cfg.n_shared:
        out = out + L.mlp_apply(params["shared"], x)
    return out, aux
