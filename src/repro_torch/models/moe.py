"""Mixture-of-Experts FFN: top-k token-choice routing, sort-based dispatch.
The port's counterpart of ``repro.models.moe``.

The (T·K) routed copies are sorted by expert id (a stable sort), each copy's
slot inside its expert comes from exclusive-cumsum arithmetic, and the copies
are scattered into a capacity-bounded (E, C, D) buffer; the expert FFN is
then two batched einsums.  top-k gates are renormalized over the selected
experts (Qwen3-MoE's ``norm_topk_prob``); ``n_shared`` adds always-on shared
experts (Llama-4), added after the combine.

Two dispatch paths, chosen as the reference chooses (``moe_apply``):

* **Expert parallelism** (``moe_apply_ep``, the reference's
  ``_moe_ep_shardmap``) under a mesh with a ``model`` axis of M shards,
  when the tokens split evenly into the mesh's ``pod`` x ``data`` blocks
  and the experts into the M shards.  The mesh is a ``launch/mesh.MeshShape``
  passed as an argument and the shards are a device list, not a process
  group: each block of T_loc contiguous rows is routed once with the
  replicated router (the reference's M shards each compute the same
  routing), and each shard m in turn takes the block's gates and expert
  ids, sends every copy that is not one of its E/M experts to a spill
  bucket, dispatches the rest into an (E/M, C, D) buffer with ``C =
  max(8, int(T_loc*K*cf/(E/M)/M) * 2)`` (twice the dense capacity of a
  block), runs its experts and combines its copies; the M partial outputs
  are summed on the block's device in shard order from zeros (the
  reference's ``psum``), then the shared expert is added.  ``aux`` is the
  mean over blocks (the reference's ``pmean``; its ``pmean`` over the
  shards averages M equal values).  A shard runs where its experts lie:
  unplaced, every shard's experts are views of the layer's (E, ...)
  tensors on their device; ``place_experts`` puts each shard's slice on
  its own device once, and is the one place where devices are chosen.
* **The dense dispatch** (``moe_apply_dense``, the reference's
  ``_moe_dense_dispatch``) otherwise: one buffer of every expert, ``C =
  max(8, int(T*K*cf/E))``.

Where the port must match the reference exactly:

* **Ties.**  ``lax.top_k`` puts the lower expert first among equal
  probabilities; the port orders by (probability desc, expert asc) with a
  stable descending sort.
* **Capacity.**  A copy whose slot is at or past C is dropped from the
  scatter and reads back as 0 (the reference's ``mode="drop"`` /
  ``mode="fill"``): such copies, and on the EP path the copies of another
  shard's experts, write a spill row past the buffer's rows, which is never
  read, and are masked to 0 when the experts' outputs are gathered back.
  No step needs a data-dependent shape, so the layer also runs on ``meta``
  tensors.
* **Combine order.**  The reference's ``out.at[tok].add(y)`` adds a token's K
  weighted copies to zeros one after another in the sorted order, i.e. by
  expert ascending.  The port adds them in that order too, left to right
  from zeros, in the activation dtype — no atomics (``index_add_`` on CUDA
  adds in no fixed order).

The reference's custom-VJP dispatch ops are plain forward gathers and
scatters here, differentiated by autograd on both paths.

**Constraints and the dry run.**  ``rules`` (``layers.MeshRules``) puts the
reference's constraints at the dense dispatch's sites that the port's
dense path has: the tokens, the sorted routing arrays, the gathered
copies, the (E, C, D) buffers and the combined output — the forward halves
of its custom-VJP ops (their backward constraints have no place here).
They act on ``DTensor`` activations only (``layers.constrain``): in the
dry run's collective count, which also stands in for the EP path with one
device's program of the reference's ``shard_map``
(``launch/dryrun._ep_dtensor``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import resolve_device
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


def use_ep(n_tokens: int, cfg: MoEConfig, mesh) -> bool:
    """The reference's choice: expert parallelism under a mesh with a
    ``model`` axis when the tokens split into the mesh's ``pod`` x ``data``
    blocks and the experts into its ``model`` shards."""
    return (mesh is not None and "model" in mesh.axis_names
            and n_tokens % token_blocks(mesh) == 0
            and cfg.n_experts % mesh.shape["model"] == 0)


def token_blocks(mesh) -> int:
    """The number of token blocks: the product of the mesh's ``pod`` and
    ``data`` sizes (1 where it has neither)."""
    shape = mesh.shape
    return shape.get("pod", 1) * shape.get("data", 1)


def ep_capacity(n_local_tokens: int, cfg: MoEConfig, n_shards: int) -> int:
    """Slots per local expert on the EP path (the reference's rule)."""
    e_loc = cfg.n_experts // n_shards
    return max(8, int(n_local_tokens * cfg.top_k * cfg.capacity_factor
                      / e_loc / n_shards) * 2)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig,
              mesh=None, *, rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) flattened tokens.  Returns (out (T, D), aux_loss ()).

    ``moe_apply_ep`` where ``use_ep(T, cfg, mesh)``, else the dense
    dispatch (constrained by ``rules``)."""
    if use_ep(x.shape[0], cfg, mesh):
        return moe_apply_ep(params, x, cfg, mesh)
    return moe_apply_dense(params, x, cfg, rules=rules)


def moe_apply_dense(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                    rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's single-device path (``_moe_dense_dispatch``)."""
    gates, eidx, _, aux = _router(params, x, cfg)
    out = _dispatch_combine(params, L.constrain(x, rules, "tokens_flat", None),
                            eidx, gates, cfg.n_experts,
                            capacity(x.shape[0], cfg), rules=rules)
    if cfg.n_shared:
        out = out + L.mlp_apply(params["shared"], x)
    return out, aux


def moe_apply_ep(params: dict, x: torch.Tensor, cfg: MoEConfig,
                 mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ep_shardmap`` over ``mesh``'s ``model`` shards
    (module docstring).  Shard m runs on the device of its experts: views of
    ``params``' (E, ...) leaves, or the m-th entry of the leaves that
    ``place_experts`` made tuples.  The router, the blocks, their partial
    sums and the shared expert stay on ``x``'s device."""
    T, D = x.shape
    M = mesh.shape["model"]
    if not use_ep(T, cfg, mesh):
        raise ValueError(f"no expert parallelism for {T} tokens and "
                         f"{cfg.n_experts} experts on mesh {mesh.shape}")
    T_loc = T // token_blocks(mesh)
    C = ep_capacity(T_loc, cfg, M)
    shards = [_shard_params(params, cfg, m, M) for m in range(M)]
    outs, auxes = [], []
    for xb in x.split(T_loc):
        gates, eidx, _, aux = _router(params, xb, cfg)
        out = torch.zeros((T_loc, D), dtype=x.dtype, device=x.device)
        for m, ps in enumerate(shards):
            dev = ps["wo"].device
            part = _ep_shard(ps, xb.to(dev), gates.to(dev), eidx.to(dev), m,
                             C)
            out = out + part.to(x.device)     # the psum, in shard order
        if cfg.n_shared:
            out = out + L.mlp_apply(params["shared"], xb)
        outs.append(out)
        auxes.append(aux)
    return torch.cat(outs), torch.stack(auxes).mean()


def place_experts(params: dict, n_shards: int, devices=None) -> dict:
    """The layer's weights with each model shard's experts placed on its
    device once: ``wi_gate`` / ``wi_up`` / ``wo`` become tuples of
    ``n_shards`` tensors, shard m's holding its E/n_shards experts on
    ``devices[m]`` (default: ``cuda:{m % device_count}``; raises without a
    card); the router (replicated, one leaf) and the shared expert stay
    where they are, with the activations.  Works on stacked leaves too
    (experts on dim -3).  A slice that is already on its device stays a
    view."""
    if devices is None:
        resolve_device("cuda")                      # raises: no card
        devices = [f"cuda:{m % torch.cuda.device_count()}"
                   for m in range(n_shards)]
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    E = params["router"].shape[-1]
    if E % n_shards:
        raise ValueError(f"{E} experts do not split into {n_shards} shards")
    e_loc = E // n_shards
    out = dict(params)
    for k in ("wi_gate", "wi_up", "wo"):
        t = params[k]
        out[k] = tuple(t.narrow(t.dim() - 3, m * e_loc, e_loc).to(
            resolve_device(d)) for m, d in enumerate(devices))
    return out


def _shard_params(params: dict, cfg: MoEConfig, m: int, M: int) -> dict:
    """Shard m's experts: the m-th entry of a placed tuple, else a view of
    its E/M experts."""
    e_loc = cfg.n_experts // M
    out = {}
    for k in ("wi_gate", "wi_up", "wo"):
        t = params[k]
        if isinstance(t, tuple):
            if len(t) != M:
                raise ValueError(f"{k} is placed on {len(t)} shards, the "
                                 f"mesh has {M}")
            out[k] = t[m]
        else:
            out[k] = t.narrow(0, m * e_loc, e_loc)
    return out


def _ep_shard(ps: dict, xb: torch.Tensor, gates: torch.Tensor,
              eidx: torch.Tensor, m: int, C: int) -> torch.Tensor:
    """One (block, shard): keep the block's copies of shard m's experts (the
    others go to the spill bucket E/M), dispatch, run the experts, combine.
    Returns the partial output (T_loc, D)."""
    e_loc = ps["wi_gate"].shape[0]
    mine = torch.div(eidx, e_loc, rounding_mode="floor") == m
    local = torch.where(mine, eidx - m * e_loc, e_loc)
    return _dispatch_combine(ps, xb, local, gates, e_loc, C, spill=True)


def _dispatch_combine(p: dict, x: torch.Tensor, eidx: torch.Tensor,
                      gates: torch.Tensor, E: int, C: int,
                      spill: bool = False, rules=None) -> torch.Tensor:
    """Sort-based dispatch of x's (T, K) copies into E experts' (E, C, D)
    buffer, the expert FFN, the gather back and the combine, the float32
    gates cast to x's dtype where they weight the copies (the reference's
    EP path casts them first: the same values).  With ``spill``, ``eidx``
    may hold E, the bucket of copies that are not this shard's: never
    dispatched, they combine as 0.  ``rules``: the reference's constraints
    (module docstring)."""
    T, D = x.shape
    K = eidx.shape[1]
    tok_ids = torch.arange(T, device=x.device).repeat_interleave(K)   # (T*K,)
    e_flat = eidx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = L.constrain(e_flat[order], rules, "tokens_flat")
    tok_sorted = L.constrain(tok_ids[order], rules, "tokens_flat")
    g_sorted = L.constrain(gates.reshape(-1)[order], rules, "tokens_flat")
    # each bucket's first sorted copy (the exclusive cumsum of the buckets'
    # counts), from ops that need no data-dependent shape, so the dispatch
    # also runs on ``meta`` tensors
    starts = torch.searchsorted(e_sorted, torch.arange(
        E + spill, dtype=e_sorted.dtype, device=x.device))
    slot = torch.arange(T * K, device=x.device) - starts[e_sorted]
    # past capacity or in the spill bucket: not dispatched, reads 0
    keep = slot < C
    if spill:
        keep = keep & (e_sorted < E)
    # a kept copy's row of the (E*C, D) buffer; every other copy writes the
    # spill row E*C, which is never read
    row = torch.where(keep, e_sorted * C + slot, E * C)

    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[row] = L.constrain(x[tok_sorted], rules, "tokens_flat", None)
    buf = L.constrain(buf[:E * C].view(E, C, D), rules, "experts",
                      "expert_capacity", None)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, p["wi_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["wi_up"])
    out_buf = L.constrain(torch.einsum("ecf,efd->ecd", h, p["wo"]), rules,
                          "experts", "expert_capacity", None)

    y = torch.where(keep[:, None],
                    out_buf.reshape(E * C, D)[row.clamp(max=E * C - 1)], 0)
    y = L.constrain(y, rules, "tokens_flat", None)
    y = y * g_sorted[:, None].to(x.dtype)
    # combine: each token's K copies, bucket ascending, added left to right
    # from zeros (the sorted order the reference's scatter-add visits)
    y_tk = torch.empty_like(y)
    y_tk[order] = y                                       # back to (t, k) order
    y_tk = y_tk.reshape(T, K, D)
    by_expert = torch.argsort(eidx, dim=-1, stable=True)  # (T, K)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + torch.gather(
            y_tk, 1, by_expert[:, j, None, None].expand(T, 1, D))[:, 0]
    return L.constrain(out, rules, "tokens_flat", None)
