"""Decoder-only LM: GQA / MoE / alternating attention patterns.  The port's
counterpart of ``repro.models.transformer`` (forward, prefill, decode).

The repeating unit is the *layer group* = ``cfg.pattern`` (e.g. Gemma-2:
('local','global'); Llama-4: ('chunked','chunked','chunked','global') with
NoPE on the global layers).  Parameters keep the reference's layout:

    {"embed": (V, D), "final_norm": (D,), "lm_head": (V, D),
     "blocks": [one dict per group position, every leaf stacked (n_groups, ...)]}

and the layers run in the reference's scan order: for each group ``g``, the
pattern's positions ``i`` in turn, with ``blocks[i]`` sliced at ``g`` — so
layer ``l`` is group ``l // len(pattern)``, position ``l % len(pattern)``.

Caches keep the reference's layout too: one (k, v) pair per group position,
each (n_groups, B, S_kv, KV, Dh).  ``decode_step`` writes each layer's new
key and value into its cache *in place* and returns the same tensors.

Entry points (each takes ``mesh=`` for the MoE layers' expert
parallelism, ``models/moe.py``; ``place_experts`` puts the shards on their
devices once; and ``rules=``, the ``layers.MeshRules`` of the reference's
in-step constraints, ``layers.constrain``, which act on ``DTensor``
activations only, i.e. in the dry run's collective count):
  loss_fn(params, batch)                         (train_* shapes, through
                                                 ``LMArch.make_step``'s
                                                 train_step and autograd)
  prefill(params, tokens)                        (prefill_* shapes)
  decode_step(params, caches, tokens, cache_len) (decode_* / long_* shapes)
They run on the device the parameters are on; ``init_params`` and
``init_cache`` put them on the card unless the caller passes ``device``.

With ``cfg.remat`` and autograd on, ``forward`` runs each layer under
``torch.utils.checkpoint`` (non-reentrant): only the layers' inputs are kept
for the backward pass, and each layer's activations are recomputed there —
the reference's ``jax.checkpoint(..., nothing_saveable)`` around each layer
group of its scan.  The layers read their weights through one ``unbind`` of
each stacked leaf, so the backward pass stacks the layers' gradients once
(a per-layer index would add a full-size zero tensor per layer).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None            # default d_model // n_heads
    pattern: tuple[str, ...] = ("global",)
    use_rope_pattern: tuple[bool, ...] = (True,)
    window: int = 0
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_norms: bool = False             # Gemma-2 post-block norms
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: M.MoEConfig | None = None
    dtype: Any = torch.bfloat16
    remat: bool = True
    aux_loss_weight: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(f"{self.n_layers} layers are not whole groups of "
                             f"the pattern {self.pattern}")
        return self.n_layers // len(self.pattern)

    def attn_cfg(self) -> A.AttnConfig:
        return A.AttnConfig(n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                            d_head=self.head_dim, qk_norm=self.qk_norm,
                            softcap=self.attn_softcap, rope_theta=self.rope_theta,
                            window=self.window)

    def param_count(self) -> int:
        """Analytic parameter count."""
        D, V, Dh = self.d_model, self.vocab, self.head_dim
        attn = D * Dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.moe:
            ffn = (self.moe.n_experts * 3 * D * self.moe.d_ff
                   + D * self.moe.n_experts
                   + (3 * D * self.moe.d_ff * self.moe.n_shared))
        else:
            ffn = 3 * D * self.d_ff
        return self.n_layers * (attn + ffn) + 2 * V * D

    def active_param_count(self) -> int:
        """MoE: params touched per token (6·N_active·D FLOPs convention)."""
        if not self.moe:
            return self.param_count()
        D, V = self.d_model, self.vocab
        Dh = self.head_dim
        attn = D * Dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = (self.moe.top_k + self.moe.n_shared) * 3 * D * self.moe.d_ff
        return self.n_layers * (attn + ffn) + 2 * V * D


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _init_blocks(generator, cfg: LMConfig, device) -> dict:
    """One group position's parameters, stacked over the n_groups layers."""
    dtype, D, lead = cfg.dtype, cfg.d_model, (cfg.n_groups,)
    kw = dict(lead=lead, device=device)
    p = {
        "attn": A.init_attn(generator, D, cfg.attn_cfg(), dtype, **kw),
    }
    for name in ("norm1", "norm2") + (("norm1_post", "norm2_post")
                                      if cfg.post_norms else ()):
        p[name] = torch.zeros((*lead, D), dtype=dtype, device=device)
    if cfg.moe:
        p["moe"] = M.init_moe(generator, D, cfg.moe, dtype, **kw)
    else:
        p["mlp"] = {
            "wi_gate": L.init_dense(generator, D, cfg.d_ff, dtype, **kw),
            "wi_up": L.init_dense(generator, D, cfg.d_ff, dtype, **kw),
            "wo": L.init_dense(generator, cfg.d_ff, D, dtype, **kw),
        }
    return p


def init_params(cfg: LMConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (default: the card; ``"meta"`` describes them without
    allocating), with the reference's distributions: dense weights normal x
    ``(1/d_in)^0.5``, embedding and head normal x 0.02, norms zeros."""
    dev = L.param_device(device)
    gen = L.generator(seed, dev)
    blocks = [_init_blocks(gen, cfg, dev) for _ in cfg.pattern]
    shape = (cfg.vocab, cfg.d_model)
    return {
        "embed": L.normal(gen, shape, 0.02, cfg.dtype, dev),
        "blocks": blocks,                   # list over group positions
        "final_norm": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=dev),
        "lm_head": L.normal(gen, shape, 0.02, cfg.dtype, dev),  # used as .T
    }


def param_specs(cfg: LMConfig, rules: L.MeshRules) -> dict:
    """Spec tree matching ``init_params`` (FSDP + TP, the reference's):
    one tuple of mesh-axis entries per leaf, the stacked leaves led by an
    unsharded (n_groups,) axis."""
    def attn_spec():
        s = {"wq": rules.spec("embed", "heads"),
             "wk": rules.spec("embed", "heads"),
             "wv": rules.spec("embed", "heads"),
             "wo": rules.spec("heads", "embed")}
        if cfg.qk_norm:
            s["q_norm"] = rules.spec(None)
            s["k_norm"] = rules.spec(None)
        return s

    def mlp_spec():
        return {"wi_gate": rules.spec("embed", "mlp"),
                "wi_up": rules.spec("embed", "mlp"),
                "wo": rules.spec("mlp", "embed")}

    def block_spec():
        p = {"attn": attn_spec(),
             "norm1": rules.spec(None), "norm2": rules.spec(None)}
        if cfg.post_norms:
            p["norm1_post"] = rules.spec(None)
            p["norm2_post"] = rules.spec(None)
        if cfg.moe:
            p["moe"] = {
                "router": rules.spec("embed", "experts"),
                "wi_gate": rules.spec("experts", "batch", None),
                "wi_up": rules.spec("experts", "batch", None),
                "wo": rules.spec("experts", None, "batch"),
            }
            if cfg.moe.n_shared:
                p["moe"]["shared"] = mlp_spec()
        else:
            p["mlp"] = mlp_spec()
        return p

    def stack(spec):
        return {k: stack(v) if isinstance(v, dict) else (None, *v)
                for k, v in spec.items()}

    return {
        "embed": rules.spec("vocab", "embed"),
        "blocks": [stack(block_spec()) for _ in cfg.pattern],
        "final_norm": rules.spec(None),
        "lm_head": rules.spec("vocab", "embed"),
    }


def layers(params: dict, cfg: LMConfig) -> list[tuple[int, int, dict]]:
    """(group, position, block params as views) of every layer, in scan
    order; each stacked leaf is unbound once."""
    per_pos = []
    for blk in params["blocks"]:
        leaves, spec = pytree.tree_flatten(blk)
        per_pos.append(([t.unbind(0) for t in leaves], spec))
    return [(g, i, pytree.tree_unflatten([u[g] for u in per_pos[i][0]],
                                         per_pos[i][1]))
            for g in range(cfg.n_groups) for i in range(len(cfg.pattern))]


def place_experts(params: dict, cfg: LMConfig, n_shards: int,
                  devices=None) -> dict:
    """``params`` with every MoE layer's experts split into ``n_shards``
    model shards and each shard placed on its device once
    (``moe.place_experts`` on the stacked leaves; default: shard m on
    ``cuda:{m % device_count}``).  Pass the result, with a mesh whose
    ``model`` axis has ``n_shards`` shards, to any entry point; a train
    step on it updates each shard's experts where they lie and the one
    router leaf once."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE layers")
    return dict(params, blocks=[
        dict(blk, moe=M.place_experts(blk["moe"], n_shards, devices))
        for blk in params["blocks"]])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    # sqrt(d_model) is rounded to the activation dtype first, as in the
    # reference
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
    scale = scale.to(cfg.dtype).to(tokens.device)
    return params["embed"][tokens.long()].to(cfg.dtype) * scale


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"])
    logits = x @ params["lm_head"].T.to(cfg.dtype)
    return L.softcap(logits.float(), cfg.final_softcap)


def _block_apply(p: dict, x: torch.Tensor, cfg: LMConfig, pattern: str,
                 use_rope: bool, kv_cache=None, cache_len=None, mesh=None,
                 rules=None):
    pat_id = A.PATTERNS.index(pattern)
    h = L.rms_norm(x, p["norm1"])
    attn_out, new_kv = A.attend(p["attn"], h, cfg.attn_cfg(), pat_id,
                                use_rope=use_rope, kv_cache=kv_cache,
                                cache_len=cache_len, rules=rules)
    if cfg.post_norms:
        attn_out = L.rms_norm(attn_out, p["norm1_post"])
    x = x + attn_out
    h = L.rms_norm(x, p["norm2"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe:
        B, S, D = h.shape
        out, aux = M.moe_apply(p["moe"], h.reshape(B * S, D), cfg.moe, mesh,
                               rules=rules)
        out = out.reshape(B, S, D)
    else:
        out = L.mlp_apply(p["mlp"], h)
    if cfg.post_norms:
        out = L.rms_norm(out, p["norm2_post"])
    return x + out, new_kv, aux


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            collect_cache: bool = False, *, mesh=None, rules=None):
    """tokens (B, S) -> (logits (B, S, V) float32, aux ()) [+ caches: one
    (k, v) pair per group position, each (n_groups, B, S, KV, Dh)].
    ``mesh`` (a ``launch/mesh.MeshShape``) goes to every MoE layer
    (``moe.moe_apply``: expert parallelism where the reference takes it);
    without a mesh the MoE layers take the dense dispatch.  ``rules``: the
    reference's constraints, at its sites (the embedding, each layer
    group's input, the logits)."""
    x = _embed(params, tokens, cfg)
    x = L.constrain(x, rules, "batch", "seq", "embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # one (k, v) pair per group position, each (n_groups, B, S, KV, Dh),
    # made at the position's first layer
    caches = [None] * len(cfg.pattern) if collect_cache else None
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    for g, i, p in layers(params, cfg):
        if i == 0:
            # the reference pins its scan carry at each group's start
            x = L.constrain(x, rules, "batch", "seq", "embed")
        if remat:
            x, a = checkpoint(_layer, p, x, cfg, cfg.pattern[i],
                              cfg.use_rope_pattern[i], mesh, rules,
                              use_reentrant=False)
        else:
            x, (k, v), a = _block_apply(p, x, cfg, cfg.pattern[i],
                                        cfg.use_rope_pattern[i], mesh=mesh,
                                        rules=rules)
            if collect_cache:
                if g == 0:
                    caches[i] = (L.stacked_empty(k, cfg.n_groups),
                                 L.stacked_empty(v, cfg.n_groups))
                caches[i][0][g] = k
                caches[i][1][g] = v
        aux = aux + a
    # vocab-parallel logits, S unsharded (the reference's note: seq and
    # vocab may both map to the model axis)
    logits = L.constrain(_logits(params, x, cfg), rules, "batch", None,
                         "vocab")
    return (logits, aux, caches) if collect_cache else (logits, aux)


def _layer(p: dict, x: torch.Tensor, cfg: LMConfig, pattern: str,
           use_rope: bool, mesh=None, rules=None):
    """One layer's (output, aux) — what a rematerialized layer keeps."""
    x, _, aux = _block_apply(p, x, cfg, pattern, use_rope, mesh=mesh,
                             rules=rules)
    return x, aux


def loss_fn(params: dict, batch: dict, cfg: LMConfig, *, mesh=None,
            rules=None):
    """The reference's training loss: (loss, {"nll", "aux"}) — the mean
    token NLL plus ``aux_loss_weight`` x the MoE layers' summed balancing
    loss.  Differentiable; ``LMArch.make_step(cfg, "train")`` takes its
    gradient."""
    logits, aux = forward(params, batch["tokens"], cfg, mesh=mesh,
                          rules=rules)
    nll = L.cross_entropy(logits, batch["labels"])
    return nll + cfg.aux_loss_weight * aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_shapes(cfg: LMConfig, batch: int, max_len: int) -> list:
    """Per group position: a (k, v) pair of ``meta`` tensors (n_groups, B,
    S_kv, KV, Dh).  Local and chunked layers get window-sized ring buffers
    of ``min(window, max_len)`` slots."""
    out = []
    for pat in cfg.pattern:
        s_kv = max_len if pat == "global" or cfg.window == 0 else \
            min(cfg.window, max_len)
        shp = (cfg.n_groups, batch, s_kv, cfg.n_kv_heads, cfg.head_dim)
        out.append(tuple(torch.empty(shp, dtype=cfg.dtype, device="meta")
                         for _ in range(2)))
    return out


def init_cache(cfg: LMConfig, batch: int, max_len: int, *,
               device=None) -> list:
    """Zero caches of ``cache_shapes`` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return [tuple(torch.zeros(t.shape, dtype=t.dtype, device=dev)
                  for t in pair) for pair in cache_shapes(cfg, batch, max_len)]


def decode_step(params: dict, caches: list, tokens: torch.Tensor,
                cache_len, cfg: LMConfig, *, mesh=None, rules=None):
    """One decode step: tokens (B,) at position ``cache_len`` (an int or a
    0-d tensor) -> (logits (B, V) float32, caches updated in place).  The
    MoE layers see B tokens: under ``mesh`` they take expert parallelism
    where B splits into the mesh's token blocks, else the dense dispatch
    (the reference's rule)."""
    x = _embed(params, tokens[:, None], cfg)
    cache_len = int(cache_len)
    for g, i, p in layers(params, cfg):
        kv = (caches[i][0][g], caches[i][1][g])
        x, _, _ = _block_apply(p, x, cfg, cfg.pattern[i],
                               cfg.use_rope_pattern[i], kv_cache=kv,
                               cache_len=cache_len, mesh=mesh, rules=rules)
    return _logits(params, x, cfg)[:, 0], caches


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
            mesh=None, rules=None):
    """Prefill: the full forward, returning logits and caches S long at every
    layer (the reference has no function that places them into
    ``init_cache``'s rings, and neither has the port)."""
    logits, _, caches = forward(params, tokens, cfg, collect_cache=True,
                                mesh=mesh, rules=rules)
    return logits, caches
