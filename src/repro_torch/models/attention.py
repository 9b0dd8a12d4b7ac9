"""Attention: GQA with a per-layer pattern (global / sliding-window /
chunked), optional qk-norm (Qwen3) and attention-logit softcap (Gemma-2),
RoPE or NoPE.  The port's counterpart of ``repro.models.attention``.

* **Grouped einsums**: queries are shaped (B, S, KV, G, Dh), so the KV
  tensor is never repeated across the G = H / KV query heads of a KV head.
* **Blockwise online softmax** over KV blocks of ``KV_BLOCK`` at
  S >= ``FLASH_THRESHOLD``: a running (m, l, acc) carried through a Python
  loop over the blocks (the reference's ``lax.scan``), so the live score
  tensor is (B, KV, G, S, block) instead of (B, KV, G, S, S).
* **Decode** attends one token against a KV cache; the new key and value are
  written at slot ``cache_len % S_kv`` of the cache *in place*.

The constants are the reference's: a masked score is ``-1e30`` (never
``-inf``), the running max starts at ``-inf`` so the first block's
correction ``exp(m - m_new)`` is 0, probabilities are cast to the activation
dtype before the PV product while the accumulator stays float32, and the
output is divided by ``max(l, 1e-30)``.

Layer patterns:
  'global'   full causal
  'local'    sliding window `window` (Gemma-2 alternates local/global)
  'chunked'  attention confined to aligned `window` chunks (Llama-4 iRoPE
             local layers; its global layers are 'global' with NoPE)
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L

PATTERNS = ("global", "local", "chunked")
FLASH_THRESHOLD = 2048    # dense path below, blockwise at/above
KV_BLOCK = 1024
MASKED = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    d_head: int
    qk_norm: bool = False
    softcap: float | None = None      # attention-logit soft cap (gemma2: 50)
    rope_theta: float = 10000.0
    window: int = 0                   # for local/chunked patterns


def init_attn(generator, d_model: int, cfg: AttnConfig, dtype=torch.float32,
              *, lead: tuple = (), device=None) -> dict:
    """The layer's weights on ``device`` (default: the card; ``"meta"``
    allocates nothing)."""
    device = L.param_device(device)
    hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    kw = dict(lead=lead, device=device)
    p = {
        "wq": L.init_dense(generator, d_model, hd, dtype, **kw),
        "wk": L.init_dense(generator, d_model, kvd, dtype, **kw),
        "wv": L.init_dense(generator, d_model, kvd, dtype, **kw),
        "wo": L.init_dense(generator, hd, d_model, dtype, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*lead, cfg.d_head), dtype=dtype,
                                  device=device)
        p["k_norm"] = torch.zeros((*lead, cfg.d_head), dtype=dtype,
                                  device=device)
    return p


def _mask(pattern_id: int, q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: int) -> torch.Tensor:
    """Boolean (q, k) mask for pattern_id in {0: global, 1: local, 2: chunked}."""
    w = max(window, 1)
    causal = k_pos[None, :] <= q_pos[:, None]
    if pattern_id == 0:
        return causal
    if pattern_id == 1:
        return causal & (q_pos[:, None] - k_pos[None, :] < w)
    return causal & (torch.div(q_pos[:, None], w, rounding_mode="floor")
                     == torch.div(k_pos[None, :], w, rounding_mode="floor"))


def _grouped_scores(q5, k, scale: float, softcap: float | None):
    """q5 (B,S,KV,G,Dh) x k (B,T,KV,Dh) -> float32 (B,KV,G,S,T), softcapped."""
    s = torch.einsum("bskgd,btkd->bkgst", q5, k) * scale
    return L.softcap(s.float(), softcap)


def _dense_attend(q5, k, v, mask, softcap, scale):
    scores = _grouped_scores(q5, k, scale, softcap)
    scores = scores.masked_fill(~mask, MASKED)
    probs = torch.softmax(scores, dim=-1).to(q5.dtype)
    return torch.einsum("bkgst,btkd->bskgd", probs, v)


def _flash_attend(q5, k, v, pattern_id: int, window: int, softcap, scale,
                  block: int):
    """Online-softmax blockwise attention; causal-pattern masks per block."""
    B, S, KV, G, Dh = q5.shape
    T = k.shape[1]
    q_pos = torch.arange(S, dtype=torch.int32, device=q5.device)
    m = torch.full((B, KV, G, S), -float("inf"), dtype=torch.float32,
                   device=q5.device)
    l = torch.zeros((B, KV, G, S), dtype=torch.float32, device=q5.device)
    acc = torch.zeros((B, KV, G, S, Dh), dtype=torch.float32, device=q5.device)
    for lo in range(0, T, block):
        # the reference pads the last block with masked zero keys; they only
        # add to l while a row has seen no unmasked key, and the first
        # unmasked key's correction exp(-1e30 - m) = 0 clears that
        k_j, v_j = k[:, lo:lo + block], v[:, lo:lo + block]
        k_pos = torch.arange(lo, lo + k_j.shape[1], dtype=torch.int32,
                             device=q5.device)
        s = torch.einsum("bskgd,btkd->bkgst", q5, k_j) * scale
        s = L.softcap(s.float(), softcap)
        s = s.masked_fill(~_mask(pattern_id, q_pos, k_pos, window), MASKED)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,btkd->bkgsd", p.to(q5.dtype), v_j).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.movedim(3, 1).to(q5.dtype)                        # (B,S,KV,G,Dh)


def attend(params: dict, x: torch.Tensor, cfg: AttnConfig, pattern_id: int,
           *, use_rope: bool = True,
           kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
           cache_len: int | None = None,
           rules=None) -> tuple[torch.Tensor, tuple]:
    """x: (B, S, D).  Training/prefill when kv_cache is None; decode (S == 1,
    new token written in place at slot ``cache_len % S_kv``) otherwise.
    ``rules``: the reference's constraints on q and k (prefill) and on the
    caches (decode), ``layers.constrain``.

    Returns (output (B, S, D), kv pair (B, S_kv, KV, Dh))."""
    B, S, D = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KV
    scale = 1.0 / (Dh ** 0.5)

    q = (x @ params["wq"]).reshape(B, S, H, Dh)
    k = (x @ params["wk"]).reshape(B, S, KV, Dh)
    v = (x @ params["wv"]).reshape(B, S, KV, Dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, params["q_norm"])
        k = L.rms_norm(k, params["k_norm"])

    if kv_cache is None:
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        if use_rope:
            q = L.rope(q, pos.expand(B, S), cfg.rope_theta)
            k = L.rope(k, pos.expand(B, S), cfg.rope_theta)
        q = L.constrain(q, rules, "batch", "seq", "heads", None)
        k = L.constrain(k, rules, "batch", "seq", "kv_heads", None)
        q5 = q.reshape(B, S, KV, G, Dh)
        if S >= FLASH_THRESHOLD:
            o5 = _flash_attend(q5, k, v, pattern_id, cfg.window, cfg.softcap,
                               scale, KV_BLOCK)
        else:
            mask = _mask(pattern_id, pos[0], pos[0], cfg.window)
            o5 = _dense_attend(q5, k, v, mask, cfg.softcap, scale)
        out = o5.reshape(B, S, H * Dh) @ params["wo"]
        return out, (k, v)

    # ---- decode: one token vs cache ----------------------------------------
    ck, cv = kv_cache                           # (B, S_kv, KV, Dh)
    S_kv = ck.shape[1]
    cache_len = int(cache_len)
    if use_rope:
        pos = torch.full((B, 1), cache_len, dtype=torch.int32, device=x.device)
        q = L.rope(q, pos, cfg.rope_theta)
        k = L.rope(k, pos, cfg.rope_theta)
    slot = cache_len % S_kv
    ck[:, slot:slot + 1] = k.to(ck.dtype)
    cv[:, slot:slot + 1] = v.to(cv.dtype)
    ck = L.constrain(ck, rules, "batch", "kv_seq", "kv_heads", None)
    cv = L.constrain(cv, rules, "batch", "kv_seq", "kv_heads", None)
    kq_pos = torch.arange(S_kv, dtype=torch.int32, device=x.device)
    ring_full = cache_len >= S_kv               # window-sized ring has wrapped
    valid = (kq_pos <= cache_len) | ring_full
    if S_kv <= max(cfg.window, 1):
        # ring buffer sized to the window: every live slot is in-window
        # (keys were RoPE'd at absolute positions when written)
        mask = valid[None, :]
    else:
        q_pos = torch.full((1,), cache_len, dtype=torch.int32, device=x.device)
        mask = _mask(pattern_id, q_pos, kq_pos, cfg.window) & valid[None, :]
    q5 = q.reshape(B, 1, KV, G, Dh)
    o5 = _dense_attend(q5, ck, cv, mask, cfg.softcap, scale)
    out = o5.reshape(B, S, H * Dh) @ params["wo"]
    return out, (ck, cv)
