"""Shared neural layers: pure functions over parameter dicts of tensors.

The port's counterpart of ``repro.models.layers``'s primitives, with the
reference's casts: ``rms_norm`` and ``rope`` compute in float32 and cast back
to the input's dtype, ``softcap`` is applied to whatever dtype it is given
(the callers pass float32), and ``cross_entropy`` works in float32.

The reference's sharding rules (``MeshRules``, ``DEFAULT_RULES``,
``constrain``) are left out: the port runs a model on one device, which has
no mesh to shard over.

Initializers draw from a ``torch.Generator`` with the reference's
distributions (dense: normal x ``(1/d_in)^0.5``).  On the ``meta`` device
they allocate nothing and draw nothing: that is how the configs describe
parameters without making them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings on split halves. x: (..., seq, heads, d_head);
    positions: (..., seq).  Angles in float32."""
    half = x.shape[-1] // 2
    expo = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     expo)
    angles = positions[..., :, None, None].float() * freq   # (..., s, 1, half)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def normal(generator: torch.Generator | None, shape, std: float, dtype,
           device) -> torch.Tensor:
    """float32 normal draws times ``std``, cast to ``dtype`` (the reference's
    ``(normal(key, shape) * std).astype(dtype)``); on ``meta`` an empty
    tensor of that shape and dtype."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    z = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (z * std).to(dtype)


def init_dense(generator: torch.Generator | None, d_in: int, d_out: int,
               dtype=torch.float32, *, lead: tuple = (),
               device="cpu") -> torch.Tensor:
    """A (*lead, d_in, d_out) dense weight: normal x ``(1/d_in)^0.5``;
    ``lead`` stacks one weight per layer group."""
    return normal(generator, (*lead, d_in, d_out), (1.0 / d_in) ** 0.5, dtype,
                  device)


def mlp_apply(params: dict, x: torch.Tensor, act=F.silu,
              gated: bool = True) -> torch.Tensor:
    """SwiGLU (gated=True) or plain MLP."""
    if gated:
        h = act(x @ params["wi_gate"]) * (x @ params["wi_up"])
    else:
        h = act(x @ params["wi_up"])
    return h @ params["wo"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; logits (..., V) any float dtype, labels int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
