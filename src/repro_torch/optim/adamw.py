"""AdamW with global-norm clipping, a warmup + cosine schedule, and the
int8 error-feedback gradient compression.  The port's counterpart of
``repro.optim.adamw``, on trees of tensors.

The reference's float32 arithmetic is kept: the moments are float32 trees
with the parameters' structure; ``b1 ** step`` and ``b2 ** step`` are
float32 tensor powers; the global norm sums one float32 sum of squares per
leaf, the leaves in the reference's flatten order (``jax.tree.leaves``:
dict keys sorted, as ``checkpoint.ckpt.tree_leaves`` visits them); a bf16
parameter is updated in float32 and rounded back to nearest.

Unlike the reference, ``apply_updates`` updates in place (see its
docstring) and never materializes the clipped float32 gradient tree: the
clip scale is applied leaf by leaf inside the update.  At qwen3-1.7b that
tree alone would be 8.1 GB.

``state_specs`` gives the optimizer state's sharding specs: the
parameters' (FSDP), the step replicated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.checkpoint.ckpt import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32: the number of updates applied
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init_state(params) -> AdamWState:
    """Step 0 and float32 zero moments on each parameter's device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(_zeros32, params),
                      v=tree_map(_zeros32, params))


def state_specs(param_specs) -> AdamWState:
    """Optimizer-state specs = parameter specs (FSDP); the step
    replicated."""
    return AdamWState(step=(), m=param_specs, v=param_specs)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int32 tensor): a linear
    warmup, then a cosine decay to ``min_lr_frac`` of ``lr``; float32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of each leaf's float32 sum of squares (a float32 0-d
    tensor on the first leaf's device: leaves may lie on several)."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack([s.to(sums[0].device)
                                             for s in sums])))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(the float32 gradients scaled to a global norm of at most
    ``max_norm``, the global norm before scaling)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


def apply_updates(params, state: AdamWState, grads, cfg: AdamWConfig):
    """One AdamW step: ``(params, new_state, {"grad_norm", "lr"})``.

    **In place**: every parameter leaf and the moments ``state.m`` and
    ``state.v`` are updated in place, and the returned ``params`` and
    ``new_state.m`` / ``.v`` are those same tensors (only ``step`` is a new
    tensor).  A caller that needs the state before the step copies it
    first.  Runs under ``torch.no_grad()``; ``grads`` (any float dtype) are
    only read.  The arithmetic per leaf is the reference's, in float32:

        g = grad * min(1, clip_norm / global_norm)
        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        p = p - lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p)
    """
    flat_p, flat_m = tree_leaves(params), tree_leaves(state.m)
    flat_v, flat_g = tree_leaves(state.v), tree_leaves(grads)
    if not len(flat_p) == len(flat_m) == len(flat_v) == len(flat_g):
        raise ValueError(f"apply_updates: {len(flat_p)} parameters, "
                         f"{len(flat_m)} / {len(flat_v)} moments and "
                         f"{len(flat_g)} gradients")
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg.clip_norm)
        step = state.step + 1
        lr = schedule(cfg, step)
        t = step.float()
        bc1 = 1 - torch.pow(cfg.b1, t)
        bc2 = 1 - torch.pow(cfg.b2, t)
        for p, m, v, g in zip(flat_p, flat_m, flat_v, flat_g):
            d = p.device                 # leaves may lie on several devices
            g = g.float() * scale.to(d)
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
            del g
            delta = (m / bc1.to(d)).div_((v / bc2.to(d)).sqrt_().add_(cfg.eps))
            delta.add_(p.float() * cfg.weight_decay).mul_(lr.to(d))
            p.copy_(p.float() - delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# error-feedback int8 gradient compression (the cross-pod axis)
# ---------------------------------------------------------------------------

class EFState(NamedTuple):
    residual: Any   # float32 error accumulator, the gradients' structure


def ef_init(params) -> EFState:
    return EFState(residual=tree_map(_zeros32, params))


def compress_decompress(g: torch.Tensor, r: torch.Tensor):
    """int8 quantize -> dequantize with error feedback: (the dequantized
    gradient, the new residual).  Across pods the int8 payload is what an
    all-reduce would carry; the residual keeps the scheme unbiased over
    time (EF-SGD)."""
    x = g.float() + r
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, x - deq


def ef_compress_tree(grads, ef: EFState):
    """``compress_decompress`` leaf by leaf: (dequantized tree, new
    ``EFState``)."""
    out = [compress_decompress(g, r) for g, r in
           zip(tree_leaves(grads), tree_leaves(ef.residual))]
    deq, res = iter([d for d, _ in out]), iter([r for _, r in out])
    return (tree_map(lambda _: next(deq), grads),
            EFState(residual=tree_map(lambda _: next(res), grads)))
