"""Shared neural layers: pure functions over parameter dicts of tensors.

The port's counterpart of ``repro.models.layers``'s primitives, with the
reference's casts: ``rms_norm`` and ``rope`` compute in float32 and cast back
to the input's dtype, ``softcap`` is applied to whatever dtype it is given
(the callers pass float32), and ``cross_entropy`` works in float32.

Sharding rules follow the reference's logical-axis pattern: every
parameter and input dimension is tagged with a logical name, and
``MeshRules`` maps logical names to mesh axes.  ``MeshRules.spec`` gives a
tuple of mesh-axis entries (the reference's ``PartitionSpec`` entries: a
mesh axis, a tuple of mesh axes, or None), which the dry run
(``launch/dryrun.py``) reads to say what each device would hold.  The
reference's ``constrain`` is not ported: the port runs a model on one
device, so nothing inside a step is constrained to a mesh.

Initializers draw from a ``torch.Generator`` with the reference's
distributions (dense: normal x ``(1/d_in)^0.5``).  They put their tensors on
the card unless the caller passes ``device`` (``"cpu"``, or ``"meta"``, where
they allocate nothing and draw nothing: that is how the configs describe
parameters without making them).

``segment_sum`` is the port's ``jax.ops.segment_sum``: a sum over sorted
segments in a fixed order, the same on the card and on the CPU.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.backend import resolve_device

# ---------------------------------------------------------------------------
# logical axis rules
# ---------------------------------------------------------------------------

#: default production rules: batch over (pod, data); model dims over model.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,              # sequence kept unsharded for training activations
    "kv_seq": "model",        # decode: split-KV over model axis (flash-decode)
    "heads": "model",
    "kv_heads": None,         # GQA kv counts (4-8) don't divide model=16; replicate
    "embed": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_capacity": ("pod", "data"),  # shard the MoE dispatch buffers
    "tokens_flat": ("pod", "data"),      # flattened (B*S,) routing arrays
    "rows": ("pod", "data"),  # embedding-table rows (recsys)
    "table_dim": "model",
    "edges": ("pod", "data"), # GNN edge lists
    "nodes": ("pod", "data"),
    "stack": None,            # scanned layer stack
}


@dataclasses.dataclass(frozen=True)
class MeshRules:
    rules: tuple[tuple[str, Any], ...]

    @classmethod
    def make(cls, overrides: dict[str, Any] | None = None) -> "MeshRules":
        r = dict(DEFAULT_RULES)
        if overrides:
            r.update(overrides)
        return cls(tuple(sorted(r.items())))

    def spec(self, *logical: str | None) -> tuple:
        """One entry per dimension: the mesh axes ``logical`` maps to."""
        d = dict(self.rules)
        return tuple(d.get(ax) if ax is not None else None for ax in logical)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


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


def param_device(device) -> torch.device:
    """Where parameters go: ``meta`` as asked, else ``resolve_device`` (the
    card unless the caller asks for the CPU; raises without a card)."""
    return torch.device("meta") if str(device) == "meta" else \
        resolve_device(device)


def generator(seed: int, device) -> torch.Generator | None:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (None on
    ``meta``, which draws nothing)."""
    dev = torch.device(device)
    if dev.type == "meta":
        return None
    return torch.Generator(device=dev).manual_seed(seed)


def normal(generator: torch.Generator | None, shape, std: float, dtype,
           device=None) -> torch.Tensor:
    """float32 normal draws times ``std``, cast to ``dtype`` (the reference's
    ``(normal(key, shape) * std).astype(dtype)``) on ``device`` (default:
    the card); on ``meta`` an empty tensor of that shape and dtype."""
    device = param_device(device)
    if device.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    z = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (z * std).to(dtype)


def init_dense(generator: torch.Generator | None, d_in: int, d_out: int,
               dtype=torch.float32, *, lead: tuple = (),
               device=None) -> torch.Tensor:
    """A (*lead, d_in, d_out) dense weight: normal x ``(1/d_in)^0.5``;
    ``lead`` stacks one weight per layer group."""
    return normal(generator, (*lead, d_in, d_out), (1.0 / d_in) ** 0.5, dtype,
                  device)


class Segments(NamedTuple):
    """Rows grouped by segment id for ``segment_sum``, made once and reused
    for every sum over the same ids: ``order`` puts the rows in id order (a
    stable sort), ``lengths`` (n + 1,) counts each segment's rows, the last
    count being the dropped rows."""
    order: torch.Tensor
    lengths: torch.Tensor
    n: int

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        rows = data[self.order]
        flat = rows.reshape(rows.shape[0], math.prod(data.shape[1:]))
        out = torch.segment_reduce(flat, "sum", lengths=self.lengths, axis=0,
                                   unsafe=True)
        return out[:self.n].reshape((self.n,) + tuple(data.shape[1:]))


def segments(ids: torch.Tensor, num_segments: int) -> Segments:
    """The ``Segments`` of ``ids``; ids outside [0, num_segments) form the
    dropped segment."""
    n = int(num_segments)
    key = ids.long()
    key = torch.where((key >= 0) & (key < n), key, n)
    order = torch.sort(key, stable=True).indices
    lengths = torch.zeros(n + 1, dtype=torch.long, device=key.device)
    lengths.index_add_(0, key, torch.ones_like(key))
    return Segments(order, lengths, n)


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: (num_segments, *data.shape[1:]) sums of the
    rows of ``data`` by ``ids``; ids outside [0, num_segments) are dropped.

    The rows are stably sorted by id and each segment is summed from zero in
    the rows' order, left to right — the order of the reference's scatter-add
    on the CPU and of ``index_add_`` on the CPU.  On the card
    ``torch.segment_reduce`` sums a 2-D segment one output element per thread
    in that same order, so the result is deterministic (``index_add_`` on the
    card adds by atomics, in an order that varies from run to run)."""
    return segments(ids, num_segments).sum(data)


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
