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
(``launch/dryrun.py``) reads to say what each device would hold and to place
each argument as a ``DTensor``.  ``constrain`` is the reference's in-step
constraint: it returns a plain tensor as it is (every path that runs on a
device), and redistributes a ``DTensor`` (the dry run's collective count)
to the placements its logical names give, except where the reference's
``with_sharding_constraint`` raises on a mesh of ``Auto`` axes and its
``constrain`` returns ``x``.  (The reference's own meshes, from
``jax.make_mesh``, have ``Explicit`` axes, on which every one of its
constraints raises and is skipped: ROADMAP R13.  The port's dry run counts
with its constraints acting, the layouts the reference's code names.)

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


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes one spec entry names, in order."""
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def constraint_skip(spec: tuple, ndim: int,
                    axis_names: tuple[str, ...]) -> str | None:
    """Why the reference's ``with_sharding_constraint(x, P(*spec))`` raises
    on a mesh of ``axis_names`` whose axes are ``Auto`` for an
    ``ndim``-dimensional ``x``, so that its ``constrain`` returns ``x``;
    None where it constrains.  JAX checks, in this order: a mesh axis named
    twice (``DuplicateSpecError``), an axis the mesh lacks, and more entries
    than dimensions.  A dimension its axes do not divide is no reason: JAX
    pads it."""
    named = [a for e in spec for a in spec_axes(e)]
    if len(set(named)) < len(named):
        return "duplicate mesh axis"
    if any(a not in axis_names for a in named):
        return "axis not in the mesh"
    if len(spec) > ndim:
        return "more entries than dimensions"
    return None


def placements(spec: tuple, axis_names: tuple[str, ...], ndim: int) -> list:
    """The ``DTensor`` placements, one per mesh axis, of a spec: ``Shard(d)``
    on each axis that dimension d's entry names, ``Replicate()`` on the
    others.  An entry of several axes must name them in the mesh's order
    (a dimension split over several mesh axes is cut major axis first)."""
    from torch.distributed.tensor import Replicate, Shard
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    out = [Replicate() for _ in axis_names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        pos = [axis_names.index(a) for a in axes]
        if pos != sorted(pos):
            raise NotImplementedError(
                f"spec entry {entry} splits a dimension over mesh axes out of "
                f"the mesh's order {axis_names}")
        for i in pos:
            out[i] = Shard(d)
    return out


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s partial placements reduced (made ``Replicate``);
    anything else as it is.  For a partial whose reduction ``DTensor``
    cannot carry through a later reshape (a vocab-split gather's masked
    partial)."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor) or not any(
            isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in x.placements])


def placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` redistributed to ``p``'s placements where both are
    ``DTensor``s (a parameter's gradient reduced to the parameter's
    sharding, as the reference's gradients come); else ``g`` itself."""
    if type(g) is torch.Tensor or type(p) is torch.Tensor:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def stacked_empty(x: torch.Tensor, n: int):
    """An empty (n, *x.shape) tensor of x's dtype on x's device, to hold n
    tensors like ``x``; for a ``DTensor``, split as ``x`` is on each of its
    dimensions, the new leading one whole (replicated where ``x`` is
    partial)."""
    if type(x) is not torch.Tensor:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if isinstance(x, DTensor):
            local = x.to_local()
            pl = [Shard(p.dim + 1) if isinstance(p, Shard) else Replicate()
                  for p in x.placements]
            return DTensor.from_local(
                local.new_empty((n, *local.shape)), x.device_mesh, pl,
                run_check=False, shape=(n, *x.shape),
                stride=torch.empty((n, *x.shape), device="meta").stride())
    return x.new_empty((n, *x.shape))


def constrain(x: torch.Tensor, rules: MeshRules, *logical: str | None):
    """The reference's ``constrain`` (``with_sharding_constraint`` by
    logical names).  A plain tensor, on any device, comes back as it is.
    A ``DTensor`` is redistributed over its mesh to the placements of
    ``rules.spec(*logical)``, except where ``constraint_skip`` names the
    reason the reference's constraint raises there, which its ``except``
    turns into ``return x``: then ``x`` comes back as it is too.  A
    ``DeviceMesh``'s axes constrain as JAX's ``Auto`` axes do.  Any other
    failure raises."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    spec = rules.spec(*logical)
    if constraint_skip(spec, x.dim(), names) is not None:
        return x
    return x.redistribute(mesh, placements(spec, names, x.dim()))


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
    lengths = key.new_zeros(n + 1)
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
    gold = reduce_partial(torch.gather(logits, -1, labels[..., None].long()))
    return (logz - gold[..., 0]).mean()
