"""Architecture glue: Cell (arch x shape) definitions, abstract inputs and
parameters as ``meta`` tensors (shapes and dtypes, no allocation), their
sharding specs, and the functions that build a step.  The port's
counterpart of ``repro.configs.base``.

Every architecture provides an ArchDef; ``arch.make_step(cfg, kind)`` gives
the step a cell runs (the LM family's also takes ``mesh=`` for its MoE
layers' expert parallelism),
``arch.abstract_inputs(cfg, shape)`` its inputs and
``arch.abstract_params(cfg)`` its parameters; ``arch.param_specs(cfg,
rules)`` and ``arch.input_specs(cfg, shape, rules)`` give, per leaf, the
mesh axes each dimension would be split over (``launch/dryrun.py`` reads
them).  Smoke runs use ``arch.config(smoke=True)`` at reduced size.

``train_wrapper`` gives the train step: the loss with autograd on, its
gradient over every parameter leaf (``torch.autograd.grad``), then one
``optim.adamw.apply_updates``, which updates the parameters and the
optimizer state in place.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Callable

import torch

from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.models import layers as L
from repro_torch.optim import adamw

F32, I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str                         # train | prefill | decode | serve | retrieval
    skip: str | None = None           # reason if this cell is skipped
    rules_overrides: tuple = ()       # ((logical, mesh_axes), ...)

    @property
    def cell_id(self) -> str:
        return f"{self.arch}:{self.shape}"


def meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype description: a ``meta`` tensor (no storage)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def make_rules(mesh_axis_names: tuple[str, ...], cell: Cell | None = None,
               extra: dict | None = None) -> L.MeshRules:
    """Logical rules filtered to the axes that exist on this mesh, with
    per-cell overrides applied."""
    overrides = dict(extra or {})
    if cell is not None:
        overrides.update(dict(cell.rules_overrides))
    merged = dict(L.DEFAULT_RULES)
    merged.update(overrides)

    def keep(v):
        if v is None:
            return None
        axes = (v,) if isinstance(v, str) else tuple(v)
        axes = tuple(a for a in axes if a in mesh_axis_names)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    return L.MeshRules.make({k: keep(v) for k, v in merged.items()})


class ArchDef(abc.ABC):
    name: str
    family: str

    @abc.abstractmethod
    def config(self, smoke: bool = False): ...

    def config_for(self, shape: str, smoke: bool = False):
        """Per-shape config override hook."""
        return self.config(smoke)

    @abc.abstractmethod
    def cells(self) -> list[Cell]: ...

    @abc.abstractmethod
    def init_params(self, cfg, *, seed: int = 0, device=None): ...

    @abc.abstractmethod
    def param_specs(self, cfg, rules: L.MeshRules): ...

    @abc.abstractmethod
    def abstract_inputs(self, cfg, shape: str) -> dict: ...

    @abc.abstractmethod
    def input_specs(self, cfg, shape: str, rules: L.MeshRules) -> dict: ...

    @abc.abstractmethod
    def make_step(self, cfg, kind: str) -> Callable: ...

    # ---- shared helpers ------------------------------------------------------

    def abstract_params(self, cfg):
        """The parameters' shapes and dtypes as ``meta`` tensors."""
        return self.init_params(cfg, device="meta")

    def optimizer_cfg(self) -> adamw.AdamWConfig:
        return adamw.AdamWConfig()

    def train_wrapper(self, loss_fn, cfg):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        metrics)``: ``loss_fn``'s gradient, then one AdamW step under
        ``optimizer_cfg()``.  ``params`` and the moments are updated in place
        (``adamw.apply_updates``); metrics are ``loss_fn``'s, ``"loss"``,
        ``"grad_norm"`` and ``"lr"``, as 0-d tensors."""
        ocfg = self.optimizer_cfg()

        def train_step(params, opt_state, batch):
            grads, loss, metrics = gradients(loss_fn, params, batch, cfg)
            params, opt_state, om = adamw.apply_updates(params, opt_state,
                                                        grads, ocfg)
            return params, opt_state, {**metrics, "loss": loss, **om}

        return train_step

    def flops_note(self, cfg) -> dict:
        """Analytic MODEL_FLOPS hints for the roofline (per family)."""
        return {}


def gradients(loss_fn, params, batch, cfg):
    """``(grads, loss, metrics)``: ``loss_fn(params, batch, cfg)`` with
    autograd on and its gradient with respect to every parameter leaf, as a
    tree of ``params``' structure and dtypes (a leaf the loss does not reach
    gets zeros; on ``DTensor`` parameters each gradient is redistributed
    to its parameter's placements, ``layers.placed_like``).  ``params`` are
    read through detached aliases, so the
    caller's tensors are left as they are; the loss and metrics come back
    detached."""
    leaves = []

    def alias(t):
        leaves.append(t.detach().requires_grad_(True))
        return leaves[-1]

    with torch.enable_grad():
        loss, metrics = loss_fn(tree_map(alias, params), batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    it = iter(L.placed_like(g, p) for g, p in zip(grads, leaves))
    return (tree_map(lambda _: next(it), params), loss.detach(),
            {k: v.detach() for k, v in metrics.items()})
