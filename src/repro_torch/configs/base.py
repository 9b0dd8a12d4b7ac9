"""Architecture glue: Cell (arch x shape) definitions, abstract inputs and
parameters as ``meta`` tensors (shapes and dtypes, no allocation), and the
functions that build a step.  The port's counterpart of ``repro.configs.base``.

Every architecture provides an ArchDef; ``arch.make_step(cfg, kind)`` gives
the step a cell runs, ``arch.abstract_inputs(cfg, shape)`` its inputs and
``arch.abstract_params(cfg)`` its parameters.  Smoke runs use
``arch.config(smoke=True)`` at reduced size.

Left for later slices: the reference's mesh rules (``make_rules``,
``param_specs``, ``input_specs``), which the dry-run slice needs, and
``train_wrapper`` with its optimizer, which the training slice brings
(ROADMAP Queue 1 items 5 and 6).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Callable

import torch

F32, I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str                         # train | prefill | decode | serve | retrieval
    skip: str | None = None           # reason if this cell is skipped

    @property
    def cell_id(self) -> str:
        return f"{self.arch}:{self.shape}"


def meta(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype description: a ``meta`` tensor (no storage)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


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
    def abstract_inputs(self, cfg, shape: str) -> dict: ...

    @abc.abstractmethod
    def make_step(self, cfg, kind: str) -> Callable: ...

    # ---- shared helpers ------------------------------------------------------

    def abstract_params(self, cfg):
        """The parameters' shapes and dtypes as ``meta`` tensors."""
        return self.init_params(cfg, device="meta")

    def flops_note(self, cfg) -> dict:
        """Analytic MODEL_FLOPS hints for the roofline (per family)."""
        return {}
