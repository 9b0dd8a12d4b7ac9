"""The dry run against the card: ``launch/dryrun.argument_leaves`` of a
smoke LM's ``train_4k`` cell on ``make_local_mesh()`` against what placing
its parameters and AdamW state adds on the card.  Card only (the ``cuda``
marker); this file does not import JAX.

Exact: the caching allocator's requested bytes grow by the dry run's bytes,
and ``memory_allocated`` by the dry run's bytes with each tensor rounded up
to 512 (every smoke tensor is under 1 MiB, so each lies in a block of its
own rounded size).
"""
import pytest
import torch

from repro_torch.configs import qwen3_1p7b, qwen3_moe_235b_a22b
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _held() -> tuple[int, int]:
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated(),
            torch.cuda.memory_stats()["requested_bytes.all.current"])


@pytest.mark.cuda
@pytest.mark.parametrize("mod", [qwen3_1p7b, qwen3_moe_235b_a22b],
                         ids=["qwen3-1.7b", "qwen3-moe"])
def test_local_mesh_argument_bytes_equal_the_cards(card, mod):
    arch = mod.ARCH
    cell = next(c for c in arch.cells() if c.shape == "train_4k")
    mesh = mesh_lib.make_local_mesh()
    assert mesh.axis_names == ("data",)
    assert mesh.size == torch.cuda.device_count()
    if mesh.size != 1:
        pytest.skip("on several cards the dry run splits leaves over them")
    cfg = arch.config(smoke=True)
    leaves = dryrun.argument_leaves(arch, cell, mesh,
                                    cfg_override=lambda _: cfg)
    dry = dryrun.argument_bytes(leaves)
    rounded = {g: sum(-(-b // 512) * 512 for g_, _, b in leaves if g_ == g)
               for g in ("params", "opt_state")}
    a0, r0 = _held()
    params = arch.init_params(cfg, seed=0, device=card)
    a1, r1 = _held()
    opt = adamw.init_state(params)
    a2, r2 = _held()
    assert r1 - r0 == dry["params"]
    assert r2 - r1 == dry["opt_state"]
    assert a1 - a0 == rounded["params"]
    assert a2 - a1 == rounded["opt_state"]
    del params, opt
