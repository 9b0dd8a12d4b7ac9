"""--arch registry: the ten assigned architectures and the paper's own
system, ``wtbc`` (``configs/wtbc_paper.py``: the deployment of the WTBC
index over every device of a mesh).  The port's counterpart of
``repro.configs.registry``.
"""
from __future__ import annotations

from repro_torch.configs import (dlrm_mlperf, egnn, fm, gemma2_9b,
                                 granite_3_8b, llama4_scout_17b_a16e,
                                 qwen3_1p7b, qwen3_moe_235b_a22b, sasrec,
                                 wtbc_paper, xdeepfm)

ARCHS = {a.name: a for a in [
    qwen3_moe_235b_a22b.ARCH,
    llama4_scout_17b_a16e.ARCH,
    gemma2_9b.ARCH,
    qwen3_1p7b.ARCH,
    granite_3_8b.ARCH,
    egnn.ARCH,
    xdeepfm.ARCH,
    fm.ARCH,
    sasrec.ARCH,
    dlrm_mlperf.ARCH,
    wtbc_paper.ARCH,
]}

ASSIGNED = [n for n in ARCHS if n != "wtbc"]


def get(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown --arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells(include_paper: bool = True):
    for name, arch in ARCHS.items():
        if name == "wtbc" and not include_paper:
            continue
        yield from arch.cells()
