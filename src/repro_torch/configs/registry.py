"""--arch registry: the ten assigned architectures.  The port's counterpart
of ``repro.configs.registry``.

The reference's registry also holds the paper's own system, ``wtbc``
(``configs/wtbc_paper.py``: the dry-run deployment of the WTBC index over
every device).  It comes with the dry-run slice (ROADMAP Queue 1 item 6);
until then ``get("wtbc")`` raises a ``KeyError`` that says so.
"""
from __future__ import annotations

from repro_torch.configs import (dlrm_mlperf, egnn, fm, gemma2_9b,
                                 granite_3_8b, llama4_scout_17b_a16e,
                                 qwen3_1p7b, qwen3_moe_235b_a22b, sasrec,
                                 xdeepfm)

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
]}

ASSIGNED = list(ARCHS)


def get(name: str):
    if name == "wtbc":
        raise KeyError("--arch 'wtbc' is not in the port yet: the paper's "
                       "dry-run deployment (configs/wtbc_paper.py) comes with "
                       "the dry-run slice, ROADMAP Queue 1 item 6")
    if name not in ARCHS:
        raise KeyError(f"unknown --arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Every cell of every assigned architecture (the reference's
    ``all_cells(include_paper=False)``)."""
    for arch in ARCHS.values():
        yield from arch.cells()
