"""Carry an index built elsewhere into the port, from plain numpy arrays.

The arrays are named as the reference's dataclass fields, so a caller that
holds a ``repro`` index passes ``np.asarray`` of its leaves and this module
never needs ``repro`` itself:

``index_arrays``
    ``levels``: a list of 3 dicts with the ``ByteMap`` fields ``data``,
    ``counts``, ``length``, ``block``; ``offsets``: a list of 3 arrays; and
    ``cw``, ``cw_len``, ``node_off``, ``base_rank``, ``sep_pos``, ``df``,
    ``occ``, ``doc_len``, ``n``, ``n_docs``, ``s``, ``c``.
``model_arrays``
    the ``SCDCModel`` fields ``s``, ``c``, ``codes``, ``lens``,
    ``rank_of_word``, ``word_of_rank``, ``freqs``.
``aux_arrays`` (DRB tf bitmaps)
    ``words`` (the ``BitVec`` words, uint32), ``counts``, ``n_bits``, and
    the ``DRBAux`` fields ``bit_off``, ``has_bm``, ``eps``.
``sharded_arrays`` (a document-sharded index, stacked)
    ``idx`` and ``aux`` as above with a leading shard axis on every array
    (``length``, ``n``, ``n_docs`` and ``n_bits`` too), and the
    ``ShardedWTBC`` fields ``doc_base``, ``global_df``, ``global_idf``,
    ``global_avg_dl``, ``n_shards``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core import scdc
from repro_torch.core.bitvec import BitVec
from repro_torch.core.bytemap import ByteMap
from repro_torch.core.drb import DRBAux
from repro_torch.core.wtbc import WTBCIndex


def _t(a, dtype, device) -> torch.Tensor:
    arr = np.asarray(a, dtype=dtype)
    if torch.device(device).type == "cuda" and arr.flags.c_contiguous:
        # one host -> device copy straight from the source buffer, which may
        # be read-only (a memory-mapped snapshot leaf, another framework's
        # array): only the card's copy is ever written to
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The given NumPy array is not "
                                    "writable")
            return torch.from_numpy(arr).to(device)
    # np.array copies: a CPU tensor must not alias a read-only buffer
    return torch.from_numpy(np.array(arr)).to(device)


def from_reference(index_arrays: dict, model_arrays: dict, *,
                   device) -> tuple[WTBCIndex, scdc.SCDCModel]:
    """A port ``WTBCIndex`` on ``device`` and its ``SCDCModel`` from numpy
    arrays under the reference's field names (module docstring)."""
    return (index_from_arrays(index_arrays, device=device),
            model_from_arrays(model_arrays))


def index_from_arrays(index_arrays: dict, *, device) -> WTBCIndex:
    """A port ``WTBCIndex`` on ``device`` from ``index_arrays`` (module
    docstring)."""
    a = index_arrays
    levels = tuple(
        ByteMap(data=_t(lv["data"], np.uint8, device),
                counts=_t(lv["counts"], np.int32, device),
                length=int(lv["length"]), block=int(lv["block"]))
        for lv in a["levels"])
    return WTBCIndex(
        levels=levels,
        offsets=tuple(_t(o, np.int32, device) for o in a["offsets"]),
        cw=_t(a["cw"], np.uint8, device),
        cw_len=_t(a["cw_len"], np.int32, device),
        node_off=_t(a["node_off"], np.int32, device),
        base_rank=_t(a["base_rank"], np.int32, device),
        sep_pos=_t(a["sep_pos"], np.int32, device),
        df=_t(a["df"], np.int32, device),
        occ=_t(a["occ"], np.int32, device),
        doc_len=_t(a["doc_len"], np.int32, device),
        n=int(a["n"]), n_docs=int(a["n_docs"]), s=int(a["s"]), c=int(a["c"]))


def model_from_arrays(model_arrays: dict) -> scdc.SCDCModel:
    """An ``SCDCModel`` (host numpy) from ``model_arrays``."""
    m = model_arrays
    return scdc.SCDCModel(
        s=int(m["s"]), c=int(m["c"]),
        codes=np.asarray(m["codes"], dtype=np.uint8),
        lens=np.asarray(m["lens"], dtype=np.int8),
        rank_of_word=np.asarray(m["rank_of_word"], dtype=np.int32),
        word_of_rank=np.asarray(m["word_of_rank"], dtype=np.int32),
        freqs=np.asarray(m["freqs"], dtype=np.int64))


def sharded_from_reference(sharded_arrays: dict, *, device=None,
                           devices=None):
    """A port ``ShardedWTBC`` from the reference's stacked ``ShardedWTBC``
    leaves as numpy (``sharded_arrays``: ``idx`` as ``index_arrays`` and
    ``aux`` as ``aux_arrays`` with a leading shard axis, plus ``doc_base``,
    ``global_df``, ``global_idf``, ``global_avg_dl`` and ``n_shards``):
    each shard trimmed to its own lengths and placed on its device —
    ``devices[s]``, or by the rule of ``distributed.resolve_devices``."""
    from repro_torch.core.distributed import ShardedWTBC
    return ShardedWTBC.unstack(sharded_arrays, device=device, devices=devices)


def idf_table(table, idx: WTBCIndex) -> torch.Tensor:
    """A (V,) float32 idf table carried across, on the index's device."""
    t = np.asarray(table, dtype=np.float32)
    if t.shape != (idx.vocab_size,):
        raise ValueError(f"idf table of shape {t.shape}, expected "
                         f"({idx.vocab_size},)")
    return _t(t, np.float32, idx.device)


def aux_from_reference(aux_arrays: dict, *, device) -> DRBAux:
    """A port ``DRBAux`` on ``device`` from numpy arrays under the
    reference's field names (module docstring); the uint32 bitmap words
    are kept as int32 bit patterns."""
    a = aux_arrays
    words = np.asarray(a["words"], dtype=np.uint32).view(np.int32)
    bv = BitVec(words=_t(words, np.int32, device),
                counts=_t(a["counts"], np.int32, device),
                n_bits=int(a["n_bits"]))
    return DRBAux(bv=bv, bit_off=_t(a["bit_off"], np.int32, device),
                  has_bm=_t(a["has_bm"], np.bool_, device),
                  eps=float(a["eps"]))
