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
``lm_params_from_jax`` (an LM's parameters)
    the reference's ``init_params`` tree as numpy: ``embed``, ``blocks`` (a
    list over group positions, every leaf stacked ``(n_groups, ...)``),
    ``final_norm`` and ``lm_head``.
``recsys_params_from_jax`` (a recsys tower's parameters)
    the reference's ``recsys.init_params`` tree as numpy: SASRec's
    ``item_emb``, ``pos_emb`` and ``blocks`` (a list of dicts); a tabular
    tower's ``tables`` (a list, one per sparse feature) and, by interaction,
    ``linear`` and ``bias`` (FM), ``bot`` / ``top`` (DLRM), ``cin``, ``dnn``,
    ``out`` and ``linear_w`` (xDeepFM) — each MLP a list of weights.
``gnn_params_from_jax`` (EGNN's parameters)
    the reference's ``gnn.init_params`` tree as numpy: ``embed_in``,
    ``layers`` (a list of dicts of ``phi_e`` / ``phi_x`` / ``phi_h`` weight
    lists) and ``head``.
``adamw_state_from_jax`` (an optimizer state)
    the reference's ``adamw.AdamWState`` with numpy leaves: ``step`` (0-d
    int32) and the float32 moments ``m`` and ``v``, each a tree of the
    parameters' structure (dicts and lists).
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


def _leaf_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: no numpy kind
        t = torch.from_numpy(np.array(arr.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype)


def _params_from_jax(tree, want, cfg, dev) -> dict:
    """Walk the reference's numpy tree against the port's ``meta``
    parameters ``want``: the same keys and list lengths, the same shape at
    every leaf; each leaf cast to the port's dtype for it, on ``dev``."""

    def walk(ref, meta, path):
        if isinstance(meta, dict):
            if not isinstance(ref, dict) or set(ref) != set(meta):
                got = sorted(ref) if isinstance(ref, dict) else type(ref)
                raise ValueError(f"{path or 'params'}: keys {got}, expected "
                                 f"{sorted(meta)}")
            return {k: walk(ref[k], meta[k], f"{path}.{k}".lstrip("."))
                    for k in meta}
        if isinstance(meta, list):
            if not isinstance(ref, (list, tuple)) or len(ref) != len(meta):
                got = len(ref) if isinstance(ref, (list, tuple)) else type(ref)
                raise ValueError(f"{path}: {got} entries, expected "
                                 f"{len(meta)}")
            return [walk(r, m, f"{path}[{i}]")
                    for i, (r, m) in enumerate(zip(ref, meta))]
        shape = tuple(np.shape(ref))
        if shape != tuple(meta.shape):
            raise ValueError(f"{path}: shape {shape}, expected "
                             f"{tuple(meta.shape)} for {cfg.name}")
        return _leaf_tensor(ref, meta.dtype, dev)

    return walk(tree, want, "")


def lm_params_from_jax(tree, cfg, *, device=None) -> dict:
    """The port's LM parameters on ``device`` (default: the card) from the
    reference's ``init_params`` tree as numpy (module docstring).  The port
    keeps the reference's layout, so every leaf maps to the leaf of the same
    name; each is checked against ``cfg``'s shape and cast to the port's
    dtype for it (the router stays float32)."""
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.models import transformer
    return _params_from_jax(tree, transformer.init_params(cfg, device="meta"),
                            cfg, resolve_device(device))


def recsys_params_from_jax(tree, cfg, *, device=None) -> dict:
    """A recsys tower's parameters on ``device`` (default: the card) from
    the reference's ``recsys.init_params`` tree as numpy (module docstring),
    checked leaf by leaf against ``cfg``'s shapes."""
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.models import recsys
    return _params_from_jax(tree, recsys.init_params(cfg, device="meta"),
                            cfg, resolve_device(device))


def gnn_params_from_jax(tree, cfg, *, device=None) -> dict:
    """EGNN's parameters on ``device`` (default: the card) from the
    reference's ``gnn.init_params`` tree as numpy (module docstring),
    checked leaf by leaf against ``cfg``'s shapes."""
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.models import gnn
    return _params_from_jax(tree, gnn.init_params(cfg, device="meta"),
                            cfg, resolve_device(device))


def adamw_state_from_jax(state, *, device=None):
    """The port's ``optim.adamw.AdamWState`` on ``device`` (default: the
    card) from the reference's ``AdamWState`` with numpy leaves (module
    docstring): ``step`` an int32 0-d tensor, ``m`` and ``v`` float32 trees
    of the same structure, every value carried bitwise — so a step taken
    from the same parameters and state computes the same thing on both
    sides."""
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.optim.adamw import AdamWState
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf_tensor(node, torch.float32, dev)

    step = np.asarray(state.step)
    if step.shape != ():
        raise ValueError(f"AdamWState.step of shape {step.shape}, expected ()")
    return AdamWState(step=_leaf_tensor(step, torch.int32, dev),
                      m=walk(state.m), v=walk(state.v))
