"""Document-sharded retrieval (the reference's ``repro.core.distributed``).

The paper's own deployment motivation is "a cluster that implements a large
in-memory distributed index".  It is realized by document partitioning:

* the (s,c)-DC model is fitted once on **global** frequencies (codewords
  agree across shards);
* each shard holds a full WTBC (and its DRB tf bitmaps) over its own
  contiguous, token-balanced document range;
* a query runs on every shard with the *identical* single-host cores
  (``ranked.topk_dr_batch``, ``drb.topk_drb_and`` / ``topk_drb_or``), and
  the per-shard top-k lists are merged into one.

Scoring uses the **global** idf table and mean document length, so shard
scores are directly comparable; each shard's own ``df`` stays local (it
drives the DRB cursors only).

**Placement.**  The reference stacks the shards into one rectangular pytree
(ragged leaves padded to the largest shard) and runs them under a
``shard_map`` over a 1-D mesh.  The port keeps one trimmed ``WTBCIndex``
(and ``DRBAux``) per shard, each on its own torch device, in one process:
the shards are searched one after another from the host thread, and the
merge runs on ``devices[0]``.  :meth:`ShardedWTBC.stack` pads and stacks
them exactly as the reference does (the on-disk form of a sharded snapshot)
and :meth:`ShardedWTBC.unstack` trims them back.

**Merge** (the reference's ``distributed_topk``): a (k+1)-wide top-k over
the gathered lists, ties to the lower global document (a stable sort: the
lists are gathered in shard order, each in its own score order); ``iters``,
``pops`` and ``padded`` summed over shards; ``overflowed`` if any shard
overflowed; ``bound`` the max over shards.  A slot is certified only if its
score *strictly* beats that bound (a tie across shards could hide a
lower-document tie winner behind another shard's frontier), and the
reported bound also covers the best candidate the merge dropped.

**Collectives** (``merge_collectives``).  On a mesh the merge is the
reference's program: for each shard axis in turn, the documents and the
scores are all-gathered over it and folded into the candidate axis, then
``iters``, ``pops``, ``overflowed`` and ``padded`` are summed and ``bound``
maxed over each axis, one reduction each.  The port merges its device list
in one step on ``devices[0]`` (``gather_candidates``), which takes from the
shards the bytes that those gathers deliver; the dry run
(``launch/dryrun.py``) counts the list.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import drb, ranked, scdc, scoring, wtbc
from repro_torch.core import heap as H
from repro_torch.core.drb import DRBAux
from repro_torch.core.ranked import DRResult
from repro_torch.core.wtbc import WTBCIndex
from repro_torch.kernels import backend
from repro_torch.kernels.bitmap_rank import WORDS_PER_BLOCK

METHODS = ("dr-and", "dr-or", "drb-and", "drb-or")


@dataclasses.dataclass(frozen=True)
class ShardedWTBC:
    """Per-shard indexes on their devices + the global scoring tables (on
    ``devices[0]``)."""
    idx: tuple[WTBCIndex, ...]          # one trimmed index per shard
    aux: tuple[DRBAux, ...] | None      # one DRB bitmap set per shard
    global_df: torch.Tensor             # (V,) int32 global document frequency
    global_idf: torch.Tensor            # (V,) float32 tf-idf, idf['$'] = 0
    global_avg_dl: torch.Tensor         # () float32 BM25 mean document length

    @property
    def n_shards(self) -> int:
        return len(self.idx)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        return tuple(i.device for i in self.idx)

    @property
    def n_docs(self) -> int:
        return sum(i.n_docs for i in self.idx)

    @property
    def bases(self) -> list[int]:
        """The global id of each shard's document 0 (the reference's
        ``doc_base``; the shards are contiguous)."""
        return np.cumsum([0] + [i.n_docs for i in self.idx[:-1]]).tolist()

    def replicate(self, t: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``t`` on every shard's device (one copy per device)."""
        copies = {}
        for dev in self.devices:
            copies.setdefault(dev, t.to(dev))
        return tuple(copies[dev] for dev in self.devices)

    def stack(self) -> dict:
        """The reference's stacked arrays, on the host: ragged leaves padded
        to the largest shard (byte and bit data with zeros, counter rows by
        repeating the final cumulative row so select's search stays right
        past the logical end, ``sep_pos`` with the largest ``n``,
        ``doc_len`` with zeros).  Field names as in :mod:`repro_torch.convert`
        with a leading shard axis; the bitmap words as uint32."""
        shards = self.idx
        max_docs = max(s.n_docs for s in shards)
        big_n = max(s.n for s in shards)

        def host(t):
            return t.cpu().numpy()

        def stk(get, pad_fill=None, pad_len=None):
            arrs = [host(get(s)) for s in shards]
            if pad_len is not None:
                arrs = [_pad_to(a, pad_len, pad_fill) for a in arrs]
            return np.stack(arrs)

        levels = []
        for L in range(wtbc.MAX_LEVELS):
            lvs = [s.levels[L] for s in shards]
            levels.append({
                "data": _stack_padded([host(lv.data) for lv in lvs]),
                "counts": _stack_counters([host(lv.counts) for lv in lvs]),
                "length": np.array([lv.length for lv in lvs], np.int32),
                "block": lvs[0].block})
        idx = {
            "levels": levels,
            "offsets": [stk(lambda s, L=L: s.offsets[L])
                        for L in range(wtbc.MAX_LEVELS)],
            "cw": stk(lambda s: s.cw), "cw_len": stk(lambda s: s.cw_len),
            "node_off": stk(lambda s: s.node_off),
            "base_rank": stk(lambda s: s.base_rank),
            "sep_pos": stk(lambda s: s.sep_pos, big_n, max_docs),
            "df": stk(lambda s: s.df), "occ": stk(lambda s: s.occ),
            "doc_len": stk(lambda s: s.doc_len, 0, max_docs),
            "n": np.array([s.n for s in shards], np.int32),
            "n_docs": np.array([s.n_docs for s in shards], np.int32),
            "s": shards[0].s, "c": shards[0].c}
        aux = None
        if self.aux is not None:
            aux = {"words": _stack_padded(
                       [host(a.bv.words).view(np.uint32) for a in self.aux]),
                   "counts": _stack_counters([host(a.bv.counts)
                                              for a in self.aux]),
                   "n_bits": np.array([a.bv.n_bits for a in self.aux],
                                      np.int32),
                   "bit_off": np.stack([host(a.bit_off) for a in self.aux]),
                   "has_bm": np.stack([host(a.has_bm) for a in self.aux]),
                   "eps": self.aux[0].eps}
        return {"idx": idx, "aux": aux,
                "doc_base": np.array(self.bases, np.int32),
                "global_df": host(self.global_df),
                "global_idf": host(self.global_idf),
                "global_avg_dl": host(self.global_avg_dl),
                "n_shards": self.n_shards}

    @classmethod
    def unstack(cls, stacked: dict, *, device=None,
                devices: Sequence | None = None) -> "ShardedWTBC":
        """Shard ``s`` of the stacked arrays (:meth:`stack`'s form, or the
        reference's ``ShardedWTBC`` leaves as numpy) sliced out, trimmed to
        its own lengths and placed on its device (:func:`resolve_devices`);
        the global tables on the first shard's device."""
        n_shards = int(stacked["n_shards"])
        devices = resolve_devices(n_shards, device=device, devices=devices)
        idxs, auxes = [], []
        for s, dev in enumerate(devices):
            index_arrays, aux_arrays = _shard_arrays(stacked, s)
            idxs.append(convert.index_from_arrays(index_arrays, device=dev))
            if aux_arrays is not None:
                auxes.append(convert.aux_from_reference(aux_arrays,
                                                        device=dev))
        dev0 = devices[0]
        out = cls(
            idx=tuple(idxs), aux=tuple(auxes) if auxes else None,
            global_df=torch.from_numpy(np.array(stacked["global_df"],
                                                np.int32)).to(dev0),
            global_idf=torch.from_numpy(np.array(stacked["global_idf"],
                                                 np.float32)).to(dev0),
            global_avg_dl=torch.tensor(np.float32(stacked["global_avg_dl"]),
                                       device=dev0))
        if np.asarray(stacked["doc_base"]).tolist() != out.bases:
            raise ValueError("doc_base disagrees with the shards' document "
                             "counts: the shards are not contiguous")
        return out


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _stack_padded(arrs: list[np.ndarray]) -> np.ndarray:
    n = max(a.shape[0] for a in arrs)
    return np.stack([_pad_to(a, n, 0) for a in arrs])


def _stack_counters(arrs: list[np.ndarray]) -> np.ndarray:
    """Cumulative counter tables padded by repeating their final row."""
    n = max(a.shape[0] for a in arrs)
    return np.stack([np.concatenate([a, np.repeat(a[-1:], n - a.shape[0], 0)])
                     for a in arrs])


def _shard_arrays(stacked: dict, s: int) -> tuple[dict, dict | None]:
    """Shard ``s``'s index and bitmap arrays out of the stacked ones,
    trimmed to the lengths its own build gives them (``bytemap.build_np``:
    ``max(1, ceil(length / block))`` blocks; ``bitvec.build``: ``ceil(
    max(1, ceil(n_bits / 32)) / WORDS_PER_BLOCK)`` blocks)."""
    a = stacked["idx"]
    n_docs = int(a["n_docs"][s])
    levels = []
    for lv in a["levels"]:
        length, block = int(lv["length"][s]), int(lv["block"])
        nb = max(1, -(-length // block))
        levels.append({"data": lv["data"][s][:nb * block],
                       "counts": lv["counts"][s][:nb + 1],
                       "length": length, "block": block})
    index_arrays = {f: a[f][s] for f in ("cw", "cw_len", "node_off",
                                         "base_rank", "df", "occ")}
    index_arrays.update(
        levels=levels, offsets=[o[s] for o in a["offsets"]],
        sep_pos=a["sep_pos"][s][:n_docs], doc_len=a["doc_len"][s][:n_docs],
        n=int(a["n"][s]), n_docs=n_docs, s=int(a["s"]), c=int(a["c"]))
    x = stacked.get("aux")
    if x is None:
        return index_arrays, None
    n_bits = int(x["n_bits"][s])
    nb = -(-max(1, -(-n_bits // 32)) // WORDS_PER_BLOCK)
    aux_arrays = {"words": x["words"][s][:nb * WORDS_PER_BLOCK],
                  "counts": x["counts"][s][:nb + 1], "n_bits": n_bits,
                  "bit_off": x["bit_off"][s], "has_bm": x["has_bm"][s],
                  "eps": float(x["eps"])}
    return index_arrays, aux_arrays


def resolve_devices(n_shards: int, *, device=None,
                    devices: Sequence | None = None) -> list[torch.device]:
    """Where each shard lives: ``devices`` (one per shard) when given, else
    shard ``s`` on ``cuda:{s % device_count}`` — or every shard on
    ``device`` when that is the CPU or one numbered card.  A ``cuda``
    device raises when no card is present (``backend.resolve_device``)."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is not None:
        devs = [backend.resolve_device(d) for d in devices]
        if len(devs) != n_shards:
            raise ValueError(f"{len(devs)} devices for {n_shards} shards")
        return devs
    dev = backend.resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev] * n_shards
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", s % n_cards) for s in range(n_shards)]


def _shard_bounds(doc_len: np.ndarray, n_shards: int) -> list[int]:
    """Contiguous document ranges balanced by token count (separators
    included): shard ``s`` holds documents ``[bounds[s], bounds[s+1])``."""
    n_docs = len(doc_len)
    tokens_cum = np.cumsum(np.asarray(doc_len, np.int64) + 1)
    targets = (np.arange(1, n_shards) * tokens_cum[-1]) // n_shards
    cuts = np.searchsorted(tokens_cum, targets).tolist()
    bounds = sorted(set([0] + [c + 1 for c in cuts] + [n_docs]))
    while len(bounds) < n_shards + 1:          # degenerate tiny corpora
        bounds.append(n_docs)
    if any(hi <= lo for lo, hi in zip(bounds, bounds[1:])):
        raise ValueError("a shard received zero documents; lower n_shards")
    return bounds


def build_sharded(doc_tokens: list[np.ndarray], vocab_size: int,
                  n_shards: int, block: int = 4096, with_drb: bool = True,
                  eps: float = 1e-6, *, device=None,
                  devices: Sequence | None = None
                  ) -> tuple[ShardedWTBC, scdc.SCDCModel]:
    """Fit the global codes, then build every shard's index (and bitmaps)
    on the host and place it on its device (:func:`resolve_devices`)."""
    devs = resolve_devices(n_shards, device=device, devices=devices)
    n_docs = len(doc_tokens)
    doc_len = np.array([len(d) for d in doc_tokens], dtype=np.int64)
    freqs = np.bincount(wtbc._flatten(doc_tokens)[0], minlength=vocab_size)
    model = scdc.fit(freqs, reserve_first=0)
    bounds = _shard_bounds(doc_len, n_shards)
    shard_docs = [doc_tokens[bounds[i]:bounds[i + 1]] for i in range(n_shards)]
    shards = [wtbc.build_index_with_model(sd, model, block, device=dev)
              for sd, dev in zip(shard_docs, devs)]

    # global document frequencies (each shard's df counts its documents;
    # the separator's entry counts no document) -> global idf and the
    # global stopword decision of the DRB bitmaps
    df_global = np.zeros(vocab_size, dtype=np.int64)
    for s in shards:
        df_global += s.df.cpu().numpy()
    df_global[wtbc.SEP_RANK] = 0
    idf_np = np.log(n_docs / np.maximum(df_global, 1)).astype(np.float32)
    idf_np[wtbc.SEP_RANK] = 0.0
    has_bm_global = (idf_np >= eps) & (df_global > 0)
    auxes = (tuple(drb.build_aux(s, model, sd, eps,
                                 has_bm_override=has_bm_global)
                   for s, sd in zip(shards, shard_docs))
             if with_drb else None)
    dev0 = devs[0]
    sharded = ShardedWTBC(
        idx=tuple(shards), aux=auxes,
        global_df=torch.from_numpy(df_global.astype(np.int32)).to(dev0),
        global_idf=torch.from_numpy(idf_np).to(dev0),
        global_avg_dl=torch.tensor(scoring.avg_doc_len(doc_len, n_docs),
                                   device=dev0))
    return sharded, model


def global_idf_table(sharded: ShardedWTBC, measure) -> torch.Tensor:
    """``measure``'s idf table over the *global* document frequencies, on
    ``devices[0]`` — what a single index over every document would use."""
    return measure.idf(types.SimpleNamespace(df=sharded.global_df,
                                             n_docs=sharded.n_docs))


# ---------------------------------------------------------------------------
# distributed query: every shard's core, then the merge
# ---------------------------------------------------------------------------

def distributed_topk(sharded: ShardedWTBC, words: torch.Tensor,
                     wmask: torch.Tensor, *, k: int, method: str,
                     heap_cap: int | None = None, max_df_cap: int = 256,
                     max_pops: int | None = None, measure=None,
                     idf: torch.Tensor | Sequence[torch.Tensor] | None = None,
                     beam_width: int = 1) -> DRResult:
    """Run a top-k query over every shard and merge (module docstring).

    method: 'dr-and' | 'dr-or' | 'drb-and' | 'drb-or'.  DR runs the heap
    core per shard (the mega core covers the single-index backend only);
    ``heap_cap`` defaults to the global ``2 * max(n_docs) + 4``.
    max_pops: per-shard anytime budget of the loop cores (DR and DRB-AND).
    idf: the (V,) scoring table (one tensor, or one per shard already on
    the shard's device); defaults to ``sharded.global_idf`` (tf-idf form).
    ``words`` / ``wmask`` are (B, Q); the result's leaves are (B, k) on
    ``devices[0]``.  ``padded`` is absent on drb-or,
    the one core that reports no pad-waste count."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    measure = measure or scoring.TfIdf()
    if heap_cap is None:
        heap_cap = 2 * max(i.n_docs for i in sharded.idx) + 4
    if idf is None:
        idf = sharded.global_idf
    idfs = sharded.replicate(idf) if isinstance(idf, torch.Tensor) \
        else tuple(idf)
    avgs = sharded.replicate(sharded.global_avg_dl)
    if method.startswith("drb") and sharded.aux is None:
        raise ValueError("this sharded index was built without DRB bitmaps")
    results = []
    for s, idx in enumerate(sharded.idx):
        w, m = words.to(idx.device), wmask.to(idx.device)
        if method in ("dr-and", "dr-or"):
            res = ranked.topk_dr_batch(idx, w, m, idfs[s], k=k,
                                       conjunctive=method == "dr-and",
                                       heap_cap=heap_cap, max_pops=max_pops,
                                       beam_width=beam_width)
        elif method == "drb-and":
            res = drb.topk_drb_and(idx, sharded.aux[s], w, m, measure, k=k,
                                   idf=idfs[s], avg_dl=avgs[s],
                                   beam_width=beam_width, max_pops=max_pops)
        else:
            res = drb.topk_drb_or(idx, sharded.aux[s], w, m, measure, k=k,
                                  max_df_cap=max_df_cap, idf=idfs[s],
                                  avg_dl=avgs[s])
        results.append(res)
    return merge_topk(results, sharded.bases, k=k,
                      device=sharded.devices[0], has_pad=method != "drb-or")


def gather_candidates(results: Sequence[DRResult], bases: Sequence[int],
                      device) -> tuple[torch.Tensor, torch.Tensor]:
    """Every shard's (B, k) documents (as global ids, -1 kept) and scores,
    side by side in shard order on ``device``: (B, n_shards x k) each."""
    dev = torch.device(device)
    all_d = torch.cat([torch.where(r.docs >= 0, r.docs + b, -1).to(dev)
                       for r, b in zip(results, bases)], -1)
    all_s = torch.cat([r.scores.to(dev) for r in results], -1)
    return all_d, all_s


#: the merge's reductions over a shard axis: (kind, leaf, dtype)
MERGE_REDUCTIONS = (("sum", "iters", torch.int32), ("sum", "pops", torch.int32),
                    ("sum", "overflowed", torch.int32),
                    ("sum", "padded", torch.int32),
                    ("max", "bound", torch.float32))


def merge_collectives(batch: int, k: int, axes: Sequence[tuple[str, int]], *,
                      has_pad: bool = True) -> list[dict]:
    """The merge's collectives on a mesh whose shard axes are ``axes``
    (``(name, size)``, in the order they are gathered), for (B, k) results
    per shard, in program order: per axis of n shards, an all-gather of the
    documents (int32) and one of the scores (float32), each delivering (n,
    B, k x the shards already folded in); then per axis one all-reduce of
    each ``MERGE_REDUCTIONS`` leaf, (B,), ``padded`` only where ``has_pad``.
    Each entry: ``kind`` ("all-gather" / "all-reduce"), ``op`` ("gather",
    "sum", "max"), ``leaf``, ``axis``, ``shape`` (what the op delivers) and
    ``dtype``."""
    out, folded = [], 1
    for name, n in axes:
        for leaf, dtype in (("docs", torch.int32), ("scores", torch.float32)):
            out.append({"kind": "all-gather", "op": "gather", "leaf": leaf,
                        "axis": name, "shape": (n, batch, k * folded),
                        "dtype": dtype})
        folded *= n
    for name, _ in axes:
        for op, leaf, dtype in MERGE_REDUCTIONS:
            if leaf != "padded" or has_pad:
                out.append({"kind": "all-reduce", "op": op, "leaf": leaf,
                            "axis": name, "shape": (batch,), "dtype": dtype})
    return out


def merge_topk(results: Sequence[DRResult], bases: Sequence[int], *, k: int,
               device, has_pad: bool = True) -> DRResult:
    """Merge per-shard (B, k) results (shard order; shard ``s``'s documents
    start at global id ``bases[s]``) into one on ``device`` (module
    docstring)."""
    dev = torch.device(device)
    all_d, all_s = gather_candidates(results, bases, dev)
    # (k+1)-wide: slot k is the best candidate the merge DROPS, folded into
    # the reported bound; the stable sort keeps the lower gathered index —
    # the lower global document — first among equal scores
    kk = min(k + 1, all_s.shape[-1])
    top_s, ti = torch.sort(all_s, dim=-1, descending=True, stable=True)
    top_s, ti = top_s[..., :kk], ti[..., :kk]
    dropped = top_s[..., k] if kk > k else torch.full(
        top_s.shape[:-1], H.NEG_INF, dtype=torch.float32, device=dev)
    top_s, ti = top_s[..., :k], ti[..., :k]
    top_d = all_d.gather(-1, ti)
    found = top_s > H.NEG_INF

    def total(name):
        return torch.stack([getattr(r, name).to(dev) for r in results]
                           ).sum(0, dtype=torch.int32)
    over = torch.stack([r.overflowed.to(dev) for r in results]).any(0)
    bound = torch.stack([r.bound.to(dev) for r in results]).amax(0)
    certified = (top_s > bound[..., None]) & ~over[..., None] & found
    return DRResult(torch.where(found, top_d, -1), top_s,
                    found.sum(-1, dtype=torch.int32), total("iters"),
                    total("pops"), over,
                    padded=total("padded") if has_pad else None,
                    certified=certified,
                    bound=torch.maximum(bound, dropped))
