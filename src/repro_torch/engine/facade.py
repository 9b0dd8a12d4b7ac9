"""`SearchEngine` — the port's public query API (WTBC-DR, WTBC-DRB and
positional search).

    engine = SearchEngine.build(doc_tokens)                 # on the card
    engine = SearchEngine.build(doc_tokens, device="cpu")   # plain PyTorch
    engine = SearchEngine.shard(doc_tokens, n_shards=4)     # document-sharded
    res = engine.search([[w1, w2], [w3]], k=10, mode="and")
    res = engine.search([[w1, w2]], k=10, mode="or", measure="bm25")
    res = engine.search([[w1, w2]], k=10, mode="near", window=8)
    print(res.hits(0), engine.snippets(res, length=8))

The facade owns word-id -> frequency-rank mapping, ragged-query padding and
masking (Q padded to pow2 buckets), idf tables and the mean document length,
frontier capacities, DR / DRB routing and the BM25 compatibility check, the
lazily built DRB tf bitmaps and their gather width, anytime budgets and SLA
classes, snippet decoding, and an executor cache keyed like the reference's.
``and``/``or`` queries run on WTBC-DR (tf-idf: the heap core with
``beam_width`` or the mega core with ``mega=True``) or on WTBC-DRB (tf-idf or
BM25); ``phrase``/``near`` queries and ``word_positions`` on the bare WTBC
(``core/positional.py``, tf-idf or BM25).  With an enabled
:mod:`repro_torch.obs` registry every search records its counters, work
histograms and the live WTBC roofline gauges.  A document-sharded engine
(:meth:`SearchEngine.shard`, ``backend="sharded"``) holds one index per
shard, each on its own device, answers ``and``/``or`` on every shard with
the same cores under the global idf and mean document length, and merges
the per-shard top-k lists (``core/distributed.py``); ``phrase``/``near``
are single-index only, as in the reference.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch import convert, obs
from repro_torch.analysis import roofline
from repro_torch.core import distributed, drb, positional, scoring, wtbc
from repro_torch.engine import executors
from repro_torch.engine.config import SLA_CLASSES, EngineConfig
from repro_torch.engine.results import SearchResults
from repro_torch.kernels import backend

MODES = ("and", "or", "phrase", "near")
POSITIONAL_MODES = ("phrase", "near")
STRATEGIES = ("dr", "drb", "auto")
MEASURES = {"tfidf": scoring.TfIdf(), "bm25": scoring.BM25()}

# cold-start pop cost (µs) assumed by the deadline -> budget conversion until
# the engine has observed real traffic (see SearchEngine.us_per_pop)
DEFAULT_US_PER_POP = 50.0


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1) — the shape-bucket policy for the
    query-word dim Q (and a serving batcher's batch dim B)."""
    return 1 << max(0, int(n) - 1).bit_length()


def budget_bucket(n: int) -> int:
    """Largest power of FOUR <= n (n >= 1) — the anytime-budget quantizer, so
    a deadline-derived budget that drifts with the live us/pop estimate maps
    onto a handful of executor keys (floor: never overshoots a deadline)."""
    n = max(1, int(n))
    return 1 << ((n.bit_length() - 1) & ~1)


def _normalize_docs(docs, vocab_size: int | None):
    """Accept a corpus object (``.doc_tokens`` / ``.vocab_size``) or a plain
    list of per-document word-id arrays; return (list[np.ndarray], vocab_size).
    Word id 0 is the reserved document separator '$'."""
    if hasattr(docs, "doc_tokens") and hasattr(docs, "vocab_size"):
        if vocab_size is not None and vocab_size < int(docs.vocab_size):
            raise ValueError(f"vocab_size={vocab_size} smaller than the "
                             f"corpus's own vocab_size={docs.vocab_size}")
        return list(docs.doc_tokens), int(vocab_size or docs.vocab_size)
    doc_tokens = [np.asarray(d, dtype=np.int64) for d in docs]
    if not doc_tokens:
        raise ValueError("cannot build an engine over zero documents")
    max_id = max((int(d.max()) for d in doc_tokens if len(d)), default=0)
    for d in doc_tokens:
        if len(d) and int(d.min()) < 1:
            raise ValueError("word id 0 is reserved for the '$' separator; "
                             "document ids must be >= 1")
    if vocab_size is None:
        vocab_size = max_id + 1
    elif vocab_size <= max_id:
        raise ValueError(f"vocab_size={vocab_size} too small for max word id "
                         f"{max_id}")
    return doc_tokens, int(vocab_size)


class SearchEngine:
    """Facade over the WTBC-DR and WTBC-DRB search cores: one index on one
    device, or one index per shard (``backend="sharded"``).

    Construct with :meth:`build` or :meth:`shard` (or :meth:`from_arrays`
    to carry an index across); query with :meth:`search`; recover text
    around the hits with :meth:`snippets`.
    """

    def __init__(self, *, _token=None, config: EngineConfig, model,
                 idx: wtbc.WTBCIndex | None = None, doc_tokens=None,
                 sharded: distributed.ShardedWTBC | None = None):
        if _token is not _CTOR_TOKEN:
            raise TypeError("use SearchEngine.build(...), "
                            "SearchEngine.shard(...) or "
                            "SearchEngine.from_arrays(...)")
        self.config = config
        self.model = model
        self.backend = "single" if sharded is None else "sharded"
        self._idx = idx
        self._sharded = sharded
        # kept only until the lazy DRB build has run — pinning the raw
        # tokens for good would defeat the paper's "no space" premise
        self._doc_tokens = doc_tokens if config.with_drb else None
        self._aux: drb.DRBAux | None = None
        self._avg_dl: torch.Tensor | None = None
        self._idf_tables: dict[str, torch.Tensor] = {}
        self._executors: dict[executors.ExecutorKey, Any] = {}
        self._trace_counts: dict[executors.ExecutorKey, int] = {}
        self._us_per_pop: float | None = None   # EWMA, None until observed
        self._stats_lock = threading.Lock()     # executors / counts / EWMA
        # None -> record into the live process default (obs.enable()/use());
        # the serving frontend pins its own registry here on adoption
        self.obs_registry: obs.Registry | None = None
        if sharded is None:
            self.n_docs = idx.n_docs
            # the heap core's frontier: < 2*n_docs segments pending at once
            self._heap_cap = 2 * idx.n_docs + 4
            # the pool core's frontier holds <= n_docs segments (each split
            # removes 1, adds <= 2, over < n_docs splits)
            self._mega_cap = idx.n_docs + 2
            self._df_np = idx.df.cpu().numpy()
        else:
            self.n_docs = sharded.n_docs
            self._heap_cap = 2 * max(i.n_docs for i in sharded.idx) + 4
            self._mega_cap = 0          # mega covers the single backend only
            # per-word max over shards: any shard's DRB/OR gather fits
            self._df_np = np.max([i.df.cpu().numpy() for i in sharded.idx],
                                 axis=0)
            self._aux = sharded.aux
            self._avg_dl = sharded.global_avg_dl
        self._max_df_cap = int(self._df_np.max()) + 2
        self._content_tag: int | None = None

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, docs, config: EngineConfig | None = None, *,
              vocab_size: int | None = None, device=None) -> "SearchEngine":
        """Build an engine over ``docs`` (a corpus object or a list of
        per-document word-id arrays, ids >= 1).  ``device`` defaults to the
        card ("cuda", raising when none is present); pass "cpu" for the plain
        PyTorch path."""
        dev = backend.resolve_device(device)
        config = config or EngineConfig()
        doc_tokens, vocab_size = _normalize_docs(docs, vocab_size)
        idx, model = wtbc.build_index(doc_tokens, vocab_size,
                                      block=config.block, device=dev)
        return cls(_token=_CTOR_TOKEN, config=config, model=model, idx=idx,
                   doc_tokens=doc_tokens)

    @classmethod
    def from_arrays(cls, index_arrays: dict, model_arrays: dict,
                    idf: dict | None = None,
                    config: EngineConfig | None = None, *,
                    aux: dict | None = None, avg_dl: float | None = None,
                    device=None) -> "SearchEngine":
        """An engine over an index carried across as plain numpy arrays under
        the reference's field names (see :mod:`repro_torch.convert`).
        ``idf`` maps measure names to idf tables, and ``avg_dl`` is the mean
        document length, to use instead of the engine's own host-computed
        ones.  ``aux`` carries the DRB tf bitmaps; without it, DRB (and
        BM25) queries raise, since the raw tokens to build them from are
        not carried."""
        dev = backend.resolve_device(device)
        idx, model = convert.from_reference(index_arrays, model_arrays,
                                            device=dev)
        config = config or EngineConfig(block=idx.levels[0].block)
        if config.block != idx.levels[0].block:
            raise ValueError(f"config.block={config.block} differs from the "
                             f"index's block {idx.levels[0].block}")
        eng = cls(_token=_CTOR_TOKEN, config=config, model=model, idx=idx)
        for name, table in (idf or {}).items():
            if name not in MEASURES:
                raise ValueError(f"unknown measure {name!r} in idf tables")
            eng._idf_tables[name] = convert.idf_table(table, idx)
        if aux is not None:
            eng._aux = convert.aux_from_reference(aux, device=dev)
        if avg_dl is not None:
            eng._avg_dl = torch.tensor(np.float32(avg_dl), device=dev)
        return eng

    @classmethod
    def shard(cls, docs, n_shards: int, config: EngineConfig | None = None,
              *, vocab_size: int | None = None, device=None,
              devices=None) -> "SearchEngine":
        """Build a document-sharded engine: one WTBC (and its DRB bitmaps)
        per contiguous, token-balanced document range, a global (s,c)-DC
        code and global idf so shard scores merge exactly.  ``devices``
        places shard ``s`` on ``devices[s]``; without it shard ``s`` goes to
        ``cuda:{s % device_count}`` (raising when no card is present), or
        every shard to the CPU with ``device="cpu"``."""
        config = config or EngineConfig()
        doc_tokens, vocab_size = _normalize_docs(docs, vocab_size)
        sharded, model = distributed.build_sharded(
            doc_tokens, vocab_size, n_shards=n_shards, block=config.block,
            with_drb=config.with_drb, eps=config.eps, device=device,
            devices=devices)
        return cls(_token=_CTOR_TOKEN, config=config, model=model,
                   sharded=sharded)

    @classmethod
    def from_sharded(cls, sharded: distributed.ShardedWTBC, model,
                     config: EngineConfig) -> "SearchEngine":
        """A sharded engine over an already placed ``ShardedWTBC`` (a
        snapshot's, or one carried across with
        ``convert.sharded_from_reference``)."""
        if config.block != sharded.idx[0].levels[0].block:
            raise ValueError(f"config.block={config.block} differs from the "
                             f"index's block "
                             f"{sharded.idx[0].levels[0].block}")
        return cls(_token=_CTOR_TOKEN, config=config, model=model,
                   sharded=sharded)

    # -- state ----------------------------------------------------------------

    @property
    def idx(self) -> wtbc.WTBCIndex | tuple[wtbc.WTBCIndex, ...]:
        """The index (a tuple of per-shard indexes when sharded)."""
        return self._idx if self._sharded is None else self._sharded.idx

    @property
    def sharded(self) -> distributed.ShardedWTBC | None:
        return self._sharded

    @property
    def device(self) -> torch.device:
        """Where queries enter and results come back (the first shard's
        device when sharded)."""
        return self._idx.device if self._sharded is None \
            else self._sharded.devices[0]

    @property
    def _obs(self) -> obs.Registry:
        """The registry this engine records into: an adopted one
        (``obs_registry``, set by the serving frontend), else the *live*
        process default — looked up per call so ``obs.enable()`` /
        ``obs.use`` after construction still take effect."""
        return self.obs_registry if self.obs_registry is not None \
            else obs.default_registry()

    @property
    def aux(self) -> drb.DRBAux | tuple[drb.DRBAux, ...]:
        """DRB tf bitmaps, built on the host on first use and placed on the
        engine's device (a sharded engine's per-shard bitmaps are built with
        it)."""
        if self._aux is None:
            if not self.config.with_drb:
                raise ValueError("this engine was built with with_drb=False; "
                                 "DRB (and BM25) queries are unavailable")
            if self._doc_tokens is None:
                raise ValueError("DRB bitmaps unavailable: this engine was "
                                 "carried across without them (pass aux= to "
                                 "from_arrays)")
            self._aux = drb.build_aux(self._idx, self.model, self._doc_tokens,
                                      eps=self.config.eps)
            self._doc_tokens = None     # raw tokens no longer needed
        return self._aux

    def _idf_table(self, measure) -> torch.Tensor:
        """Per-measure idf table; on the sharded backend from the *global*
        document frequencies (a shard's own df would make shard scores
        incomparable)."""
        if measure.name not in self._idf_tables:
            self._idf_tables[measure.name] = measure.idf(self._idx) \
                if self._sharded is None \
                else distributed.global_idf_table(self._sharded, measure)
        return self._idf_tables[measure.name]

    def _shard_idf(self, measure) -> tuple[torch.Tensor, ...]:
        """The global idf table on every shard's device (copied once)."""
        key = ("shards", measure.name)
        if key not in self._idf_tables:
            self._idf_tables[key] = self._sharded.replicate(
                self._idf_table(measure))
        return self._idf_tables[key]

    def _avg_doc_len(self) -> torch.Tensor:
        """BM25's mean document length: an exact integer sum on the host,
        then a float32 division (``scoring.avg_doc_len``)."""
        if self._avg_dl is None:
            self._avg_dl = torch.tensor(scoring.avg_doc_len(
                self._idx.doc_len.cpu().numpy(), self.n_docs),
                device=self.device)
        return self._avg_dl

    @property
    def content_tag(self) -> int:
        """CRC32 fingerprint of what this engine would answer with: the
        config plus the index's document-frequency, separator-position and
        document-length tables."""
        if self._content_tag is None:
            shards = (self._idx,) if self._sharded is None \
                else self._sharded.idx
            h = zlib.crc32(repr(dataclasses.astuple(self.config)).encode())
            leaves = [self._df_np]
            for idx in shards:
                leaves += [idx.sep_pos.cpu().numpy(),
                           idx.doc_len.cpu().numpy()]
            for leaf in leaves:
                h = zlib.crc32(np.ascontiguousarray(leaf), h)
            self._content_tag = h
        return self._content_tag

    # -- query normalization -------------------------------------------------

    def _encode_queries(self, queries) -> tuple[np.ndarray, np.ndarray]:
        """Word ids (array or ragged lists) -> padded (B, Q) frequency ranks
        + validity mask.  A single flat query becomes a batch of one.  Q is
        padded up to a power-of-two bucket with masked columns, which every
        core ignores."""
        if hasattr(queries, "ndim") or (
                len(queries) and np.isscalar(queries[0])):
            arr = np.asarray(queries, dtype=np.int64)
            if arr.ndim == 1:
                arr = arr[None, :]
            if arr.ndim != 2:
                raise ValueError(f"queries must be (B, Q) or (Q,), got shape "
                                 f"{arr.shape}")
            mask = np.ones(arr.shape, dtype=bool)
        else:
            rows = [np.asarray(q, dtype=np.int64).reshape(-1) for q in queries]
            if not rows:
                raise ValueError("empty query batch")
            Q = max((len(r) for r in rows), default=0)
            if Q == 0:
                raise ValueError("all queries are empty")
            arr = np.zeros((len(rows), Q), dtype=np.int64)
            mask = np.zeros((len(rows), Q), dtype=bool)
            for b, r in enumerate(rows):
                arr[b, :len(r)] = r
                mask[b, :len(r)] = True
        V = self.model.vocab_size
        bad = mask & ((arr < 1) | (arr >= V))
        if bad.any():
            raise ValueError(f"query word ids must be in [1, {V}); offending "
                             f"ids: {sorted(set(arr[bad].tolist()))[:10]}")
        Qb = pow2_bucket(arr.shape[1])
        if Qb != arr.shape[1]:
            arr = np.pad(arr, ((0, 0), (0, Qb - arr.shape[1])))
            mask = np.pad(mask, ((0, 0), (0, Qb - mask.shape[1])))
        ranks = np.where(mask, self.model.rank_of_word[arr], 0)
        return ranks.astype(np.int32), mask

    def _resolve_measure(self, measure):
        if isinstance(measure, str):
            try:
                return MEASURES[measure]
            except KeyError:
                raise ValueError(f"unknown measure {measure!r}; expected one "
                                 f"of {sorted(MEASURES)} or a scoring object")
        for attr in ("name", "dr_compatible", "idf", "part", "score"):
            if not hasattr(measure, attr):
                raise ValueError(f"measure object lacks .{attr}")
        return measure

    def _resolve_strategy(self, strategy: str, measure, budget,
                          mode: str) -> str:
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                             f"{STRATEGIES}")
        if mode in POSITIONAL_MODES:
            # phrase/near run on the bare WTBC (locate/decode walks); DRB
            # bitmaps carry no positions.  Any additive measure works:
            # documents are fully materialized before scoring
            if strategy == "drb":
                raise ValueError(f"mode={mode!r} runs on the bare WTBC; use "
                                 "strategy='dr' or 'auto'")
            if budget is not None:
                raise ValueError("budget (any-time max_pops) applies to the "
                                 "and/or DR strategy only")
            return "dr"
        if strategy == "auto":
            strategy = "dr" if measure.dr_compatible else "drb"
        if strategy == "dr":
            scoring.assert_dr_compatible(measure)   # BM25 + "dr" -> ValueError
        elif not self.config.with_drb:
            raise ValueError("this engine was built with with_drb=False; "
                             "only strategy='dr' is available")
        return strategy

    def _df_cap(self, ranks: np.ndarray, mask: np.ndarray) -> int:
        """DRB/OR gather width: the largest df among the query words (+2
        slack), rounded up to a power of two so nearby workloads share one
        executor, capped at the engine's largest df + 2."""
        m = int(self._df_np[ranks[mask]].max()) if mask.any() else 1
        return min(pow2_bucket(m + 2), self._max_df_cap)

    def suggested_df_cap(self, queries) -> int:
        """The DRB/OR gather width ``search`` would derive for ``queries`` —
        pass it back as ``search(..., df_cap=...)`` to pin every batch drawn
        from the same word population onto one executor."""
        ranks, mask = self._encode_queries(queries)
        return self._df_cap(ranks, mask)

    # -- anytime cost model ---------------------------------------------------

    def note_cost(self, seconds: float, pops_per_row: float) -> None:
        """Feed the live us/pop estimator one observed batch: ``seconds`` of
        blocking wall time against the mean per-row pop count (EWMA)."""
        if pops_per_row <= 0 or seconds <= 0:
            return
        us = seconds * 1e6 / float(pops_per_row)
        with self._stats_lock:
            prev = self._us_per_pop
            self._us_per_pop = us if prev is None else 0.8 * prev + 0.2 * us

    @property
    def us_per_pop(self) -> float:
        """Live cost estimate (µs of wall time per pop per row);
        ``DEFAULT_US_PER_POP`` until traffic has been observed."""
        with self._stats_lock:
            est = self._us_per_pop
        return DEFAULT_US_PER_POP if est is None else est

    def budget_for_deadline(self, deadline_ms: float) -> int | None:
        """Pop budget affordable within ``deadline_ms`` at the live us/pop
        estimate, floor-quantized to a :func:`budget_bucket`.  None when the
        exhaustive search provably fits (a DR search pops < 2*n_docs + 2
        segments)."""
        pops = int(float(deadline_ms) * 1e3 / self.us_per_pop)
        if pops >= 2 * self.n_docs + 2:
            return None
        return budget_bucket(max(1, pops))

    # -- dispatch ------------------------------------------------------------

    def _executor(self, key: executors.ExecutorKey):
        with self._stats_lock:
            ex = self._executors.get(key)
        if ex is None:
            def note():
                with self._stats_lock:
                    self._trace_counts[key] = self._trace_counts.get(key, 0) + 1
                self._obs.counter(
                    "repro_engine_traces_total",
                    {"backend": key.backend, "strategy": key.strategy,
                     "mode": key.mode},
                    "executor constructions (growth after warmup = key "
                    "churn)").inc()
            if key.backend == "sharded":
                ex = executors.make_sharded(key, heap_cap=self._heap_cap,
                                            note=note)
            elif key.mode in POSITIONAL_MODES:
                ex = executors.make_single_positional(key, note=note)
            elif key.strategy == "dr":
                ex = executors.make_single_dr(key, heap_cap=self._heap_cap,
                                              mega_cap=self._mega_cap,
                                              note=note)
            else:
                ex = executors.make_single_drb(key, note=note)
            with self._stats_lock:
                ex = self._executors.setdefault(key, ex)
        return ex

    def warmup(self, queries, *, max_batch: int = 1, k: int | None = None,
               mode: str = "and", strategy: str = "auto", measure="tfidf",
               budget: int | None = None, sla: str | None = None,
               window: int | None = None,
               beam_width: int | None = None, df_cap: int | None = None,
               mega: bool | None = None) -> int:
        """Construct every executor the traffic profile can hit: one per
        (batch bucket <= pow2(max_batch), Q bucket present in ``queries``),
        each by one real search.  Returns the number of new executors; after
        it, traffic of this profile adds none (``stats['traces']``).  For
        DRB ``or`` traffic pass a ``df_cap`` (e.g. :meth:`suggested_df_cap`
        over the word population), else each batch derives its own.  On the
        card it first builds every missing kernel library, so no request
        (and no second thread) starts ``nvcc``."""
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if self.device.type == "cuda":
            backend.build()
        if hasattr(queries, "ndim") or (
                len(queries) and np.isscalar(queries[0])):
            arr = np.asarray(queries)
            rows = list(arr[None, :] if arr.ndim == 1 else arr)
        else:
            rows = [np.asarray(q).reshape(-1) for q in queries]
        reps = {}                       # Q bucket -> one representative row
        for r in rows:
            reps.setdefault(pow2_bucket(max(1, len(r))), r)
        before = sum(self._trace_counts.values())
        kw = dict(k=k, mode=mode, strategy=strategy, measure=measure,
                  budget=budget, sla=sla, window=window,
                  beam_width=beam_width, df_cap=df_cap, mega=mega)
        n_b = pow2_bucket(max_batch).bit_length()     # 1, 2, 4, ..., bucket
        for r in reps.values():
            row = [int(w) for w in r]
            for bb in (1 << i for i in range(n_b)):
                self.search([row] * bb, **kw)
        return sum(self._trace_counts.values()) - before

    def search(self, queries, *, k: int | None = None, mode: str = "and",
               strategy: str = "auto", measure="tfidf",
               budget: int | None = None,
               deadline_ms: float | None = None,
               sla: str | None = None,
               window: int | None = None,
               beam_width: int | None = None,
               df_cap: int | None = None,
               mega: bool | None = None) -> SearchResults:
        """Ranked top-k retrieval (the reference's contract).

        queries:  (B, Q) / (Q,) array of word ids, or ragged lists of ids.
        k:        results per query (default ``config.default_k``).
        mode:     "and" (conjunctive), "or" (bag-of-words), "phrase" (the
                  words consecutive, in order) or "near" (every word within
                  a window of ``window`` tokens).
        strategy: "dr" (no extra space), "drb" (tf bitmaps) or "auto" (DR
                  for tf-idf, DRB for measures DR cannot rank, i.e. BM25).
        measure:  "tfidf" or "bm25" (DRB only; DR rejects it as in the
                  reference).
        budget:   anytime budget per row — pops on DR, candidate documents
                  on DRB ``and``; results carry ``certified`` bits and a
                  ``score_bound``.  A budget that cannot bind runs the exact
                  search; DRB ``or`` is loop-free and ignores it.
        deadline_ms: converted to a budget through the live us/pop estimate
                  (pow-4 buckets); combines with ``budget`` by min.
        sla:      "exact" (rejects budgets/deadlines), "bounded" or
                  "best_effort".
        beam_width: frontier width P of the heap core or of the DRB ``and``
                  walk (default ``config.default_beam_width``); results are
                  identical at every width.
        df_cap:   DRB ``or`` gather width (pow2-bucketed, capped at the
                  engine's largest df + 2); by default derived from the
                  batch's heaviest word.  A cap below what the batch needs
                  raises instead of silently truncating.  DRB ``or`` only.
        mega:     run DR on the pool-frontier megabatch core (forces P=1);
                  normalized off on DRB.
        window:   proximity width in tokens, ``mode="near"`` only (default
                  ``config.default_window``).

        Positional modes run on the bare WTBC under any measure: they take
        no ``budget``, ``deadline_ms`` or ``beam_width``, reject
        ``strategy="drb"``, cap ``k`` at the collection's size, and their
        results carry ``match_pos`` / ``match_len``.
        """
        k = self.config.default_k if k is None else int(k)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
        if sla is not None and sla not in SLA_CLASSES:
            raise ValueError(f"unknown sla {sla!r}; expected one of "
                             f"{SLA_CLASSES}")
        if deadline_ms is not None and float(deadline_ms) <= 0:
            raise ValueError(f"deadline_ms must be positive, got {deadline_ms}")
        anytime = budget is not None or deadline_ms is not None
        sla = sla or ("bounded" if anytime else self.config.default_sla)
        if sla == "exact" and anytime:
            raise ValueError("sla='exact' guarantees an uninterrupted search "
                             "— budget/deadline_ms require sla='bounded' or "
                             "'best_effort'")
        if deadline_ms is not None:
            db = self.budget_for_deadline(deadline_ms)
            if db is not None:
                budget = db if budget is None else min(int(budget), db)
        if mode == "near":
            window = self.config.default_window if window is None \
                else int(window)
            if window < 1:
                raise ValueError(f"window must be >= 1, got {window}")
        elif window is not None:
            raise ValueError(f"window applies to mode='near' only "
                             f"(got mode={mode!r})")
        m = self._resolve_measure(measure)
        if mode in POSITIONAL_MODES and deadline_ms is not None:
            raise ValueError("deadline_ms applies to the anytime and/or "
                             f"search cores only (got mode={mode!r}); "
                             "positional searches are always exhaustive")
        strat = self._resolve_strategy(strategy, m, budget, mode)
        if budget is not None:
            budget = int(budget)
            if budget < 1:
                raise ValueError(f"budget must be >= 1, got {budget}")
            if strat == "drb" and mode == "or":
                budget = None   # loop-free gather: always complete/certified
            elif budget >= 2 * self.n_docs + 2:
                budget = None   # can never bind: run the plain exact search
        if mode in POSITIONAL_MODES:
            if beam_width is not None:
                raise ValueError("beam_width applies to the looped and/or "
                                 f"search cores only (got mode={mode!r})")
            if self.backend == "sharded":
                raise ValueError(f"mode={mode!r} is not yet supported on the "
                                 "sharded backend; build a single-host engine")
            # positional top-k ranks the whole document table
            k = min(k, self.n_docs)
        if beam_width is None:
            beam_width = self.config.default_beam_width
        elif int(beam_width) < 1:
            raise ValueError(f"beam_width must be >= 1, got {beam_width}")
        beam_width = int(beam_width)
        if mode in POSITIONAL_MODES or (strat == "drb" and mode == "or"):
            beam_width = 1      # no search loop: don't split the executor
        mega = self.config.default_mega if mega is None else bool(mega)
        # the mega core covers DR and/or only; elsewhere normalize it off (a
        # serving profile may carry one flag across strategy routing)
        mega = mega and self.backend == "single" and strat == "dr" \
            and mode in ("and", "or")
        if mega:
            beam_width = 1      # one pop per row: the batch dim IS the beam
        ranks, mask = self._encode_queries(queries)
        if strat == "drb" and mode == "or":
            auto_cap = self._df_cap(ranks, mask)
            if df_cap is None:
                df_cap = auto_cap
            else:
                df_cap = min(pow2_bucket(int(df_cap)), self._max_df_cap)
                if df_cap < auto_cap:
                    raise ValueError(
                        f"df_cap={df_cap} is smaller than the {auto_cap} this "
                        "batch's heaviest word needs — the gather would "
                        "silently truncate; pass a cap derived from "
                        "suggested_df_cap over the full word population")
        elif df_cap is not None:
            raise ValueError("df_cap applies to the DRB/OR gather path only "
                             f"(got strategy={strat!r}, mode={mode!r})")
        key = executors.ExecutorKey(self.backend, strat, mode, m, k,
                                    tuple(ranks.shape), budget, df_cap,
                                    beam_width, mega)
        ex = self._executor(key)
        dev = self.device
        words = torch.from_numpy(ranks).to(dev)
        wmask = torch.from_numpy(mask).to(dev)
        reg = self._obs
        t0 = time.perf_counter() if reg.enabled else 0.0
        if mode in POSITIONAL_MODES:
            res = ex(self._idx, words, wmask, self._idf_table(m), window or 0,
                     self._avg_doc_len())
            if reg.enabled:
                self._record_search(reg, key, res, ranks.shape, t0)
            return SearchResults(docs=res.docs, scores=res.scores,
                                 n_found=res.n_found, work=res.iters, k=k,
                                 mode=mode, strategy=strat, measure=m.name,
                                 match_pos=res.match_pos,
                                 match_len=res.match_len,
                                 beam_width=beam_width, sla=sla)
        if self.backend == "sharded":
            res = ex(self._sharded, words, wmask, self._shard_idf(m))
        elif strat == "dr":
            res = ex(self._idx, words, wmask, self._idf_table(m))
        else:
            res = ex(self._idx, self.aux, words, wmask, self._idf_table(m),
                     self._avg_doc_len())
        if reg.enabled:
            self._record_search(reg, key, res, ranks.shape, t0)
        return SearchResults(docs=res.docs, scores=res.scores,
                             n_found=res.n_found, work=res.iters, k=k,
                             mode=mode, strategy=strat, measure=m.name,
                             beam_width=beam_width, pops=res.pops,
                             overflowed=res.overflowed, padded=res.padded,
                             certified=res.certified,
                             score_bound=res.bound, sla=sla)

    def _record_search(self, reg: obs.Registry, key, res, shape, t0: float
                       ) -> None:
        """Registry side of one observed search (enabled registries only):
        per-(backend, strategy, mode) dispatch counters, per-row work
        histograms and the live WTBC roofline gauges.  Reading ``res.docs``
        to the host first waits for the device, so the wall time covers the
        work and not only its launch — which is why a disabled registry
        skips this method entirely."""
        res.docs.cpu()
        dt = time.perf_counter() - t0
        B, Q = int(shape[0]), int(shape[1])
        labels = {"backend": key.backend, "strategy": key.strategy,
                  "mode": key.mode}
        reg.counter("repro_engine_searches_total", labels,
                    "search batches dispatched").inc()
        reg.counter("repro_engine_rows_total", labels,
                    "query rows searched").inc(B)
        reg.histogram("repro_engine_dispatch_seconds", labels,
                      "blocking wall time per search batch").observe(dt)
        with self._stats_lock:
            n_exec = len(self._executors)
        reg.gauge("repro_engine_executors", None,
                  "executors cached").set(n_exec)
        reg.histogram("repro_engine_trips", labels,
                      "search-loop trips per query row"
                      ).observe_many(res.iters.cpu().numpy().ravel().tolist())
        pops = getattr(res, "pops", None)
        padded = getattr(res, "padded", None)
        if padded is not None:
            padded = padded.cpu().numpy().ravel()
            reg.histogram("repro_engine_pad_lanes", labels,
                          "dead beam lanes per query row (pad waste)"
                          ).observe_many(padded.tolist())
        if pops is None:
            return
        pops = pops.cpu().numpy().ravel()
        reg.histogram("repro_engine_pops", labels,
                      "candidate pops per query row"
                      ).observe_many(pops.tolist())
        if key.budget is None and len(pops):
            # feed the deadline -> budget estimator from *unbudgeted*
            # batches only: a budget-cut batch would bias us/pop optimistic
            self.note_cost(dt, float(pops.mean()))
        reg.gauge("repro_engine_us_per_pop", None,
                  "live pop cost estimate feeding deadline budgets"
                  ).set(self.us_per_pop)
        if len(pops):
            rl = roofline.wtbc_query_roofline(
                backend=self.device.type,
                measured_us_per_query=dt * 1e6 / max(B, 1),
                pops=float(pops.mean()),
                padded=float(padded.mean()) if padded is not None else 0.0,
                q=Q, block=int(self.config.block))
            roofline.live_wtbc_gauges(rl, reg)

    # -- post-processing -----------------------------------------------------

    def _shard_of(self, docs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(shard, local document id) of each global document id."""
        if self._sharded is None:
            return np.zeros(len(docs), np.int64), docs
        bases = np.asarray(self._sharded.bases)
        s = np.searchsorted(bases, docs, side="right") - 1
        return s, docs - bases[s]

    def snippets(self, results: SearchResults,
                 length: int = 8) -> list[list[np.ndarray]]:
        """Decode the first ``length`` word ids of every hit document
        straight from the compressed index (no stored text).  Returns one
        list per query, one id array per hit (shorter documents come back
        whole).  The hits of each index (each shard's, when sharded) are
        decoded in one batched ``wtbc.decode_at`` on its device — on the
        card, one ``wtbc_decode`` launch."""
        length = int(length)
        if length < 1:
            raise ValueError(f"length must be >= 1, got {length}")
        hits = [[d for d, _ in results.hits(b)] for b in range(len(results))]
        flat = np.array([d for row in hits for d in row], dtype=np.int64)
        if not len(flat):
            return [[] for _ in hits]
        shard, local = self._shard_of(flat)
        indexes = (self._idx,) if self._sharded is None else self._sharded.idx
        words = [None] * len(flat)
        for s in np.unique(shard):
            idx = indexes[s]
            at = np.flatnonzero(shard == s)
            d = torch.from_numpy(local[at].astype(np.int32)).to(idx.device)
            pos = wtbc.doc_start(idx, d)[:, None] + torch.arange(
                length, dtype=torch.int32, device=idx.device)
            # a fixed decode width; positions clamped in bounds, trimmed on
            # the host
            ranks = wtbc.decode_at(idx, pos.clamp(max=idx.n - 1)).cpu().numpy()
            n_take = np.minimum(length, idx.doc_len[d.long()].cpu().numpy())
            for i, j in enumerate(at):
                words[j] = self.model.word_of_rank[ranks[i, :n_take[i]]]
        out, at = [], 0
        for row in hits:
            out.append(words[at:at + len(row)])
            at += len(row)
        return out

    def word_positions(self, doc: int, word_ids,
                       cap: int = 32) -> dict[int, np.ndarray]:
        """Doc-relative occurrence positions of each word id inside document
        ``doc`` (the first ``cap`` per word), extracted straight from the
        compressed index (the hit's own shard when sharded) — the
        hit-highlighting companion to :meth:`snippets`.  Every word at once:
        on the card one ``wavelet_count`` launch for the counts and one
        ``wtbc_locate`` launch for the positions."""
        doc = int(doc)
        if not 0 <= doc < self.n_docs:
            raise ValueError(f"doc id {doc} outside [0, {self.n_docs})")
        V = self.model.vocab_size
        ids = [int(w) for w in word_ids]
        for w in ids:
            if not 1 <= w < V:
                raise ValueError(f"word id {w} outside [1, {V})")
        if not ids:
            return {}
        shard, local = self._shard_of(np.array([doc], dtype=np.int64))
        idx = self._idx if self._sharded is None \
            else self._sharded.idx[int(shard[0])]
        ranks = torch.from_numpy(self.model.rank_of_word[ids].astype(
            np.int32)).to(idx.device)
        pos = positional.doc_positions(idx, ranks, int(local[0]),
                                       cap=int(cap)).cpu().numpy()
        return {w: p[p >= 0] for w, p in zip(ids, pos)}

    # -- introspection -------------------------------------------------------

    @property
    def stats(self) -> dict:
        """Executor-cache occupancy and per-key construction counts."""
        with self._stats_lock:
            return {"executors": len(self._executors),
                    "traces": dict(self._trace_counts)}

    def space_report(self) -> dict[str, int]:
        """Index (and, once built, DRB bitmap) space on its device, bytes
        per component (summed over the shards when sharded)."""
        reports = self.shard_space_reports()
        return {k: sum(r[k] for r in reports) for k in reports[0]}

    def shard_space_reports(self) -> list[dict[str, int]]:
        """:meth:`space_report` of each index (one per shard when
        sharded), as it lies on its device."""
        shards = (self._idx,) if self._sharded is None else self._sharded.idx
        auxes = (self._aux,) if self._sharded is None else \
            (self._aux or (None,) * len(shards))
        out = []
        for idx, aux in zip(shards, auxes):
            report = wtbc.space_report(idx)
            if aux is not None:
                aux_rep = drb.space_report(aux)
                report.update({f"drb_{k}": v for k, v in aux_rep.items()})
                report["total"] += sum(aux_rep.values())
            out.append(report)
        return out


_CTOR_TOKEN = object()
