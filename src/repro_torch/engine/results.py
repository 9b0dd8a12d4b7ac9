"""Query results returned by :meth:`repro_torch.engine.SearchEngine.search`.

A thin wrapper over the cores' ``DRResult`` tensors (on the engine's device)
plus the resolved routing metadata.  Host views (``hits``, ``doc_ids``,
``diagnostics``) copy to numpy on demand.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class SearchResults:
    """Top-k answers for a batch of queries.

    docs:    (B, k) int32 document ids, -1 padded past ``n_found``.
    scores:  (B, k) float32, descending, -inf padded.
    n_found: (B,)   int32 documents actually found per query.
    work:    (B,)   int32 loop trips per query row.
    k / mode / strategy / measure: the resolved query parameters.
    match_pos / match_len: positional payloads of the "phrase" and "near"
             modes only (None otherwise).  ``match_pos`` is the (B, k)
             doc-relative token offset of the first phrase match / of the
             minimal proximity window; ``match_len`` its width in tokens;
             both -1 padded past ``n_found``.
    beam_width: the frontier width the executor ran with.
    pops:    (B,) int32 segments popped.
    overflowed: (B,) bool — a frontier dropped a push at capacity; the
             query's ranking may be incomplete.
    padded:  (B,) int32 dead beam lanes paid for (None on the mega core).
    certified: (B, k) bool — a True slot provably equals the exact oracle's
             slot; a prefix per row, all True when the search completed.
    score_bound: (B,) float32 score upper bound on every document NOT in
             ``docs`` (-inf when the frontier was exhausted).
    sla:     the resolved SLA class.
    """
    docs: torch.Tensor
    scores: torch.Tensor
    n_found: torch.Tensor
    work: torch.Tensor
    k: int
    mode: str
    strategy: str
    measure: str
    match_pos: torch.Tensor | None = None
    match_len: torch.Tensor | None = None
    beam_width: int = 1
    pops: torch.Tensor | None = None
    overflowed: torch.Tensor | None = None
    padded: torch.Tensor | None = None
    certified: torch.Tensor | None = None
    score_bound: torch.Tensor | None = None
    sla: str = "exact"

    def __post_init__(self):
        if self.docs.ndim != 2 or self.scores.shape != self.docs.shape:
            raise ValueError(f"expected batched (B, k) results, got docs "
                             f"{tuple(self.docs.shape)} / scores "
                             f"{tuple(self.scores.shape)}")
        for a in (self.match_pos, self.match_len):
            if a is not None and a.shape != self.docs.shape:
                raise ValueError(f"match payload shape {tuple(a.shape)} != "
                                 f"docs shape {tuple(self.docs.shape)}")

    def __len__(self) -> int:
        return int(self.docs.shape[0])

    def hits(self, b: int = 0) -> list[tuple[int, float]]:
        """Found ``(doc_id, score)`` pairs of query ``b``, best first."""
        n = int(self.n_found[b])
        docs = _np(self.docs[b])[:n]
        scores = _np(self.scores[b])[:n]
        return [(int(d), float(s)) for d, s in zip(docs, scores)]

    def matches(self, b: int = 0) -> list[tuple[int, float, int, int]]:
        """Found ``(doc_id, score, match_pos, match_len)`` tuples of query
        ``b``, best first — positional ("phrase" / "near") results only."""
        if self.match_pos is None or self.match_len is None:
            raise ValueError(f"mode={self.mode!r} results carry no match "
                             "positions; use .hits() (positions exist for "
                             "the 'phrase' and 'near' modes only)")
        n = int(self.n_found[b])
        return [(int(d), float(s), int(p), int(l)) for d, s, p, l in zip(
            _np(self.docs[b])[:n], _np(self.scores[b])[:n],
            _np(self.match_pos[b])[:n], _np(self.match_len[b])[:n])]

    def doc_ids(self) -> np.ndarray:
        """(B, k) numpy view of the document ids (-1 padded)."""
        return _np(self.docs)

    def certified_fraction(self) -> float:
        """Certified slots / found slots over the whole batch."""
        if self.certified is None:
            return 1.0
        found = int(_np(self.n_found).sum())
        if found == 0:
            return 1.0
        return float(_np(self.certified).sum()) / found

    @property
    def diagnostics(self) -> dict:
        """Per-query health/work counters as host arrays: ``work``,
        ``beam_width``, ``sla`` and, when reported, ``pops``,
        ``overflowed``, ``padded``, ``certified``, ``certified_fraction``,
        ``score_bound``."""
        out = {"work": _np(self.work), "beam_width": self.beam_width,
               "sla": self.sla}
        for name in ("pops", "overflowed", "padded", "certified"):
            v = getattr(self, name)
            if v is not None:
                out[name] = _np(v)
        if self.certified is not None:
            out["certified_fraction"] = self.certified_fraction()
        if self.score_bound is not None:
            out["score_bound"] = _np(self.score_bound)
        return out
