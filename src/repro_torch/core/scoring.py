"""Relevance scoring: tf-idf (the paper's measure) and Okapi BM25 (extension).

The paper stores df_w per word and computes
``tfidf(w, d) = tf_{w,d} * log(N / df_w)``, summing over query words.

WTBC-DR's prioritized traversal requires the score to be *monotone over
concatenation of documents*; tf-idf with raw tf satisfies this, BM25 does not
(document-length normalization), which is why the paper pairs BM25 with the
DRB strategy only.  ``assert_dr_compatible`` enforces that at the API level.

**Number contract.**

* idf tables are computed once on the host: the argument of the log in
  float32 steps (the reference's arithmetic), the log in float64, rounded
  to float32.  The table is therefore identical on the CPU and the card; it
  may differ from the reference's float32 ``jnp.log`` by 1 ulp per entry.
* a score is *round each product, add from left to right over Q*
  (:func:`dot_q`) — an explicit loop of separate multiplies and adds, never
  ``.sum(-1)`` or ``@``, so no reduction order or FMA contraction can enter.
  The beam-loop kernel uses ``__fmul_rn`` / ``__fadd_rn`` in the same order,
  so the port's scores are bitwise equal across devices and batch shapes.
* BM25's per-word part runs the reference's operations in the reference's
  order, each a separate rounded float32 operation:
  ``norm = (1 - b) + b * (doc_len / avg_dl)``, then
  ``tf * (k1 + 1) / (tf + k1 * norm)``, with ``1 - b`` and ``k1 + 1``
  formed in double precision and rounded once, as Python does for the
  reference.  ``avg_dl`` is computed on the host from an exact integer sum
  (:func:`avg_doc_len`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def dot_q(tf: torch.Tensor, idf_w: torch.Tensor) -> torch.Tensor:
    """sum_q tf[..., q] * idf_w[..., q]: each product rounded to float32,
    added from left to right."""
    acc = torch.zeros(torch.broadcast_shapes(tf.shape, idf_w.shape)[:-1],
                      dtype=torch.float32, device=tf.device)
    for q in range(tf.shape[-1]):
        acc = acc + tf[..., q].to(torch.float32) * idf_w[..., q]
    return acc


def avg_doc_len(doc_len: np.ndarray, n_docs: int) -> np.float32:
    """Mean document length for BM25: the int64 sum of the lengths, then a
    float32 division.  Below 2**24 tokens this is the reference's float32
    ``jnp.sum`` / n_docs bit for bit; above, the reference's float32
    summation depends on its order and the two may differ."""
    total = np.float32(np.asarray(doc_len, dtype=np.int64).sum())
    return np.float32(total / np.float32(max(int(n_docs), 1)))


def _f32(x: float) -> float:
    """``x`` rounded to float32 (a Python scalar, so no device copy): the
    constant the reference's weakly typed float becomes."""
    return float(np.float32(x))


def _host_df(idx) -> np.ndarray:
    return idx.df.cpu().numpy().astype(np.float32)


def _to_device(idf64: np.ndarray, idx) -> torch.Tensor:
    return torch.from_numpy(idf64.astype(np.float32)).to(idx.df.device)


@dataclasses.dataclass(frozen=True)
class TfIdf:
    """score(d) = sum_w tf_{w,d} * ln(N / df_w)"""
    name: str = "tfidf"
    dr_compatible: bool = True

    def idf(self, idx) -> torch.Tensor:
        df = np.maximum(_host_df(idx), np.float32(1.0))
        ratio = np.float32(idx.n_docs) / df                 # float32 quotient
        return _to_device(np.log(ratio.astype(np.float64)), idx)

    def part(self, tf: torch.Tensor, doc_len: torch.Tensor | None = None,
             avg_dl: torch.Tensor | None = None) -> torch.Tensor:
        """The per-word factor that multiplies idf: tf itself."""
        return tf.to(torch.float32)

    def score(self, tf: torch.Tensor, idf_w: torch.Tensor,
              doc_len: torch.Tensor | None = None,
              avg_dl: torch.Tensor | None = None) -> torch.Tensor:
        return dot_q(self.part(tf), idf_w)


@dataclasses.dataclass(frozen=True)
class BM25:
    """Okapi BM25 (k1, b) — usable with WTBC-DRB (candidate-then-rank) only."""
    k1: float = 1.2
    b: float = 0.75
    name: str = "bm25"
    dr_compatible: bool = False

    def idf(self, idx) -> torch.Tensor:
        df = _host_df(idx)
        n = np.float32(idx.n_docs)
        half = np.float32(0.5)
        arg = np.float32(1.0) + (n - df + half) / (df + half)  # float32 steps
        return _to_device(np.log(arg.astype(np.float64)), idx)

    def part(self, tf: torch.Tensor, doc_len: torch.Tensor,
             avg_dl: torch.Tensor) -> torch.Tensor:
        """The per-word factor that multiplies idf: ``tf (k1 + 1) / (tf +
        k1 norm(d))``; ``tf`` (..., Q), ``doc_len`` (...), ``avg_dl`` a
        float32 scalar."""
        tf = tf.to(torch.float32)
        ratio = doc_len.to(torch.float32) / avg_dl
        norm = _f32(1.0 - self.b) + _f32(self.b) * ratio
        return tf * _f32(self.k1 + 1.0) / (tf + _f32(self.k1)
                                            * norm[..., None])

    def score(self, tf: torch.Tensor, idf_w: torch.Tensor,
              doc_len: torch.Tensor | None = None,
              avg_dl: torch.Tensor | None = None) -> torch.Tensor:
        """sum_q idf_q * part_q (:func:`dot_q`)."""
        return dot_q(self.part(tf, doc_len, avg_dl), idf_w)


def assert_dr_compatible(measure) -> None:
    if not measure.dr_compatible:
        raise ValueError(
            f"{measure.name} is not monotone over document concatenation; "
            "WTBC-DR's prioritized traversal requires tf-idf (paper §5). "
            "Use WTBC-DRB for BM25.")
