"""Synthetic natural-language-like corpora (Zipf words, lognormal doc lengths).

The port's own copy of ``repro.text.corpus``'s generators: the same seed
draws the same tokens, document-frequency bands and query words (band
samples, n-gram queries and the df-weighted "real-log" queries), so the
port rebuilds the reference's corpora and query sets without importing it.

The paper evaluates on ~1GB of TREC text (219M words, 718,691-word vocabulary,
345,778 documents).  Scaled-down corpora come from the same statistical
family: Zipf(alpha~1.2) unigram frequencies and lognormal document lengths.
Query workloads mirror the paper's: words sampled uniformly from
document-frequency bands i) 10-100, ii) 101-1k, iii) 1k-10k, iv) 10k-100k
(bands rescaled with the corpus).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticCorpus:
    doc_tokens: list[np.ndarray]   # word ids per document (0 reserved for '$')
    vocab_size: int
    seed: int

    @property
    def n_docs(self) -> int:
        return len(self.doc_tokens)

    @property
    def n_tokens(self) -> int:
        return int(sum(len(d) for d in self.doc_tokens)) + self.n_docs

    def doc_freqs(self) -> np.ndarray:
        """Document frequency per word id."""
        df = np.zeros(self.vocab_size, dtype=np.int64)
        for d in self.doc_tokens:
            df[np.unique(d)] += 1
        df[0] = self.n_docs
        return df


def zipf_probs(vocab_size: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, vocab_size, dtype=np.float64)  # ids 1..V-1 (0 is '$')
    p = ranks ** (-alpha)
    return p / p.sum()


def make_corpus(n_docs: int = 2000, mean_doc_len: int = 400,
                vocab_size: int = 20_000, alpha: float = 1.2,
                seed: int = 0) -> SyntheticCorpus:
    """One ``rng.choice`` per document, exactly as the reference draws them
    (so a seed gives the reference's tokens)."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(2, rng.lognormal(np.log(mean_doc_len), 0.6, n_docs)).astype(np.int64)
    p = zipf_probs(vocab_size, alpha)
    docs = [rng.choice(np.arange(1, vocab_size), size=int(l), p=p) for l in lens]
    return SyntheticCorpus(doc_tokens=docs, vocab_size=vocab_size, seed=seed)


def fdoc_bands(n_docs: int) -> dict[str, tuple[int, int]]:
    """The paper's four document-frequency bands, rescaled to the corpus size.

    Paper bands (345,778 docs): i) 10-100, ii) 101-1,000, iii) 1,001-10,000,
    iv) 10,001-100,000.  The absolute decade structure is kept, clipped to
    the corpus.
    """
    scale = n_docs / 345_778
    bands = {}
    for name, (lo, hi) in {"i": (10, 100), "ii": (101, 1000),
                           "iii": (1001, 10_000), "iv": (10_001, 100_000)}.items():
        lo_s = max(2, int(lo * scale)) if scale < 1 else lo
        hi_s = max(lo_s + 1, int(hi * scale)) if scale < 1 else hi
        bands[name] = (lo_s, min(hi_s, n_docs))
    return bands


def sample_queries(df: np.ndarray, band: tuple[int, int], n_queries: int,
                   words_per_query: int, seed: int = 0,
                   exclude: int = 0) -> np.ndarray:
    """Sample query word-id sets from a document-frequency band (paper §4.2)."""
    rng = np.random.default_rng(seed)
    lo, hi = band
    pool = np.flatnonzero((df >= lo) & (df <= hi))
    pool = pool[pool != exclude]
    if len(pool) < words_per_query:
        raise ValueError(f"band {band} has only {len(pool)} candidate words")
    return np.stack([rng.choice(pool, size=words_per_query, replace=False)
                     for _ in range(n_queries)])


def sample_ngram_queries(doc_tokens, n_queries: int, q_len: int,
                         seed: int = 0, *, df: np.ndarray | None = None,
                         df_cap: int | None = None, random_prob: float = 0.0,
                         vocab_size: int | None = None) -> np.ndarray:
    """(n_queries, q_len) word-id batches: contiguous n-grams lifted from
    random documents — positional (phrase/near) queries that actually have
    occurrences to rank (independent random words almost never co-occur
    adjacently, which would exercise only the empty-result path).

    df/df_cap:   best-effort rejection (up to 50 draws) of n-grams containing
                 a word with document frequency above ``df_cap`` — the near
                 sweep is O(sum of the query words' occurrences), so Zipf-head
                 stopword grams benchmark the worst case, not the typical one.
    random_prob: probability of replacing an n-gram with uniform random ids
                 in [1, vocab_size) (differential tests want no-match cases).
    """
    rng = np.random.default_rng(seed)
    pool = [d for d in doc_tokens if len(d) >= q_len]
    if not pool:
        raise ValueError(f"no documents with >= {q_len} tokens to lift "
                         f"{q_len}-gram queries from")
    out = np.empty((n_queries, q_len), dtype=np.int64)
    for i in range(n_queries):
        if random_prob and rng.random() < random_prob:
            out[i] = rng.integers(1, vocab_size, size=q_len)
            continue
        for _ in range(50):
            d = pool[int(rng.integers(len(pool)))]
            j = int(rng.integers(0, len(d) - q_len + 1))
            out[i] = d[j:j + q_len]
            if df is None or df_cap is None or int(df[out[i]].max()) <= df_cap:
                break
    return out


def zipf_real_queries(df: np.ndarray, n_queries: int, words_per_query: int,
                      seed: int = 0) -> np.ndarray:
    """'Real-log'-like queries: words drawn with probability ~ df (frequent
    words are queried more), mimicking the head-heavy TREC million-query log."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, len(df))
    p = df[1:].astype(np.float64)
    p = np.where(p > 0, p, 0)
    p = p / p.sum()
    out = np.empty((n_queries, words_per_query), dtype=np.int64)
    for q in range(n_queries):
        out[q] = rng.choice(w, size=words_per_query, replace=False, p=p)
    return out
