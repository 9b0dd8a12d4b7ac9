"""(s,c)-Dense Code — word-based byte-oriented semistatic statistical compressor.

The port's own copy of the numpy build logic of ``repro.core.scdc``: the
same fit gives the same (s, c), codewords and rank tables for the same
frequencies, so a port index is byte-for-byte the reference's.

The paper builds the WTBC on top of (s,c)-DC [Brisaboa et al., Inf.Retr. 2007]:
byte values ``[0, s)`` are *stoppers*, ``[s, 256)`` are *continuers* (``s+c = 256``).
A codeword is zero or more continuers terminated by exactly one stopper, so the
``s`` most frequent words get 1-byte codewords, the next ``s*c`` get 2 bytes, the
next ``s*c^2`` get 3 bytes, and so on.  ``(s, c)`` is chosen to minimize the
compressed size for the observed word-frequency distribution.

Everything here is host-side build logic (numpy); the query-time structures the
WTBC needs (codeword tables, per-word node paths) are emitted as plain arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

#: Maximum codeword length we materialize node-offset tables for.  With the
#: constraint enforced in :func:`optimal_sc`, every vocabulary we handle fits in
#: codewords of at most MAX_CODE_LEN bytes (the paper's 1GB corpus, 718,691
#: distinct words, fits in 3 bytes for every (s,c) with s*(1+c+c^2) >= |V|).
MAX_CODE_LEN = 3


def capacity(s: int, max_len: int = MAX_CODE_LEN) -> int:
    """Number of distinct codewords of length <= max_len for a given ``s``."""
    c = 256 - s
    total, width = 0, s
    for _ in range(max_len):
        total += width
        width *= c
    return total


def code_lengths(s: int, vocab_size: int, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Length (in bytes) of the codeword of each frequency rank ``0..V-1``."""
    c = 256 - s
    lens = np.empty(vocab_size, dtype=np.int8)
    base, width = 0, s
    for k in range(1, max_len + 1):
        hi = min(vocab_size, base + width)
        lens[base:hi] = k
        base, width = base + width, width * c
        if base >= vocab_size:
            break
    if base < vocab_size:
        raise ValueError(
            f"vocab of {vocab_size} does not fit in {max_len}-byte (s={s},c={c}) codes"
        )
    return lens


def compressed_size(s: int, freqs_desc: np.ndarray, max_len: int = MAX_CODE_LEN) -> int:
    """Total compressed bytes when ranks are assigned by decreasing frequency."""
    lens = code_lengths(s, len(freqs_desc), max_len)
    return int(np.dot(lens.astype(np.int64), freqs_desc.astype(np.int64)))


def optimal_sc(freqs_desc: np.ndarray, max_len: int = MAX_CODE_LEN) -> tuple[int, int]:
    """Search ``s`` in [1, 255] minimizing compressed size (subject to fit).

    The classical (s,c)-DC optimization; the size function is unimodal-ish in
    ``s`` but cheap enough to scan exhaustively (255 evaluations).
    """
    best_s, best_sz = None, None
    v = len(freqs_desc)
    for s in range(1, 256):
        if capacity(s, max_len) < v:
            continue
        sz = compressed_size(s, freqs_desc, max_len)
        if best_sz is None or sz < best_sz:
            best_s, best_sz = s, sz
    if best_s is None:
        raise ValueError(f"no (s,c) fits a vocabulary of {v} words in {max_len} bytes")
    return best_s, 256 - best_s


def encode_table(s: int, vocab_size: int, max_len: int = MAX_CODE_LEN) -> tuple[np.ndarray, np.ndarray]:
    """Codewords for every rank: returns (codes (V, max_len) uint8, lens (V,) int8).

    Rank ``r``'s codeword is ``(k-1)`` continuers followed by one stopper, where
    ``k`` is the code length.  Within the k-byte band, writing
    ``x = r - base_k``:  stopper ``= x % s`` is the last byte and the continuer
    prefix is the base-c representation of ``x // s`` offset by ``s``.
    Vectorized over the whole vocabulary.
    """
    c = 256 - s
    lens = code_lengths(s, vocab_size, max_len)
    codes = np.zeros((vocab_size, max_len), dtype=np.uint8)
    r = np.arange(vocab_size, dtype=np.int64)
    base, width = 0, s
    for k in range(1, max_len + 1):
        sel = lens == k
        if not np.any(sel):
            base, width = base + width, width * c
            continue
        x = r[sel] - base
        codes[sel, k - 1] = (x % s).astype(np.uint8)          # stopper, last byte
        x = x // s
        for lvl in range(k - 2, -1, -1):                       # continuers, right to left
            codes[sel, lvl] = (s + (x % c)).astype(np.uint8)
            x = x // c
        base, width = base + width, width * c
    return codes, lens


def decode_rank(s: int, byteseq: Sequence[int]) -> int:
    """Inverse of :func:`encode_table` for one codeword (host-side scalar)."""
    c = 256 - s
    byteseq = [int(b) for b in byteseq]   # guard numpy uint8 overflow
    k = len(byteseq)
    x = 0
    for b in byteseq[:-1]:
        if not s <= b < 256:
            raise ValueError(f"byte {b} is not a continuer for s={s}")
        x = x * c + (b - s)
    last = byteseq[-1]
    if not 0 <= last < s:
        raise ValueError(f"terminal byte {last} is not a stopper for s={s}")
    x = x * s + int(last)
    base, width = 0, s
    for _ in range(1, k):
        base, width = base + width, width * c
    return base + x


@dataclasses.dataclass(frozen=True)
class SCDCModel:
    """A fitted (s,c)-DC model over a frequency-ranked vocabulary.

    ``rank_of_word`` / ``word_of_rank`` translate between original word ids and
    frequency ranks; codewords are assigned to *ranks*.
    """

    s: int
    c: int
    codes: np.ndarray          # (V, MAX_CODE_LEN) uint8, rank-indexed
    lens: np.ndarray           # (V,) int8, rank-indexed
    rank_of_word: np.ndarray   # (V,) int32: original word id -> frequency rank
    word_of_rank: np.ndarray   # (V,) int32: frequency rank   -> original word id
    freqs: np.ndarray          # (V,) int64, rank-indexed frequencies

    @property
    def vocab_size(self) -> int:
        return len(self.lens)

    def encode_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """Compress a token-id sequence to a flat byte stream (for CR/CT benchmarks)."""
        ranks = self.rank_of_word[tokens]
        lens = self.lens[ranks].astype(np.int64)
        total = int(lens.sum())
        out = np.empty(total, dtype=np.uint8)
        ends = np.cumsum(lens)
        starts = ends - lens
        for k in range(1, MAX_CODE_LEN + 1):
            sel = lens >= k
            out[starts[sel] + (k - 1)] = self.codes[ranks[sel], k - 1]
        return out

    def decode_bytes(self, stream: np.ndarray) -> np.ndarray:
        """Decompress a byte stream back to token ids (vectorized)."""
        stream = np.asarray(stream, dtype=np.uint8)
        is_stop = stream < self.s
        ends = np.flatnonzero(is_stop)
        starts = np.concatenate(([0], ends[:-1] + 1))
        lens = ends - starts + 1
        x = np.zeros(len(ends), dtype=np.int64)
        maxlen = int(lens.max()) if len(lens) else 0
        for off in range(maxlen - 1):                    # accumulate continuers
            sel = lens > off + 1
            x[sel] = x[sel] * self.c + (stream[starts[sel] + off].astype(np.int64) - self.s)
        x = x * self.s + stream[ends].astype(np.int64)
        base, width = 0, self.s
        bases = np.zeros(maxlen + 1, dtype=np.int64)
        for k in range(1, maxlen + 1):
            bases[k] = base
            base, width = base + width, width * self.c
        ranks = bases[lens] + x
        return self.word_of_rank[ranks]


def fit(freqs_by_word: np.ndarray, reserve_first: int | None = 0,
        max_len: int = MAX_CODE_LEN) -> SCDCModel:
    """Fit (s,c)-DC to per-word frequencies.

    ``reserve_first``: word id that must receive frequency rank 0 (the paper
    reserves the first 1-byte codeword for the document separator ``'$'`` so it
    can be found directly in the WTBC root).  Pass ``None`` to disable.
    """
    freqs_by_word = np.asarray(freqs_by_word, dtype=np.int64)
    order = np.argsort(-freqs_by_word, kind="stable").astype(np.int32)
    if reserve_first is not None:
        pos = int(np.flatnonzero(order == reserve_first)[0])
        order = np.concatenate(([reserve_first], np.delete(order, pos))).astype(np.int32)
    rank_of_word = np.empty_like(order)
    rank_of_word[order] = np.arange(len(order), dtype=np.int32)
    freqs_desc = freqs_by_word[order]
    s, c = optimal_sc(freqs_desc, max_len)
    codes, lens = encode_table(s, len(order), max_len)
    return SCDCModel(s=s, c=c, codes=codes, lens=lens,
                     rank_of_word=rank_of_word, word_of_rank=order,
                     freqs=freqs_desc)
