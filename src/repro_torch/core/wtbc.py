"""Wavelet Tree on Bytecodes (WTBC) — level-concatenated, array-native layout.

The paper's WTBC places the i-th bytes of each (s,c)-DC codeword in tree nodes:
the root holds every codeword's first byte in text order; the child ``B_b`` of
the root holds the second byte of every codeword starting with continuer ``b``;
and so on.  Count is a ``rank`` difference at the word's leaf node.

Layout (the reference's, unchanged): one contiguous byte array per level; a
node is the slice ``[offset, offset+len)`` given by a dense per-level offset
table indexed by the codeword's continuer prefix.  Per word, ``node_off[w, L]``
(absolute offset of the node word ``w`` traverses at level ``L``) and
``base_rank[w, L]`` (rank of ``w``'s level-L byte at that node's start) are
precomputed, so a count is two ranks per level.

The document separator '$' is word-rank 0: its codeword is the single stopper
byte 0 in the root.  Separator positions are kept in a sorted ``sep_pos``
array (the paper's footnote-2 fast select), making document extents O(1).

The build is the reference's numpy host build; the index is a frozen
dataclass of tensors on one device plus host integers for scalars.
``locate``, ``decode_at`` and ``extract`` are batched over many positions
(a whole locate is one ``wtbc_locate`` launch on the card, a whole decode
one ``wtbc_decode`` launch).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bytemap, scdc
from repro_torch.core.bytemap import ByteMap
from repro_torch.kernels import backend, ops, wtbc_decode, wtbc_locate

MAX_LEVELS = scdc.MAX_CODE_LEN  # 3
SEP_RANK = 0                    # '$' is frequency-rank 0 by construction


@dataclasses.dataclass(frozen=True)
class WTBCIndex:
    """The full index: tensors on one device + host-integer scalars."""

    levels: tuple[ByteMap, ...]        # MAX_LEVELS ByteMaps (possibly empty)
    offsets: tuple[torch.Tensor, ...]  # per-level dense node offset tables
    cw: torch.Tensor                   # (V, MAX_LEVELS) uint8 codeword bytes
    cw_len: torch.Tensor               # (V,) int32
    node_off: torch.Tensor             # (V, MAX_LEVELS) int32
    base_rank: torch.Tensor            # (V, MAX_LEVELS) int32
    sep_pos: torch.Tensor              # (n_docs,) int32 separator positions in root
    df: torch.Tensor                   # (V,) int32 document frequency per word-rank
    occ: torch.Tensor                  # (V,) int32 total occurrences per word-rank
    doc_len: torch.Tensor              # (n_docs,) int32 tokens per doc (sans '$')
    n: int                             # total tokens (incl. separators)
    n_docs: int
    s: int                             # stoppers
    c: int                             # continuers

    @property
    def vocab_size(self) -> int:
        return self.cw.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cw.device


# ---------------------------------------------------------------------------
# build (host side, numpy)
# ---------------------------------------------------------------------------

def _flatten(doc_tokens: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Token ids of all documents, each followed by the separator 0."""
    n_docs = len(doc_tokens)
    doc_len = np.array([len(d) for d in doc_tokens], dtype=np.int64)
    flat = np.empty(int(doc_len.sum()) + n_docs, dtype=np.int64)
    pos = 0
    for d in doc_tokens:
        flat[pos:pos + len(d)] = d
        flat[pos + len(d)] = 0                      # '$'
        pos += len(d) + 1
    return flat, doc_len


def build_index(doc_tokens: list[np.ndarray], vocab_size: int,
                block: int = bytemap.DEFAULT_BLOCK,
                device: torch.device | str | None = None
                ) -> tuple[WTBCIndex, scdc.SCDCModel]:
    """Build the WTBC for a document collection.

    ``doc_tokens``: one int array of word ids per document, word id 0 reserved
    for the separator '$'.  Returns the index (query ids are *frequency
    ranks*) and the fitted (s,c)-DC model.  ``device`` defaults to the card
    (raising when none is present); pass "cpu" for the plain path.
    """
    device = backend.resolve_device(device)
    flat, doc_len = _flatten(doc_tokens)
    freqs = np.bincount(flat, minlength=vocab_size)
    model = scdc.fit(freqs, reserve_first=0)
    ranks = model.rank_of_word[flat]
    return _build_from_ranks(ranks, model, doc_len, block, device), model


def build_index_with_model(doc_tokens: list[np.ndarray], model: scdc.SCDCModel,
                           block: int = bytemap.DEFAULT_BLOCK,
                           device: torch.device | str | None = None
                           ) -> WTBCIndex:
    """Build an index reusing an already-fitted (s,c)-DC model (so codewords
    agree with another index built from the same model); on the card unless
    ``device`` says otherwise."""
    device = backend.resolve_device(device)
    flat, doc_len = _flatten(doc_tokens)
    ranks = model.rank_of_word[flat]
    return _build_from_ranks(ranks, model, doc_len, block, device)


def _build_from_ranks(ranks: np.ndarray, model: scdc.SCDCModel,
                      doc_len: np.ndarray, block: int,
                      device) -> WTBCIndex:
    s, c = model.s, model.c
    V = model.vocab_size
    codes, lens = model.codes, model.lens
    tok_codes = codes[ranks]                         # (n, 3) uint8
    tok_lens = lens[ranks]                           # (n,)
    n = len(ranks)

    levels: list[tuple[np.ndarray, np.ndarray, int]] = []
    offset_tables: list[np.ndarray] = []
    keys = np.zeros(n, dtype=np.int64)               # continuer-prefix node key
    for L in range(MAX_LEVELS):
        if L == 0:
            offset_tables.append(np.array([0, n], dtype=np.int64))
            levels.append(bytemap.build_np(tok_codes[:, 0], block))
            continue
        # key at level L extends the key by the continuer byte at level L-1
        alive_prev = tok_lens > (L - 1)
        keys[alive_prev] = keys[alive_prev] * c + (
            tok_codes[alive_prev, L - 1].astype(np.int64) - s)
        sel = np.flatnonzero(tok_lens > L)
        nspace = c ** L
        if len(sel) == 0:
            offset_tables.append(np.zeros(nspace + 1, dtype=np.int64))
            levels.append(bytemap.build_np(np.zeros(0, dtype=np.uint8), block))
            continue
        keys_sel = keys[sel]
        order = np.argsort(keys_sel, kind="stable")  # group by node, keep text order
        data = tok_codes[sel[order], L]
        sizes = np.bincount(keys_sel, minlength=nspace)
        offs = np.zeros(nspace + 1, dtype=np.int64)
        np.cumsum(sizes, out=offs[1:])
        offset_tables.append(offs)
        levels.append(bytemap.build_np(data, block))

    # --- per-word node paths -------------------------------------------------
    node_off = np.zeros((V, MAX_LEVELS), dtype=np.int64)
    prefix = np.zeros(V, dtype=np.int64)
    for L in range(1, MAX_LEVELS):
        has = lens > L
        prefix[has] = prefix[has] * c + (codes[has, L - 1].astype(np.int64) - s)
        node_off[has, L] = offset_tables[L][prefix[has]]

    # base ranks: rank of cw[w, L] at node_off[w, L] within level L
    base_rank = np.zeros((V, MAX_LEVELS), dtype=np.int64)
    for L in range(MAX_LEVELS):
        padded, _, length = levels[L]
        level_data = padded[:length]
        order = np.argsort(level_data, kind="stable")
        sorted_vals = level_data[order]
        w = np.flatnonzero(lens > L)
        if len(w) == 0 or len(level_data) == 0:
            continue
        b = codes[w, L]
        base_rank_w = np.empty(len(w), dtype=np.int64)
        for bv in np.unique(b):
            sel = b == bv
            lo = np.searchsorted(sorted_vals, bv, side="left")
            hi = np.searchsorted(sorted_vals, bv, side="right")
            occ_positions = np.sort(order[lo:hi])
            base_rank_w[sel] = np.searchsorted(occ_positions, node_off[w[sel], L])
        base_rank[w, L] = base_rank_w

    root = levels[0][0][:n]
    sep_pos = np.flatnonzero(root == codes[SEP_RANK, 0]).astype(np.int64)
    if len(sep_pos) != len(doc_len):
        raise ValueError("separator count must equal n_docs")

    n_docs = len(doc_len)
    doc_ids = np.repeat(np.arange(n_docs, dtype=np.int64), (doc_len + 1).astype(np.int64))
    occ = np.bincount(ranks, minlength=V).astype(np.int64)
    pair = ranks.astype(np.int64) * n_docs + doc_ids
    uniq_words = np.unique(pair) // n_docs
    df = np.bincount(uniq_words, minlength=V).astype(np.int64)

    def i32(a):
        if np.max(a, initial=0) >= 2**31:
            raise ValueError("index positions must stay below 2**31")
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return WTBCIndex(
        levels=tuple(ByteMap(data=torch.from_numpy(d).to(device),
                             counts=torch.from_numpy(cnt).to(device),
                             length=ln, block=block) for d, cnt, ln in levels),
        offsets=tuple(i32(t) for t in offset_tables),
        cw=torch.from_numpy(np.ascontiguousarray(codes)).to(device),
        cw_len=i32(lens.astype(np.int64)),
        node_off=i32(node_off),
        base_rank=i32(base_rank),
        sep_pos=i32(sep_pos),
        df=i32(df),
        occ=i32(occ),
        doc_len=i32(doc_len),
        n=int(n),
        n_docs=int(n_docs),
        s=int(s),
        c=int(c),
    )


# ---------------------------------------------------------------------------
# document geometry ('$' fast path — paper footnote 2)
# ---------------------------------------------------------------------------

def doc_start(idx: WTBCIndex, d: torch.Tensor) -> torch.Tensor:
    """First root position of document d (0-based).  Out-of-range ids are
    clamped into the table, so masked lanes stay in bounds."""
    prev = idx.sep_pos[(d - 1).clamp(0, idx.n_docs - 1).long()]
    return torch.where(d == 0, 0, prev + 1).to(torch.int32)


def doc_end(idx: WTBCIndex, d: torch.Tensor) -> torch.Tensor:
    """One past the last content position of doc d (its separator position)."""
    return idx.sep_pos[d.clamp(0, idx.n_docs - 1).long()]


def segment_extent(idx: WTBCIndex, d0: torch.Tensor, d1: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Root range [lo, hi) covering documents [d0, d1)."""
    lo = doc_start(idx, d0)
    hi = torch.where(d1 >= idx.n_docs, idx.n, doc_start(idx, d1)).to(torch.int32)
    return lo, hi


def doc_of_pos(idx: WTBCIndex, pos: torch.Tensor) -> torch.Tensor:
    """Document containing root position pos ( = rank_$(T, pos) )."""
    return torch.searchsorted(idx.sep_pos, pos.to(torch.int32),
                              side="left").to(torch.int32)


# ---------------------------------------------------------------------------
# count
# ---------------------------------------------------------------------------

def count_range_batch(idx: WTBCIndex, words: torch.Tensor, los: torch.Tensor,
                      his: torch.Tensor, *, kernel_backend: str = "auto"
                      ) -> torch.Tensor:
    """Occurrences of ``words[i]`` in root range ``[los[i], his[i])`` for a
    flat batch of M triples; (M,) int32.  The search cores' rank entry point:
    the whole (M x levels x 2) rank workload goes down in one call — the
    ``wavelet_count`` kernel on the card, the plain batched descent on the
    CPU (``kernels/ops.py``)."""
    return ops.wavelet_count_batch(idx.levels, idx.cw, idx.cw_len,
                                   idx.node_off, idx.base_rank, words, los,
                                   his, kernel_backend=kernel_backend)


def count_range(idx: WTBCIndex, w: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, *, kernel_backend: str = "auto"
                ) -> torch.Tensor:
    """Occurrences of word-rank ``w`` in root range [lo, hi), elementwise
    over broadcast inputs."""
    w, lo, hi = torch.broadcast_tensors(torch.as_tensor(w, device=idx.device),
                                        torch.as_tensor(lo, device=idx.device),
                                        torch.as_tensor(hi, device=idx.device))
    out = count_range_batch(idx, w.reshape(-1), lo.reshape(-1), hi.reshape(-1),
                            kernel_backend=kernel_backend)
    return out.reshape(w.shape)


def count_doc(idx: WTBCIndex, w: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """tf of word-rank w in document d."""
    lo, hi = segment_extent(idx, d, d + 1)
    return count_range(idx, w, lo, hi)


# ---------------------------------------------------------------------------
# locate / decode (paper §2.2)
# ---------------------------------------------------------------------------

def locate(idx: WTBCIndex, w: torch.Tensor, j: torch.Tensor, *,
           kernel_backend: str = "auto") -> torch.Tensor:
    """Root position of the ``j[i]``-th (1-based) occurrence of word-rank
    ``w[i]``; same-shape int32.

    Walks leaf -> root with one select per level.  Out-of-range ``j`` is
    not checked (as in the reference): each level's select saturates to its
    stream length, so callers that cannot guarantee ``1 <= j <= occ[w]``
    validate ``j`` themselves.  On the card every lane runs every level in
    one ``wtbc_locate`` launch; on the CPU, or with
    ``kernel_backend="ref"``, the plain batched walk runs
    (``kernels/wtbc_locate.py``)."""
    return wtbc_locate.wtbc_locate(idx, w, j, kernel_backend=kernel_backend)


def decode_at(idx: WTBCIndex, pos: torch.Tensor, *,
              kernel_backend: str = "auto") -> torch.Tensor:
    """Word-rank at root position ``pos[i]``; same-shape int32.

    Descends with one access and two ranks per level, reconstructing the
    (s,c)-DC rank arithmetically from the byte path.  On the card every
    position runs every level in one ``wtbc_decode`` launch, stopping at
    its word's last byte; on the CPU, or with ``kernel_backend="ref"``, the
    plain batched descent runs (``kernels/wtbc_decode.py``)."""
    return wtbc_decode.wtbc_decode(idx, pos, kernel_backend=kernel_backend)


def extract(idx: WTBCIndex, lo: torch.Tensor, length: int, *,
            kernel_backend: str = "auto") -> torch.Tensor:
    """The ``length`` consecutive word-ranks starting at root position
    ``lo`` (any shape; the result gains a trailing ``length`` axis) — one
    batched ``decode_at``."""
    lo = torch.as_tensor(lo, device=idx.device).to(torch.int32)
    offs = torch.arange(length, dtype=torch.int32, device=idx.device)
    return decode_at(idx, lo[..., None] + offs, kernel_backend=kernel_backend)


def decode_all_np(idx: WTBCIndex, model: scdc.SCDCModel) -> np.ndarray:
    """Reconstruct the full token stream (frequency ranks) on the host from
    the level arrays by inverting the stable grouping — the sequential
    decompression behind the paper's Table-1 'DT' measurement."""
    s, c = idx.s, idx.c
    root = idx.levels[0].data.cpu().numpy()[:idx.levels[0].length]
    n = len(root)
    x = np.zeros(n, dtype=np.int64)
    lens = np.ones(n, dtype=np.int64)
    bytes_L = root.astype(np.int64)
    alive = np.arange(n)
    prefix = np.zeros(n, dtype=np.int64)
    for L in range(MAX_LEVELS):
        if L > 0:
            level = idx.levels[L].data.cpu().numpy()[:idx.levels[L].length]
            # tokens alive at this level, grouped by node key in text order
            order = np.argsort(prefix[alive], kind="stable")
            bytes_for = np.empty(len(alive), dtype=np.int64)
            bytes_for[order] = level[:len(alive)]
            bytes_L = bytes_for
            lens[alive] += 1
        cont = bytes_L >= s
        x[alive] = x[alive] * np.where(cont, c, s) + np.where(
            cont, bytes_L - s, bytes_L)
        prefix_new = prefix[alive] * c + (bytes_L - s)
        keep = alive[cont]
        prefix_next = np.zeros(n, dtype=np.int64)
        prefix_next[keep] = prefix_new[cont]
        prefix = prefix_next
        alive = keep
        if len(alive) == 0:
            break
    bases = np.zeros(MAX_LEVELS + 1, dtype=np.int64)
    base, width = 0, s
    for k in range(1, MAX_LEVELS + 1):
        bases[k] = base
        base, width = base + width, width * c
    return bases[lens] + x


def space_report(idx: WTBCIndex) -> dict[str, int]:
    """Bytes per component of the index as it lies on its device."""
    def nbytes(t):
        return t.numel() * t.element_size()
    report = {
        "level_bytes": sum(lv.length for lv in idx.levels),
        "rank_counters": sum(nbytes(lv.counts) for lv in idx.levels),
        "node_offsets": sum(nbytes(o) for o in idx.offsets),
        "codeword_tables": nbytes(idx.cw) + nbytes(idx.cw_len)
                           + nbytes(idx.node_off) + nbytes(idx.base_rank),
        "sep_positions": nbytes(idx.sep_pos),
        "df_occ_doclen": nbytes(idx.df) + nbytes(idx.occ) + nbytes(idx.doc_len),
    }
    report["total"] = sum(report.values())
    return report
