"""The WTBC decode's kernel module (``repro_torch/kernels/wtbc_decode.py``).

On the CPU:

* the plain decode (``decode_at_ref``) against the reference's
  ``repro.core.wtbc.decode_at`` at every root position of a small corpus,
  bitwise, on the default (s,c)-DC and on one with s = 4 stoppers (words of
  1, 2 and 3 bytes, so every level's rank runs), at blocks 64 and 512;
* ``wtbc.decode_at`` and ``extract`` on CPU tensors are the plain version
  with no launch, and the wrapper's argument checks raise.

The tests marked ``cuda`` hold the kernel against the plain version on the
card, bitwise: every position (0 and n - 1 among them), positions whose
level-0 or level-1 ranks land on tile edges (where the nearer-end rank
switches sides), any input shape, and the engine's one ``wtbc_decode``
launch per ``snippets`` call with no ``byte_rank`` launch.  They skip
without a GPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scdc as r_scdc
from repro.core import wtbc as r_wtbc
from repro.text import corpus as r_corpus
from repro_torch.core import wtbc
from repro_torch.engine import EngineConfig, SearchEngine
from repro_torch.kernels import backend, wtbc_decode

torch.set_num_threads(1)

_BUILDS = {}


def indexes(coding: str, block: int, device: str = "cpu"):
    """(reference index or None, port index) over one small corpus, coded
    by its fitted (s,c)-DC ("fit") or with s = 4 stoppers ("s4": words of
    1, 2 and 3 bytes).  The reference index is built on the CPU only.
    Memoized."""
    key = (coding, block, device)
    if key not in _BUILDS:
        cp = r_corpus.make_corpus(n_docs=200, mean_doc_len=50,
                                  vocab_size=3000, seed=11)
        flat = np.concatenate(cp.doc_tokens)
        model = r_scdc.fit(np.bincount(np.concatenate(
            [flat, np.zeros(cp.n_docs, np.int64)]), minlength=cp.vocab_size))
        if coding == "s4":
            codes, lens = r_scdc.encode_table(4, model.vocab_size)
            model = dataclasses.replace(model, s=4, c=252, codes=codes,
                                        lens=lens)
        ridx = r_wtbc.build_index_with_model(cp.doc_tokens, model,
                                             block=block) \
            if device == "cpu" else None
        pidx = wtbc.build_index_with_model(cp.doc_tokens, model, block=block,
                                           device=device)
        _BUILDS[key] = (ridx, pidx)
    return _BUILDS[key]


@pytest.mark.parametrize("coding,block", [("fit", 512), ("s4", 64),
                                          ("s4", 512)])
def test_decode_at_ref_matches_reference_everywhere(coding, block):
    ridx, pidx = indexes(coding, block)
    pos = np.arange(pidx.n, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda p: r_wtbc.decode_at(
        ridx, p)))(jnp.asarray(pos)))
    got = wtbc_decode.decode_at_ref(pidx, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    if coding == "s4":
        assert set(pidx.cw_len[torch.from_numpy(want).long()].tolist()) \
            == {1, 2, 3}


def test_decode_at_on_cpu_is_the_plain_version():
    _, pidx = indexes("s4", 64)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.integers(0, pidx.n, (7, 5)).astype(np.int32))
    before = backend.launch_counts()
    got = wtbc.decode_at(pidx, pos)
    lo = torch.tensor([0, 5, pidx.n - 3], dtype=torch.int32)
    ext = wtbc.extract(pidx, lo, 3)
    assert backend.launch_counts() == before
    assert got.shape == (7, 5) and got.dtype == torch.int32
    assert torch.equal(got, wtbc_decode.decode_at_ref(pidx, pos))
    assert torch.equal(ext, wtbc_decode.decode_at_ref(
        pidx, lo[:, None] + torch.arange(3, dtype=torch.int32)))


def test_wtbc_decode_argument_checks_raise():
    _, pidx = indexes("s4", 64)
    pos = torch.arange(10, dtype=torch.int32)
    args = wtbc_decode.launch_args(pidx, pos)
    assert args[-2:] == (pidx.s, pidx.c) and len(args) == 13 + 3 + 2
    bad_off = dataclasses.replace(
        pidx, offsets=(pidx.offsets[0], pidx.offsets[1].long(),
                       pidx.offsets[2]))
    short = dataclasses.replace(
        pidx, offsets=(pidx.offsets[0], pidx.offsets[1][:-1],
                       pidx.offsets[2]))
    bad_block = dataclasses.replace(pidx, levels=tuple(
        dataclasses.replace(lv, block=40) for lv in pidx.levels))
    for idx, p, match in (
            (pidx, pos.long(), "positions must be contiguous int32"),
            (pidx, pos.reshape(2, 5).t(), "positions must be contiguous"),
            (bad_off, pos, "offsets of level 1"),
            (short, pos, "offsets of level 1"),
            (bad_block, pos, "not a multiple of 16")):
        with pytest.raises(ValueError, match=match):
            wtbc_decode.launch_args(idx, p)


# ---------------------------------------------------------------------------
# on the card (skip elsewhere)
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the kernels run only there")


def edge_positions(idx) -> np.ndarray:
    """Root positions whose rank positions at level 0 and level 1 lie on a
    tile edge or one either side of it, with 0 and n - 1."""
    out = [0, idx.n - 1]
    for L in (0, 1):
        lv = idx.levels[L]
        edges = np.arange(0, lv.length + 1, lv.block)
        near = np.unique(np.clip(np.concatenate([edges - 1, edges,
                                                 edges + 1]), 0,
                                 max(lv.length - 1, 0)))
        if L == 0:
            out += near.tolist()
            continue
        # a level-1 position is reached from the root position of the
        # occurrence of its level-0 byte that maps there: brute force
        root = idx.levels[0].data.cpu().numpy()[:idx.levels[0].length]
        s = idx.s
        first = np.flatnonzero(root >= s)
        order = np.argsort(root[first], kind="stable")
        out += first[order][near[near < len(first)]].tolist()
    return np.unique(np.clip(out, 0, idx.n - 1)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("coding,block", [("fit", 4096), ("s4", 64),
                                          ("s4", 512)])
def test_wtbc_decode_kernel_matches_plain_on_card(coding, block):
    _need_card()
    _, idx = indexes(coding, block, "cuda")
    every = torch.arange(idx.n, dtype=torch.int32, device="cuda")
    edges = torch.from_numpy(edge_positions(idx)).cuda()
    for pos in (every, edges, every[:37].reshape(37, 1),
                every[idx.n - 12:].reshape(3, 4)):
        before = backend.launch_counts()
        got = wtbc.decode_at(idx, pos)
        after = backend.launch_counts()
        assert {n: after[n] - before[n] for n in after} == {
            n: int(n == "wtbc_decode") for n in after}
        want = wtbc.decode_at(idx, pos, kernel_backend="ref")
        torch.cuda.synchronize()
        assert got.shape == pos.shape and torch.equal(got, want)


@pytest.mark.cuda
def test_engine_snippets_are_one_launch_on_card():
    _need_card()
    cp = r_corpus.make_corpus(n_docs=300, mean_doc_len=60, vocab_size=800,
                              seed=21)
    eng = SearchEngine.build(cp, EngineConfig(block=512), device="cuda")
    res = eng.search([[1, 2, 3], [4, 5, 6]], k=6, mode="or", strategy="drb",
                     measure="bm25")
    before = backend.launch_counts()
    sn = eng.snippets(res, length=8)
    after = backend.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "wtbc_decode") for n in after}
    for b in range(len(res)):
        for (d, _), toks in zip(res.hits(b), sn[b]):
            np.testing.assert_array_equal(toks, cp.doc_tokens[d][:8])
