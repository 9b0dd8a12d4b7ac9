"""The port's counter -> batch pipelines (``repro_torch.data.pipeline``)
against ``repro.data.pipeline`` on the CPU.

``lm_batch`` and ``recsys_batch`` draw from a seeded ``torch.Generator``:
the port cannot reproduce JAX's threefry values, so they are held to the
reference's contract instead — determinism in (seed, step), shapes, dtypes
and ranges, and the squared-uniform skew toward low token ids.
``random_graph`` and ``molecule_batch`` draw with numpy on both sides and
are compared bitwise.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as R
from repro.models.recsys import RecsysConfig as RConfig
from repro_torch.data import pipeline as P
from repro_torch.models.recsys import RecsysConfig as PConfig

DOT = dict(name="x", interaction="dot", n_sparse=4, n_dense=3, embed_dim=8,
           table_rows=(100, 200, 50, 1000))
SASREC = dict(name="s", interaction="self-attn-seq", embed_dim=8,
              seq_len=12, n_items=300)
FM = dict(name="f", interaction="fm", n_sparse=5, embed_dim=4,
          table_rows=(7, 600, 513, 30, 2))


def test_lm_batch_deterministic_and_bounded():
    a = P.lm_batch(0, 7, 4, 16, 1000, device="cpu")
    b = P.lm_batch(0, 7, 4, 16, 1000, device="cpu")
    c = P.lm_batch(0, 8, 4, 16, 1000, device="cpu")
    d = P.lm_batch(1, 7, 4, 16, 1000, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert int(a["tokens"].max()) < 1000 and int(a["tokens"].min()) >= 0
    ref = R.lm_batch(0, 7, 4, 16, 1000)
    for k in ("tokens", "labels"):
        assert a[k].dtype == torch.int32
        assert tuple(a[k].shape) == np.asarray(ref[k]).shape
        assert np.asarray(ref[k]).dtype == np.int32


def test_lm_batch_labels_are_the_next_tokens_and_skewed():
    b = P.lm_batch(3, 0, 8, 4096, 50_000, device="cpu")
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    toks = b["tokens"].numpy().ravel()
    ref = np.asarray(R.lm_batch(3, 0, 8, 4096, 50_000)["tokens"]).ravel()
    # ids floor(u^2 (V - 1)): P(id < V/4) = 1/2 on both sides
    for t in (toks, ref):
        assert abs(float((t < 12_500).mean()) - 0.5) < 0.02
        assert t.max() < 49_999


@pytest.mark.parametrize("kw", [DOT, FM], ids=["dot", "fm"])
def test_recsys_batch_bounds(kw):
    pc, rc = PConfig(**kw), RConfig(**kw)
    b = P.recsys_batch(0, 3, 512, pc, device="cpu")
    ref = R.recsys_batch(0, 3, 512, rc)
    assert set(b) == set(ref)
    rows = pc.rows()
    assert rows == rc.rows()
    sp = b["sparse"].numpy()
    for f in range(pc.n_sparse):
        assert 0 <= sp[:, f].min() and sp[:, f].max() < rows[f]
    # ids cover their range, not only the unpadded rows
    assert sp[:, 0].max() >= kw["table_rows"][0]
    for k, v in b.items():
        assert tuple(v.shape) == np.asarray(ref[k]).shape, k
        assert str(v.dtype).split(".")[-1] == str(np.asarray(ref[k]).dtype), k
    assert set(np.unique(b["label"].numpy())) <= {0, 1}
    assert 0.15 < float(b["label"].float().mean()) < 0.35
    again = P.recsys_batch(0, 3, 512, pc, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b["sparse"],
                           P.recsys_batch(0, 4, 512, pc, device="cpu")["sparse"])


def test_sasrec_batch_shift_and_range():
    pc, rc = PConfig(**SASREC), RConfig(**SASREC)
    b = P.recsys_batch(5, 1, 64, pc, device="cpu")
    ref = R.recsys_batch(5, 1, 64, rc)
    assert set(b) == set(ref) == {"seq", "pos", "neg"}
    for k in b:
        assert b[k].dtype == torch.int32
        assert tuple(b[k].shape) == np.asarray(ref[k]).shape == (64, 12)
        assert int(b[k].min()) >= 1 and int(b[k].max()) < 300
    assert torch.equal(b["pos"][:, :-1], b["seq"][:, 1:])
    again = P.recsys_batch(5, 1, 64, pc, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)


@pytest.mark.parametrize("n,e,pn,pe", [(90, 400, 96, 448), (512, 2048, None,
                                                             None)])
def test_random_graph_bitwise(n, e, pn, pe):
    got = P.random_graph(11, n, e, 8, 5, pad_nodes=pn, pad_edges=pe,
                         device="cpu")
    want = R.random_graph(11, n, e, 8, 5, pad_nodes=pn, pad_edges=pe)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w)


def test_molecule_batch_bitwise():
    got = P.molecule_batch(2, n_graphs=16, nodes_per=7, edges_per=12,
                           d_feat=5, n_classes=3, device="cpu")
    want = R.molecule_batch(2, n_graphs=16, nodes_per=7, edges_per=12,
                            d_feat=5, n_classes=3)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w)


def test_batches_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.lm_batch(0, 0, 1, 4, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.molecule_batch(0, 2, 3, 4, 5, 2)
