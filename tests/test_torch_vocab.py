"""``repro_torch.text.vocab`` against ``repro.text.vocab``, and the port's
quickstart (``examples/torch_quickstart.py``) against the reference's
(``examples/quickstart.py``) on the CPU: the same lines printed."""
import contextlib
import io
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.text import corpus as rcorpus
from repro.text import vocab as rvocab
from repro_torch.text import vocab as pvocab

ROOT = Path(__file__).resolve().parents[1]


def _docs(seed: int, n_docs: int, vocab: int) -> list[list[str]]:
    c = rcorpus.make_corpus(n_docs=n_docs, mean_doc_len=20, vocab_size=vocab,
                            seed=seed)
    return [[f"w{int(t)}" for t in d] for d in c.doc_tokens]


QUICK = runpy.run_path(str(ROOT / "examples" / "torch_quickstart.py"),
                       run_name="torch_quickstart")


@pytest.mark.parametrize("docs", [
    QUICK["DOCS"], [], [[]], [["a", "b", "a"], [], ["b", "$x", "c"]],
    _docs(1, 40, 300), _docs(2, 200, 5000)],
    ids=["quickstart", "no-docs", "empty-doc", "small", "corpus-40",
         "corpus-200"])
def test_vocabulary_matches_reference(docs):
    want = rvocab.Vocabulary.from_documents(docs)
    got = pvocab.Vocabulary.from_documents(docs)
    assert got.words == want.words and got.words[0] == pvocab.SEPARATOR == "$"
    assert got.ids == want.ids
    assert got.freqs.dtype == want.freqs.dtype == np.int64
    assert np.array_equal(got.freqs, want.freqs)
    assert got.size == want.size
    assert got.freqs[0] == len(docs)            # one '$' per document
    for w in got.words[:50]:
        assert got.id_of(w) == want.id_of(w)
    enc_g, enc_w = got.encode_docs(docs), want.encode_docs(docs)
    assert len(enc_g) == len(enc_w)
    for a, b in zip(enc_g, enc_w):
        assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)


def test_unknown_word_raises_like_the_reference():
    docs = [["x", "y"]]
    for mod in (rvocab, pvocab):
        v = mod.Vocabulary.from_documents(docs)
        with pytest.raises(KeyError):
            v.id_of("z")
        with pytest.raises(KeyError):
            v.encode_docs([["z"]])


def _stdout(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def test_torch_quickstart_prints_the_reference_quickstarts_answers():
    ref = runpy.run_path(str(ROOT / "examples" / "quickstart.py"),
                         run_name="quickstart")
    want = _stdout(ref["main"])
    got = _stdout(lambda: QUICK["main"](["--device", "cpu"]))
    assert got == want
    assert "doc 5 (bm25" in got and "snippet" in got


def test_torch_quickstart_run_returns_the_answers():
    out = QUICK["run"]("cpu")
    assert [d for d, _ in out["dr_and"]] == [0, 3, 5]
    assert [d for d, _ in out["drb_or_bm25"]] == [5, 4, 0]
    assert out["snippets"][0] == "wavelet trees support ranked retrieval".split()
    assert out["space"]["total"] > 0


def test_torch_quickstart_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QUICK["run"]()
