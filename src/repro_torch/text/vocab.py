"""Vocabulary: word <-> id mapping with frequencies (id 0 = '$' separator).

The port's own copy of ``repro.text.vocab`` (numpy only): the same documents
give the same words, ids and int64 frequencies."""
from __future__ import annotations

import dataclasses

import numpy as np

SEPARATOR = "$"


@dataclasses.dataclass
class Vocabulary:
    words: list[str]               # id -> word; words[0] == '$'
    ids: dict[str, int]            # word -> id
    freqs: np.ndarray              # (V,) int64 occurrence counts (incl. '$')

    @property
    def size(self) -> int:
        return len(self.words)

    def id_of(self, word: str) -> int:
        return self.ids[word]

    @classmethod
    def from_documents(cls, docs: list[list[str]]) -> "Vocabulary":
        ids: dict[str, int] = {SEPARATOR: 0}
        words = [SEPARATOR]
        counts = [0]
        for doc in docs:
            for w in doc:
                i = ids.get(w)
                if i is None:
                    i = len(words)
                    ids[w] = i
                    words.append(w)
                    counts.append(0)
                counts[i] += 1
            counts[0] += 1  # one '$' per document
        return cls(words=words, ids=ids, freqs=np.asarray(counts, dtype=np.int64))

    def encode_docs(self, docs: list[list[str]]) -> list[np.ndarray]:
        return [np.asarray([self.ids[w] for w in doc], dtype=np.int64) for doc in docs]
