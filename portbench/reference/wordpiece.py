"""A frozen copy of the BERT WordPiece algorithm (plain Python).

Basic tokenisation (lower case, accents stripped, split on whitespace and
punctuation), then greedy longest-match-first WordPiece with ``##``
continuations, a word over 100 characters or with no match becoming the
unknown token; ``[CLS] … [SEP]`` framing, cut to ``max_length`` with the
last slot kept for ``[SEP]``, padded with the pad token.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def split_words(text: str) -> List[str]:
    text = unicodedata.normalize("NFD", text.lower())
    words: List[str] = []
    cur = ""
    for ch in text:
        if unicodedata.category(ch) == "Mn":
            continue
        if ch.isspace():
            if cur:
                words.append(cur)
            cur = ""
        elif _punct(ch):
            if cur:
                words.append(cur)
            words.append(ch)
            cur = ""
        else:
            cur += ch
    if cur:
        words.append(cur)
    return words


class WordPiece:
    def __init__(self, vocab: Sequence[str], unk: str = "[UNK]", cls: str = "[CLS]",
                 sep: str = "[SEP]", pad: str = "[PAD]"):
        self.ids: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        self.unk, self.cls, self.sep, self.pad = (self.ids[t] for t in (unk, cls, sep, pad))

    def pieces(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk]
        out: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            found = None
            while end > start:
                sub = word[start:end] if start == 0 else "##" + word[start:end]
                if sub in self.ids:
                    found = self.ids[sub]
                    break
                end -= 1
            if found is None:
                return [self.unk]
            out.append(found)
            start = end
        return out

    def encode(self, text: str, max_length: int) -> List[int]:
        ids = [self.cls]
        for w in split_words(text):
            ids.extend(self.pieces(w))
        ids.append(self.sep)
        if len(ids) > max_length:
            ids = ids[:max_length - 1] + [self.sep]
        return ids

    def batch(self, texts: Sequence[str], max_length: int) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids, mask), (len(texts), max_length) int64, padded."""
        ids = np.full((len(texts), max_length), self.pad, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, t in enumerate(texts):
            row = self.encode(t, max_length)
            ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
        return ids, mask
