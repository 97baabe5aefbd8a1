"""Host-side tokenizers — a copy of ``qst_tpu/models/tokenizer.py``.

Numpy and the standard library only. ``WordPieceTokenizer`` and
``HashTokenizer`` are copied as they are; ``tests/test_torch_ops.py`` holds
them to their source on the same texts. ``load_tokenizer`` picks the native
C++ WordPiece batch tokenizer (``qst_tpu_torch/native``, the port's copy of
``qst_tpu/native``) where g++ builds it, as the source does, and the
byte-level BPE tokenizer (``models/bpe_tokenizer.py``) for a ``.json``
vocabulary.
"""

from __future__ import annotations

import hashlib
import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """Whitespace + punctuation splitting with optional lowercasing and
    accent stripping (BERT basic tokenizer behavior)."""
    if lowercase:
        text = text.lower()
        text = unicodedata.normalize("NFD", text)
        text = "".join(ch for ch in text if unicodedata.category(ch) != "Mn")
    tokens: List[str] = []
    current: List[str] = []
    for ch in text:
        if ch.isspace():
            if current:
                tokens.append("".join(current))
                current = []
        elif _is_punctuation(ch):
            if current:
                tokens.append("".join(current))
                current = []
            tokens.append(ch)
        else:
            current.append(ch)
    if current:
        tokens.append("".join(current))
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT vocab."""

    def __init__(
        self,
        vocab: Dict[str, int],
        lowercase: bool = True,
        unk_token: str = "[UNK]",
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
        mask_token: str = "[MASK]",
        max_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.unk_id = vocab[unk_token]
        self.mask_id = vocab.get(mask_token, self.unk_id)
        self.max_chars_per_word = max_chars_per_word

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: int = 128) -> Tuple[List[int], List[int], List[int]]:
        """→ (ids, mask, token_type_ids), unpadded, with [CLS]/[SEP] framing."""
        ids = [self.cls_id]
        types = [0]
        for tok in self.tokenize(text):
            ids.append(self.vocab.get(tok, self.unk_id))
            types.append(0)
        ids.append(self.sep_id)
        types.append(0)
        if text_pair is not None:
            for tok in self.tokenize(text_pair):
                ids.append(self.vocab.get(tok, self.unk_id))
                types.append(1)
            ids.append(self.sep_id)
            types.append(1)
        if len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
            types = types[:max_length]
        return ids, [1] * len(ids), types

    def batch_encode(
        self, texts: Sequence[str], max_length: int = 128,
        text_pairs: Optional[Sequence[str]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(texts)
        ids_arr = np.full((n, max_length), self.pad_id, np.int32)
        mask_arr = np.zeros((n, max_length), np.int32)
        for i, text in enumerate(texts):
            pair = text_pairs[i] if text_pairs is not None else None
            ids, mask, _ = self.encode(text, pair, max_length)
            ids_arr[i, : len(ids)] = ids
            mask_arr[i, : len(mask)] = mask
        return ids_arr, mask_arr

    def batch_encode_pairs(
        self, pairs: Sequence[Tuple[str, str]], max_length: int = 128,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = len(pairs)
        ids_arr = np.full((n, max_length), self.pad_id, np.int32)
        mask_arr = np.zeros((n, max_length), np.int32)
        type_arr = np.zeros((n, max_length), np.int32)
        for i, (a, b) in enumerate(pairs):
            ids, mask, types = self.encode(a, b, max_length)
            ids_arr[i, : len(ids)] = ids
            mask_arr[i, : len(mask)] = mask
            type_arr[i, : len(types)] = types
        return ids_arr, mask_arr, type_arr


class HashTokenizer:
    """Deterministic mock tokenizer: word → stable id in [n_special, vocab).

    Mirrors the reference's fake-backend test pattern; lets every pipeline
    (datasets, mining, IR eval) run hermetically. Same word → same id, so a
    hash-embedding encoder over these ids is a deterministic mock embedder.
    """

    def __init__(self, vocab_size: int = 512, lowercase: bool = True):
        if vocab_size < 8:
            raise ValueError("vocab_size must be >= 8")
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_id, self.cls_id, self.sep_id, self.unk_id, self.mask_id = 0, 1, 2, 3, 4
        self._n_special = 5

    def _word_id(self, word: str) -> int:
        h = hashlib.md5(word.encode("utf-8")).digest()
        return self._n_special + int.from_bytes(h[:4], "little") % (
            self.vocab_size - self._n_special
        )

    def tokenize(self, text: str) -> List[str]:
        return basic_tokenize(text, self.lowercase)

    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: int = 128):
        ids = [self.cls_id] + [self._word_id(w) for w in self.tokenize(text)]
        ids.append(self.sep_id)
        types = [0] * len(ids)
        if text_pair is not None:
            pair_ids = [self._word_id(w) for w in self.tokenize(text_pair)] + [self.sep_id]
            ids.extend(pair_ids)
            types.extend([1] * len(pair_ids))
        if len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
            types = types[:max_length]
        return ids, [1] * len(ids), types

    def batch_encode(self, texts: Sequence[str], max_length: int = 128,
                     text_pairs=None) -> Tuple[np.ndarray, np.ndarray]:
        n = len(texts)
        ids_arr = np.full((n, max_length), self.pad_id, np.int32)
        mask_arr = np.zeros((n, max_length), np.int32)
        for i, text in enumerate(texts):
            pair = text_pairs[i] if text_pairs is not None else None
            ids, mask, _ = self.encode(text, pair, max_length)
            ids_arr[i, : len(ids)] = ids
            mask_arr[i, : len(mask)] = mask
        return ids_arr, mask_arr

    def batch_encode_pairs(self, pairs, max_length: int = 128):
        n = len(pairs)
        ids_arr = np.full((n, max_length), self.pad_id, np.int32)
        mask_arr = np.zeros((n, max_length), np.int32)
        type_arr = np.zeros((n, max_length), np.int32)
        for i, (a, b) in enumerate(pairs):
            ids, mask, types = self.encode(a, b, max_length)
            ids_arr[i, : len(ids)] = ids
            mask_arr[i, : len(mask)] = mask
            type_arr[i, : len(types)] = types
        return ids_arr, mask_arr, type_arr


def load_tokenizer(path_or_mock: str, vocab_size: int = 512, **kw):
    """Load a WordPiece vocab if a path exists (native C++ batch tokenizer
    when buildable, else pure Python), otherwise a HashTokenizer mock.
    A ``.json`` path loads a byte-level BPE vocab (roberta-family
    checkpoints: ``vocab.json`` + sibling ``merges.txt``)."""
    if path_or_mock and os.path.isfile(path_or_mock):
        if path_or_mock.endswith(".json"):
            from qst_tpu_torch.models.bpe_tokenizer import RobertaBPETokenizer

            return RobertaBPETokenizer.from_files(path_or_mock, **kw)
        # the source's broad ``except`` is left out: native_available() is
        # False when g++ fails, and any other error is a fault to see
        from qst_tpu_torch.native import FastWordPieceTokenizer, native_available

        if native_available():
            return FastWordPieceTokenizer.from_vocab_file(path_or_mock, **kw)
        return WordPieceTokenizer.from_vocab_file(path_or_mock, **kw)
    return HashTokenizer(vocab_size=vocab_size)
