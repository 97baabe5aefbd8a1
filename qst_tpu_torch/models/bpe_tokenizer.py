"""Byte-level BPE tokenizer (GPT-2 / RoBERTa scheme) — a copy of
``qst_tpu/models/bpe_tokenizer.py``.

The vocabulary of RoBERTa checkpoints such as the reference's relevance
labeler ``cross-encoder/stsb-roberta-large`` (``vocab.json`` +
``merges.txt``). The batch API is ``WordPieceTokenizer``'s (fixed-shape
int32 ids / mask / type arrays) with RoBERTa's framing: ``<s> A </s>`` and
``<s> A </s></s> B </s>`` for pairs, token types all zero (RoBERTa is
segment-blind).

The one difference from the source is the pre-tokenizer. The source splits
with GPT-2's pattern in the third-party ``regex`` module::

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

Here the same alternation runs in the standard library's ``re``, with its
three classes written out as explicit code-point ranges:

- ``\\p{L}`` and ``\\p{N}``: every code point whose ``unicodedata`` category
  starts with L or N. Python's ``[^\\W\\d_]`` is not ``\\p{L}``: it takes the
  No/Nl numerics (``²``, ``½``, ``Ⅻ``) as letters;
- ``\\s``: the 25 code points of Unicode's White_Space property, which is
  what ``regex`` matches. Python's ``\\s`` also takes U+001C..U+001F.

The alternation and its backtracking are ``re``'s own, so a whitespace run
before a word still leaves its last space to the word. The classes are built
once, at the first ``tokenize``.
"""

from __future__ import annotations

import json
import os
import re
import sys
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Unicode's White_Space property: the code points the ``regex`` module's \s
# matches in a str pattern
WHITE_SPACE = ("\t\n\x0b\x0c\r \x85\xa0\u1680" + "".join(map(chr, range(0x2000, 0x200B)))
               + "\u2028\u2029\u202f\u205f\u3000")


def _ranges(codes: Sequence[int]) -> str:
    """Sorted code points → the body of a character class of ranges."""
    out, start, prev = [], None, None
    for c in codes:
        if start is None:
            start = prev = c
        elif c == prev + 1:
            prev = c
        else:
            out.append((start, prev))
            start = prev = c
    if start is not None:
        out.append((start, prev))
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}" for a, b in out)


@lru_cache(maxsize=1)
def pretokenize_pattern() -> "re.Pattern[str]":
    """GPT-2's pre-tokenization pattern with ``\\p{L}``, ``\\p{N}`` and
    ``\\s`` spelled out from ``unicodedata`` (see the module docstring)."""
    letters, numbers = [], []
    for c in range(sys.maxunicode + 1):
        cat = unicodedata.category(chr(c))
        if cat[0] == "L":
            letters.append(c)
        elif cat[0] == "N":
            numbers.append(c)
    L, N = _ranges(letters), _ranges(numbers)
    S = _ranges(sorted(map(ord, WHITE_SPACE)))
    return re.compile(
        rf"""'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+|[{S}]+(?![^{S}])|[{S}]+""")


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte→printable-unicode table: printable latin
    bytes map to themselves, the rest shift into U+0100.."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


class RobertaBPETokenizer:
    """Greedy lowest-rank-first byte-pair merging over a GPT-2 vocab."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>", unk_token: str = "<unk>",
                 mask_token: str = "<mask>"):
        self.vocab = dict(vocab)
        self.inv_vocab = {v: k for k, v in self.vocab.items()}
        self._ranks = {tuple(m): i for i, m in enumerate(merges)}
        self._byte_map = bytes_to_unicode()
        self._cache: Dict[str, List[str]] = {}
        self.cls_id = self.vocab[bos_token]
        self.sep_id = self.vocab[eos_token]
        self.pad_id = self.vocab[pad_token]
        self.unk_id = self.vocab.get(unk_token, self.vocab[eos_token])
        self.mask_id = self.vocab.get(mask_token, self.unk_id)

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: Optional[str] = None,
                   **kw) -> "RobertaBPETokenizer":
        """``merges_txt`` defaults to ``merges.txt`` next to the vocab."""
        if merges_txt is None:
            merges_txt = os.path.join(os.path.dirname(vocab_json), "merges.txt")
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_txt, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        return cls(vocab, merges, **kw)

    # ------------------------------------------------------------------
    def _bpe(self, token: str) -> List[str]:
        """Standard BPE merge loop: repeatedly merge the lowest-rank
        adjacent pair until none is mergeable."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token)
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self._ranks.get(p, float("inf")))
            if best not in self._ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == a and parts[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[token] = parts
        return parts

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        bm = self._byte_map
        for piece in pretokenize_pattern().findall(text):
            mapped = "".join(bm[b] for b in piece.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def _token_ids(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]

    # ---------------- WordPieceTokenizer-compatible batch API ----------
    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: int = 128) -> Tuple[List[int], List[int], List[int]]:
        """→ (ids, mask, token_type_ids), unpadded. RoBERTa framing:
        ``<s> A </s>`` / ``<s> A </s></s> B </s>``; types all zero."""
        ids = [self.cls_id] + self._token_ids(text) + [self.sep_id]
        if text_pair is not None:
            ids += [self.sep_id] + self._token_ids(text_pair) + [self.sep_id]
        if len(ids) > max_length:
            ids = ids[: max_length - 1] + [self.sep_id]
        return ids, [1] * len(ids), [0] * len(ids)

    def batch_encode(self, texts: Sequence[str], max_length: int = 128,
                     text_pairs: Optional[Sequence[str]] = None
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

    def batch_encode_pairs(self, pairs: Sequence[Tuple[str, str]], max_length: int = 128
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
