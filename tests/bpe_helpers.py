"""A byte-level BPE vocabulary learned from a few texts, for the port's
RoBERTa tests: ``learn_bpe`` counts GPT-2 pre-tokenized words (the source
tokenizer's pattern, through the ``regex`` module) and merges the most
frequent adjacent pair ``n_merges`` times; ``write_bpe_files`` writes
``vocab.json`` + ``merges.txt`` as a RoBERTa checkpoint carries them."""

import collections
import json
import os
from typing import Dict, List, Sequence, Tuple

SPECIALS = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]

TEXTS = [
    "a red car drives down the road next to the park",
    "the cat sits on a mat in the sun, it's warm",
    "people walk their dogs in the park on sundays",
    "pasta with tomato sauce and basil on a white plate",
    "a small plane flies over the beach at 12:30",
    "we'll meet at the café near the station — 3 trains later",
    "children build sand castles by the sea; the tide comes in",
    "the young dog runs after a red ball in the garden",
]


def learn_bpe(texts: Sequence[str], n_merges: int) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    from qst_tpu.models.bpe_tokenizer import _PRETOKENIZE, bytes_to_unicode

    bm = bytes_to_unicode()
    words = collections.Counter(
        tuple(bm[b] for b in piece.encode("utf-8"))
        for t in texts for piece in _PRETOKENIZE.findall(t))
    merges: List[Tuple[str, str]] = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for a, b in zip(w, w[1:]):
                pairs[a, b] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        new = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new[tuple(out)] += c
        words = new
    tokens = SPECIALS + list(bm.values()) + [a + b for a, b in merges]
    return {t: i for i, t in enumerate(dict.fromkeys(tokens))}, merges


def write_bpe_files(d: str, vocab: Dict[str, int], merges) -> str:
    """→ the ``vocab.json`` path (``merges.txt`` beside it)."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(d, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return os.path.join(d, "vocab.json")
