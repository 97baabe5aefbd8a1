"""Everything a run feeds the program, made from ``--seed``.

- ``sub_seed``: an independent 31-bit seed for each named stream of a run.
- ``Lexicon``: a synthetic WordPiece vocabulary (specials, punctuation,
  every letter and digit alone and as a ``##`` piece, then random stems and
  ``##`` suffixes up to the configured size) and a Zipf-weighted lexicon of
  surface words — stems, stems with a suffix glued on, and rare long
  strings — so the tokenizer splits words into pieces as it splits text;
  each word's piece count comes from the reference tokenizer.
- ``Lexicon.texts``: texts whose token counts (or word counts) follow a
  traffic file's ``lengths`` (``lognormal`` with median, sigma, clipped to
  [min, max], or ``uniform``).
- ``write_quadruplets``: a COCO-caption-like quadruplet dataset in the
  program's chunk format (a caption of 8–20 words; each positive replaces
  three words; each part-positive keeps the first half and adds four words).
- ``make_weights``: a model's tensors by their Hugging Face names, made on
  the device in one draw: embeddings N(0, 1/H), matrices N(0, 1/fan_in),
  biases and LayerNorm offsets N(0, 0.1²), LayerNorm scales 1 + N(0, 0.1²).
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from portbench.reference.wordpiece import WordPiece

BIAS_STD = 0.1      # biases and LayerNorm offsets
SCALE_STD = 0.1     # LayerNorm scales about 1
LETTERS = "abcdefghijklmnopqrstuvwxyz"
PUNCT = list(".,?!'-:;")
SPECIALS = {"bert": ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
            # MPNet pads with id 1, as its published tokenizer does
            "mpnet": ["<s>", "[PAD]", "</s>", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]}


def sub_seed(seed: int, name: str) -> int:
    state = np.random.SeedSequence([int(seed) & ((1 << 63) - 1), zlib.crc32(name.encode())])
    return int(state.generate_state(1, np.uint32)[0]) & 0x7FFFFFFF


def rng_of(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, name))


def _strings(rng: np.random.Generator, n: int, lo: int, hi: int) -> List[str]:
    lens = rng.integers(lo, hi + 1, n)
    chars = np.array(list(LETTERS))[rng.integers(0, 26, (n, hi))]
    return ["".join(row[:k]) for row, k in zip(chars, lens)]


class Lexicon:
    def __init__(self, model_type: str, vocab_size: int, seed: int, n_words: int = 12000):
        rng = rng_of(seed, "vocab")
        tokens = (SPECIALS[model_type] + PUNCT + list(LETTERS) + list("0123456789")
                  + ["##" + c for c in LETTERS + "0123456789"])
        seen = set(tokens)
        n_suffix = (vocab_size - len(tokens)) * 3 // 10
        stems: List[str] = []
        suffixes: List[str] = []
        while len(stems) + len(suffixes) < vocab_size - len(tokens):
            want_suffix = len(suffixes) < n_suffix
            for s in _strings(rng, 4096, 2 if want_suffix else 3, 4 if want_suffix else 8):
                t = "##" + s if want_suffix else s
                if t not in seen and len(stems) + len(suffixes) < vocab_size - len(tokens):
                    seen.add(t)
                    (suffixes if want_suffix else stems).append(t)
                    if want_suffix and len(suffixes) >= n_suffix:
                        break
        self.vocab = tokens + stems + suffixes
        self.tokenizer = WordPiece(self.vocab)
        n_words = min(n_words, len(stems))
        plain = stems[:n_words * 6 // 10]
        glued = [s + x[2:] for s, x in zip(rng.choice(stems, n_words * 3 // 10),
                                           rng.choice(suffixes, n_words * 3 // 10))]
        rare = _strings(rng, n_words - len(plain) - len(glued), 7, 13)
        words = plain + glued + rare
        order = rng.permutation(len(words))
        self.words = np.array(words, dtype=object)[order]
        self.pieces = np.array([len(self.tokenizer.pieces(w)) for w in self.words])
        weights = 1.0 / (np.arange(len(self.words)) + 10.0)
        self.p = weights / weights.sum()

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            f.write("\n".join(self.vocab) + "\n")
        return path

    def draw_words(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.choice(len(self.words), size=n, p=self.p)

    def texts(self, spec: Mapping, n: int, rng: np.random.Generator) -> List[str]:
        """``n`` sentences (a capital first letter, a closing period) whose
        length in ``spec['unit']`` (tokens with [CLS] and [SEP], or words)
        follows ``spec``."""
        lengths = draw_lengths(spec, n, rng)
        if spec.get("unit", "tokens") == "tokens":
            # words until their pieces, [CLS], [SEP] and the period reach the target
            need = np.maximum(lengths - 3, 1)
            mean = float((self.p * self.pieces).sum())
            draw = self.draw_words(rng, int(need.sum() / mean * 1.2) + 64 * n)
            while True:
                csum = np.cumsum(self.pieces[draw])
                ends, start, ok = [], 0, True
                for t in need:
                    base = csum[start - 1] if start else 0
                    e = int(np.searchsorted(csum, base + t, side="left")) + 1
                    if e > len(draw):
                        ok = False
                        break
                    ends.append(e)
                    start = e
                if ok:
                    break
                draw = np.concatenate([draw, self.draw_words(rng, len(draw))])
        else:
            draw = self.draw_words(rng, int(lengths.sum()))
            ends = np.cumsum(lengths).tolist()
        out, start = [], 0
        for e in ends:
            text = " ".join(self.words[draw[start:e]])
            out.append(text[:1].upper() + text[1:] + ".")
            start = e
        return out


def draw_lengths(spec: Mapping, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["kind"] == "lognormal":
        x = np.exp(rng.normal(np.log(spec["median"]), spec["sigma"], n))
    elif spec["kind"] == "uniform":
        x = rng.uniform(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown length distribution {spec['kind']!r}")
    return np.clip(np.floor(x), spec["min"], spec["max"]).astype(np.int64)


def write_quadruplets(root: str, n: int, lexicon: Lexicon, spec: Mapping,
                      rng: np.random.Generator, positives: int, parts: int,
                      per_chunk: int) -> None:
    """``n`` instances in the program's chunk format under ``root``, each with
    ``positives`` positives and ``parts`` part-positives, ``per_chunk`` a file."""
    from qst_tpu_torch.data import write_chunk, write_meta

    lengths = draw_lengths(spec, n, rng)
    ids = lexicon.draw_words(rng, int(lengths.sum()))
    swaps = lexicon.draw_words(rng, 3 * positives * n).reshape(n, positives, 3)
    where = (rng.random((n, positives, 3)) * lengths[:, None, None]).astype(np.int64)
    tails = lexicon.draw_words(rng, 4 * parts * n).reshape(n, parts, 4)
    words = lexicon.words
    insts, pos = [], 0

    def text(ix):
        t = " ".join(words[ix])
        return t[:1].upper() + t[1:] + "."

    for i, L in enumerate(lengths):
        ref = ids[pos:pos + L]
        pos += L
        positives_of_i = []
        for j in range(positives):
            v = ref.copy()
            v[where[i, j]] = swaps[i, j]
            positives_of_i.append(text(v))
        insts.append({"id": i, "reference": text(ref), "positive": positives_of_i,
                      "part_positive": [text(np.concatenate([ref[:L // 2], tails[i, j]]))
                                        for j in range(parts)]})
    for c in range(0, n, per_chunk):
        write_chunk(root, c // per_chunk, insts[c:c + per_chunk], dataset_name="portbench")
    write_meta(root, (n + per_chunk - 1) // per_chunk)


def weight_shapes(cfg: Mapping) -> Dict[str, Tuple[int, ...]]:
    """Hugging Face names and shapes of the configuration's tensors."""
    H, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    out: Dict[str, Tuple[int, ...]] = {
        "embeddings.word_embeddings.weight": (V, H),
        "embeddings.position_embeddings.weight": (cfg["max_position_embeddings"], H)}
    mpnet = cfg["model_type"] == "mpnet"
    if not mpnet:
        out["embeddings.token_type_embeddings.weight"] = (cfg["type_vocab_size"], H)
    out["embeddings.LayerNorm.weight"] = (H,)
    out["embeddings.LayerNorm.bias"] = (H,)
    att = (["attention.attn.q", "attention.attn.k", "attention.attn.v", "attention.attn.o"]
           if mpnet else ["attention.self.query", "attention.self.key", "attention.self.value",
                          "attention.output.dense"])
    ln1 = "attention.LayerNorm" if mpnet else "attention.output.LayerNorm"
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."
        for a in att:
            out[p + a + ".weight"], out[p + a + ".bias"] = (H, H), (H,)
        out[p + ln1 + ".weight"], out[p + ln1 + ".bias"] = (H,), (H,)
        out[p + "intermediate.dense.weight"], out[p + "intermediate.dense.bias"] = (F, H), (F,)
        out[p + "output.dense.weight"], out[p + "output.dense.bias"] = (H, F), (H,)
        out[p + "output.LayerNorm.weight"], out[p + "output.LayerNorm.bias"] = (H,), (H,)
    if mpnet:
        out["encoder.relative_attention_bias.weight"] = (
            cfg["relative_attention_num_buckets"], cfg["num_attention_heads"])
    return out


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor from one draw: embeddings N(0, 1/H), matrices
    N(0, 1/fan_in), biases and LayerNorm offsets N(0, BIAS_STD²), LayerNorm
    scales 1 + N(0, SCALE_STD²), so a lost bias add or LayerNorm affine
    shows in the output."""
    shapes = weight_shapes(cfg)
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(total, device=device, generator=gen)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        t = flat[at:at + n].view(shape)
        at += n
        if len(shape) == 2:
            out[name] = t.mul_(shape[1] ** -0.5)   # embeddings: 1/√H; (out, in): 1/√fan_in
        elif name.endswith("LayerNorm.weight"):
            out[name] = t.mul_(SCALE_STD).add_(1.0)
        else:
            out[name] = t.mul_(BIAS_STD)
    return out


def scratch_dir(prefix: str) -> str:
    """A fresh directory for this run's data under ``$TMPDIR``."""
    import tempfile

    return tempfile.mkdtemp(prefix=prefix, dir=os.environ.get("TMPDIR") or None)
