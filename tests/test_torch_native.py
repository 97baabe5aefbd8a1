"""The port's native WordPiece tokenizer (``qst_tpu_torch/native``) against
its source (``qst_tpu/native``) and the Python tokenizer.

The C++ file is the source byte for byte; the binding's class and
``native_available`` are the source's code, only the build's location
differs. Outputs are held bit for bit to the port's Python tokenizer and to
qst_tpu's, ASCII and non-ASCII texts and pairs included. qst_tpu's own native
library is never built or loaded here: it belongs to the JAX package.
"""

import ast
import json
import os

import numpy as np
import pytest

from qst_tpu.models import tokenizer as jtok
from qst_tpu_torch.models import tokenizer as ttok
from qst_tpu_torch.native import fast_wordpiece as fw

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "sit", "##s", "on", "the",
         "mat", ".", "hello", ",", "world", "!", "dog", "'", "ball", ":", "red", "/", "blue",
         "?", "un", "##known", "##word", "##ing", "play", "run", "##ner", "x", "##y", "##z"]


def _vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(WORDS) + "\n")
    return str(path)


def _texts(n=300, seed=0):
    """Words of the vocabulary, pieces, unknown words, punctuation, case,
    non-ASCII letters, empty and over-long texts."""
    rng = np.random.default_rng(seed)
    pool = ["cat", "CATS", "sitting", "Playing", "runner", "xyzzy", "unknownword", "hello,",
            "world!", "dog's", "red/blue?", "mat.", "Héllo", "wörld", "naïve", "東京", "a",
            "", "\t", "ball:", "Zzz", "ünïcode"]
    out = [" ".join(rng.choice(pool, size=int(rng.integers(0, 40)))) for _ in range(n)]
    out += ["", "a " * 300, "A cat sits on the mat.", "Héllo, wörld!  tabs\tand   spaces"]
    return out


def _functions(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


def test_copies_are_the_source():
    """wordpiece.cpp byte for byte; the class and native_available are the
    source's code (only the imports and the build's location differ)."""
    with open(os.path.join(_ROOT, "qst_tpu/native/wordpiece.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(_ROOT, "qst_tpu_torch/native/wordpiece.cpp"), "rb") as f:
        assert f.read() == want
    src = _functions(os.path.join(_ROOT, "qst_tpu/native/fast_wordpiece.py"))
    got = _functions(os.path.join(_ROOT, "qst_tpu_torch/native/fast_wordpiece.py"))
    for name in ("FastWordPieceTokenizer", "native_available"):
        assert got[name] == src[name], name
    assert not fw._SRC_DIR.startswith(os.path.join(_ROOT, "qst_tpu") + os.sep)


@pytest.mark.parametrize("max_length", [16, 64])
def test_native_outputs_are_the_python_tokenizers_bit_for_bit(tmp_path, max_length):
    if not fw.native_available():
        pytest.skip("g++ cannot build the native tokenizer here")
    path = _vocab_file(tmp_path)
    native = fw.FastWordPieceTokenizer.from_vocab_file(path)
    assert native._handle is not None
    texts = _texts(seed=max_length)
    want = [ttok.WordPieceTokenizer.from_vocab_file(path).batch_encode(texts, max_length),
            jtok.WordPieceTokenizer.from_vocab_file(path).batch_encode(texts, max_length)]
    got = native.batch_encode(texts, max_length)
    for w in want:
        for a, b in zip(got, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    pairs = texts[::-1][:50]
    got = native.batch_encode(texts[:50], max_length, text_pairs=pairs)
    want = ttok.WordPieceTokenizer.from_vocab_file(path).batch_encode(texts[:50], max_length,
                                                                       text_pairs=pairs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_empty_batch(tmp_path):
    ids, mask = fw.FastWordPieceTokenizer.from_vocab_file(_vocab_file(tmp_path)).batch_encode(
        [], 32)
    assert ids.shape == mask.shape == (0, 32)
    assert ids.dtype == mask.dtype == np.int32


def test_without_gpp_the_python_tokenizer_runs(tmp_path, monkeypatch):
    """A failed build (no g++ on the PATH) degrades to the Python tokenizer,
    as the source's binding does, and load_tokenizer returns it."""
    monkeypatch.setattr(fw, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(fw, "_lib", None)
    monkeypatch.setattr(fw, "_build_failed", False)
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    assert not fw.native_available()
    assert not os.path.exists(tmp_path / "build") or not os.listdir(tmp_path / "build")
    path = _vocab_file(tmp_path)
    tok = fw.FastWordPieceTokenizer.from_vocab_file(path)
    assert tok._handle is None
    texts = _texts(40, seed=3)
    for a, b in zip(tok.batch_encode(texts, 24),
                    ttok.WordPieceTokenizer.from_vocab_file(path).batch_encode(texts, 24)):
        np.testing.assert_array_equal(a, b)
    loaded = ttok.load_tokenizer(path)
    assert type(loaded) is ttok.WordPieceTokenizer


def test_load_tokenizer_picks_the_native_tokenizer(tmp_path):
    if not fw.native_available():
        pytest.skip("g++ cannot build the native tokenizer here")
    tok = ttok.load_tokenizer(_vocab_file(tmp_path))
    assert isinstance(tok, fw.FastWordPieceTokenizer) and tok._handle is not None
    assert fw._lib_path().startswith(os.path.join(_ROOT, "qst_tpu_torch", "native", "_build"))
    # a .json vocabulary is byte-level BPE (with merges.txt beside it)
    from qst_tpu_torch.models.bpe_tokenizer import RobertaBPETokenizer

    json_path = tmp_path / "vocab.json"
    json_path.write_text(json.dumps({"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    assert isinstance(ttok.load_tokenizer(str(json_path)), RobertaBPETokenizer)
