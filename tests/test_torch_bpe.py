"""The port's byte-level BPE tokenizer (``qst_tpu_torch/models/bpe_tokenizer.py``)
against qst_tpu's.

The source pre-tokenizes with GPT-2's pattern in the ``regex`` module; the
port spells the pattern's ``\\p{L}``, ``\\p{N}`` and ``\\s`` out for the
standard library's ``re``. The splits must be the source's exactly, on a
fixed corpus (No/Nl numerics, combining marks, CJK, emoji, contractions,
runs of spaces, tabs and newlines, U+001C..U+001F, which Python's ``\\s``
takes and ``regex``'s does not) and on ``hypothesis`` text drawn from the
characters assigned in this Python's ``unicodedata`` (the ``regex`` module
carries newer Unicode tables, in which some of the code points unassigned
here are letters). Ids, masks and types must be equal to the source's for
``tokenize``, ``encode``, ``batch_encode`` and ``batch_encode_pairs``, with
truncation, over a vocabulary learned from a few texts.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from bpe_helpers import TEXTS, learn_bpe, write_bpe_files
from qst_tpu.models import bpe_tokenizer as jbpe
from qst_tpu.models import tokenizer as jtok
from qst_tpu_torch.models import bpe_tokenizer as tbpe
from qst_tpu_torch.models import tokenizer as ttok

CORPUS = [
    "x² ½ Ⅻ 3⁴ ٣٤ abc",
    "été café ñ äb",
    "漢字とカタカナ 한국어 テスト",
    "😀👍🏽 🇫🇷 flags & emoji!!",
    "it's we'll I'M they'd you've we're 's'll 'x \"'s",
    "a   b\t\tc\n\n d  ",
    "  hello   world  ",
    " \x1c\x1d\x1e\x1fz 　 x y  ",
    "a \tb \n c",
    "123abc 45.6 7,890 -12",
    "",
    "   ",
    "end with space ",
    "tabs\tand\u0085next\u000bline",
]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    vocab, merges = learn_bpe(TEXTS + CORPUS, 300)
    path = write_bpe_files(str(tmp_path_factory.mktemp("bpe")), vocab, merges)
    return (jbpe.RobertaBPETokenizer.from_files(path),
            tbpe.RobertaBPETokenizer.from_files(path), path)


def test_bytes_to_unicode_is_the_source():
    assert tbpe.bytes_to_unicode() == jbpe.bytes_to_unicode()
    assert len(set(tbpe.bytes_to_unicode().values())) == 256


def test_white_space_is_the_regex_modules_class():
    regex = pytest.importorskip("regex")
    every = "".join(chr(c) for c in range(0x110000) if not 0xD800 <= c < 0xE000)
    assert sorted(map(ord, tbpe.WHITE_SPACE)) == [ord(c) for c in regex.findall(r"\s", every)]


@pytest.mark.parametrize("text", CORPUS)
def test_pretokenizer_splits_as_the_source(text):
    assert tbpe.pretokenize_pattern().findall(text) == jbpe._PRETOKENIZE.findall(text)


_ASSIGNED = st.characters(exclude_categories=("Cs", "Cn"))
_TRICKY = st.sampled_from(list(" \t\n\r\x0b\x1c　'sltrevmd²½Ⅻ0é́漢😀-.,"))


@settings(max_examples=400, deadline=None, database=None)
@given(st.text(alphabet=st.one_of(_ASSIGNED, _TRICKY), max_size=40))
def test_pretokenizer_splits_hypothesis_text_as_the_source(text):
    assert tbpe.pretokenize_pattern().findall(text) == jbpe._PRETOKENIZE.findall(text)


@pytest.mark.parametrize("text", TEXTS + CORPUS)
def test_tokenize_and_encode_are_the_source(bpe, text):
    jt, tt, _ = bpe
    assert tt.tokenize(text) == jt.tokenize(text)
    for max_length in (4, 9, 64):
        assert tt.encode(text, max_length=max_length) == jt.encode(text, max_length=max_length)
        assert (tt.encode(text, TEXTS[1], max_length=max_length)
                == jt.encode(text, TEXTS[1], max_length=max_length))


@pytest.mark.parametrize("max_length", [6, 16, 48])
def test_batch_apis_are_the_source(bpe, max_length):
    """Framing ``<s> A </s></s> B </s>``, truncation to max_length − 1 plus
    ``</s>``, types all zero, padding with ``<pad>``."""
    jt, tt, _ = bpe
    texts, pairs = TEXTS + CORPUS[:6], CORPUS[:6] + TEXTS
    for got, want in zip(tt.batch_encode(texts, max_length),
                         jt.batch_encode(texts, max_length)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tt.batch_encode(texts, max_length, text_pairs=pairs),
                         jt.batch_encode(texts, max_length, text_pairs=pairs)):
        np.testing.assert_array_equal(got, want)
    got = tt.batch_encode_pairs(list(zip(texts, pairs)), max_length)
    want = jt.batch_encode_pairs(list(zip(texts, pairs)), max_length)
    for g, w in zip(got, want):
        assert g.shape == (len(texts), max_length) and g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    ids, mask, types = got
    assert types.max() == 0 and (ids[:, 0] == tt.cls_id).all()
    assert (ids[mask == 0] == tt.pad_id).all()


def test_load_tokenizer_dispatches_json_to_bpe(bpe):
    _, _, path = bpe
    t, j = ttok.load_tokenizer(path), jtok.load_tokenizer(path)
    assert isinstance(t, tbpe.RobertaBPETokenizer)
    assert (t.cls_id, t.sep_id, t.pad_id, t.unk_id, t.mask_id) == (
        j.cls_id, j.sep_id, j.pad_id, j.unk_id, j.mask_id) == (0, 2, 1, 3, 4)
    for a, b in zip(t.batch_encode(TEXTS, 32), j.batch_encode(TEXTS, 32)):
        np.testing.assert_array_equal(a, b)
