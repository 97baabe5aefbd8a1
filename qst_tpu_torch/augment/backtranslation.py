"""Backtranslation augmentation (en→fr→en roundtrip) — counterpart of
``qst_tpu/augment/backtranslation.py``.

Carried over as they are (``tests/test_torch_augment.py`` holds them to
their source): the ``>>fr<<`` batch formatter, ``IdentityBacktranslator``
(the mock), ``ParaphraseBacktranslator`` (a model-free synonym paraphraser),
``MarianBacktranslator`` (local HF MarianMT checkpoints through
``transformers``, imported inside its constructor), and the memoized,
thread-safe ``get_backtranslator`` with its environment variables
(``$QST_MARIAN_EN_FR``, ``$QST_MARIAN_FR_EN``,
``$QST_BACKTRANSLATION_BACKEND``) and its forced-backend checks.

Not ported: the JAX package's on-device Marian (``JaxMarianBacktranslator``,
``backend="jax"``, and the automatic choice when both checkpoint directories
exist), which becomes the port's on-card Marian with ``models/seq2seq.py``
(``ROADMAP.md`` A11). Until then those choices raise ``NotImplementedError``;
they never fall back to the paraphraser.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Sequence

from qst_tpu_torch.augment.synonyms import SynonymAugmenter

LANGUAGE_PREFIX = ">>fr<<"

_ON_CARD_MARIAN = ("the on-card Marian backtranslator (models/seq2seq.py) is not ported "
                   "to qst_tpu_torch yet (ROADMAP.md A11); backend='torch' runs the host "
                   "MarianMT through transformers")


def format_batch_texts(texts: Sequence[str],
                       language_code: str = "fr") -> List[str]:
    """Prepend the Marian multilingual target-language token (reference
    backtranslation.py:65-69)."""
    return [f">>{language_code}<< {t}" for t in texts]


class IdentityBacktranslator:
    """Mock roundtrip: returns inputs unchanged."""

    def backtranslate(self, texts: Sequence[str]) -> List[str]:
        return list(texts)


class ParaphraseBacktranslator:
    """Model-free approximation: synonym substitution emulating the lexical
    drift a fr-roundtrip produces."""

    def __init__(self, seed: int = 14):
        self._aug = SynonymAugmenter(aug_min=1, aug_max=3, seed=seed)

    def backtranslate(self, texts: Sequence[str]) -> List[str]:
        return self._aug.augment(list(texts))


class MarianBacktranslator:
    """Local-checkpoint MarianMT roundtrip (batched, host-side)."""

    def __init__(self, en_fr_path: str, fr_en_path: str,
                 batch_size: int = 32, max_length: int = 128):
        from transformers import MarianMTModel, MarianTokenizer  # gated

        self.tok_fwd = MarianTokenizer.from_pretrained(en_fr_path)
        self.model_fwd = MarianMTModel.from_pretrained(en_fr_path).eval()
        self.tok_bwd = MarianTokenizer.from_pretrained(fr_en_path)
        self.model_bwd = MarianMTModel.from_pretrained(fr_en_path).eval()
        self.batch_size = batch_size
        self.max_length = max_length

    def _translate(self, texts: Sequence[str], tok, model) -> List[str]:
        import torch

        out: List[str] = []
        for start in range(0, len(texts), self.batch_size):
            chunk = list(texts[start:start + self.batch_size])
            enc = tok(chunk, return_tensors="pt", padding=True,
                      truncation=True, max_length=self.max_length)
            with torch.no_grad():
                gen = model.generate(**enc, max_length=self.max_length)
            out.extend(tok.batch_decode(gen, skip_special_tokens=True))
        return out

    def backtranslate(self, texts: Sequence[str]) -> List[str]:
        fr = self._translate(format_batch_texts(texts), self.tok_fwd,
                             self.model_fwd)
        return self._translate(fr, self.tok_bwd, self.model_bwd)


_lock = threading.Lock()
_singleton = None
_singleton_backend = None  # the _BACKEND_CHOICES key the singleton realizes


_BACKEND_CHOICES = {"jax", "torch", "paraphrase", "identity"}


def _marian_tokenizer_available(path: str) -> bool:
    try:
        import sentencepiece  # noqa: F401
    except ImportError:
        return False
    return os.path.isfile(os.path.join(path, "source.spm"))


def get_backtranslator(
    en_fr_path: Optional[str] = None,
    fr_en_path: Optional[str] = None,
    allow_paraphrase_fallback: bool = True,
    backend: Optional[str] = None,
    tokenizers=None,
):
    """Best-available backend, constructed once (thread-safe).

    Checkpoint dirs default to ``$QST_MARIAN_EN_FR`` / ``$QST_MARIAN_FR_EN``;
    ``backend=`` or ``$QST_BACKTRANSLATION_BACKEND`` (``jax`` / ``torch`` /
    ``paraphrase`` / ``identity``) forces a specific one. Where the JAX
    package picks its on-device Marian — ``backend="jax"``, or both
    checkpoint directories present with a tokenizer that can load — this
    raises ``NotImplementedError``."""
    global _singleton, _singleton_backend
    en_fr_path = en_fr_path or os.environ.get("QST_MARIAN_EN_FR")
    fr_en_path = fr_en_path or os.environ.get("QST_MARIAN_FR_EN")
    backend = backend or os.environ.get("QST_BACKTRANSLATION_BACKEND")
    if backend is not None and backend not in _BACKEND_CHOICES:
        # typos must not silently fall through to auto-selection (a
        # degraded paraphrase fallback masquerading as Marian output)
        raise ValueError(f"unknown backtranslation backend {backend!r}; "
                         f"choices: {sorted(_BACKEND_CHOICES)}")
    with _lock:
        if _singleton is not None:
            # a FORCED backend must never be satisfied by a memoized
            # instance of a different kind
            if backend is None or backend == _singleton_backend:
                return _singleton
        have_ckpts = bool(
            en_fr_path and fr_en_path and os.path.isdir(en_fr_path)
            and os.path.isdir(fr_en_path))
        if backend in ("jax", "torch") and not have_ckpts:
            raise ValueError(
                f"backend={backend!r} forces Marian generation but the "
                "checkpoint dirs are missing — pass en_fr_path/fr_en_path "
                "or set $QST_MARIAN_EN_FR / $QST_MARIAN_FR_EN to existing "
                "directories")
        if backend == "identity":
            _singleton = IdentityBacktranslator()
        elif backend == "paraphrase":
            _singleton = ParaphraseBacktranslator()
        elif backend == "torch":
            _singleton = MarianBacktranslator(en_fr_path, fr_en_path)
        elif backend == "jax":
            raise NotImplementedError(_ON_CARD_MARIAN)
        elif have_ckpts:
            if tokenizers is not None or (
                    _marian_tokenizer_available(en_fr_path)
                    and _marian_tokenizer_available(fr_en_path)):
                raise NotImplementedError(_ON_CARD_MARIAN)
            _singleton = MarianBacktranslator(en_fr_path, fr_en_path)
        elif allow_paraphrase_fallback:
            _singleton = ParaphraseBacktranslator()
        else:
            _singleton = IdentityBacktranslator()
        _singleton_backend = {
            IdentityBacktranslator: "identity",
            ParaphraseBacktranslator: "paraphrase",
            MarianBacktranslator: "torch",
        }[type(_singleton)]
        return _singleton


def reset_backtranslator() -> None:
    global _singleton, _singleton_backend
    with _lock:
        _singleton = None
        _singleton_backend = None


def perform_back_translation(texts: Sequence[str], **kw) -> List[str]:
    """Convenience roundtrip with the default backend (reference
    backtranslation.py:97-113 surface)."""
    return get_backtranslator(**kw).backtranslate(list(texts))
