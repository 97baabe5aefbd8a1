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

``JaxMarianBacktranslator`` is the port's on-card Marian: both local
checkpoint directories loaded through ``models/hf_import.load_marian_dir``
into ``models/seq2seq.py``, KV-cached beam decode on the GPU for both hops.
It keeps the JAX package's name and ``backend="jax"``, as the port keeps
``backend="pallas"`` for its CUDA kernels; ``get_backtranslator`` builds it
where the JAX package builds its own (``backend="jax"``, or both directories
present with a tokenizer that can load) and never falls back to the
paraphraser, to ``transformers`` or to the CPU in its place.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, List, Optional, Sequence

from qst_tpu_torch.augment.synonyms import SynonymAugmenter

LANGUAGE_PREFIX = ">>fr<<"


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


@contextlib.contextmanager
def _matmul_precision(precision: str):
    """f32 products inside the block: ``"highest"`` keeps them in full f32
    (TF32 off); any other value allows TF32. The previous setting comes
    back on the way out."""
    import torch

    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest" if precision == "highest" else "high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


class JaxMarianBacktranslator:
    """On-card MarianMT roundtrip: local checkpoint dirs loaded into the
    port's Marian (``models/seq2seq.py``), KV-cached **beam** decode on the
    GPU for both hops (reference dataset/backtranslation.py:72-113), with the
    source's per-hop length bucketing of the source width.

    The name is the JAX package's, kept with ``backend="jax"`` as the port
    keeps ``backend="pallas"`` for its CUDA kernels. Generation settings
    (num_beams, pad suppression via ``bad_words_ids``,
    ``forced_eos_token_id``) come from each checkpoint's config.
    Tokenization stays on the host (``MarianTokenizer``, imported when
    ``tokenizers`` is None; injectable). ``device`` defaults to the GPU
    (``core/device.py``) and raises without one; the weights and the decode
    live there. ``matmul_precision="highest"`` keeps the products in full
    f32 inside a call (TF32 off, the previous setting restored after it);
    any other value allows TF32.
    """

    def __init__(self, en_fr_path: str, fr_en_path: str,
                 batch_size: int = 32, max_length: int = 128,
                 num_beams: Optional[int] = None, tokenizers=None,
                 matmul_precision: str = "highest", device: Any = None):
        from qst_tpu_torch.core.device import resolve_device
        from qst_tpu_torch.models.hf_import import load_marian_dir

        self.device = resolve_device(device)
        self.fwd_cfg, fwd, self.fwd_gen = load_marian_dir(en_fr_path)
        self.bwd_cfg, bwd, self.bwd_gen = load_marian_dir(fr_en_path)
        self.fwd_params = {k: v.to(self.device) for k, v in fwd.items()}
        self.bwd_params = {k: v.to(self.device) for k, v in bwd.items()}
        if tokenizers is None:
            from transformers import MarianTokenizer  # needs sentencepiece

            tokenizers = (MarianTokenizer.from_pretrained(en_fr_path),
                          MarianTokenizer.from_pretrained(fr_en_path))
        self.tok_fwd, self.tok_bwd = tokenizers
        self.batch_size = batch_size
        self.max_length = max_length
        self.matmul_precision = matmul_precision
        if num_beams is not None:
            self.fwd_gen = {**self.fwd_gen, "num_beams": num_beams}
            self.bwd_gen = {**self.bwd_gen, "num_beams": num_beams}

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, cap)

    def _translate(self, texts: Sequence[str], cfg, params, tok,
                   gen) -> List[str]:
        import numpy as np
        import torch

        from qst_tpu_torch.models.seq2seq import beam_decode_cached

        out: List[str] = []
        for start in range(0, len(texts), self.batch_size):
            chunk = list(texts[start:start + self.batch_size])
            enc = tok(chunk, padding=True, truncation=True,
                      max_length=self.max_length, return_tensors="np")
            ids = np.asarray(enc["input_ids"], np.int64)
            mask = np.asarray(enc["attention_mask"], np.int64)
            # pad the source to a bucketed width (masked positions cannot
            # influence decode), as the source does to bound its compiles
            S = self._bucket(ids.shape[1], self.max_length)
            if ids.shape[1] < S:
                pad_w = ((0, 0), (0, S - ids.shape[1]))
                ids = np.pad(ids, pad_w, constant_values=cfg.pad_token_id)
                mask = np.pad(mask, pad_w, constant_values=0)
            with _matmul_precision(self.matmul_precision):
                toks = beam_decode_cached(
                    params, torch.from_numpy(ids).to(self.device),
                    torch.from_numpy(mask).to(self.device), cfg,
                    max_length=min(gen.get("max_length", 512),
                                   self.max_length),
                    num_beams=int(gen.get("num_beams", 4)),
                    length_penalty=float(gen.get("length_penalty", 1.0)),
                    suppress_tokens=tuple(gen.get("suppress_tokens", ())),
                    # bool(False) = off; an int is the forced TOKEN ID
                    # (may differ from eos_token_id — see load_marian_dir)
                    forced_eos=gen.get("forced_eos", False))
            out.extend(tok.batch_decode(toks.cpu().numpy(),
                                        skip_special_tokens=True))
        return out

    def backtranslate(self, texts: Sequence[str]) -> List[str]:
        fr = self._translate(format_batch_texts(texts), self.fwd_cfg,
                             self.fwd_params, self.tok_fwd, self.fwd_gen)
        return self._translate(fr, self.bwd_cfg, self.bwd_params,
                               self.tok_bwd, self.bwd_gen)


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
    device: Any = None,
):
    """Best-available backend, constructed once (thread-safe).

    Checkpoint dirs default to ``$QST_MARIAN_EN_FR`` / ``$QST_MARIAN_FR_EN``.
    When both are present the on-card ``JaxMarianBacktranslator`` is
    selected (generation on the GPU, or on ``device``); ``backend=`` or
    ``$QST_BACKTRANSLATION_BACKEND`` (``jax`` / ``torch`` / ``paraphrase`` /
    ``identity``) forces a specific one."""
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
            _singleton = JaxMarianBacktranslator(en_fr_path, fr_en_path,
                                                 tokenizers=tokenizers, device=device)
        elif have_ckpts:
            # on-card decode whenever the tokenizer can load; the torch
            # backend remains reachable explicitly (backend="torch")
            if tokenizers is not None or (
                    _marian_tokenizer_available(en_fr_path)
                    and _marian_tokenizer_available(fr_en_path)):
                _singleton = JaxMarianBacktranslator(en_fr_path, fr_en_path,
                                                     tokenizers=tokenizers, device=device)
            else:
                _singleton = MarianBacktranslator(en_fr_path, fr_en_path)
        elif allow_paraphrase_fallback:
            _singleton = ParaphraseBacktranslator()
        else:
            _singleton = IdentityBacktranslator()
        _singleton_backend = {
            IdentityBacktranslator: "identity",
            ParaphraseBacktranslator: "paraphrase",
            MarianBacktranslator: "torch",
            JaxMarianBacktranslator: "jax",
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
