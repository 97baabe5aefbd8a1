"""MLM insert/substitute augmentation, batched on the device — counterpart of
``qst_tpu/augment/mlm.py``.

Equivalent of ``nlpaug.ContextualWordEmbsAug(action="substitute"|"insert")``
as the reference configures it: mask or insert positions at the word level,
score the texts in one forward, sample replacements from the top-k
vocabulary predictions. The numpy ``default_rng(seed)`` draws are the
source's, in the source's order, so the same logits give the same texts.

One change from the source, which keeps its outputs: the source projects
every position of every text onto the vocabulary, (N, S, V) f32 logits (4 GB
at N = 256, S = 128, V = 30,522), and reads the mask slots' rows. Here the
trunk and the head's transform run over the whole batch, and only the rows
at mask slots go through the vocabulary projection (``BertMLMModule.decoder``)
and to the host. ``models/mlm.py``'s ``mlm_logits_fn`` keeps the (B, S, V)
API.

Requires an invertible tokenizer (``WordPieceTokenizer``); quality tracks
the MLM checkpoint loaded into the head — with random weights the mechanism
still runs end to end.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
import torch

from qst_tpu_torch.core.config import EncoderConfig
from qst_tpu_torch.models.mlm import mlm_module
from qst_tpu_torch.models.tokenizer import WordPieceTokenizer


class MLMAugmenter:
    def __init__(
        self,
        cfg: EncoderConfig,
        params: Any,
        tokenizer: WordPieceTokenizer,
        action: str = "substitute",
        aug_min: int = 1,
        aug_max: int = 2,
        top_k: int = 10,
        seed: int = 14,
    ):
        if action not in ("substitute", "insert"):
            raise ValueError(f"action must be substitute/insert, {action} given")
        if aug_min < 0 or aug_max < aug_min:
            raise ValueError(f"invalid aug range [{aug_min}, {aug_max}]")
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.action = action
        self.aug_min = aug_min
        self.aug_max = aug_max
        self.top_k = top_k
        self._model = mlm_module(cfg, params)
        self._rng = np.random.default_rng(seed)
        self._special = {tokenizer.pad_id, tokenizer.cls_id, tokenizer.sep_id,
                         tokenizer.unk_id, tokenizer.mask_id}

    def _prepare(self, text: str):
        """→ (ids-with-masks, mask positions). Word-level masking: each
        chosen word's first piece becomes [MASK] (substitute) or a [MASK] is
        spliced before a word boundary (insert)."""
        tok = self.tokenizer
        words = text.split(" ")
        if not words:
            return None
        n = int(self._rng.integers(self.aug_min, self.aug_max + 1))
        n = min(max(n, 0), len(words))
        if n == 0:
            return None
        positions = sorted(
            int(i) for i in self._rng.choice(len(words), size=n, replace=False))

        ids: List[int] = [tok.cls_id]
        mask_slots: List[int] = []
        for wi, word in enumerate(words):
            pieces = [tok.vocab.get(p, tok.unk_id) for p in tok.wordpiece(word)]
            if self.action == "insert" and wi in positions:
                mask_slots.append(len(ids))
                ids.append(tok.mask_id)
                ids.extend(pieces)
            elif self.action == "substitute" and wi in positions:
                mask_slots.append(len(ids))
                ids.append(tok.mask_id)
                ids.extend(pieces[1:])  # keep continuation pieces
            else:
                ids.extend(pieces)
        ids.append(tok.sep_id)
        max_len = self.cfg.max_seq_length
        if len(ids) > max_len:
            ids = ids[: max_len - 1] + [tok.sep_id]
            mask_slots = [s for s in mask_slots if s < max_len - 1]
        return ids, mask_slots

    def _decode(self, ids: Sequence[int]) -> str:
        tok = self.tokenizer
        words: List[str] = []
        for i in ids:
            if i in (tok.cls_id, tok.sep_id, tok.pad_id):
                continue
            piece = tok.inv_vocab.get(int(i), tok.unk_token)
            if piece.startswith("##") and words:
                words[-1] += piece[2:]
            else:
                words.append(piece)
        return " ".join(words)

    def _slot_logits(self, batch_ids: np.ndarray, batch_mask: np.ndarray,
                     rows: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """(M, V) f32 logits of the (row, slot) positions: the rows of the
        source's (N, S, V) logits that ``augment`` reads."""
        model = self._model
        dev = next(model.parameters()).device
        with torch.no_grad():
            hidden = model.hidden(torch.from_numpy(batch_ids.astype(np.int64)).to(dev),
                                  torch.from_numpy(batch_mask.astype(np.int64)).to(dev))
            picked = hidden[torch.from_numpy(rows).to(dev), torch.from_numpy(slots).to(dev)]
            return model.decoder(picked).cpu().numpy()

    def augment(self, texts) -> List[str]:
        if isinstance(texts, str):
            texts = [texts]
        prepared = [self._prepare(t) for t in texts]
        S = self.cfg.max_seq_length
        batch_ids = np.full((len(texts), S), self.tokenizer.pad_id, np.int32)
        batch_mask = np.zeros((len(texts), S), np.int32)
        rows: List[int] = []
        slots: List[int] = []
        for row, prep in enumerate(prepared):
            if prep is None:
                continue
            ids, row_slots = prep
            batch_ids[row, : len(ids)] = ids
            batch_mask[row, : len(ids)] = 1
            rows += [row] * len(row_slots)
            slots += row_slots

        logits = self._slot_logits(batch_ids, batch_mask, np.asarray(rows, np.int64),
                                   np.asarray(slots, np.int64))
        out: List[str] = []
        m = 0
        for text, prep in zip(texts, prepared):
            if prep is None:
                out.append(text)
                continue
            ids, row_slots = prep
            new_ids = list(ids)
            for slot in row_slots:
                scores = logits[m].copy()
                m += 1
                for sp in self._special:
                    scores[sp] = -np.inf
                top = np.argpartition(-scores, self.top_k)[: self.top_k]
                pick = int(top[self._rng.integers(0, len(top))])
                new_ids[slot] = pick
            out.append(self._decode(new_ids))
        return out
