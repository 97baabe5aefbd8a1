"""Dataset augmentation (counterpart of ``qst_tpu/augment``): POS tagging,
synonym replacement, backtranslation backends, partial-positive synthesis,
positive mining and the LLM client — host code, copied from the JAX package
— and the two model-backed augmenters: ``MLMAugmenter``, the MLM
insert/substitute augmentation over the port's MLM head, and
``JaxMarianBacktranslator``, the on-card Marian roundtrip over
``models/seq2seq.py`` (the JAX package's name, kept)."""

from qst_tpu_torch.augment.pos_tagger import pos_tag_universal
from qst_tpu_torch.augment.synonyms import SynonymAugmenter, DEFAULT_LEXICON
from qst_tpu_torch.augment.backtranslation import (
    IdentityBacktranslator,
    ParaphraseBacktranslator,
    MarianBacktranslator,
    JaxMarianBacktranslator,
    get_backtranslator,
    reset_backtranslator,
    perform_back_translation,
    format_batch_texts,
)
from qst_tpu_torch.augment.llm_client import OpenAICompatibleClient, get_llm_fn
from qst_tpu_torch.augment.mlm import MLMAugmenter
from qst_tpu_torch.augment.partial_positive import (
    ADAPTIVE_CROP,
    ADAPTIVE_CROP_AUGMENT,
    LLM,
    MOCK,
    mock_llm_response,
    build_llm_prompt,
    parse_llm_response,
    crop_text_based_on_tagging,
    adaptive_crop_part_pos_examples,
    get_part_pos_examples,
)
from qst_tpu_torch.augment.positive_mining import (
    compute_cosine_scores,
    pop_random_caption,
    select_positive_examples,
    TOP_K_BACKUP,
)

__all__ = [
    "pos_tag_universal",
    "SynonymAugmenter",
    "DEFAULT_LEXICON",
    "IdentityBacktranslator",
    "ParaphraseBacktranslator",
    "MarianBacktranslator",
    "JaxMarianBacktranslator",
    "get_backtranslator",
    "reset_backtranslator",
    "perform_back_translation",
    "format_batch_texts",
    "ADAPTIVE_CROP",
    "ADAPTIVE_CROP_AUGMENT",
    "LLM",
    "MOCK",
    "OpenAICompatibleClient",
    "get_llm_fn",
    "MLMAugmenter",
    "mock_llm_response",
    "build_llm_prompt",
    "parse_llm_response",
    "crop_text_based_on_tagging",
    "adaptive_crop_part_pos_examples",
    "get_part_pos_examples",
    "compute_cosine_scores",
    "pop_random_caption",
    "select_positive_examples",
    "TOP_K_BACKUP",
]
