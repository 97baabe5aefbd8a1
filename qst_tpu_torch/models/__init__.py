"""Encoder models, tokenizers and weight import (counterpart of
``qst_tpu/models``)."""

from qst_tpu_torch.models.bert import BertEncoder
from qst_tpu_torch.models.sentence_encoder import (
    SentenceEncoderModule,
    SentenceEncoder,
    init_params,
    embed_fn,
)
from qst_tpu_torch.models.bpe_tokenizer import RobertaBPETokenizer
from qst_tpu_torch.models.cross_encoder import (
    CrossEncoderModule,
    CrossEncoder,
    init_cross_encoder,
)
from qst_tpu_torch.models.discriminator import PairDiscriminator, init_discriminator
from qst_tpu_torch.models.tokenizer import (
    WordPieceTokenizer,
    HashTokenizer,
    load_tokenizer,
    basic_tokenize,
)
from qst_tpu_torch.models.hf_import import (
    import_bert_params,
    import_sentence_encoder_params,
    load_torch_state_dict,
)

__all__ = [
    "BertEncoder",
    "SentenceEncoderModule",
    "SentenceEncoder",
    "init_params",
    "embed_fn",
    "RobertaBPETokenizer",
    "CrossEncoderModule",
    "CrossEncoder",
    "init_cross_encoder",
    "PairDiscriminator",
    "init_discriminator",
    "WordPieceTokenizer",
    "HashTokenizer",
    "load_tokenizer",
    "basic_tokenize",
    "import_bert_params",
    "import_sentence_encoder_params",
    "load_torch_state_dict",
]
