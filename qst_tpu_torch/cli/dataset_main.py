"""``python -m qst_tpu_torch.cli.dataset_main`` — dataset construction CLI,
counterpart of ``qst_tpu/cli/dataset_main.py``.

Build chunked quadruplet datasets from COCO caption annotations or
sentence-compression records, with chunk-range flags for partial or resumed
builds and a ``--verbose_check`` smoke pass that reads samples across chunks
through the LRU cache. Positive mining embeds each image's captions with a
random-init encoder (a production run would import a checkpoint) on the GPU
unless ``--device`` names another device:

  python -m qst_tpu_torch.cli.dataset_main --ann_file captions.json \\
      --output_root data/train --chunk_dim 500

The flags and defaults are the JAX CLI's, plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from qst_tpu_torch.cli.common import (
    add_bool_flag,
    add_device_flag,
    dump_args,
    encoder_from_args,
    tokenizer_from_args,
)
from qst_tpu_torch.core.config import CHUNK_DIM, N_EXAMPLES, N_PART_EXAMPLES

logger = logging.getLogger("qst_tpu_torch.cli.dataset")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset_type", choices=["coco", "sentence_compression"],
                   default="coco")
    p.add_argument("--ann_file", help="COCO captions annotation JSON")
    p.add_argument("--records_file",
                   help="sentence-compression records JSON/JSONL")
    p.add_argument("--output_root", required=True)
    p.add_argument("--dataset_name", default=None)
    p.add_argument("--chunk_dim", type=int, default=CHUNK_DIM)
    p.add_argument("--n_pos_examples", type=int, default=N_EXAMPLES)
    p.add_argument("--n_part_pos_examples", type=int, default=N_PART_EXAMPLES)
    p.add_argument("--start_chunk", type=int, default=0)
    p.add_argument("--last_chunk", type=int, default=None)
    p.add_argument("--part_pos_algorithm", default="adaptive_crop",
                   choices=["adaptive_crop", "adaptive_crop_augment", "llm",
                            "mock"])
    p.add_argument("--encoder_preset", default="minilm-l6")
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--seed", type=int, default=14)
    add_bool_flag(p, "augment", True, "augment lacking positive examples")
    add_bool_flag(p, "verbose_check", True,
                  "smoke-read samples across chunks after creation")
    add_device_flag(p)
    return p


def _encode_fn(args):
    """The embedder of positive mining: the port's ``SentenceEncoder`` with
    random-init weights from ``--seed`` on the device (no fused-layer flag
    is set, as in the JAX CLI, so it runs the encoder's ``nn.Module``
    path). → ``texts → (n, D) numpy``."""
    import torch

    from qst_tpu_torch.core.device import resolve_device
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params

    device = resolve_device(args.device)
    cfg = encoder_from_args(args.encoder_preset)
    tok = tokenizer_from_args(args.vocab_path, cfg.vocab_size)
    enc = SentenceEncoder(cfg, init_params(cfg, torch.Generator().manual_seed(args.seed),
                                           device=device), tok)
    return lambda texts: enc.encode(list(texts))


def verbose_check(root: str) -> None:
    """Cross-chunk sample reads exercising cache hits/misses/evictions
    (reference dataset/main.py:77-116)."""
    from qst_tpu_torch.data.quadruplet_dataset import QuadrupletDataset

    ds = QuadrupletDataset(root, cache_size=3)
    n = len(ds)
    pattern = [0, n // 2, n - 1, 0, n // 3, n - 1, 1]
    for idx in pattern:
        item = ds[idx % n]
        logger.info("sample %d: ref=%r (#pos=%d #part=%d)", idx,
                    item["reference"][:60], len(item["positive"]),
                    len(item["part_positive"]))
    logger.info("cache stats after check: %s", ds.cache_stats)


def main(argv=None) -> int:
    from qst_tpu_torch.core.device import resolve_device

    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    resolve_device(args.device)        # the card unless told otherwise
    dump_args(args, args.output_root)

    if args.dataset_type == "coco":
        if not args.ann_file:
            raise SystemExit("--ann_file is required for --dataset_type coco")
        from qst_tpu_torch.data.coco import CocoCaptionsSource, create_coco_dataset

        src = CocoCaptionsSource(
            args.ann_file, dataset_name=args.dataset_name or "CoCoCaptionDataset")
        last = create_coco_dataset(
            args.output_root, src, _encode_fn(args),
            start_chunk=args.start_chunk, last_chunk=args.last_chunk,
            chunk_dim=args.chunk_dim, n_pos_examples=args.n_pos_examples,
            n_part_pos_examples=args.n_part_pos_examples,
            augment=args.augment, part_pos_algorithm=args.part_pos_algorithm,
            seed=args.seed)
        root = f"{args.output_root}/{src.dataset_name}"
    else:
        if not args.records_file:
            raise SystemExit("--records_file is required for "
                             "--dataset_type sentence_compression")
        from qst_tpu_torch.data.sentence_compression import (
            create_dataset_sentence_compression,
        )

        with open(args.records_file) as f:
            text = f.read()
        records = (json.loads(text) if text.lstrip().startswith("[")
                   else [json.loads(line) for line in text.splitlines() if line])
        name = args.dataset_name or "sent_compr"
        last = create_dataset_sentence_compression(
            args.output_root, records, dataset_name=name,
            start_chunk=args.start_chunk, last_chunk=args.last_chunk,
            chunk_dim=args.chunk_dim, n_pos_examples=args.n_pos_examples,
            n_part_pos_examples=args.n_part_pos_examples, seed=args.seed)
        root = f"{args.output_root}/{name}"

    logger.info("last created chunk: %d", last)
    if last < args.start_chunk:
        logger.error("no chunks were created")
        return 1
    if args.verbose_check:
        verbose_check(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
