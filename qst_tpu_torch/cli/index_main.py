"""``python -m qst_tpu_torch.cli.index_main`` — retrieval-index CLI,
counterpart of ``qst_tpu/cli/index_main.py``.

Build a persistent embedding index from a chunked quadruplet dataset or a
plain text file (one doc per line), then query or serve it. Everything runs
on the GPU unless ``--device`` names another device.

  # build (encodes docs; saves the index + ids + docs)
  python -m qst_tpu_torch.cli.index_main build --texts docs.txt --index_dir idx \
      --encoder_preset minilm-l6 --model_path trained/exp1 --use_fused_layer \
      --index_dtype ivf --ivf_clusters 256 --ivf_probe 8

  # query (reloads without re-encoding the corpus)
  python -m qst_tpu_torch.cli.index_main query --index_dir idx --index_dtype ivf \
      --k 5 --queries "a cat on a mat" "a dog in a park"

  # serve over HTTP (POST /search, POST /encode, GET /healthz; --updatable
  # adds POST/DELETE /docs)
  python -m qst_tpu_torch.cli.index_main serve --index_dir idx --index_dtype ivf --port 8080

``--index_dtype pq`` (``--pq_m`` bytes a doc, exact re-rank from host
rows), ``ivfpq`` (``--ivfpq_bits`` 8 or 4) and ``streaming`` (the embeddings
written to a memmap as they are encoded, then streamed from disk) build and
serve as the other kinds do.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from qst_tpu_torch.cli.common import (
    add_device_flag,
    dump_args,
    encoder_from_args,
    load_best_params,
    tokenizer_from_args,
)

logger = logging.getLogger("qst_tpu_torch.cli.index")

_INDEX_KINDS = ["float32", "bfloat16", "int8", "pq", "ivf", "ivfpq", "streaming"]
_INDEX_DTYPE_HELP = (
    "index storage dtype/kind: bfloat16 scores on the tensor cores; int8 "
    "halves the memory again (quantized-exact ranking); ivf is the "
    "approximate k-means-cell index (n_probe cells scanned per query); "
    "pq stores m bytes/doc (16x smaller than bf16 at m=48) with exact "
    "re-rank from host-resident rows; ivfpq holds PQ codes inside IVF cells "
    "— m bytes/doc and only probed cells decode per query; streaming keeps "
    "the embeddings on disk and streams them through the device")


def _add_encoder_flags(p: argparse.ArgumentParser, model_path_help: str = None) -> None:
    p.add_argument("--encoder_preset", default="minilm-l6")
    p.add_argument("--vocab_path", default=None)
    p.add_argument("--model_path", default=None, help=model_path_help)
    p.add_argument("--seed", type=int, default=14)
    p.add_argument("--use_fused_layer", action=argparse.BooleanOptionalAction,
                   default=False, help="encode through the fused per-layer "
                   "CUDA kernel (the GPU inference path)")
    add_device_flag(p)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="encode docs and persist an index")
    b.add_argument("--texts", help="plain text file, one document per line")
    b.add_argument("--dataset_root",
                   help="chunked quadruplet dataset (uses all captions)")
    b.add_argument("--index_dir", required=True)
    b.add_argument("--index_dtype", default="float32", choices=_INDEX_KINDS,
                   help=_INDEX_DTYPE_HELP)
    b.add_argument("--pq_m", type=int, default=48,
                   help="PQ subspaces (= bytes/doc) for --index_dtype pq")
    b.add_argument("--ivf_clusters", type=int, default=256,
                   help="k-means cells for --index_dtype ivf")
    b.add_argument("--ivf_probe", type=int, default=8,
                   help="cells scanned per query for --index_dtype ivf "
                   "(persisted as the index default)")
    b.add_argument("--ivfpq_bits", type=int, default=8, choices=[4, 8],
                   help="code width for --index_dtype ivfpq: 8 = one "
                   "256-way subspace per byte, 4 = two packed 16-way "
                   "nibble subspaces per byte")
    b.add_argument("--batch_size", type=int, default=256)
    _add_encoder_flags(b, "experiment dir with a trained best checkpoint")

    s = sub.add_parser("serve", help="serve a persisted index over HTTP "
                       "(POST /search, POST /encode, GET /healthz; "
                       "dynamic micro-batching across concurrent requests)")
    s.add_argument("--index_dir", required=True)
    s.add_argument("--index_dtype", default="float32", choices=_INDEX_KINDS,
                   help=_INDEX_DTYPE_HELP)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--max_batch", type=int, default=256)
    s.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="dynamic-batching straggler window")
    s.add_argument("--workers", type=int, default=2,
                   help="batcher completer threads; >1 keeps a second "
                   "batch in flight so host transfers overlap device "
                   "compute")
    s.add_argument("--updatable", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="serve a mutable corpus: load the index into a "
                   "fixed-capacity UpdatableIndex so POST/DELETE /docs "
                   "add/remove documents online (requires docs.json in "
                   "the index dir; cos/dot scores only)")
    s.add_argument("--capacity", type=int, default=0,
                   help="updatable buffer capacity (default: 2x the "
                   "loaded corpus, min 65536)")
    _add_encoder_flags(s)

    q = sub.add_parser("query", help="search a persisted index")
    q.add_argument("--index_dir", required=True)
    q.add_argument("--index_dtype", default="float32", choices=_INDEX_KINDS,
                   help=_INDEX_DTYPE_HELP)
    q.add_argument("--queries", nargs="+", required=True)
    q.add_argument("--k", type=int, default=10)
    _add_encoder_flags(q)
    return p


def _encoder(args):
    import torch

    from qst_tpu_torch.core.device import resolve_device
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params

    device = resolve_device(args.device)
    cfg = encoder_from_args(args.encoder_preset,
                            use_fused_layer=args.use_fused_layer)
    tok = tokenizer_from_args(args.vocab_path, cfg.vocab_size)
    if args.model_path:
        params = load_best_params(args.model_path)
    else:
        params = init_params(cfg, torch.Generator().manual_seed(args.seed), device=device)
    return SentenceEncoder(cfg, params, tok, device=device)


def serving_retriever(args):
    """The retriever the ``serve`` command serves: the encoder, the index
    loaded from ``--index_dir`` and, with ``--updatable``, converted to an
    updatable one."""
    from qst_tpu_torch.retrieval import Retriever

    retriever = Retriever(_encoder(args),
                          index_dtype=args.index_dtype).load(args.index_dir)
    if args.updatable:
        retriever.to_updatable(capacity=args.capacity)
        logger.info("updatable serving: capacity %d (POST/DELETE /docs "
                    "enabled)", retriever.index.capacity)
    return retriever


def serving_server(args, retriever):
    """The ``serve`` command's ``RetrievalServer`` (not yet started)."""
    from qst_tpu_torch.serve import RetrievalServer

    return RetrievalServer(
        retriever, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3,
        workers=args.workers)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)

    from qst_tpu_torch.retrieval import Retriever

    if args.command == "build":
        if bool(args.texts) == bool(args.dataset_root):
            raise SystemExit("give exactly one of --texts / --dataset_root")
        if args.texts:
            with open(args.texts) as f:
                docs = [line.rstrip("\n") for line in f if line.strip()]
        else:
            from qst_tpu_torch.data.chunks import ChunkStore

            docs = ChunkStore(args.dataset_root).all_positive_captions()
        if not docs:
            raise SystemExit("no documents to index")
        retriever = Retriever(_encoder(args),
                              index_dtype=args.index_dtype,
                              pq_m=args.pq_m,
                              ivf_clusters=args.ivf_clusters,
                              ivf_probe=args.ivf_probe,
                              ivfpq_bits=args.ivfpq_bits)
        if args.index_dtype == "streaming":
            # the embedding matrix never exists whole in host or device
            # memory: it is written to disk as it is encoded
            retriever.build_to_disk(docs, args.index_dir)
        else:
            retriever.build(docs)
            retriever.save(args.index_dir)
        dump_args(args, args.index_dir)
        logger.info("indexed %d docs into %s", len(docs), args.index_dir)
        return 0

    if args.command == "serve":
        retriever = serving_retriever(args)
        server = serving_server(args, retriever)
        port = server.start()
        logger.info("serving %d docs on http://%s:%d (POST /search, "
                    "POST /encode, GET /healthz)",
                    retriever.index.n_docs, args.host, port)
        try:
            import threading

            threading.Event().wait()  # run until interrupted
        except KeyboardInterrupt:
            logger.info("shutting down")
        finally:
            server.stop()
        return 0

    retriever = Retriever(_encoder(args),
                          index_dtype=args.index_dtype).load(args.index_dir)
    hits = retriever.search(list(args.queries), k=args.k, return_texts=True)
    for query, row in zip(args.queries, hits):
        print(json.dumps({
            "query": query,
            "hits": [{"id": h[0], "score": round(h[1], 4), "text": h[2]}
                     for h in row],
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
