"""Times of the serving paths with and without a mesh on one card, for
comparing two trees in one call:

    python3 -m qst_tpu_torch.experiments.mesh_times [--out PATH]

Run it from each tree's root in turns (parent, change, change, parent). It
times, with CUDA events, the unsharded paths — exact search over 1M × 384
(bf16 at Q = 4,096 and 256, int8 at 4,096), IVF over 1,024 cells of 2,048 ×
384 bf16 (Q = 256 / 64 / 8, n_probe 8), the streamed index over 2^20 host
rows in tiles of 2^19 (Q = 256), and the MiniLM-L6 encode of a batch of
256 × 128 through K1 — and, where the tree has ``core/meshes.py``, the same
calls on a 4 × 2 mesh of eight positions of the card: the cost of the shard
structure on one card, not scaling. Prints the card's name and power limit
and one JSON object (ms; QPS or sentences/s); ``--out`` writes it too.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _mesh():
    try:
        from qst_tpu_torch.core.meshes import make_mesh
    except ImportError:          # a tree from before the meshes
        return None
    return make_mesh(4, 2, devices=["cuda:0"] * 8)


def _pair(out: dict, name: str, build, call, reps: int, per_call: int, mesh) -> None:
    """Time ``call(index)`` for the unsharded index and, with a mesh, the
    sharded one, in turns."""
    made = {"plain": build(None)}
    if mesh is not None:
        made["sharded"] = build(mesh)
    for who in ("plain", "sharded", "sharded", "plain"):
        if who in made:
            ms = cuda_ms(lambda: call(made[who]), reps)
            best = min(out.get(f"{name}_{who}_ms", ms), ms)
            out[f"{name}_{who}_ms"] = best
            out[f"{name}_{who}_per_s"] = per_call / best * 1e3
    del made
    torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from qst_tpu_torch.core.config import EncoderConfig
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
    from qst_tpu_torch.models.tokenizer import HashTokenizer
    from qst_tpu_torch.retrieval import ExactIndex, IVFIndex, StreamingExactIndex

    mesh = _mesh()
    kw = lambda m: {} if m is None else {"mesh": m}  # noqa: E731
    out: dict = {"sharded": mesh is not None}
    gen = torch.Generator(device="cuda").manual_seed(71)
    unit = torch.nn.functional.normalize
    N, D, k = 1 << 20, 384, 10
    rows = unit(torch.randn((N, D), device="cuda", generator=gen), dim=1)
    queries = unit(torch.randn((4096, D), device="cuda", generator=gen), dim=1)
    for dtype, Q in (("bfloat16", 4096), ("bfloat16", 256), ("int8", 4096)):
        q = queries[:Q]
        _pair(out, f"exact_{dtype}_q{Q}", lambda m: ExactIndex(rows, dtype=dtype, **kw(m)),
              lambda idx: idx._device_search(q, k, "dot_score", 131072, "auto"), 10, Q, mesh)

    # IVF: 1,024 cells of 2,048 x 384 bf16 around random centroids
    C, L, P = 1024, 2048, 8
    centroids = unit(torch.randn((C, D), device="cuda", generator=gen), dim=1)
    fill = torch.randint(0, L + 1, (C,), device="cuda", generator=gen, dtype=torch.int32)
    cells = torch.zeros((C, L, D), dtype=torch.bfloat16, device="cuda")
    for c0 in range(0, C, 64):
        x = centroids[c0:c0 + 64, None, :] + 0.3 * torch.randn((64, L, D), device="cuda",
                                                               generator=gen)
        live = torch.arange(L, device="cuda")[None, :] < fill[c0:c0 + 64, None]
        cells[c0:c0 + 64] = torch.where(live[..., None], unit(x, dim=2), 0).to(torch.bfloat16)
    slot = torch.arange(L, device="cuda")[None, :]
    first = torch.cumsum(fill, 0) - fill
    cell_ids = torch.where(slot < fill[:, None], first[:, None] + slot, -1).to(torch.int32)
    for Q in (256, 64, 8):
        pick = torch.randint(0, C, (Q,), device="cuda", generator=gen)
        q = unit(centroids[pick] + 0.3 * torch.randn((Q, D), device="cuda", generator=gen), dim=1)
        _pair(out, f"ivf_q{Q}",
              lambda m: IVFIndex.from_arrays(centroids, cells, cell_ids, fill, **kw(m)),
              lambda idx: idx._device_search(q, k, P, "auto"), 20, Q, mesh)
    del cells, cell_ids

    host = rows.cpu().numpy()
    q = queries[:256]
    _pair(out, "streaming_q256",
          lambda m: StreamingExactIndex(host, tile_rows=1 << 19, device="cuda", **kw(m)),
          lambda idx: idx.search(q, k=k), 2, 256, mesh)
    del host, rows

    cfg = EncoderConfig.minilm_l6(use_fused_layer=True)
    params = init_params(cfg, torch.Generator().manual_seed(72), device="cuda")
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    rng = np.random.default_rng(73)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 5000, rng.integers(4, 40)))
             for _ in range(256)]
    ids, mask = tok.batch_encode(texts, max_length=128)
    ids = torch.from_numpy(ids.astype(np.int64)).cuda()
    mask = torch.from_numpy(mask.astype(np.int64)).cuda()
    _pair(out, "encode_b256",
          lambda m: SentenceEncoder(cfg, params, tok, **({} if m is None else {"mesh": m})),
          lambda enc: enc.encode_ids(ids, mask), 10, 256, mesh)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    out["at"] = time.strftime("%H:%M:%S")
    print(out["card"])
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
