"""Times of the long-document path (``use_flash_attention``: K7 and K8) on
a GPU, to compare two trees of the repository in turns.

    python3 -m qst_tpu_torch.experiments.flash_times     # from a tree's root

Prints one JSON object: K7 at (64, 12, 512, 32) and (256, 12, 512, 32) and K8
at (64, 12, 512, 32) and (32, 12, 512, 32), bf16, on the encoder's (B, S, nh,
hd) activations seen as (B, nh, S, hd), with segment ids as the encoder
makes them from its masks — padded rows (``padded``), and every row real
(``real``) — in ms by CUDA events; MiniLM-L6 encode sentences/s at B = 256,
S = 256 and 512; one flash train step (8 quadruplets = 32 sequences of
S = 512, bf16, hidden dropout 0.1, attention dropout 0) in ms, by CUDA events
and as its kernels' device time from torch.profiler. Weights, ids
and activations are random from fixed seeds. It calls only APIs that have
existed since the flash path was ported, so the file copied into an older
tree times that tree's kernels: run parent, change, change, parent one
after another on one card and compare within that run.
"""

from __future__ import annotations

import json
import time

import torch

from qst_tpu_torch.core.config import EncoderConfig, LossConfig, TrainConfig
from qst_tpu_torch.models.sentence_encoder import SentenceEncoder, init_params
from qst_tpu_torch.models.tokenizer import HashTokenizer
from qst_tpu_torch.ops import flash_attention as fa
from qst_tpu_torch.train import create_train_state, dropout_key, make_train_step

NH, HD = 12, 32


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
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


def segments(B: int, S: int, gen: torch.Generator, kind: str) -> torch.Tensor:
    """(B, S) int32 ids on the GPU: ``padded`` — sequence 0 all real, 1
    padded after two thirds, 2 all padding, the rest random lengths from
    S/4 up; ``real`` — every position real."""
    if kind == "real":
        return torch.ones((B, S), dtype=torch.int32, device="cuda")
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen)
    lens[0], lens[1], lens[2] = S, 2 * S // 3, 0
    return (torch.arange(S)[None, :] < lens[:, None]).to(torch.int32).cuda()


def kernel_times(gen: torch.Generator, reps: int) -> dict:
    out = {}
    S, sc = 512, HD ** -0.5
    for B, which in ((64, "K7 K8"), (256, "K7"), (32, "K8")):
        q, k, v, do = (torch.randn((B, S, NH, HD), generator=gen).to("cuda", torch.bfloat16)
                       .transpose(1, 2) for _ in range(4))
        for kind in ("padded", "real"):
            seg = segments(B, S, gen, kind)
            o, m, l = fa.flash_attention(q, k, v, seg, seg, sc, return_stats=True)
            if "K7" in which:
                out[f"K7 {B}x{S} {kind}"] = cuda_ms(
                    lambda: fa.flash_attention(q, k, v, seg, seg, sc), reps)
            if "K8" in which:
                out[f"K8 {B}x{S} {kind}"] = cuda_ms(
                    lambda: fa.flash_attention_bwd(q, k, v, seg, seg, o, m, l, do, sc), reps)
        del q, k, v, do, o, m, l
        torch.cuda.empty_cache()
    return out


def encode_rates(gen: torch.Generator, reps: int) -> dict:
    cfg = EncoderConfig.minilm_l6(use_flash_attention=True, max_seq_length=512)
    params = init_params(cfg, torch.Generator().manual_seed(41), device="cuda")
    enc = SentenceEncoder(cfg, params, HashTokenizer(vocab_size=cfg.vocab_size), device="cuda")
    out = {}
    for S in (256, 512):
        ids = torch.randint(5, cfg.vocab_size, (256, S), generator=gen).cuda()
        mask = segments(256, S, gen, "padded").long()
        mask[2, 0] = 1                       # the encoder's pad-row rule: never all zero
        out[f"encode S={S} sentences/s"] = 256e3 / cuda_ms(lambda: enc.encode_ids(ids, mask),
                                                           reps)
    return out


def train_step_ms(gen: torch.Generator, reps: int) -> dict:
    enc_cfg = EncoderConfig.minilm_l6(use_flash_attention=True, max_seq_length=512,
                                      attention_dropout=0.0)
    loss_cfg = LossConfig(kind="gamma", use_fused_kernel=True)
    state, _ = create_train_state(enc_cfg, TrainConfig(batch_size=8),
                                  torch.Generator().manual_seed(36), 1000, loss_cfg,
                                  device="cuda")
    step = make_train_step(enc_cfg, loss_cfg)
    S = 512
    ids = torch.randint(5, enc_cfg.vocab_size, (4, 8, S), generator=gen).cuda()
    mask = segments(32, S, gen, "padded").long().reshape(4, 8, S)
    mask[..., 0] = 1
    n = [0]

    def one():
        n[0] += 1
        step(state, ids, mask, dropout_key(7, n[0]))

    out = {"flash train step ms": cuda_ms(one, reps)}
    out.update(step_device_ms(one, reps))
    return out


def step_device_ms(fn, reps: int) -> dict:
    """Device time of one call of ``fn`` (its kernels' durations summed, from
    torch.profiler over ``reps`` calls), which the host's gaps between
    launches do not move, and the kernel records a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("Optimizer.")]
    return {"flash train step device ms": sum(e.time_range.elapsed_us() for e in kernels)
            / 1e3 / reps, "flash train step kernels": len(kernels) / reps}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU: this script times the CUDA kernels")
    gen = torch.Generator().manual_seed(40)
    t0 = time.perf_counter()
    out = {"device": torch.cuda.get_device_name(0)}
    out.update(kernel_times(gen, 20))
    out.update(encode_rates(gen, 5))
    out.update(train_step_ms(gen, 10))
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
