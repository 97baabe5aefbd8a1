"""The quadruplet-vs-triplet ablation through both packages from one init.

Runs ``benchmarks/ablation_quadruplet_vs_triplet.py`` (the JAX package, as
is, in a subprocess) and ``qst_tpu_torch.experiments.ablation.run`` with
both of the port's arms started from the JAX script's own init
(``init_params(cfg, jax.random.key(14))`` carried over by
``state_dict_from_flax_params``). Data, mining, the evaluation sets and the
init are then the same on both sides; only the dropout draws and the
arithmetic's order differ. Prints each side's table and the 2,000-step
quality bars of ``qst_tpu_torch.experiments.ablation.quality_bars`` held
against each, then one JSON line with both results.

    JAX_PLATFORMS=cpu python tests/ablation_witness.py --steps 500 --wordpiece

On the CPU both sides take the plain paths (no fused layer), so the Pallas
kernels are not run in interpret mode; ``--use_fused_layer`` passes through
to the port only (its kernels' plain versions on the CPU).

The sides also run apart: ``--side jax`` alone; ``--save_init F`` writes
the JAX init (for ``--vocab_size``, 384 with ``--wordpiece`` at the default
``--n_images``) as a ``torch.save`` state dict, and ``--side port --init F
--device cuda`` trains the port's arms from it where JAX is not installed:

    JAX_PLATFORMS=cpu python tests/ablation_witness.py --save_init init.pt
    python tests/ablation_witness.py --side port --init init.pt --device cuda \
        --steps 2000 --wordpiece --use_fused_layer --steps_per_call 4

``--step_parity N`` compares N train steps of the two packages at the
ablation's shapes from that init (dropout 0, both loss kinds).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

JAX_SCRIPT = os.path.join(ROOT, "benchmarks", "ablation_quadruplet_vs_triplet.py")


def jax_init(cfg) -> dict:
    """cfg (the port's) → the JAX script's init as the port's state dict."""
    import jax

    from qst_tpu.core import config as jc
    from qst_tpu.models.sentence_encoder import init_params
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params

    jcfg = jc.EncoderConfig(**{f: getattr(cfg, f) for f in jc.EncoderConfig.__dataclass_fields__
                               if f != "use_fused_layer"})
    return state_dict_from_flax_params(init_params(jcfg, jax.random.key(14)), cfg)


def init_fn_for(args):
    """The port side's ``init_fn``: the JAX init, or ``--init``'s file."""
    if args.init is None:
        return jax_init

    def from_file(cfg):
        import torch

        sd = torch.load(args.init, map_location="cpu")
        have = tuple(sd["embeddings.word_embeddings.weight"].shape)
        if have != (cfg.vocab_size, cfg.hidden_size):
            raise ValueError(f"{args.init} holds a {have} embedding table, the run needs "
                             f"{(cfg.vocab_size, cfg.hidden_size)}")
        return sd
    return from_file


def step_parity(preset: str, kind: str, steps: int, seed: int = 5) -> dict:
    """The ablation's train step (S = 32, the WordPiece table of 384 rows,
    batch 32 quadruplets, lr 5e-5 warming up over 50 of 2,000 steps, dropout
    0) through both packages from the JAX init, on the same padded batches:
    → per-step losses, and the port's update against JAX's over ``steps``
    (cosine, norm ratio, relative distance)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from qst_tpu.core import config as jc
    from qst_tpu.models.sentence_encoder import init_params
    from qst_tpu.train import train_step as jts
    from qst_tpu_torch.core import config as tc
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
    from qst_tpu_torch.train import train_step as tts

    jcfg = getattr(jc.EncoderConfig, preset)(max_seq_length=32, vocab_size=384,
                                             hidden_dropout=0.0, attention_dropout=0.0)
    jl = jc.LossConfig(kind=kind, margin_pos_part=0.5, margin_part_neg=0.5)
    jt = jc.TrainConfig(batch_size=32, learning_rate=5e-5, scheduler="warmuplinear",
                        warmup_steps=50)
    tcfg, tl, tt = (cls(**dataclasses.asdict(c)) for cls, c in
                    ((tc.EncoderConfig, jcfg), (tc.LossConfig, jl), (tc.TrainConfig, jt)))
    params = jax.tree.map(np.asarray, init_params(jcfg, jax.random.key(14)))
    init = state_dict_from_flax_params(params, tcfg)
    sj, tx = jts.create_train_state(jcfg, jt, jax.random.key(0), 2000, jl, initial_params=params)
    step_j = jts.make_train_step(jcfg, jl, tx)
    st, _ = tts.create_train_state(tcfg, tt, torch.Generator().manual_seed(0), 2000, tl,
                                   initial_params=init, device="cpu")
    step_t = tts.make_train_step(tcfg, tl)
    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        lens = rng.integers(8, 20, (4, 32, 1))
        mask = (np.arange(32)[None, None, :] < lens).astype(np.int32)
        ids = rng.integers(5, 384, (4, 32, 32)).astype(np.int32) * mask
        sj, lj = step_j(sj, jnp.asarray(ids), jnp.asarray(mask), jax.random.key(1))
        st, lt = step_t(st, ids, mask, None)
        losses.append((float(lj), float(lt)))
    want = state_dict_from_flax_params(jax.tree.map(np.asarray, sj.params), tcfg)
    got = st.model.state_dict()
    dot = lambda a, b: sum(float((a[k] * b[k]).sum()) for k in want)  # noqa: E731
    du_j = {k: want[k] - init[k] for k in want}
    du_t = {k: got[k] - init[k] for k in want}
    diff = {k: got[k] - want[k] for k in want}
    nj, nt = dot(du_j, du_j) ** 0.5, dot(du_t, du_t) ** 0.5
    return {"losses": losses, "cosine": dot(du_t, du_j) / (nt * nj),
            "norm_ratio": nt / nj, "relative_distance": dot(diff, diff) ** 0.5 / nj}


def jax_args(args) -> list:
    out = ["--steps", str(args.steps), "--n_images", str(args.n_images),
           "--n_eval", str(args.n_eval), "--batch", str(args.batch), "--lr", str(args.lr),
           "--preset", args.preset]
    return out + (["--wordpiece"] if args.wordpiece else [])


def start_jax(args, log_path: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    with open(log_path, "w") as log:
        return subprocess.Popen([sys.executable, JAX_SCRIPT, *jax_args(args)],
                                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)


def jax_results(log_path: str) -> dict:
    with open(log_path) as f:
        lines = f.read().splitlines()
    line = next((ln for ln in lines if ln.startswith('{"metric"')), None)
    if line is None:
        raise RuntimeError("the JAX script printed no result:\n" + "\n".join(lines[-30:]))
    return json.loads(line)["results"]


def port_results(args) -> dict:
    from qst_tpu_torch.experiments import ablation as abl

    flags = jax_args(args) + ["--device", args.device,
                              "--steps_per_call", str(args.steps_per_call)]
    pargs = abl.build_parser().parse_args(
        flags + (["--use_fused_layer"] if args.use_fused_layer else []))
    with tempfile.TemporaryDirectory(prefix="ablation_witness_") as work:
        return abl.run(pargs, work, init_fn=init_fn_for(args))["results"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--n_images", type=int, default=4000)
    ap.add_argument("--n_eval", type=int, default=600)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--preset", default="minilm_l6", choices=["minilm_l6", "tiny"])
    ap.add_argument("--wordpiece", action="store_true")
    ap.add_argument("--use_fused_layer", action="store_true",
                    help="the port's arms through the fused layer and loss (plain versions)")
    ap.add_argument("--steps_per_call", type=int, default=1)
    ap.add_argument("--side", default="both", choices=["both", "jax", "port"])
    ap.add_argument("--device", default="cpu", help="the port side's device")
    ap.add_argument("--init", default=None,
                    help="the port side's init from this file (--save_init's) instead of JAX")
    ap.add_argument("--save_init", default=None,
                    help="write the JAX init for --preset and --vocab_size here, then exit")
    ap.add_argument("--vocab_size", type=int, default=384)
    ap.add_argument("--step_parity", type=int, default=0,
                    help="compare this many train steps of both packages (step_parity), "
                    "both loss kinds, then exit")
    ap.add_argument("--log", default=None,
                    help="the JAX script's output (default: a temporary file)")
    return ap


def main(argv=None) -> dict:
    from qst_tpu_torch.experiments import ablation as abl

    args = build_parser().parse_args(argv)
    if args.step_parity:
        out = {kind: step_parity(args.preset, kind, args.step_parity)
               for kind in ("gamma", "triplet")}
        print(json.dumps(out))
        return out
    if args.save_init:
        import torch

        from qst_tpu_torch.core.config import EncoderConfig

        cfg = getattr(EncoderConfig, args.preset)(max_seq_length=32,
                                                  vocab_size=args.vocab_size)
        torch.save(jax_init(cfg), args.save_init)
        return {}
    log = args.log or tempfile.mkstemp(prefix="ablation_jax_", suffix=".log")[1]
    t0 = time.perf_counter()
    proc = start_jax(args, log) if args.side != "port" else None
    out = {"steps": args.steps, "preset": args.preset, "wordpiece": args.wordpiece,
           "use_fused_layer": args.use_fused_layer}
    try:
        if args.side != "jax":
            out["port"] = port_results(args)
    finally:
        rc = proc.wait() if proc is not None else 0
    if rc != 0:
        raise RuntimeError(f"the JAX script exited {rc}; its output is in {log}")
    if proc is not None:
        out["jax"] = jax_results(log)
    out["seconds"] = round(time.perf_counter() - t0, 1)
    for side in ("jax", "port"):
        if side not in out:
            continue
        print(f"--- {side} (init: jax.random.key(14))")
        print(abl.markdown_table(out[side], with_jax=False, side=side))
        failed = abl.quality_bars(out[side])
        print("quality bars: " + ("all hold" if not failed else "; ".join(failed)))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
