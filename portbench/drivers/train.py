"""Fine-tuning through the program's own loop: ``cli/train_main.py``'s
``build_trainer`` and ``Trainer.train``, at ``--use_fused_layer
--use_fused_loss_kernel --steps_per_call K`` with the default random
negatives, dropout, AdamW on warmuplinear and clip 1.0.

Set-up: the vocabulary, a quadruplet dataset and the weights file are
written from the seed into ``$TMPDIR``; ``build_trainer`` builds the miner,
the collator and the trainer from them (``--hf_checkpoint``: the weights the
benchmark made). The harness then hands the trainer three probes: its
``evaluator`` is the window's marks (called by ``Trainer.train`` on its
main thread every ``evaluation_steps`` steps, after the loop's own
synchronising read of the loss), the collator and its tokenizer are timed
and counted, and the multi-step call records the inputs, keys and losses of
its first calls and the state after them.

Window: from the first mark at or after ``warm_steps`` (the first call ran
eagerly and captured the graph) to the first mark ``--seconds`` later that
closes a whole number of ``period_steps`` — the miner refreshes its table
and an epoch ends once a period — where the mark stops training.
``train_quads_per_s`` counts the quadruplets of the window's steps over its
seconds.

Check: the reference follows two stretches of steps: the recorded first
calls from the seed's weights, and the call that starts after
``window_call_step`` steps, inside the window (past the miner's refresh, at
a learning rate hundreds of times the first steps'), from the program's
parameters and Adam moments before it. It uses the texts the collator
tokenized (its own tokenizer, its own padding) and the same dropout draws:
``token_mismatch`` counts ids that differ; ``loss_gap`` is the largest
relative gap of a step's loss (compared where the cell's file gives it a
limit, else printed); ``moment_gap`` and ``update_gap`` the
largest gap between the program's and the reference's norm of a tensor's
first Adam moment and of its change over the stretch, against the larger of
the reference's norm of it and of the median tensor's (``window_…``: the
same of the window's call). Tensors whose reference gradient is under a
thousandth of the median tensor's (the attention key bias, which softmax
ignores) move by rounding alone and are left out of ``update_gap``.
"""

from __future__ import annotations

import functools
import os
import shutil
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import data, program
from portbench.harness import (
    Check,
    Outcome,
    Run,
    TokenizerProbe,
    Window,
    free_program_memory,
    peak_memory,
    spanned,
)
from portbench.reference import train as ref_train
from portbench.reference.precision import strict_f32


class CollatorProbe:
    """Times each collation and counts its real tokens (the program's
    ``QuadrupletCollator`` inside; it runs on the prefetch thread)."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds: List[float] = []
        self.lengths: List[np.ndarray] = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, instances):
        t0 = time.perf_counter()
        with torch.profiler.record_function("portbench.collate"):
            batch = self.inner(instances)
        self.seconds.append(time.perf_counter() - t0)
        self.lengths.append(batch.attention_mask.reshape(-1, batch.attention_mask.shape[-1])
                            .sum(axis=1))
        return batch


def snapshot(state, second_moments: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """Copies of the parameters and Adam moments by name, made on the device
    in stream order (no wait); a moment never made reads as zeros."""
    opt = state.optimizer
    named = dict(state.model.named_parameters())

    def moment(p, name):
        m = opt.state[p].get(name)
        return torch.zeros_like(p) if m is None else m.detach().clone()

    out = {"params": {k: p.detach().clone() for k, p in named.items()},
           "mu": {k: moment(p, "mu") for k, p in named.items()}}
    if second_moments:
        out["nu"] = {k: moment(p, "nu") for k, p in named.items()}
        out["count"] = int(opt.param_groups[0]["count"])
    return out


class StepProbe:
    """Around the trainer's multi-step call: the first ``record`` calls'
    ids, masks, keys and losses, and after the last of them the state; and
    the call that starts after ``window_step`` steps (inside the window),
    with the state before and after it and its losses, read after the
    window."""

    def __init__(self, inner, record: int, window_step: int):
        self.inner, self.record, self.window_step = inner, record, window_step
        self.calls = 0
        self.inputs: List[tuple] = []
        self.losses: List[float] = []
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.window_call: Dict[str, object] = {}

    def __call__(self, state, input_ids, attention_mask, keys):
        n = self.calls
        self.calls += 1
        if n < self.record:
            self.inputs.append((np.array(input_ids), np.array(attention_mask),
                                keys.clone().cpu()))
        in_window = state.step == self.window_step
        if in_window:
            self.window_call = {"inputs": (np.array(input_ids), np.array(attention_mask),
                                           keys.detach().clone()),
                                "before": snapshot(state, second_moments=True)}
        state, losses = self.inner(state, input_ids, attention_mask, keys)
        if n < self.record:
            self.losses.extend(float(x) for x in losses.detach().cpu())
            if n == self.record - 1:
                self.state = snapshot(state)
        if in_window:
            self.window_call.update(after=snapshot(state), losses=losses.detach().clone())
        return state, losses


class Marks:
    """The trainer's evaluator: opens the window, then stops training at the
    first mark that has run ``seconds`` and a whole number of periods."""

    def __init__(self, run: Run, steps: StepProbe, window: Window, tracer, warm: int,
                 period: int, seconds: float):
        self.run, self.steps, self.window, self.tracer = run, steps, window, tracer
        self.warm, self.period, self.seconds = warm, period, seconds
        self.calls = 0
        self.seen: List[tuple] = []          # (step, host clock) at each mark
        self.start_step = self.end_step = None

    def __call__(self, model, epoch, steps):
        self.calls += 1
        self.seen.append((steps, time.perf_counter()))
        if self.end_step is not None:
            return float("-inf")
        if self.start_step is None:
            if steps >= self.warm and self.steps.calls >= self.steps.record:
                self.window.start()
                self.tracer.start()
                self.start_step = steps
        elif (steps - self.start_step) % self.period == 0 and \
                self.window.elapsed() >= self.seconds:
            self.window.stop()
            self.tracer.stop()
            self.end_step = steps
            return float("-inf")        # patience 1: the loop stops here
        return float(self.calls)


def run(run: Run) -> Outcome:
    from qst_tpu_torch.cli import train_main
    from qst_tpu_torch.train import trainer as trainer_module

    cfg, tr, dev, seed = run.cfg, run.traffic, run.device, run.seed
    run.phase("imports")
    tmp = data.scratch_dir("portbench_train_")
    lex = data.Lexicon(cfg["model_type"], cfg["vocab_size"], seed)
    vocab = lex.write(os.path.join(tmp, "vocab.txt"))
    root = os.path.join(tmp, "quadruplets")
    data.write_quadruplets(root, tr["instances"], lex, tr["lengths"], data.rng_of(seed, "quads"),
                           tr["positives"], tr["part_positives"], tr["chunk"])
    weights_path = os.path.join(tmp, "pytorch_model.bin")
    torch.save({k: v.cpu() for k, v in data.make_weights(cfg, seed, dev).items()}, weights_path)
    run.phase("lexicon, dataset, weights file")
    train_seed = data.sub_seed(seed, "train")
    K, B = tr["steps_per_call"], tr["batch_size"]
    argv = ["--dataset_root", root, "--experiment_dir", os.path.join(tmp, "run"),
            "--vocab_path", vocab, "--hf_checkpoint", weights_path,
            "--encoder_preset", cfg["preset"], "--max_seq_length", str(cfg["max_seq_length"]),
            "--use_fused_layer", "--use_fused_loss_kernel", "--steps_per_call", str(K),
            "--batch_size", str(B), "--epochs", str(tr["epochs"]),
            "--evaluation_steps", str(tr["evaluation_steps"]), "--checkpoint_save_steps", "0",
            "--no-save_best_model", "--early_stopping_patience", "1",
            "--hard_contrastive_mode", str(tr["hard_contrastive_mode"]),
            "--seed", str(train_seed), "--device", str(dev)]
    argv += [a for k, v in tr["recipe"].items()
             for a in (f"--{k}", str(v))]
    args = train_main.build_parser().parse_args(argv)
    if run.dry_run:   # the rehearsal's small encoder in place of the preset's
        made_cfg = train_main.encoder_from_args
        train_main.encoder_from_args = lambda *a, **kw: program.encoder_config(
            cfg, use_fused_layer=False)
        try:
            trainer = train_main.build_trainer(args)
        finally:
            train_main.encoder_from_args = made_cfg
    else:
        trainer = train_main.build_trainer(args)
    run.phase("build_trainer")
    differ = program.same_encoder(trainer.encoder_cfg, program.encoder_config(cfg))
    if differ:
        raise SystemExit(f"portbench: the trainer's encoder differs from the configuration in "
                         f"{differ}")
    collator = CollatorProbe(trainer.collator)
    first_steps, window_step = tr["recorded_calls"] * K, tr["window_call_step"]
    collator.inner.tokenizer = TokenizerProbe(     # one call a batch: a step's texts
        collator.inner.tokenizer,
        record=[*range(first_steps), *range(window_step, window_step + K)])
    trainer.collator = collator
    mining = trainer.dataset.miner.encode_fn.__self__      # the miner's own encoder
    miner_tok = mining.tokenizer = TokenizerProbe(mining.tokenizer)
    steps = StepProbe(None, record=tr["recorded_calls"], window_step=window_step)
    window, tracer = Window(run), run.tracer()
    period = tr["period_steps"]
    # a traced run closes at the first period's end
    marks = Marks(run, steps, window, tracer, tr["warm_steps"], period,
                  0.0 if run.trace else run.seconds)
    trainer.evaluator = marks
    made, prefetch = trainer_module.make_multi_step, trainer_module.PrefetchIterator

    def probed(*a, **kw):
        steps.inner = made(*a, **kw)
        return steps

    class Prefetch(prefetch):     # the main thread's wait for a batch, as a span
        __next__ = spanned(prefetch.__next__, "portbench.wait_batch")

    trainer_module.make_multi_step, trainer_module.PrefetchIterator = probed, Prefetch
    try:
        result = trainer.train(seed=train_seed)
    finally:
        trainer_module.make_multi_step, trainer_module.PrefetchIterator = made, prefetch
    if marks.end_step is None:
        raise SystemExit("portbench: training ended before the window closed "
                         f"(steps {marks.start_step}; add epochs or instances)")
    n_steps = marks.end_step - marks.start_step
    inside = [(k, t) for k, t in marks.seen if marks.start_step <= k <= marks.end_step]
    print("marks (steps: seconds since the window opened): " + " ".join(
        f"{k}:{t - inside[0][1]:.3f}" for k, t in inside), file=sys.stderr)
    quads = n_steps * B
    finite = all(bool(torch.isfinite(p).all()) for p in result.state.model.parameters())
    lo, hi = marks.start_step, marks.end_step
    S = cfg["max_seq_length"]
    t0, t1 = window.t0, window.t0 + window.seconds
    observed = {"lengths": np.concatenate(collator.lengths[lo:hi]),
                "slots": n_steps * 4 * B * S, "steps": n_steps,
                "collate_s": float(np.sum(collator.seconds[lo:hi])),
                "miner": miner_tok.between(t0, t1)}
    memory = peak_memory(run)
    total = trainer.total_steps
    recorded_texts = collator.inner.tokenizer.recorded
    state = steps.state
    del result, trainer, collator, mining, steps.inner
    free_program_memory(run)
    checks, control = judge(run, lex, recorded_texts, steps, state, train_seed, total)
    shutil.rmtree(tmp, ignore_errors=True)
    return Outcome(attempted=quads, failed=0 if finite else quads,
                   e2e={"train_quads_per_s": quads / window.seconds}, setup_s=window.setup_s,
                   memory_peak_bytes=memory, checks=checks, launched=window.launched,
                   observed=observed, trace=tracer.summary, control=control)


def relative_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], names) -> float:
    """max over ``names`` of |‖got‖ − ‖want‖| / max(‖want‖, the median ‖want‖)."""
    norms = {n: float(want[n].double().norm()) for n in got}
    median = float(np.median(list(norms.values())))
    worst = 0.0
    for n in names:
        g = float(got[n].double().norm())
        worst = max(worst, abs(g - norms[n]) / max(norms[n], median, 1e-30))
    return worst


def judge(run: Run, lex, texts, steps: StepProbe, state, train_seed: int, total: int):
    """The reference follows the recorded steps → (checks, control readings).

    Two stretches are compared: the first calls, from the seed's weights
    and fresh moments, and the window's call at ``window_call_step``, from
    the program's parameters and moments before it (the reference cannot
    follow the window's hundreds of steps itself in the time a run has)."""
    cfg, tr, dev = run.cfg, run.traffic, run.device
    S = cfg["max_seq_length"]
    mismatch = 0

    def batches_of(calls, first_step):
        """(ids, mask, step) a step from the reference tokenizer on the texts
        the collator tokenized, counting where they or the keys differ."""
        nonlocal mismatch
        out, step_no = [], first_step
        for ids, mask, keys in calls:
            for j in range(ids.shape[0]):
                four, B, _ = ids[j].shape
                want_ids, want_mask = lex.tokenizer.batch(texts.get(step_no, []), S)
                if want_ids.shape != (four * B, S):
                    mismatch += ids[j].size
                    step_no += 1
                    continue
                mismatch += int((want_ids != ids[j].reshape(four * B, S)).sum()
                                + (want_mask != mask[j].reshape(four * B, S)).sum())
                step_no += 1
                out.append((torch.from_numpy(want_ids.reshape(four, B, S)).to(dev),
                            torch.from_numpy(want_mask.reshape(four, B, S)).to(dev), step_no))
                if int(keys[j][0]) != train_seed or int(keys[j][1]) != step_no:
                    mismatch += 1       # the steps' dropout draws are not (seed, 1, 2, …)
        return out

    first = batches_of(steps.inputs, 0)
    win = steps.window_call
    window = []
    if win:
        ids, mask, keys = win["inputs"]
        window = batches_of([(ids, mask, keys.cpu())], tr["window_call_step"])
    w0 = data.make_weights(cfg, run.seed, dev)
    recipe = dict(tr["recipe"], dropout_block=tr["dropout_block"])

    def readings(losses, mu, params, reference, start_params):
        want = np.array(reference.losses)
        loss_gap = float(np.max(np.abs(np.array(losses) - want) / np.abs(want)))
        grads = reference.first_grads
        median = float(np.median([float(g.norm()) for g in grads.values()]))
        moving = [n for n, g in grads.items() if float(g.norm()) >= 1e-3 * median]
        moment = relative_gaps(mu, reference.mu, list(grads))
        update = relative_gaps({n: params[n] - start_params[n] for n in grads},
                               {n: reference.params[n].detach() - start_params[n]
                                for n in grads}, moving)
        return loss_gap, moment, update

    stretches = [("", w0, None, first, (steps.losses, state.get("mu"), state.get("params")))]
    if win and len(window) == tr["steps_per_call"]:
        before, after = win["before"], win["after"]
        stretches.append(("window_", before["params"],
                          (before["mu"], before["nu"], before["count"]), window,
                          ([float(x) for x in win["losses"].cpu()], after["mu"],
                           after["params"])))
    values, control = {}, {}
    names = ("loss_gap", "moment_gap", "update_gap")
    with strict_f32():
        for prefix, start_params, start, batches, (losses, mu, params) in stretches:
            if not batches or mu is None:
                continue
            ref_run = functools.partial(ref_train.run_steps, cfg, recipe, start_params, total,
                                        batches, train_seed, start=start)
            reference = ref_run()
            values.update(zip((prefix + n for n in names),
                              readings(losses, mu, params, reference, start_params)))
            if run.control:   # the reference in the program's place, its products in fp8
                low = ref_run(precision="fp8")
                control.update(zip((prefix + n for n in names), readings(
                    low.losses, low.mu, {n: p.detach() for n, p in low.params.items()},
                    reference, start_params)))
                # a planted fault read at the cell's size: half of each batch left out
                half = ref_run(half_batch=True)
                control.update(zip((f"half_batch:{prefix}{n}" for n in names), readings(
                    half.losses, half.mu, {n: p.detach() for n, p in half.params.items()},
                    reference, start_params)))
    # a reading without a limit in the cell's file is printed, not compared
    limits = run.cell.spec["limits"]
    for name, value in values.items():
        if name not in limits:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    checks = [Check("token_mismatch", float(mismatch), 0.0)]
    checks += [Check(prefix + n, values.get(prefix + n, float("inf")), run.limit(prefix + n))
               for prefix in ("", "window_") for n in names if prefix + n in limits]
    want_steps = tr["recorded_calls"] * tr["steps_per_call"] + tr["steps_per_call"]
    checks.append(Check("steps_compared_short",
                        float(max(0, want_steps - len(first) - len(window))), 0.0))
    return checks, control
