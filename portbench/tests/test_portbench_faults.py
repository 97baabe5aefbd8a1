"""Each cell's check against a broken timed path, and against the control.

The rehearsal skips the look for a card and runs the rest of a run at the
cell's small sizes on the CPU, with one fault planted in the program under
it; ``correct`` must come out false. The control (the reference with its
products in fp8 put in the program's place) must fail one of the cell's
numbers: on the CPU at the small sizes, and on the card at the cell's own
size (``test_control_fails_at_the_cells_size``)."""

from __future__ import annotations

import contextlib
import io
import json
import os

import pytest
import torch

from portbench_rehearsal import CELLS, ROOT, rehearse


def altered_tokens(monkeypatch):
    """A token altered where the tokenizer produces it: each text's first."""
    from qst_tpu_torch.models.tokenizer import WordPieceTokenizer
    from qst_tpu_torch.native.fast_wordpiece import FastWordPieceTokenizer

    for cls in (WordPieceTokenizer, FastWordPieceTokenizer):
        made = cls.batch_encode

        def broken(self, texts, max_length=128, *a, _made=made, **kw):
            ids, mask = _made(self, texts, max_length, *a, **kw)
            ids = ids.copy()
            ids[:, 1] = ids[:, 1] + 1
            return ids, mask

        monkeypatch.setattr(cls, "batch_encode", broken)


def unchanged_state(monkeypatch):
    """A step that returns its state unchanged."""
    from qst_tpu_torch.train.train_step import ClippedAdamW

    monkeypatch.setattr(ClippedAdamW, "apply_row", lambda self, row: None)


def half_the_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from qst_tpu_torch.train import train_step

    made = train_step.loss_from_config

    def broken(*a, **kw):
        fn = made(*a, **kw)
        return lambda *embs: fn(*[e[: e.shape[0] // 2] for e in embs])

    monkeypatch.setattr(train_step, "loss_from_config", broken)


def altered_embedding(monkeypatch):
    """An answer altered where it is produced: each embedding's coordinates
    rotated by one place."""
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder

    made = SentenceEncoder.encode_ids

    def broken(self, ids, mask):
        return made(self, ids, mask).roll(1, dims=1)

    monkeypatch.setattr(SentenceEncoder, "encode_ids", broken)


def half_the_rows(monkeypatch):
    """Half of each batch left out: its second half answered with the first's."""
    from qst_tpu_torch.models.sentence_encoder import SentenceEncoder

    made = SentenceEncoder.encode_ids

    def broken(self, ids, mask):
        out = made(self, ids, mask).clone()
        half = out.shape[0] // 2
        out[half:2 * half] = out[:half]
        return out

    monkeypatch.setattr(SentenceEncoder, "encode_ids", broken)


def dropped_biases(monkeypatch):
    """The layers' bias adds left out: K1's and the module layers' products
    with their biases zeroed (the CPU's plain K1 stands for the kernel)."""
    import torch.nn.functional as F

    from qst_tpu_torch.models import bert
    from qst_tpu_torch.ops import fused_layer

    made = fused_layer.fused_bert_layer_plain

    def broken(x, mask_bias, weights, **kw):
        return made(x, mask_bias, {n: torch.zeros_like(w) if n.startswith("b") else w
                                   for n, w in weights.items()}, **kw)

    monkeypatch.setattr(fused_layer, "fused_bert_layer_plain", broken)
    monkeypatch.setattr(bert._Linear, "forward",
                        lambda self, x: F.linear(x, self.weight.to(x.dtype)))


def dropped_layernorm_affine(monkeypatch):
    """The layers' LayerNorm scales and offsets left out (normalisation alone)."""
    import torch.nn.functional as F

    from qst_tpu_torch.models import bert, mpnet
    from qst_tpu_torch.ops import fused_layer

    def plain(x, gamma, beta, eps):
        return F.layer_norm(x, x.shape[-1:], None, None, eps)

    def module(ln, x):
        return F.layer_norm(x.float(), ln.normalized_shape, None, None, ln.eps)

    monkeypatch.setattr(fused_layer, "_layernorm_f32", plain)
    monkeypatch.setattr(bert, "_layer_norm_f32", module)
    monkeypatch.setattr(mpnet, "_layer_norm_f32", module)


FAULTS = [("minilm_l6.train_b32", unchanged_state), ("minilm_l6.train_b32", half_the_batch),
          ("minilm_l6.train_b32", altered_tokens), ("minilm_l6.train_b32", dropped_biases),
          ("minilm_l6.train_b32", dropped_layernorm_affine),
          ("mpnet_base.encode_long", altered_embedding), ("mpnet_base.encode_long", half_the_rows),
          ("mpnet_base.encode_long", altered_tokens), ("mpnet_base.encode_long", dropped_biases),
          ("mpnet_base.encode_long", dropped_layernorm_affine)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = rehearse(cell, seed=2200000311)
    failed = [n for n, c in line["checks"].items() if not c["value"] <= c["limit"]]
    assert line["correct"] is False and failed, line["checks"]


def control_fails(line: dict) -> bool:
    limits = line["checks"]
    return any(not v <= limits[n]["limit"] for n, v in line["control"].items() if n in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_small_sizes(cell):
    line = rehearse(cell, seed=2200000401, control=1)
    assert line["correct"] is True, line["checks"]
    assert control_fails(line), (line["control"], line["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell, card):
    """On the card: a short run of the cell at its own sizes with the
    control; the program passes and the control fails."""
    from portbench import run

    out = io.StringIO()
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with contextlib.redirect_stdout(out):
            assert run.main(["--workload", cell, "--seed", "2200000503", "--seconds", "3",
                             "--trace", "0", "--control", "1"]) == 0
    finally:
        os.chdir(cwd)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert control_fails(line), (line["control"], line["checks"])
