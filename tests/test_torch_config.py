"""``ExperimentConfig``, ``MeshConfig`` and ``load_config`` across the two
packages: a file written by either package's ``save_config`` or ``Trainer``
loads in the other to equal dataclasses, ``config_hash`` gives the same
string in both, and ``MeshConfig.shape`` gives the same answers and the same
errors. Host code only: no model runs but two steps of the tiny one.
"""

import dataclasses
import json
import os

import pytest

from helpers import write_synthetic_dataset
from qst_tpu.core import config as jc
from qst_tpu_torch.core import config as tc


def _non_default(c):
    """One config of package ``c`` with a field changed in every section,
    tuples and a nested preset among them."""
    return c.ExperimentConfig(
        loss=c.LossConfig(gamma=0.8, margin_pos_neg=1.5, margin_pos_part=0.3,
                          margin_part_neg=0.4, use_fused_kernel=True),
        encoder=c.EncoderConfig.mpnet_base(use_fused_layer=True, max_seq_length=256),
        data=c.DataConfig(root="data/x", batch_size=16, hard_contrastive_mode=1),
        train=c.TrainConfig(epochs=3, scheduler="warmupcosine", warmup_steps=7,
                            manual_notes="γ sweep"),
        ir_eval=c.IREvalConfig(accuracy_at_k=(1, 5), map_at_k=(100,),
                               score_functions=("cos_sim",)),
        mesh=c.MeshConfig(data=4, model=2))


CONFIGS = {"default": lambda c: c.ExperimentConfig(), "non-default": _non_default}


def _same(port_cfg, jax_cfg):
    assert type(port_cfg).__name__ == type(jax_cfg).__name__
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    for f in dataclasses.fields(jax_cfg):        # each section is its own package's class
        assert type(getattr(port_cfg, f.name)).__module__ == tc.__name__


@pytest.mark.parametrize("which", CONFIGS)
@pytest.mark.parametrize("writer", ["qst_tpu", "qst_tpu_torch"])
def test_a_saved_config_loads_in_the_other_package(tmp_path, writer, which):
    jcfg, tcfg = CONFIGS[which](jc), CONFIGS[which](tc)
    path = str(tmp_path / "sub" / "cfg.json")
    (jc if writer == "qst_tpu" else tc).save_config(jcfg if writer == "qst_tpu" else tcfg, path)
    port_loaded, jax_loaded = tc.load_config(path), jc.load_config(path)
    _same(port_loaded, jax_loaded)
    assert port_loaded == tcfg and jax_loaded == jcfg
    assert isinstance(port_loaded.ir_eval.accuracy_at_k, tuple)


@pytest.mark.parametrize("which", CONFIGS)
def test_config_hash_is_the_same_in_both_packages(which):
    h = tc.config_hash(CONFIGS[which](tc))
    assert h == jc.config_hash(CONFIGS[which](jc))
    assert len(h) == 64 and int(h, 16) >= 0
    assert (tc.config_hash(tc.ExperimentConfig()) == h) == (which == "default")


def test_load_config_ignores_unknown_keys_and_missing_sections(tmp_path):
    """As the source: an unknown key or section is skipped, a missing
    section keeps its default, lists become tuples."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"loss": {"gamma": 0.3, "not_a_field": 1},
                                "mesh": {"model": 2}, "extra": {"a": 1},
                                "ir_eval": {"mrr_at_k": [10, 20]}}))
    got, want = tc.load_config(str(path)), jc.load_config(str(path))
    _same(got, want)
    assert got.loss.gamma == 0.3 and got.mesh == tc.MeshConfig(data=-1, model=2)
    assert got.ir_eval.mrr_at_k == (10, 20) and got.train == tc.TrainConfig()


def _shape(cls, data, model, n):
    try:
        return cls(data=data, model=model).shape(n)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("data", [-1, 0, 1, 2, 3, 4, 8])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_mesh_config_shape_agrees_in_value_and_error(data, model):
    for n in range(1, 17):
        got = _shape(tc.MeshConfig, data, model, n)
        assert got == _shape(jc.MeshConfig, data, model, n), (data, model, n)
        if data <= 0 and n % model == 0:
            assert got == (n // model, model)


def test_experiment_config_is_frozen_with_the_source_fields():
    a = tc.ExperimentConfig()
    assert a == tc.ExperimentConfig() and a.encoder == tc.EncoderConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.mesh = tc.MeshConfig()
    assert [f.name for f in dataclasses.fields(tc.ExperimentConfig)] == [
        f.name for f in dataclasses.fields(jc.ExperimentConfig)]
    assert [f.name for f in dataclasses.fields(tc.MeshConfig)] == [
        f.name for f in dataclasses.fields(jc.MeshConfig)]


def _trainer_cfgs(c, exp):
    return (c.EncoderConfig.tiny(), c.LossConfig(gamma=0.7, margin_pos_part=0.4),
            c.TrainConfig(batch_size=4, epochs=1, warmup_steps=1, evaluation_steps=0,
                          checkpoint_save_steps=0, save_best_model=False,
                          experiment_dir=exp))


def test_trainer_experiment_config_loads_in_both_packages(tmp_path):
    """The ``experiment_config.json`` of a two-step tiny run of the port's
    ``Trainer``, and the file qst_tpu's ``Trainer`` writes for the same
    configs (its ``save_config`` of the same three keys, without the JAX
    run): each loads in both packages to the run's configs, with the other
    sections at their defaults."""
    from qst_tpu_torch.data import QuadrupletCollator, QuadrupletDataset
    from qst_tpu_torch.models import HashTokenizer
    from qst_tpu_torch.train import Trainer

    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=1, chunk_dim=8)
    enc, loss, train = _trainer_cfgs(tc, str(tmp_path / "port"))
    ds = QuadrupletDataset(root, n_pos=1, n_part_pos=1, n_neg=1, seed=1)
    collator = QuadrupletCollator(HashTokenizer(vocab_size=enc.vocab_size),
                                  max_length=enc.max_seq_length)
    result = Trainer(enc, loss, train, ds, collator, device="cpu").train()
    assert result.state.step == 2

    jenc, jloss, jtrain = _trainer_cfgs(jc, str(tmp_path / "jax"))
    jpath = os.path.join(jtrain.experiment_dir, "experiment_config.json")
    jc.save_config({"encoder": jenc, "loss": jloss, "train": jtrain}, jpath)
    for path, exp in ((os.path.join(train.experiment_dir, "experiment_config.json"), train),
                      (jpath, jtrain)):
        with open(path) as f:
            assert set(json.load(f)) == {"encoder", "loss", "train"}
        got, want = tc.load_config(path), jc.load_config(path)
        _same(got, want)
        assert (got.encoder, got.loss) == (enc, loss)
        assert got.train == dataclasses.replace(train, experiment_dir=exp.experiment_dir)
        assert (got.data, got.ir_eval, got.mesh) == (
            tc.DataConfig(), tc.IREvalConfig(), tc.MeshConfig())
        assert tc.config_hash(got) == jc.config_hash(want)
