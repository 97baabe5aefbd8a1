"""The port's dataset construction against qst_tpu's: ``data/coco.py`` and
``data/sentence_compression.py`` write byte-equal chunk files from one
annotation or records file and one embedder (a resume after a failed chunk
included), ``cli/dataset_main.py`` writes the same chunks, provenance and
verbose-check reads, its encoder-backed embedder agrees with the JAX
``SentenceEncoder`` on the same weights (1e-5), and the ablation's own
copies of the JAX script's embedder and annotation writer are the source.
"""

import importlib.util
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from helpers import hash_embed
from qst_tpu.augment import backtranslation as jbt
from qst_tpu.cli import dataset_main as jdm
from qst_tpu.data import coco as jcoco
from qst_tpu.data import sentence_compression as jsc
from qst_tpu_torch.augment import backtranslation as tbt
from qst_tpu_torch.cli import dataset_main as tdm
from qst_tpu_torch.data import coco as tcoco
from qst_tpu_torch.data import sentence_compression as tsc
from qst_tpu_torch.experiments import ablation as tabl
from test_torch_augment import ported_code
from test_torch_data import _code

GROUPS = [
    ["a cat sits on the mat", "the cat rests on a mat", "a small cat lying on the rug",
     "a young cat on the carpet", "a cat on a mat indoors"],
    ["a dog runs in the park", "the dog sprints across the grass",
     "a young dog playing in the field", "a dog chasing a ball outside", "a dog running outdoors"],
    ["a plate of pasta with sauce", "an airplane flies high", "a red car drives down the road",
     "two people playing guitar", "a boat on the river"],
]
RECORDS = [{"sentence": "the quick brown fox jumps over the lazy dog near the barn",
            "compression": "the fox jumps over the dog near the barn", "compression_ratio": 0.8},
           {"sentence": "a woman in a red coat walks her small dog along the beach",
            "compression": "woman walks dog", "compression_ratio": 0.2}] * 3


def embed(xs):
    return hash_embed(list(xs))


@pytest.fixture(autouse=True)
def fresh_backtranslators(monkeypatch):
    monkeypatch.delenv("QST_BACKTRANSLATION_BACKEND", raising=False)
    jbt.reset_backtranslator()
    tbt.reset_backtranslator()
    yield
    jbt.reset_backtranslator()
    tbt.reset_backtranslator()


def write_coco_ann(path, n_images=7):
    images, anns, aid = [], [], 0
    for i in range(n_images):
        images.append({"id": 100 + i})
        for cap in GROUPS[i % len(GROUPS)]:
            anns.append({"id": aid, "image_id": 100 + i, "caption": cap})
            aid += 1
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns}, f)


def tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_host_copies_are_the_source_code():
    for name in ("CocoCaptionsSource", "create_coco_dataset_chunk", "create_coco_dataset"):
        assert ported_code(getattr(tcoco, name)) == _code(getattr(jcoco, name)), name
    for name in ("generate_variations", "get_pos_examples_sentence_compr",
                 "get_part_pos_examples_sentence_compr", "create_sentence_compression_chunk",
                 "create_dataset_sentence_compression"):
        assert ported_code(getattr(tsc, name)) == _code(getattr(jsc, name)), name
    for name in ("COMPRESSION_RATIO_THRESHOLD", "REPLACE_WORDNET", "REPLACE_BERT",
                 "INSERT_BERT", "BACKTRANSL", "DEFAULT_AUGS"):
        assert getattr(tsc, name) == getattr(jsc, name), name


@pytest.mark.parametrize("algorithm,augment", [("adaptive_crop", False), ("adaptive_crop", True),
                                               ("adaptive_crop_augment", True), ("llm", False)])
def test_coco_chunks_are_byte_equal(tmp_path, algorithm, augment):
    ann = str(tmp_path / "captions.json")
    write_coco_ann(ann)
    lasts = []
    for pkg, coco in (("jax", jcoco), ("torch", tcoco)):
        src = coco.CocoCaptionsSource(ann, dataset_name="mini")
        assert len(src) == 7 and len(src[0]) == 5
        lasts.append(coco.create_coco_dataset(
            str(tmp_path / pkg), src, embed, chunk_dim=3, n_pos_examples=4,
            n_part_pos_examples=5, augment=augment, part_pos_algorithm=algorithm, seed=3))
    assert lasts == [2, 2]
    want, got = tree(tmp_path / "jax"), tree(tmp_path / "torch")
    assert sorted(got) == ["mini/chunk_0.json", "mini/chunk_1.json", "mini/chunk_2.json",
                           "mini/chunk_n.json"]
    assert got == want


class FailingEmbed:
    """The hash embedder that raises from its ``n_ok``-th call on."""

    def __init__(self, n_ok):
        self.calls, self.n_ok = 0, n_ok

    def __call__(self, xs):
        self.calls += 1
        if self.calls > self.n_ok:
            raise RuntimeError("injected embedder failure")
        return embed(xs)


def test_coco_resume_after_a_failed_chunk_is_byte_equal(tmp_path):
    ann = str(tmp_path / "captions.json")
    write_coco_ann(ann)
    counted = FailingEmbed(10**9)          # the calls chunk 0 makes
    tcoco.create_coco_dataset(str(tmp_path / "count"), tcoco.CocoCaptionsSource(ann), counted,
                              chunk_dim=3, last_chunk=0, part_pos_algorithm="adaptive_crop")
    tbt.reset_backtranslator()
    for pkg, coco in (("jax", jcoco), ("torch", tcoco)):
        src = coco.CocoCaptionsSource(ann)
        out = str(tmp_path / pkg)
        # chunk 0 (3 images) succeeds, chunk 1 fails: stop there, no metadata
        assert coco.create_coco_dataset(out, src, FailingEmbed(counted.calls), chunk_dim=3,
                                        part_pos_algorithm="adaptive_crop") == 0
        assert sorted(tree(out)) == ["CoCoCaptionDataset/chunk_0.json"]
        assert coco.create_coco_dataset(out, src, embed, chunk_dim=3, start_chunk=1,
                                        part_pos_algorithm="adaptive_crop") == 2
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")


def test_sentence_compression_chunks_are_byte_equal(tmp_path):
    for pkg, sc in (("jax", jsc), ("torch", tsc)):
        assert sc.create_dataset_sentence_compression(str(tmp_path / pkg), RECORDS,
                                                      chunk_dim=4, seed=5) == 1
    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")
    rec = RECORDS[0]
    for n in (3, 4):
        assert (tsc.get_pos_examples_sentence_compr(rec, n, seed=n)
                == jsc.get_pos_examples_sentence_compr(rec, n, seed=n))
        assert (tsc.get_part_pos_examples_sentence_compr(RECORDS[1], n, seed=n)
                == jsc.get_part_pos_examples_sentence_compr(RECORDS[1], n, seed=n))
    assert tsc.generate_variations("the big dog runs", 3, seed=1) == jsc.generate_variations(
        "the big dog runs", 3, seed=1)
    assert tsc.generate_variations("x", 0) == []


def test_the_encoder_backed_embedder_matches_the_jax_encoder(monkeypatch):
    """``_encode_fn`` (the port's SentenceEncoder on the CPU) on qst_tpu's
    ``init_params`` carried over, against qst_tpu's SentenceEncoder.encode:
    1e-5 at EncoderConfig.tiny()."""
    from qst_tpu.core.config import EncoderConfig as JaxEncoderConfig
    from qst_tpu.models import SentenceEncoder as JaxSentenceEncoder
    from qst_tpu.models.sentence_encoder import init_params as jax_init_params
    from qst_tpu.models.tokenizer import load_tokenizer as jax_load_tokenizer
    from qst_tpu_torch.models import sentence_encoder as tse
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params

    jcfg = JaxEncoderConfig.tiny()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(14)))
    args = tdm.build_parser().parse_args(["--output_root", "x", "--encoder_preset", "tiny",
                                          "--device", "cpu"])
    texts = [c for g in GROUPS for c in g]
    native = tdm._encode_fn(args)(texts)           # the port's own random init
    assert native.shape == (len(texts), 64) and np.isfinite(native).all()
    np.testing.assert_allclose(np.linalg.norm(native, axis=1), 1.0, rtol=1e-5)
    monkeypatch.setattr(tse, "init_params", lambda cfg, gen, device=None: {
        k: v.to(device) for k, v in state_dict_from_flax_params(params, cfg).items()})
    got = tdm._encode_fn(args)(texts)
    want = JaxSentenceEncoder(jcfg, params, jax_load_tokenizer("", vocab_size=jcfg.vocab_size)
                              ).encode(texts)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def _records(name):
    """The messages of logger ``name`` while the block runs."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger(name)

    class Ctx:
        def __enter__(self):
            self.level = logger.level
            logger.setLevel(logging.INFO)
            logger.addHandler(handler)
            return records

        def __exit__(self, *exc):
            logger.removeHandler(handler)
            logger.setLevel(self.level)

    return Ctx()


def test_dataset_main_matches_the_jax_cli(tmp_path, monkeypatch):
    """Both CLIs on one annotation file with one shared embedder: equal
    chunk files, ``command_line_args.json`` (less the port's ``--device``)
    and verbose-check reads."""
    ann = str(tmp_path / "captions.json")
    write_coco_ann(ann, n_images=9)
    monkeypatch.setattr(jdm, "_encode_fn", lambda args: embed)
    monkeypatch.setattr(tdm, "_encode_fn", lambda args: embed)
    flags = ["--ann_file", ann, "--chunk_dim", "2", "--encoder_preset", "tiny",
             "--n_part_pos_examples", "3"]
    logs = {}
    for pkg, cli, extra in (("jax", jdm, []), ("torch", tdm, ["--device", "cpu"])):
        with _records(cli.logger.name) as recs:
            assert cli.main(flags + ["--output_root", str(tmp_path / pkg)] + extra) == 0
        logs[pkg] = [r.getMessage() for r in recs]
    want, got = tree(tmp_path / "jax"), tree(tmp_path / "torch")
    args_j, args_t = (json.loads(t.pop("command_line_args.json")) for t in (want, got))
    assert args_t.pop("device") == "cpu"
    assert args_t == {**args_j, "output_root": str(tmp_path / "torch")}
    assert len(got) == 6 and got == want      # 5 chunks + metadata
    assert any(m.startswith("cache stats") for m in logs["torch"])
    assert logs["torch"] == logs["jax"]


def test_dataset_main_records_and_errors(tmp_path, monkeypatch):
    monkeypatch.setattr(tdm, "_encode_fn", lambda args: embed)
    rec = str(tmp_path / "records.jsonl")
    with open(rec, "w") as f:
        f.write("\n".join(json.dumps(r) for r in RECORDS))
    assert tdm.main(["--dataset_type", "sentence_compression", "--records_file", rec,
                     "--output_root", str(tmp_path / "sc"), "--chunk_dim", "4",
                     "--device", "cpu"]) == 0
    assert sorted(tree(tmp_path / "sc" / "sent_compr")) == ["chunk_0.json", "chunk_1.json",
                                                            "chunk_n.json"]
    for flags in (["--dataset_type", "coco"], ["--dataset_type", "sentence_compression"]):
        with pytest.raises(SystemExit):
            tdm.main(flags + ["--output_root", str(tmp_path / "e"), "--device", "cpu"])


def _jax_ablation():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmarks", "ablation_quadruplet_vs_triplet.py")
    spec = importlib.util.spec_from_file_location("jax_ablation_script", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_ablation_copies_are_the_jax_scripts(tmp_path):
    src = _jax_ablation()
    for name in ("TOPICS", "VERBS", "PLACES", "FILLER"):
        assert getattr(tabl, name) == getattr(src, name), name
    for name in ("hash_embed", "make_coco_annotations"):
        assert _code(getattr(tabl, name)) == _code(getattr(src, name)), name
    texts = [f"a {t} {v} in the park" for t, v in zip(tabl.TOPICS, tabl.VERBS)] + ["no topic"]
    np.testing.assert_array_equal(tabl.hash_embed(texts), src.hash_embed(texts))
    for mod, name in ((src, "jax.json"), (tabl, "torch.json")):
        mod.make_coco_annotations(str(tmp_path / name), 97, np.random.default_rng(14))
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "torch.json").read_bytes()


def test_the_ablation_runs_end_to_end_at_a_tiny_size(capsys):
    """The port's ablation on the CPU (tiny encoder, fused layer and loss,
    WordPiece; 5 batches an epoch at 3 steps a call, so a remainder of 2
    single steps): every table cell filled."""
    assert tabl.main(["--device", "cpu", "--preset", "tiny", "--steps", "10", "--n_images",
                      "160", "--n_eval", "40", "--use_fused_layer", "--wordpiece",
                      "--steps_per_call", "3"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(next(line for line in out.splitlines()
                              if line.startswith('{"metric"')))
    assert summary["steps_per_arm"] == {"quadruplet": 10, "triplet": 10}
    for label in ("baseline", "quadruplet", "triplet"):
        row = tabl.table_row(summary["results"][label])
        assert all(0.0 <= v <= 1.0 for v in row.values()), (label, row)
    assert "| quadruplet (JAX, RESULTS.md) | 0.39 |" in out
    fine = {"ordering": {"acc_pos_part": 1.0, "acc_part_neg": 0.9, "acc_pos_neg": 1.0,
                         "global_accuracy": 0.95},
            "pos+part": {"recall@10": 0.4, "ndcg@10": 0.5}, "pos_only": {"recall@10": 0.7},
            "part_only": {"recall@10": 0.0}}
    worse = {**fine, "ordering": {**fine["ordering"], "acc_part_neg": 0.7},
             "pos+part": {"recall@10": 0.35, "ndcg@10": 0.5}}
    assert tabl.quality_bars({"quadruplet": fine, "triplet": fine}) == []
    assert len(tabl.quality_bars({"quadruplet": worse, "triplet": fine})) == 3
    assert len(tabl.quality_bars({"quadruplet": worse, "triplet": fine},
                                 ordering_only=True)) == 1
    assert torch.cuda.is_available() or "quality bars" in out


def test_the_ablation_witness_starts_both_packages_from_one_init(tmp_path):
    """``tests/ablation_witness.py`` at a tiny size: the JAX script (in a
    subprocess) and the port's ablation from the script's own init give the
    same untrained baseline in every column, and both train their arms."""
    import ablation_witness

    out = ablation_witness.main(["--preset", "tiny", "--steps", "10", "--n_images", "160",
                                 "--n_eval", "40", "--wordpiece",
                                 "--log", str(tmp_path / "jax.log")])
    assert out["port"]["baseline"] == out["jax"]["baseline"]
    for side in ("jax", "port"):
        for arm in ("quadruplet", "triplet"):
            row = tabl.table_row(out[side][arm])
            assert all(0.0 <= v <= 1.0 for v in row.values()), (side, arm, row)
        assert out[side]["quadruplet"] != out[side]["baseline"], side


def test_the_ablation_step_tracks_jax_at_minilm_l6_width():
    """At the ablation's full width and shapes (MiniLM-L6, S = 32, batch 32
    quadruplets, dropout 0) three train steps of the port from the JAX
    script's init follow JAX's: the losses within 2e-3 relative (bf16
    projections in both), the update along JAX's (cosine ≥ 0.995: Adam's
    first steps are near sign(g), so bf16 noise in a small gradient flips a
    whole step of an element) at its length (within 1%)."""
    import ablation_witness

    for kind in ("gamma", "triplet"):
        out = ablation_witness.step_parity("minilm_l6", kind, 3)
        for lj, lt in out["losses"]:
            assert abs(lt - lj) <= 2e-3 * abs(lj), (kind, lj, lt)
        assert out["cosine"] >= 0.995, (kind, out)
        assert abs(out["norm_ratio"] - 1) <= 0.01, (kind, out)
