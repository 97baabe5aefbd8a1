"""The PyTorch port's host modules and tensor ops against qst_tpu.

Inputs are made with numpy from a seed and fed to both packages. Copied
host modules (EncoderConfig, the tokenizers, DynamicBatcher) are held to
their source; ops are held to the JAX functions at f32 with rtol 1e-6 /
atol 1e-6 (same arithmetic, another summation order).
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qst_tpu.core import config as jconfig
from qst_tpu.models import hf_export
from qst_tpu.models import tokenizer as jtok
from qst_tpu.models.sentence_encoder import init_params as jax_init_params
from qst_tpu.ops import distances as jdist
from qst_tpu.ops import pooling as jpool
from qst_tpu.serve import batcher as jbatcher
from qst_tpu_torch.core import config as tconfig
from qst_tpu_torch.models import hf_import
from qst_tpu_torch.models import tokenizer as ttok
from qst_tpu_torch.ops import distances as tdist
from qst_tpu_torch.ops import pooling as tpool
from qst_tpu_torch.serve import batcher as tbatcher

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("preset", ["minilm_l6", "mpnet_base", "roberta_large", "tiny"])
def test_encoder_config_presets_match_field_for_field(preset):
    j = getattr(jconfig.EncoderConfig, preset)()
    t = getattr(tconfig.EncoderConfig, preset)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    over = getattr(tconfig.EncoderConfig, preset)(use_fused_layer=True, dtype="float32")
    assert over.use_fused_layer and over.dtype == "float32"


@pytest.mark.parametrize("name", ["LossConfig", "TrainConfig", "DataConfig", "IREvalConfig"])
def test_training_configs_match_field_for_field(name):
    j, t = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])


def test_config_constants_match_source():
    for name in ("RANDOM_SEED", "DEFAULT_GAMMA", "NEGATIVE_SIM_THRESHOLD", "CHUNK_DIM",
                 "KEY_REFERENCE", "KEY_POSITIVE", "KEY_PART_POSITIVE", "KEY_NEGATIVE",
                 "KEY_INSTANCES", "QUADRUPLET_KEYS", "REDUCTIONS",
                 "CROSS_ENCODER_RELEVANCE_THRESHOLD", "N_IR_SAMPLES", "CORPUS_CHUNK_SIZE",
                 "POSITIVE_SIM_THRESHOLD", "N_EXAMPLES", "N_PART_EXAMPLES",
                 "MAX_WORDS_TO_REPLACE", "NO_REPLACE_WORDS"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    for cfg in (jconfig.IREvalConfig(), jconfig.IREvalConfig(n_queries=7, map_at_k=(5,))):
        mirror = tconfig.IREvalConfig(**dataclasses.asdict(cfg))
        assert tconfig.config_hash(mirror) == jconfig.config_hash(cfg)


@pytest.mark.parametrize("kwargs", [
    dict(kind="bogus"), dict(kind="triplet", use_fused_kernel=True),
    dict(p=1.0, use_fused_kernel=True), dict(swap=True, use_fused_kernel=True),
    dict(gamma=1.5), dict(margin_pos_neg=0.0), dict(margin_pos_part=-1.0),
    dict(margin_part_neg=0.0), dict(p=0.0), dict(lmbd=0.0), dict(reduction="max"),
])
def test_loss_config_checks_match_source(kwargs):
    with pytest.raises(ValueError) as want:
        jconfig.LossConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        tconfig.LossConfig(**kwargs)
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


def _pair(rng, a_shape, b_shape):
    return (rng.standard_normal(a_shape).astype(np.float32),
            rng.standard_normal(b_shape).astype(np.float32))


@pytest.mark.parametrize("name", ["cos_sim", "dot_score", "euclid_score"])
def test_score_functions_match_jax(name):
    a, b = _pair(np.random.default_rng(0), (7, 16), (11, 16))
    want = np.asarray(jdist.SCORE_FUNCTIONS[name](jnp.asarray(a), jnp.asarray(b)))
    got = tdist.SCORE_FUNCTIONS[name](torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape,axis", [((9, 8), -1), ((4, 5, 6), -1), ((9, 8), 0)])
def test_l2_normalize_matches_jax(shape, axis):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x[0] = 0.0                                       # the eps floor
    np.testing.assert_allclose(tdist.l2_normalize(torch.from_numpy(x), axis=axis).numpy(),
                               np.asarray(jdist.l2_normalize(jnp.asarray(x), axis=axis)), **TOL)


def test_bf16_operands_score_in_f32_like_jax():
    """bf16 operands upcast before the product (exact products, f32 sums),
    as the JAX functions' f32 accumulation does."""
    a, b = _pair(np.random.default_rng(2), (5, 32), (6, 32))
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    ta, tb = torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16()
    np.testing.assert_allclose(tdist.dot_score(ta, tb).numpy(),
                               np.asarray(jdist.dot_score(ja, jb)), **TOL)


@pytest.mark.parametrize("name", ["mean", "cls", "max"])
def test_poolers_match_jax(name):
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((4, 6, 8)).astype(np.float32)
    mask = np.array([[1] * 6, [1, 1, 0, 0, 0, 0], [1] * 3 + [0] * 3, [0] * 6], np.int32)
    want = np.asarray(jpool.POOLERS[name](jnp.asarray(hidden), jnp.asarray(mask)))
    got = tpool.POOLERS[name](torch.from_numpy(hidden), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


TEXTS = ["A cat sits on the mat.", "Héllo, wörld!  tabs\tand   spaces",
         "the dog's ball: red/blue?", "", "unknownword xyzzy", "a " * 200]


def test_hash_tokenizer_ids_match_source():
    j, t = jtok.HashTokenizer(vocab_size=512), ttok.HashTokenizer(vocab_size=512)
    for a, b in zip(j.batch_encode(TEXTS, max_length=32), t.batch_encode(TEXTS, max_length=32)):
        np.testing.assert_array_equal(a, b)
    pairs = list(zip(TEXTS, reversed(TEXTS)))
    for a, b in zip(j.batch_encode_pairs(pairs, 24), t.batch_encode_pairs(pairs, 24)):
        np.testing.assert_array_equal(a, b)


def test_wordpiece_tokenizer_ids_match_source(tmp_path):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "sit", "##s",
             "on", "the", "mat", ".", "hello", ",", "world", "!", "dog", "'", "ball",
             ":", "red", "/", "blue", "?", "un", "##known", "##word"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(words) + "\n")
    j = jtok.WordPieceTokenizer.from_vocab_file(str(path))
    t = ttok.load_tokenizer(str(path))
    assert isinstance(t, ttok.WordPieceTokenizer)
    for a, b in zip(j.batch_encode(TEXTS, max_length=16), t.batch_encode(TEXTS, max_length=16)):
        np.testing.assert_array_equal(a, b)
    assert isinstance(ttok.load_tokenizer("", vocab_size=99), ttok.HashTokenizer)


def _code_without_docstrings(cls):
    """The class's AST with docstrings dropped (comments never enter it)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(cls)))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["_Item", "DynamicBatcher"])
def test_batcher_classes_are_the_source_code(name):
    assert _code_without_docstrings(getattr(tbatcher, name)) == _code_without_docstrings(
        getattr(jbatcher, name))


def test_batcher_copy_batches_concurrent_submissions():
    with tbatcher.DynamicBatcher(lambda xs: [x * 2 for x in xs], max_batch=8,
                                 max_wait_s=0.01) as b:
        futs = [b.submit_async(i) for i in range(20)]
        assert [f.result() for f in futs] == [2 * i for i in range(20)]
        assert b.stats()["items"] == 20


def test_state_dict_from_flax_params_matches_hf_export():
    jcfg = jconfig.EncoderConfig.tiny()
    params = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(0)))
    want = hf_export.export_bert_state_dict(params, jcfg)
    got = hf_import.state_dict_from_flax_params(params, tconfig.EncoderConfig.tiny())
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_load_torch_state_dict_strips_prefix_and_pooler(tmp_path):
    sd = {"bert.embeddings.word_embeddings.weight": torch.ones(3, 2),
          "bert.embeddings.position_ids": torch.arange(4),
          "bert.pooler.dense.weight": torch.ones(2, 2),
          "encoder.layer.0.output.dense.bias": torch.zeros(2, dtype=torch.float16)}
    torch.save(sd, tmp_path / "model.bin")
    got = hf_import.load_torch_state_dict(str(tmp_path / "model.bin"))
    assert set(got) == {"embeddings.word_embeddings.weight", "encoder.layer.0.output.dense.bias"}
    assert all(v.dtype == torch.float32 for v in got.values())


def test_port_imports_no_jax_flax_or_qst_tpu():
    """Every qst_tpu_torch module imports in a fresh interpreter without
    pulling in jax, flax or qst_tpu (this process already imported them),
    nor regex or transformers, which the GPU machine does not have; the BPE
    tokenizer, the cross-encoder and the MLM modules are driven through a
    first call as well (the BPE pre-tokenizer builds its pattern there)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import qst_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(qst_tpu_torch.__path__, "qst_tpu_torch.")]
        for n in names:
            importlib.import_module(n)
        from qst_tpu_torch.models.bpe_tokenizer import RobertaBPETokenizer, bytes_to_unicode
        tok = RobertaBPETokenizer({t: i for i, t in enumerate(
            ["<s>", "<pad>", "</s>", "<unk>"] + list(bytes_to_unicode().values()))}, [])
        tok.batch_encode_pairs([("it's 12 words", "x\u00b2")], max_length=16)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "qst_tpu", "regex", "transformers"))
        print(len(names), bad)
        new = {"core.device", "ops.ivf", "retrieval.ivf", "retrieval.updatable", "cli.common",
               "cli.index_main", "core.config", "core.telemetry", "core.rng",
               "evals.ir_metrics", "evals.ir_evaluator", "evals.quadruplet_evaluator",
               "evals.loss_evaluator", "evals.sequential", "evals.eval_set", "evals.factory",
               "evals", "data.mining", "data.quadruplet_dataset", "cli.train_main",
               "cli.ir_eval_main", "augment", "augment.backtranslation", "augment.llm_client",
               "augment.partial_positive", "augment.pos_tagger", "augment.positive_mining",
               "augment.synonyms", "data.coco", "data.sentence_compression",
               "cli.dataset_main", "experiments", "experiments.ablation", "retrieval.pq",
               "retrieval.pq4", "retrieval.ivfpq", "retrieval.streaming",
               "models.bpe_tokenizer", "models.cross_encoder", "models.mlm", "augment.mlm",
               "models.seq2seq", "core.meshes", "parallel", "parallel.context",
               "parallel.sharding", "parallel.pipeline"}
        missing = sorted(n for n in new if "qst_tpu_torch." + n not in names)
        print(missing)
        sys.exit(1 if bad or missing or len(names) < 15 else 0)
    """)
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_launch_counts_are_exact_across_threads():
    """``kernels.build.count_launch`` — the kernels' launch counters — loses
    no count when threads add at once (the miner launches K1 on the
    trainer's prefetch thread while the main thread trains)."""
    import threading

    from qst_tpu_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [build.count_launch(wrapper)
                                                    for _ in range(5000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 5000


def test_launches_recorded_in_a_capture_count_once_per_replay(monkeypatch):
    """Inside ``capturing_launches`` a call on a capturing stream records
    its launch instead of counting it (the capture launches nothing); a call
    on another stream — a miner's thread — still counts; each replay adds
    the recording once. One capture at a time."""
    from qst_tpu_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    capturing = {"now": True}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing["now"])
    with build.capturing_launches() as recorded:
        for _ in range(3):
            build.count_launch(wrapper)
        capturing["now"] = False
        build.count_launch(wrapper)                   # another stream: a real launch
        with pytest.raises(RuntimeError, match="one graph capture"):
            build.capturing_launches().__enter__()
    assert recorded == {wrapper: 3} and wrapper.launches == 1
    capturing["now"] = True
    build.count_launch(wrapper)                       # no capture open: counts
    for _ in range(2):
        build.add_launches(recorded)
    assert wrapper.launches == 1 + 1 + 2 * 3


def test_rng_streams_are_pure_functions_of_the_seed():
    """``core/rng.py``: a stream's generators follow from (seed, counter,
    fork tags) alone; forks are independent of the parent's draws;
    ``numpy()`` is a numpy Generator; ``seed_everything`` seeds the host's
    generators as the source does."""
    import random

    from qst_tpu_torch.core import rng

    def draws(stream, n=3):
        return [torch.rand(4, generator=stream.next()) for _ in range(n)]

    a, b = rng.RngStream(5), rng.RngStream(5)
    assert all(torch.equal(x, y) for x, y in zip(draws(a), draws(b)))
    assert not torch.equal(draws(rng.RngStream(5))[0], draws(rng.RngStream(6))[0])
    fresh = rng.RngStream(5).fork("mining")
    assert torch.equal(draws(a.fork("mining"))[0], draws(fresh)[0])
    assert not torch.equal(draws(a.fork("eval"))[0], draws(rng.RngStream(5).fork("mining"))[0])
    assert isinstance(rng.RngStream(3).numpy(), np.random.Generator)
    assert (rng.RngStream(3).numpy().integers(0, 1 << 30)
            == rng.RngStream(3).numpy().integers(0, 1 << 30))
    it = rng.key_iter(9)
    assert torch.equal(torch.rand(2, generator=next(it)),
                       torch.rand(2, generator=rng.RngStream(9).next()))
    root = rng.seed_everything(14)
    x = (random.random(), np.random.random(), torch.rand(1).item())
    rng.seed_everything(14)
    assert (random.random(), np.random.random(), torch.rand(1).item()) == x
    assert isinstance(root, rng.RngStream) and os.environ["PYTHONHASHSEED"] == "14"


@pytest.mark.parametrize("preset", ["tiny", "minilm_l6"])
def test_init_params_follow_the_jax_distribution(preset):
    """The port's random init draws what qst_tpu's ``init_params`` draws, in
    distribution: per tensor the same standard deviation (within 5%), a mean
    near zero, kernels cut at two standard deviations as Flax's lecun-normal,
    embeddings uncut, exact zeros and ones where JAX has them."""
    import jax

    from qst_tpu.models.sentence_encoder import init_params as jax_init_params
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params
    from qst_tpu_torch.models.sentence_encoder import init_params

    jcfg = getattr(jconfig.EncoderConfig, preset)()
    tcfg = getattr(tconfig.EncoderConfig, preset)()
    want = state_dict_from_flax_params(
        jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.key(3))), tcfg)
    got = init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name].float()
        if w.std() == 0:
            assert torch.equal(g, w.float()), name
            continue
        n = g.numel()           # sampling error of a std over n draws ~ 1/sqrt(2n)
        assert abs(g.std().item() / w.std().item() - 1) < 0.02 + 4 / (2 * n) ** 0.5, name
        assert abs(g.mean().item()) < 5 * w.std().item() / n ** 0.5, name
        cut = lambda t: (t.abs().max() / t.std()).item()  # noqa: E731
        if not name.startswith("embeddings."):
            assert cut(g) < 2.31 and cut(w.float()) < 2.31, name
        elif n >= 4096:         # uncut: draws beyond 2.4 standard deviations appear
            assert cut(g) > 2.4 and cut(w.float()) > 2.4, name


def test_synchronized_is_the_source():
    """utils/sync.py's decorator is the source's code, and it serialises
    calls: one lock a decorated function, kept on ``__lock__``."""
    import threading

    from qst_tpu.utils import sync as jsync
    from qst_tpu_torch.utils import sync as tsync

    def dump(fn):
        return ast.dump(ast.parse(textwrap.dedent(inspect.getsource(fn))))

    assert dump(tsync.synchronized) == dump(jsync.synchronized)
    inside, most = [0], [0]

    @tsync.synchronized
    def work():
        inside[0] += 1
        most[0] = max(most[0], inside[0])
        threading.Event().wait(0.002)
        inside[0] -= 1
        return 7

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert most[0] == 1 and work() == 7 and isinstance(work.__lock__, type(threading.Lock()))


def test_profile_trace_writes_a_torch_profiler_trace(tmp_path):
    """profile_trace (qst_tpu/core/telemetry.py:96-105) on torch.profiler:
    a Chrome trace of the block's operations in ``log_dir``, even when the
    block raises; nothing without a directory."""
    import json

    from qst_tpu_torch.core.telemetry import profile_trace

    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "a")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    [name] = os.listdir(tmp_path / "a")
    with open(tmp_path / "a" / name) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with pytest.raises(RuntimeError, match="inside"):
        with profile_trace(str(tmp_path / "b")):
            raise RuntimeError("inside")
    assert len(os.listdir(tmp_path / "b")) == 1
