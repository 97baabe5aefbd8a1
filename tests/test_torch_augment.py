"""The port's augmentation layer (``qst_tpu_torch/augment``) against
qst_tpu's: the copies are the source code, and the same inputs with the same
numpy seeds give equal outputs — POS tags, synonyms, both crops, the
partial-positive strategies, the LLM prompt, parse and client, positive
mining on a shared hash embedder (threshold path, retries, top-k backup,
augment and repeat fill), cosine scores to 1e-6, and the backtranslation
backend selection. The cases mirror ``tests/test_augment.py`` and
``tests/test_llm_client.py`` one for one; the MLM augmenter's cases are in
``tests/test_torch_mlm.py``.
"""

import importlib.abc
import json
import sys
import threading
import types
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

import qst_tpu.augment as jaug
import qst_tpu_torch.augment as taug
from helpers import hash_embed
from qst_tpu.augment import backtranslation as jbt
from qst_tpu.augment import llm_client as jllm
from qst_tpu.augment import partial_positive as jpp
from qst_tpu.augment import pos_tagger as jpos
from qst_tpu.augment import positive_mining as jpm
from qst_tpu.augment import synonyms as jsyn
from qst_tpu_torch.augment import backtranslation as tbt
from qst_tpu_torch.augment import llm_client as tllm
from qst_tpu_torch.augment import partial_positive as tpp
from qst_tpu_torch.augment import pos_tagger as tpos
from qst_tpu_torch.augment import positive_mining as tpm
from qst_tpu_torch.augment import synonyms as tsyn
from qst_tpu_torch.models.hf_export import save_marian_dir
from qst_tpu_torch.models.seq2seq import Seq2SeqConfig, init_seq2seq
from test_torch_data import _code

CAPTION = "a man riding a brown horse next to a red barn on a sunny day"
TEXTS = [CAPTION, "A dog runs, jumps and swims.", "a red car drives down the road",
         "the big dog sits on the old couch near a small cat", "Two people playing guitar.",
         "a woman standing in a parking lot taking a photo"]


def ported_code(obj):
    """``_code`` of a port's copy with its imports named as in qst_tpu."""
    return _code(obj).replace("'qst_tpu_torch.", "'qst_tpu.")


def embed(xs):
    return hash_embed(list(xs))


@pytest.fixture(autouse=True)
def fresh_backtranslators(monkeypatch):
    """Both packages' memoized backends start afresh (a paraphraser's rng
    state carries from call to call), with no backend forced."""
    for var in ("QST_MARIAN_EN_FR", "QST_MARIAN_FR_EN", "QST_BACKTRANSLATION_BACKEND",
                tllm.BASE_URL_ENV):
        monkeypatch.delenv(var, raising=False)
    jbt.reset_backtranslator()
    tbt.reset_backtranslator()
    yield
    jbt.reset_backtranslator()
    tbt.reset_backtranslator()


# ------------------------------------------------------------- the copies
@pytest.mark.parametrize("src,dst,names", [
    (jpos, tpos, ["_tag_word"]),
    (jsyn, tsyn, ["_closure", "SynonymAugmenter"]),
    (jbt, tbt, ["format_batch_texts", "IdentityBacktranslator", "ParaphraseBacktranslator",
                "MarianBacktranslator", "_marian_tokenizer_available", "reset_backtranslator",
                "perform_back_translation"]),
    (jllm, tllm, ["OpenAICompatibleClient", "get_llm_fn"]),
    (jpp, tpp, ["mock_llm_response", "build_llm_prompt", "parse_llm_response",
                "_fix_punct_spacing", "crop_text_based_on_tagging",
                "adaptive_crop_part_pos_examples", "get_part_pos_examples"]),
    (jpm, tpm, ["compute_cosine_scores", "pop_random_caption", "select_positive_examples"]),
], ids=["pos_tagger", "synonyms", "backtranslation", "llm_client", "partial_positive",
        "positive_mining"])
def test_host_copies_are_the_source_code(src, dst, names):
    for name in names:
        assert ported_code(getattr(dst, name)) == _code(getattr(src, name)), name


def _without_nltk(monkeypatch, missing):
    """Make nltk unusable for one test → the list of its lookups: with
    ``missing`` "module" every import of nltk fails, with "data" a stand-in
    nltk imports and every lookup raises ``LookupError``."""
    probes = []
    for name in [m for m in sys.modules if m.split(".")[0] == "nltk"]:
        monkeypatch.delitem(sys.modules, name)

    def lookup(*args, **kwargs):
        probes.append("lookup")
        raise LookupError("no nltk data")

    if missing == "module":
        class NoNltk(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "nltk":
                    probes.append(name)
                    raise ModuleNotFoundError(name)

        monkeypatch.setattr(sys, "meta_path", [NoNltk()] + sys.meta_path)
    else:
        fake = {n: types.ModuleType(n) for n in ("nltk", "nltk.tokenize", "nltk.corpus")}
        fake["nltk"].pos_tag = fake["nltk.tokenize"].word_tokenize = lookup
        fake["nltk.corpus"].wordnet = types.SimpleNamespace(synsets=lookup)
        for name, module in fake.items():
            monkeypatch.setitem(sys.modules, name, module)
    return probes


@pytest.mark.parametrize("missing", ["module", "data"])
def test_a_failed_nltk_probe_is_made_once(monkeypatch, missing):
    """The port's one change to its copies of the tagger and the WordNet
    lookup: a failed nltk probe (no module, or no data) is remembered, so a
    caption does not search the import path or nltk's data paths again; the
    tags and synonyms stay qst_tpu's."""
    probes = _without_nltk(monkeypatch, missing)
    for port, source, flag, call in (
            (tpos, jpos, tpos._NLTK, lambda m: m.pos_tag_universal(CAPTION)),
            (tsyn, jsyn, tsyn._WORDNET, lambda m: m._wordnet_synonyms("dog"))):
        monkeypatch.setitem(flag, "usable", True)
        probes.clear()
        got = [call(port) for _ in range(4)]
        assert len(probes) == 1 and not flag["usable"]
        assert got == [call(source)] * 4 and len(probes) == 2


def test_constants_and_lexicons_match_the_source():
    for name in ("_DET", "_ADP", "_PRON", "_CONJ", "_AUX_VERBS", "_ADV", "_PRT", "_NUM_WORDS",
                 "_ADJ_SUFFIXES", "_ADV_SUFFIXES", "_VERB_SUFFIXES", "_NOUN_SUFFIXES",
                 "_COMMON_VERBS"):
        assert getattr(tpos, name) == getattr(jpos, name), name
    assert tsyn._BASE_LEXICON == jsyn._BASE_LEXICON
    assert tsyn.DEFAULT_LEXICON == jsyn.DEFAULT_LEXICON
    for name in ("ADAPTIVE_CROP", "ADAPTIVE_CROP_AUGMENT", "LLM", "MOCK", "MIN_RESPONSE_NUM",
                 "MOCK_LLM_RESPONSE"):
        assert getattr(tpp, name) == getattr(jpp, name), name
    assert (tpm.TOP_K_BACKUP, tpm.MAX_ATTEMPTS) == (jpm.TOP_K_BACKUP, jpm.MAX_ATTEMPTS)
    for name in ("BASE_URL_ENV", "API_KEY_ENV", "MODEL_ENV", "DEFAULT_MODEL"):
        assert getattr(tllm, name) == getattr(jllm, name), name
    assert (tbt.LANGUAGE_PREFIX, tbt._BACKEND_CHOICES) == (jbt.LANGUAGE_PREFIX,
                                                           jbt._BACKEND_CHOICES)


def test_all_is_the_source_less_the_model_backed_augmenters():
    """Every name of the source: both model-backed augmenters are ported
    (MLMAugmenter: tests/test_torch_mlm.py; the on-card Marian:
    tests/test_torch_marian_backend.py)."""
    assert set(taug.__all__) == set(jaug.__all__)


# ------------------------------------------------------------- POS tagging
def test_pos_tagger_caption():
    tags = dict(taug.pos_tag_universal("a red car drives down the road"))
    assert tags["a"] == "DET" and tags["the"] == "DET"
    assert tags["car"] == "NOUN" and tags["road"] == "NOUN"
    assert tags["down"] == "ADP"
    assert tags["red"] in ("ADJ", "NOUN")
    for text in TEXTS:
        assert taug.pos_tag_universal(text) == jaug.pos_tag_universal(text)


def test_pos_tagger_punct_and_verbs():
    tags = taug.pos_tag_universal("A dog runs, jumps and swims.")
    by_word = {w.lower(): t for w, t in tags}
    assert by_word["runs"] == "VERB" and by_word[","] == "." and by_word["."] == "."
    assert by_word["and"] == "CONJ"
    assert tags == jaug.pos_tag_universal("A dog runs, jumps and swims.")


# ---------------------------------------------------------------- synonyms
def test_synonym_augmenter_replaces_and_respects_stopwords():
    aug = taug.SynonymAugmenter(aug_min=1, aug_max=2, seed=3, use_wordnet=False)
    out = aug.augment_one("the big dog")
    assert out != "the big dog" and out.split()[0] == "the"
    assert aug.augment_one("qwerty zxcvb") == "qwerty zxcvb"
    assert len(aug.augment(["the big dog", "a small cat"])) == 2
    with pytest.raises(ValueError):
        taug.SynonymAugmenter(aug_min=3, aug_max=1)
    for seed in (0, 3, 14):
        t = taug.SynonymAugmenter(aug_min=1, aug_max=5, seed=seed).augment(TEXTS * 2)
        j = jaug.SynonymAugmenter(aug_min=1, aug_max=5, seed=seed).augment(TEXTS * 2)
        assert t == j, seed


# ---------------------------------------------------------- backtranslation
def test_backtranslation_backends():
    assert taug.IdentityBacktranslator().backtranslate(["hello world"]) == ["hello world"]
    texts = ["the big dog runs fast", "a small cat"]
    outs = taug.ParaphraseBacktranslator(seed=5).backtranslate(texts)
    assert len(outs) == 2 and all(isinstance(o, str) and o for o in outs)
    assert outs == jaug.ParaphraseBacktranslator(seed=5).backtranslate(texts)


def test_format_batch_texts():
    assert taug.format_batch_texts(["hi"], "fr") == [">>fr<< hi"]
    assert taug.format_batch_texts(TEXTS) == jaug.format_batch_texts(TEXTS)


def test_backend_selection_matches_the_source(tmp_path, monkeypatch):
    """Auto choice, memoization, forced backends and their errors as in
    qst_tpu; where qst_tpu builds its on-device Marian (forced, or both
    checkpoint directories with a tokenizer) the port builds its on-card
    one, here on the CPU."""
    for mod in (tbt, jbt):
        mod.reset_backtranslator()
        assert isinstance(mod.get_backtranslator(), mod.ParaphraseBacktranslator)
        assert mod.get_backtranslator() is mod.get_backtranslator()
        assert isinstance(mod.get_backtranslator(backend="identity"),
                          mod.IdentityBacktranslator)
        mod.reset_backtranslator()
        assert isinstance(mod.get_backtranslator(allow_paraphrase_fallback=False),
                          mod.IdentityBacktranslator)
        for bad in ("marian", "Torch"):
            with pytest.raises(ValueError, match="unknown backtranslation backend"):
                mod.get_backtranslator(backend=bad)
        for forced in ("jax", "torch"):
            with pytest.raises(ValueError, match="checkpoint dirs are missing"):
                mod.get_backtranslator(backend=forced)
        monkeypatch.setenv("QST_BACKTRANSLATION_BACKEND", "identity")
        mod.reset_backtranslator()
        assert isinstance(mod.get_backtranslator(), mod.IdentityBacktranslator)
        monkeypatch.delenv("QST_BACKTRANSLATION_BACKEND")
    cfg = Seq2SeqConfig.tiny()
    ckpt = [save_marian_dir(init_seq2seq(cfg, torch.Generator().manual_seed(seed), device="cpu"),
                            cfg, str(tmp_path / name))
            for name, seed in (("en_fr", 0), ("fr_en", 1))]
    toks = (object(), object())
    for mod, kw in ((tbt, {"device": "cpu"}), (jbt, {})):
        for forced in ("jax", None):
            mod.reset_backtranslator()
            assert isinstance(mod.get_backtranslator(*ckpt, backend=forced, tokenizers=toks, **kw),
                              mod.JaxMarianBacktranslator)


# ------------------------------------------------------------------- crops
@pytest.mark.parametrize("crop_prefix", [False, True], ids=["suffix", "prefix"])
def test_crops_match_the_source(crop_prefix):
    for seed in range(4):
        for text in TEXTS:
            t = taug.crop_text_based_on_tagging(
                text, crop_prefix=crop_prefix, repeat=3, rng=np.random.default_rng(seed),
                synonym_aug=taug.SynonymAugmenter(seed=seed))
            j = jaug.crop_text_based_on_tagging(
                text, crop_prefix=crop_prefix, repeat=3, rng=np.random.default_rng(seed),
                synonym_aug=jaug.SynonymAugmenter(seed=seed))
            assert t == j, (seed, text)


def test_crop_suffix_keeps_prefix():
    crops = taug.crop_text_based_on_tagging(CAPTION, crop_prefix=False, repeat=5,
                                            rng=np.random.default_rng(1))
    for crop in crops:
        assert crop and CAPTION.startswith(crop.split(" ")[0])
        assert len(crop.split()) < len(CAPTION.split())


def test_crop_prefix_keeps_suffix():
    crops = taug.crop_text_based_on_tagging(CAPTION, crop_prefix=True, repeat=5,
                                            rng=np.random.default_rng(2))
    for crop in crops:
        assert crop and crop.split(" ")[-1] == "day"
        assert len(crop.split()) < len(CAPTION.split())
        assert taug.pos_tag_universal(crop)[0][1] in ("NOUN", "VERB", "DET")


def test_adaptive_crop_count_and_partiality():
    ex = taug.adaptive_crop_part_pos_examples(CAPTION, 6, rng=np.random.default_rng(3))
    assert len(ex) == 6 and all(ex)
    for n in (1, 4, 7):
        assert (taug.adaptive_crop_part_pos_examples(CAPTION, n, seed=n)
                == jaug.adaptive_crop_part_pos_examples(CAPTION, n, seed=n))


# ---------------------------------------------------------------- LLM path
def test_parse_llm_response():
    parsed = taug.parse_llm_response(taug.mock_llm_response("x"))
    assert len(parsed) == 5 and parsed[0] == "woman wearing a hat"
    assert all(";" not in p and not p.endswith(".") for p in parsed)
    with pytest.raises(ValueError):
        taug.parse_llm_response("1. only one item")
    response = "Objects: dog, ball.\n1. A dog; 2. a ball. 3. dog runs 4. ball rolls; 5. grass"
    assert taug.parse_llm_response(response) == jaug.parse_llm_response(response)


@pytest.mark.parametrize("strategy", ["adaptive_crop", "adaptive_crop_augment", "llm", "mock",
                                      "bogus"])
def test_get_part_pos_examples_strategies(strategy):
    """Every strategy gives qst_tpu's examples for the same rng (the
    backtranslation of ``adaptive_crop_augment`` on the default paraphraser)."""
    text = "a woman standing in a parking lot taking a photo"
    for n in (4, 5):
        t = taug.get_part_pos_examples(text, n, algorithm_type=strategy,
                                       rng=np.random.default_rng(n))
        j = jaug.get_part_pos_examples(text, n, algorithm_type=strategy,
                                       rng=np.random.default_rng(n))
        assert t == j
        if strategy in ("adaptive_crop", "adaptive_crop_augment"):
            assert len(t) == n
        else:
            assert len(t) == 5
    assert text in taug.build_llm_prompt(text)
    assert taug.build_llm_prompt(text, 3) == jaug.build_llm_prompt(text, 3)


# --------------------------------------------------------- positive mining
def test_pop_random_caption():
    rng = np.random.default_rng(0)
    caps = ["a", "b", "c", "d"]
    got = taug.pop_random_caption(caps, rng=rng)
    assert got in "abcd" and len(caps) == 3 and got not in caps
    assert taug.pop_random_caption(["x", "y"], forbidden={"x"}, rng=rng) == "y"
    caps3 = ["only"]
    assert taug.pop_random_caption(caps3, forbidden={"only"}, max_iterations=3,
                                   rng=rng) == "only" and caps3 == ["only"]
    with pytest.raises(ValueError):
        taug.pop_random_caption(["a"], max_iterations=0)
    for seed in range(5):
        ct, cj = list(TEXTS), list(TEXTS)
        rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
        for forbidden in (set(), {TEXTS[0], TEXTS[2]}, set(TEXTS)):
            assert (taug.pop_random_caption(ct, forbidden, max_iterations=4, rng=rt)
                    == jaug.pop_random_caption(cj, forbidden, max_iterations=4, rng=rj))
            assert ct == cj


def test_compute_cosine_scores():
    scores = taug.compute_cosine_scores(
        "a cat sits on the mat", ["the cat rests on a mat", "a dog runs in the park"], embed)
    assert scores.shape == (2,) and scores[0] > 0.9 > scores[1]
    np.testing.assert_allclose(taug.compute_cosine_scores(TEXTS[0], TEXTS[1:], embed),
                               jaug.compute_cosine_scores(TEXTS[0], TEXTS[1:], embed),
                               rtol=0, atol=1e-6)


def _select_both(group, **kw):
    """select_positive_examples in both packages on copies of ``group`` with
    one seed → (port's result, qst_tpu's)."""
    seed = kw.pop("seed")
    t = taug.select_positive_examples(list(group), embed, rng=np.random.default_rng(seed), **kw)
    j = jaug.select_positive_examples(list(group), embed, rng=np.random.default_rng(seed), **kw)
    return t, j


def test_select_positive_examples_threshold_path():
    group = ["a cat sits on the mat", "the cat rests on a mat", "a small cat lying on the rug",
             "a young cat on the carpet"]
    (pos, ref, scores), (jpos_, jref, jscores) = _select_both(
        group, threshold=0.6, n_examples=3, augment=False, return_similarities=True,
        max_attempts=2, seed=4)
    assert ref in group and len(pos) == 3
    assert (pos, ref) == (jpos_, jref)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-6)


def test_select_positive_examples_retries():
    """A reference with no caption above the threshold is put back and
    another drawn, up to ``max_attempts``: both packages walk the same
    references."""
    group = ["a cat sits on the mat", "the cat rests on a mat", "a dog runs in the park",
             "a plate of pasta with sauce", "an airplane flies high"]
    for seed in range(6):
        t, j = _select_both(group, threshold=0.9, n_examples=2, augment=False,
                            return_similarities=True, max_attempts=4, seed=seed)
        assert t[:2] == j[:2], seed
        np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-6)


def test_select_positive_examples_topk_backup():
    group = ["a cat sits on the mat", "a dog runs in the park", "a plate of pasta with sauce",
             "an airplane flies high"]
    t, j = _select_both(group, threshold=0.99, n_examples=4, augment=True, max_attempts=2,
                        seed=5)
    assert len(t) == 4 and t == j
    with pytest.raises(ValueError):
        taug.select_positive_examples(list(group), embed, max_attempts=0)


@pytest.mark.parametrize("augment", [False, True], ids=["repeat", "augment"])
def test_select_positive_examples_fill(augment):
    """Too few positives: the fill samples from the augmented (paraphrase
    backend) or repeated selection, then repeats — as qst_tpu does."""
    group = ["a cat sits on the mat", "the cat rests on a mat", "a dog runs in the park"]
    for n in (3, 7):
        t, j = _select_both(group, threshold=0.6, n_examples=n, augment=augment,
                            max_attempts=2, seed=n)
        assert len(t) == n and t == j


# ------------------------------------------------------------- LLM client
class _Handler(BaseHTTPRequestHandler):
    requests: list = []
    fail_first = 0

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).requests.append({"path": self.path, "body": body,
                                    "auth": self.headers.get("Authorization")})
        if type(self).fail_first > 0:
            type(self).fail_first -= 1
            self.send_response(500)
            self.end_headers()
            return
        content = ("1. a partial one\n2. a partial two\n3. a partial three\n"
                   "4. a partial four\n5. a partial five")
        resp = json.dumps({"choices": [{"message": {"role": "assistant", "content": content}}],
                           "model": body["model"]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)

    def log_message(self, *a):
        pass


@pytest.fixture
def llm_server():
    _Handler.requests = []
    _Handler.fail_first = 0
    srv = HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}/v1"
    srv.shutdown()


def test_client_roundtrip(llm_server):
    out = taug.OpenAICompatibleClient(llm_server, api_key="sk-test", model="test-model")(
        "give me partials")
    assert "partial one" in out
    (req,) = _Handler.requests
    assert req["path"] == "/v1/chat/completions" and req["auth"] == "Bearer sk-test"
    assert req["body"]["model"] == "test-model"
    assert req["body"]["messages"][0]["content"] == "give me partials"


def test_client_retries_then_succeeds(llm_server, monkeypatch):
    monkeypatch.setattr(tllm.time, "sleep", lambda s: None)
    _Handler.fail_first = 1
    assert "partial two" in taug.OpenAICompatibleClient(llm_server, max_retries=3)("p")
    assert len(_Handler.requests) == 2


def test_client_exhausts_retries(llm_server, monkeypatch):
    monkeypatch.setattr(tllm.time, "sleep", lambda s: None)
    _Handler.fail_first = 99
    with pytest.raises(RuntimeError, match="failed after 2"):
        taug.OpenAICompatibleClient(llm_server, max_retries=2)("p")
    with pytest.raises(ValueError):
        taug.OpenAICompatibleClient("")


def test_env_gate(monkeypatch, llm_server):
    assert taug.get_llm_fn() is None
    monkeypatch.setenv(tllm.BASE_URL_ENV, llm_server)
    fn = taug.get_llm_fn()
    assert fn is not None and "partial three" in fn("x")


def test_part_pos_llm_strategy_uses_env_client(monkeypatch, llm_server):
    monkeypatch.setenv(tllm.BASE_URL_ENV, llm_server)
    out = taug.get_part_pos_examples("a cat sits on the mat", n_part_pos_examples=5,
                                     algorithm_type=taug.LLM)
    assert len(out) == 5 and out[0] == "a partial one" and _Handler.requests


def test_part_pos_llm_strategy_mock_fallback():
    out = taug.get_part_pos_examples("a cat sits on the mat", n_part_pos_examples=5,
                                     algorithm_type=taug.LLM)
    assert out == taug.parse_llm_response(taug.mock_llm_response(""))
