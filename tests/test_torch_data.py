"""The port's host copies of the data pipeline against their sources:
``qst_tpu/data/chunks.py``, ``collate.py`` and ``prefetch.py`` are held to
the source code (docstrings aside), ``quadruplet_dataset.py`` — the
miner-less path only — to the draws of qst_tpu's dataset on the same chunk
files.
"""

import ast
import inspect
import textwrap

import numpy as np
import pytest

from helpers import write_synthetic_dataset
from qst_tpu.data import chunks as jchunks
from qst_tpu.data import collate as jcollate
from qst_tpu.data import prefetch as jprefetch
from qst_tpu.data import quadruplet_dataset as jds
from qst_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from qst_tpu_torch.core import config as tconfig
from qst_tpu_torch.data import chunks as tchunks
from qst_tpu_torch.data import collate as tcollate
from qst_tpu_torch.data import prefetch as tprefetch
from qst_tpu_torch.data import quadruplet_dataset as tds
from qst_tpu_torch.models.tokenizer import HashTokenizer


def _code(obj):
    """The object's AST with docstrings dropped (comments never enter it)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(obj)))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module,names", [
    ("chunks", ["chunk_path", "write_chunk", "write_meta", "read_meta", "discover_chunks",
                "ChunkStore"]),
    ("collate", ["QuadrupletBatch", "select_single_example", "QuadrupletCollator"]),
    ("prefetch", ["PrefetchIterator"]),
    ("quadruplet_dataset", ["choose_examples"]),
])
def test_host_copies_are_the_source_code(module, names):
    src = {"chunks": jchunks, "collate": jcollate, "prefetch": jprefetch,
           "quadruplet_dataset": jds}[module]
    dst = {"chunks": tchunks, "collate": tcollate, "prefetch": tprefetch,
           "quadruplet_dataset": tds}[module]
    for name in names:
        assert _code(getattr(dst, name)) == _code(getattr(src, name)), name
    if module == "chunks":
        assert (tchunks.CHUNK_RE.pattern, tchunks.META_FILENAME) == (
            jchunks.CHUNK_RE.pattern, jchunks.META_FILENAME)


def test_dataset_draws_match_the_source(tmp_path):
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=3, chunk_dim=7)
    j = jds.QuadrupletDataset(root, n_pos=2, n_part_pos=3, n_neg=2, cache_size=2, seed=5)
    t = tds.QuadrupletDataset(root, n_pos=2, n_part_pos=3, n_neg=2, cache_size=2, seed=5)
    assert len(t) == len(j) == 21
    for epoch in (0, 1):
        for kw in (dict(), dict(start_batch=1, step_offset=3), dict(drop_last=False)):
            jb = list(j.iter_batches(4, epoch=epoch, **kw))
            tb = list(t.iter_batches(4, epoch=epoch, **kw))
            assert tb == jb
    assert t[[0, 5, 20]] == j[[0, 5, 20]]          # the mutable stream, map-style
    assert t.cache_stats == j.cache_stats


def test_collated_batches_match_the_source(tmp_path):
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=2, chunk_dim=6)
    insts = tds.QuadrupletDataset(root, seed=1).sample_batch(range(8), step=0)
    jb = jcollate.QuadrupletCollator(JaxHashTokenizer(vocab_size=512), 32, seed=3)(insts)
    tb = tcollate.QuadrupletCollator(HashTokenizer(vocab_size=512), 32, seed=3)(insts)
    np.testing.assert_array_equal(tb.input_ids, jb.input_ids)
    np.testing.assert_array_equal(tb.attention_mask, jb.attention_mask)
    assert tb.input_ids.shape == (4, 8, 32) and tb.batch_size == 8


def test_prefetch_copy_runs_and_surfaces_errors():
    it = tprefetch.PrefetchIterator(iter(range(10)), transform=lambda x: x * 3, depth=2)
    assert list(it) == [3 * i for i in range(10)]

    def bad():
        yield 1
        raise RuntimeError("producer failed")

    it = tprefetch.PrefetchIterator(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_mining_is_not_ported_yet(tmp_path):
    root = str(tmp_path / "chunks")
    write_synthetic_dataset(root, n_chunks=1, chunk_dim=4)
    with pytest.raises(NotImplementedError, match="mining"):
        tds.QuadrupletDataset(root, miner=object())
    cfg = tconfig.DataConfig(root=root)
    with pytest.raises(NotImplementedError, match="mining"):
        tds.QuadrupletDataset.from_config(cfg, encode_fn=lambda texts: None)
    assert len(tds.QuadrupletDataset.from_config(cfg)) == 4
    assert tds.RANDOM == -1
