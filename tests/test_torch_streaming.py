"""The port's host-streamed exact index (``retrieval/streaming.py``) against
qst_tpu's, over one ``.npy`` memmap.

Both packages search the same memmap (5,000 rows, 2,048-row tiles: the last
tile ragged) for every transfer dtype (f32, bf16, int8 quantized per tile on
the fly, a pre-quantized int8 corpus), cos and dot, with and without
``normalize``; the port's ``"pallas"`` path (``topk_local``: the plain K4
and K5 on CPU tensors) and its ``"xla"`` path against the JAX package's
``"xla"`` path, and once against its Pallas path in interpret mode.
Tolerances: f32 scores 1e-5 absolute and 1e-6 relative (the same products,
f32 sums in another order; dot scores reach 90 here), ids up to ties; the
host int8 tiles and their scales bit for bit.
Artifacts cross the packages both ways. The double buffer runs only on a
GPU (``cuda`` marker; skipped here): its test stalls the device behind the
host and holds the stream to the whole corpus searched at once.
"""

import time

import numpy as np
import pytest
import torch

from qst_tpu.retrieval import streaming as jstreaming
from qst_tpu.retrieval.retriever import Retriever as JaxRetriever
from qst_tpu.retrieval.retriever import load_index as jax_load_index
from qst_tpu_torch.ops.distances import l2_normalize
from qst_tpu_torch.retrieval import ExactIndex, Retriever, StreamingExactIndex, load_index
from qst_tpu_torch.retrieval import streaming as tstreaming
from test_torch_slice import assert_topk_equal_up_to_ties

TOL = dict(rtol=1e-6, atol=1e-5)
N, D, TILE = 5000, 32, 2048


@pytest.fixture(scope="module")
def memmap(tmp_path_factory):
    """A (5,000, 32) f32 corpus on disk, memory-mapped, and 9 queries; the
    rows have norms between 0.5 and 4 so cos and dot rank differently."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x *= rng.uniform(0.5, 4.0, (N, 1)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("stream") / "emb.npy")
    np.save(path, x)
    q = rng.standard_normal((9, D)).astype(np.float32)
    return path, np.load(path, mmap_mode="r"), q


CASES = [(t, s, n) for t in ("float32", "bfloat16", "int8")
         for s in ("cos_sim", "dot_score") for n in (False, True)
         if not (t == "int8" and n)]


@pytest.mark.parametrize("transfer, score, normalize", CASES)
def test_streaming_matches_jax(memmap, transfer, score, normalize):
    path, mm, q = memmap
    kw = dict(tile_rows=TILE, transfer_dtype=transfer, normalize=normalize)
    want = jstreaming.StreamingExactIndex.from_npy(path, **kw).search(q, k=7, score=score)
    idx = StreamingExactIndex.from_npy(path, device="cpu", **kw)
    for backend in ("xla", "pallas"):
        got = idx.search(q, k=7, score=score, backend=backend)
        assert_topk_equal_up_to_ties(*got, *want, **TOL)


def test_prequantized_int8_and_the_host_tiles(memmap):
    """quantize_host is the JAX package's bit for bit; a pre-quantized
    corpus streams verbatim at scale 127; each on-the-fly int8 tile (rows
    split over threads) and its scale equal the JAX ``_host_tile``'s."""
    path, mm, q = memmap
    q8 = StreamingExactIndex.quantize_host(mm)
    np.testing.assert_array_equal(q8, jstreaming.StreamingExactIndex.quantize_host(mm))
    want = jstreaming.StreamingExactIndex(q8, tile_rows=TILE,
                                          transfer_dtype="int8").search(q, k=7)
    got = StreamingExactIndex(q8, tile_rows=TILE, transfer_dtype="int8",
                              device="cpu").search(q, k=7, backend="pallas")
    assert_topk_equal_up_to_ties(*got, *want, **TOL)
    jidx = jstreaming.StreamingExactIndex(mm, tile_rows=TILE, transfer_dtype="int8")
    idx = StreamingExactIndex(mm, tile_rows=TILE, transfer_dtype="int8", device="cpu")
    block = tstreaming._HOST_BLOCK
    try:
        tstreaming._HOST_BLOCK = 300          # several threads a tile
        for t in range(3):
            tile, scale = jidx._host_tile(t)
            out = torch.empty((TILE, D), dtype=torch.int8)
            assert idx._fill_tile(t, out) == scale
            np.testing.assert_array_equal(out.numpy(), tile)
    finally:
        tstreaming._HOST_BLOCK = block


def test_bf16_tiles_cast_on_the_host_and_jax_interpret(memmap):
    """A bf16 tile is the memmap's rows rounded to bf16 on the host
    (round-to-nearest-even, as a cast on the device would round), the
    ragged last tile zero-padded. And the port's kernels' path against the
    JAX Pallas path in interpret mode."""
    path, mm, q = memmap
    idx = StreamingExactIndex(mm, tile_rows=TILE, device="cpu")
    tile = torch.empty((TILE, D), dtype=torch.bfloat16)
    assert idx._fill_tile(2, tile) == 1.0
    n = N - 2 * TILE
    assert torch.equal(tile[:n].view(torch.int16), torch.from_numpy(
        np.array(mm[2 * TILE:])).to(torch.bfloat16).view(torch.int16))
    assert not tile[n:].any()
    want = jstreaming.StreamingExactIndex(mm, tile_rows=TILE, transfer_dtype="float32").search(
        q, k=6, backend="pallas")
    got = StreamingExactIndex(mm, tile_rows=TILE, transfer_dtype="float32",
                              device="cpu").search(q, k=6, backend="pallas")
    assert_topk_equal_up_to_ties(*got, *want, **TOL)


def test_bf16_stream_equals_exact_index_and_refusals(memmap):
    """A bf16 cos stream equals a bf16 ExactIndex over the rows it sends
    (each rounded to bf16, normalized, rounded again) searched by dot."""
    path, mm, q = memmap
    got = StreamingExactIndex(mm, tile_rows=TILE, device="cpu").search(q, k=7, backend="pallas")
    sent = l2_normalize(torch.from_numpy(np.array(mm)).to(torch.bfloat16).float())
    want = ExactIndex(sent.to(torch.bfloat16).float(), dtype="bfloat16", device="cpu").search(
        l2_normalize(torch.from_numpy(q)), k=7, score="dot_score", backend="xla")
    assert_topk_equal_up_to_ties(*got, *want, **TOL)
    idx = StreamingExactIndex(mm, tile_rows=TILE, ids=[f"d{i}" for i in range(N)],
                              device="cpu")
    s, ids = idx.search_ids(q, k=3)
    assert ids[0][0] == f"d{got[1][0][0]}"
    with pytest.raises(ValueError, match="pallas backend supports k <= 128"):
        idx.search(q, k=200, backend="pallas")
    assert idx.search(q, k=200)[0].shape == (9, 200)           # auto: the plain path
    for kw, match in (({"tile_rows": 100}, "multiple of 128"),
                      ({"transfer_dtype": "float16"}, "transfer_dtype"),
                      ({"transfer_dtype": "int8", "normalize": True}, "always normalizes")):
        with pytest.raises(ValueError, match=match):
            StreamingExactIndex(mm, device="cpu", **kw)
    with pytest.raises(TypeError, match="Mesh"):
        StreamingExactIndex(mm, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="cos_sim|dot_score"):
        idx.search(q, score="euclid_score")


class _HashEncoder:
    def encode(self, texts):
        from helpers import hash_embed

        return hash_embed(list(texts), dim=D)


def test_streaming_artifacts_cross_packages(tmp_path):
    """``build_to_disk`` of either package streams in the other (and the
    port's Retriever answers through the index's own ``search_ids``)."""
    docs = [f"topic {i % 7} document number {i}" for i in range(700)]
    JaxRetriever(_HashEncoder()).build_to_disk(docs, str(tmp_path / "jax"), encode_batch=256)
    idx, meta = load_index(str(tmp_path / "jax"), dtype="streaming", device="cpu")
    assert isinstance(idx, StreamingExactIndex) and idx.n_docs == 700
    tr = Retriever(_HashEncoder(), index_dtype="streaming", device="cpu")
    tr.build_to_disk(docs, str(tmp_path / "port"), encode_batch=256)
    np.testing.assert_array_equal(np.load(str(tmp_path / "port" / "embeddings.npy")),
                                  np.load(str(tmp_path / "jax" / "embeddings.npy")))
    jidx, _ = jax_load_index(str(tmp_path / "port"), dtype="streaming")
    q = _HashEncoder().encode(["topic 3 document", "number 12"])
    assert_topk_equal_up_to_ties(*idx.search(q, k=5), *jidx.search(q, k=5), **TOL)
    rows = tr.search(["topic 3 document"], k=3, return_texts=True)
    assert len(rows[0]) == 3 and all(docs[d] == t for d, _, t in rows[0])
    assert tr.search_async(["topic 3 document"], k=3, return_texts=True)() == rows
    again = Retriever(_HashEncoder(), index_dtype="streaming", device="cpu").load(
        str(tmp_path / "jax"))
    assert again.search(["topic 3 document"], k=3, return_texts=True) == rows


def _resident_topk(idx, q, k):
    """The cos top-k over the whole corpus as ``idx`` sends it, held on the
    card at once (no stream): float rows normalized as a tile is, int8 rows
    with their tile's scale, the queries prepared as the search prepares
    them; one product."""
    n_tiles = -(-idx.n_docs // idx.tile_rows)
    tiles, scales = [], []
    for t in range(n_tiles):
        buf = torch.empty((idx.tile_rows, idx.dim), dtype=idx.transfer_dtype)
        scales.append(idx._fill_tile(t, buf))
        tiles.append(buf.cuda())
    rows = torch.cat(tiles)[: idx.n_docs]
    qq = l2_normalize(torch.from_numpy(q).cuda().float())
    if idx.transfer_dtype == torch.int8:
        qs = 127.0 / torch.clamp(qq.abs().max(), min=1e-12)
        qq = torch.clamp(torch.round(qq * qs), -127, 127)
        row_scale = torch.tensor(scales, device="cuda").repeat_interleave(idx.tile_rows)
        s = (qq @ rows.float().T) * (1.0 / (qs * row_scale[: idx.n_docs]))
    else:
        rows = l2_normalize(rows.float()).to(idx.transfer_dtype).float()
        s = qq.to(idx.transfer_dtype).float() @ rows.T
    return torch.topk(s, k, dim=1)


def _stalled_double_buffer(monkeypatch, mesh=None):
    """Eight tiles through the two device buffers, each shard's search
    stalled; the kernels' path against ``_resident_topk``."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 8)
    end.record()
    end.synchronize()
    cycles_per_ms = 10 ** 8 / start.elapsed_time(end)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8 * 65536 - 1000, 384)).astype(np.float32)
    q = rng.standard_normal((256, 384)).astype(np.float32)
    step = StreamingExactIndex._tile_step
    for transfer in ("bfloat16", "int8", "float32"):
        idx = StreamingExactIndex(x, tile_rows=65536, transfer_dtype=transfer, mesh=mesh)
        buf = torch.empty((65536, 384), dtype=idx.transfer_dtype)
        t0 = time.perf_counter()
        idx._fill_tile(1, buf)
        stall = int(4 * (time.perf_counter() - t0) * 1e3 * cycles_per_ms)

        def stalled(*args, **kw):
            torch.cuda._sleep(stall)
            return step(*args, **kw)

        monkeypatch.setattr(StreamingExactIndex, "_tile_step", staticmethod(stalled))
        got = idx.search(q, k=10, backend="pallas")
        monkeypatch.undo()
        want = _resident_topk(idx, q, 10)
        assert_topk_equal_up_to_ties(*got, *(t.cpu().numpy() for t in want), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_double_buffer_reuses_its_buffers_safely_on_the_card(monkeypatch):
    """Eight tiles through the two device buffers, the last ragged, with
    the compute stream stalled before each tile's search for four times
    the host's fill of a tile, so the device falls behind the host: a copy
    that did not wait until the search of the buffer's last tile had read
    it would overwrite that tile first. The kernels' path equals a top-k
    over the whole corpus as sent, held on the card at once, for bf16, int8
    quantized per tile and f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    _stalled_double_buffer(monkeypatch)


@pytest.mark.cuda
def test_double_buffer_reuses_its_buffers_safely_on_a_sharded_index(monkeypatch):
    """The same eight stalled tiles over a 4 × 2 mesh of one card: one
    copy stream and one pair of device buffers for the card, each tile's
    eight shards searched from views of them, a copy never overwriting a
    buffer before every shard's search of it was queued."""
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    from qst_tpu_torch.core.meshes import make_mesh

    _stalled_double_buffer(monkeypatch, make_mesh(4, 2, devices=["cuda:0"] * 8))
