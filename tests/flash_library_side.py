"""JAX's library flash attention (behind qst_tpu's ``use_flash_attention``)
in TPU interpret mode, in a process of its own, for tests/test_torch_flash.py.

    python tests/flash_library_side.py INPUTS.npz OUTPUTS.npz

The library keeps one simulated TPU's memory, and the callback threads that
serve it, for the whole process. Inside a test worker that has already run
other JAX tests an interpreted kernel stalled on that state (seen under
pytest-xdist), so the interpreted runs happen here, in a fresh interpreter.
Each run is one jitted program, and the CPU backend runs programs inline (no
async dispatch): the interpreter's callbacks dispatch JAX operations of
their own, and with the encoder's gradient dispatched op by op they queued
behind the main thread's next operation, which waited for the kernel that
waited for them (a hang seen under a loaded pytest-xdist run).

INPUTS holds the op cases ``<case>_{q,k,v,do,seg}`` (their names in
``cases``; ``<case>_segkv``, where present, the keys' segment ids, else
``seg``) and the encoder's config (``enc_cfg``, JSON), weight seed
(``enc_seed``), ids, mask and loss weights ``enc_w``. OUTPUTS gets, for each
op case, the library's o, l, m and the gradients of Σ o·dO (``<case>_dq`` ...);
for the encoder its ``token_embeddings`` and ``sentence_embedding`` and the
gradient of Σ w·sentence_embedding as the port's state dict (``grad/<name>``).
"""

import dataclasses
import faulthandler
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_enable_async_dispatch", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402
from jax.experimental.pallas.ops.tpu import flash_attention as jfa  # noqa: E402


def op_case(inp, case: str, out: dict) -> None:
    q, k, v, do, seg = (inp[f"{case}_{n}"] for n in ("q", "k", "v", "do", "seg"))
    seg_kv = inp[f"{case}_segkv"] if f"{case}_segkv" in inp else seg
    B, nh, S, hd = q.shape
    sc = hd ** -0.5
    ids = jfa.SegmentIds(jnp.asarray(seg), jnp.asarray(seg_kv))

    def lib(q, k, v):
        return jfa.flash_attention(q, k, v, segment_ids=ids, sm_scale=sc)

    with pltpu.force_tpu_interpret_mode():
        # the forward with its residuals (o, l, m), then the gradients
        o, l, m = jax.jit(lambda q, k, v: jfa._flash_attention(
            q, k, v, None, ids, True, False, sc,
            jfa.BlockSizes.get_default(B, nh, S, S, hd), False))(q, k, v)
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(lib(*a) * do), argnums=(0, 1, 2)))(q, k, v)
    out.update({f"{case}_o": o, f"{case}_l": l, f"{case}_m": m})
    out.update({f"{case}_d{n}": g for n, g in zip("qkv", grads)})


def encoder_case(inp, out: dict) -> None:
    from qst_tpu.core.config import EncoderConfig
    from qst_tpu.models import sentence_encoder as jse
    from qst_tpu_torch.core.config import EncoderConfig as PortConfig
    from qst_tpu_torch.models.hf_import import state_dict_from_flax_params

    jcfg = EncoderConfig(**json.loads(str(inp["enc_cfg"])))
    # init's forward runs at max_seq_length: with the flag off (the same tree)
    params = jse.init_params(dataclasses.replace(jcfg, use_flash_attention=False),
                             jax.random.key(int(inp["enc_seed"])))
    module = jse.SentenceEncoderModule(jcfg)
    ids, mask, w = (jnp.asarray(inp[f"enc_{n}"]) for n in ("ids", "mask", "w"))

    def loss(p):
        res = module.apply({"params": p}, ids, mask)
        return jnp.sum(res["sentence_embedding"] * w), res

    with pltpu.force_tpu_interpret_mode():
        (_, res), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out.update({k: v for k, v in res.items()})
    sd = state_dict_from_flax_params(jax.tree.map(np.asarray, grads),
                                     PortConfig(**dataclasses.asdict(jcfg)))
    out.update({f"grad/{k}": v.numpy() for k, v in sd.items()})


def main(inputs: str, outputs: str) -> None:
    inp = np.load(inputs)
    out: dict = {}
    for case in inp["cases"]:
        op_case(inp, str(case), out)
    if "enc_cfg" in inp:
        encoder_case(inp, out)
    np.savez(outputs, **{k: np.asarray(v) for k, v in out.items()})


if __name__ == "__main__":
    faulthandler.dump_traceback_later(600, exit=True)   # a stall shows where
    main(*sys.argv[1:3])
