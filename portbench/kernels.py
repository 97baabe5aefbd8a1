"""The port's kernels as the benchmark sees them: the wrapper whose
``.launches`` counts each one, and the CUDA function names a device trace
shows for it.

K1 (the fused encoder layer) and K2 (its backward, which recomputes the
forward) share their GEMM, attention and LayerNorm kernels, so a trace tells
them apart by who launched them and where they run in a train step. A layer
kernel that a CUDA graph replay launched (the captured train step, on the
main thread) is K1 between a step's start and its K3 forward and K2 after
K3's backward until the optimizer's first foreach kernel; one launched
otherwise (the miner's encodes on the data thread, an encode call) is K1.

``ANCHORS``: the kernels a trace must hold per launch of a wrapper (the C2
check): K1's forward attention runs once per K1 launch and once per K2
launch; K2 runs two LayerNorm backward kernels a launch.
"""

from __future__ import annotations

import importlib
import re
from typing import Dict, List, Optional, Sequence, Tuple

# label → (module, wrappers whose .launches add up)
COUNTERS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "K1": ("qst_tpu_torch.ops.fused_layer", ("fused_bert_layer",)),
    "K2": ("qst_tpu_torch.ops.fused_layer", ("fused_bert_layer_bwd",)),
    "K3": ("qst_tpu_torch.ops.quadruplet", ("fused_gamma_quadruplet_loss_fwd",
                                            "fused_gamma_quadruplet_loss_bwd")),
    "K4": ("qst_tpu_torch.ops.topk", ("bucket_maxima",)),
    "K5": ("qst_tpu_torch.ops.topk", ("rescore_buckets",)),
    "K6": ("qst_tpu_torch.ops.ivf", ("ivf_cell_scores",)),
    "K7": ("qst_tpu_torch.ops.flash_attention", ("flash_attention",)),
    "K8": ("qst_tpu_torch.ops.flash_attention", ("flash_attention_bwd",)),
    "K9": ("qst_tpu_torch.ops.fused_layer", ("module_keep_mask",)),
}

LAYER = {"gemm_bf16_kernel", "gemm_f32_kernel", "attention_kernel", "attention_mma_kernel",
         "attention_kb_kernel", "attention_kb_mma_kernel", "layernorm_kernel", "sum_rows_kernel",
         "attention_bwd_kernel", "attention_bwd_mma_kernel", "attention_bwd_q_kernel",
         "attention_bwd_q_f32_kernel", "attention_bwd_kv_kernel", "attention_bwd_kv_f32_kernel",
         "attention_drel_kernel", "attention_drel_f32_kernel", "layernorm_bwd_kernel",
         "drop_mask_kernel"}
OWN = {"quadruplet_fwd_kernel": "K3", "quadruplet_bwd_kernel": "K3",
       "bucket_max_simt_kernel": "K4", "bucket_max_wgmma_kernel": "K4",
       "rescore_kernel": "K5", "rescore_mma_kernel": "K5", "ivf_cell_scores_kernel": "K6",
       "flash_fwd_wgmma_kernel": "K7", "flash_fwd_f32_kernel": "K7",
       "flash_bwd_prep_kernel": "K8", "flash_bwd_wgmma_kernel": "K8",
       "flash_bwd_dkv_f32_kernel": "K8", "flash_bwd_dq_f32_kernel": "K8",
       "module_keep_kernel": "K9"}
FORWARD_ATTENTION = {"attention_kernel", "attention_mma_kernel", "attention_kb_kernel",
                     "attention_kb_mma_kernel"}
# label → (function names counted, records per launch of each counted label)
ANCHORS = {
    "K1": (FORWARD_ATTENTION, {"K1": 1, "K2": 1}),
    "K2": ({"layernorm_bwd_kernel"}, {"K2": 2}),
    "K3": ({"quadruplet_fwd_kernel", "quadruplet_bwd_kernel"}, {"K3": 1}),
    "K4": ({"bucket_max_simt_kernel", "bucket_max_wgmma_kernel"}, {"K4": 1}),
    "K5": ({"rescore_kernel", "rescore_mma_kernel"}, {"K5": 1}),
    "K6": ({"ivf_cell_scores_kernel"}, {"K6": 1}),
    "K7": ({"flash_fwd_wgmma_kernel", "flash_fwd_f32_kernel"}, {"K7": 1}),
    "K8": ({"flash_bwd_prep_kernel"}, {"K8": 1}),
    "K9": ({"module_keep_kernel"}, {"K9": 1}),
}

_BASE = re.compile(r"(\w+_kernel)\b")


def base_name(name: str) -> Optional[str]:
    """The port's CUDA function name in a trace record, or None for another's."""
    if "qst::" not in name and "_kernel" not in name:
        return None
    for m in _BASE.finditer(name):
        if m.group(1) in LAYER or m.group(1) in OWN:
            return m.group(1)
    return None


def launches() -> Dict[str, int]:
    """Each kernel's launches so far, by label."""
    out = {}
    for label, (mod, names) in COUNTERS.items():
        m = importlib.import_module(mod)
        out[label] = sum(int(getattr(m, n).launches) for n in names)
    return out


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


def label_kernels(names: Sequence[str], from_graph: Optional[Sequence[bool]] = None) -> List[str]:
    """A label for each device record of a time-ordered trace: K1…K9 for the
    port's kernels, ``optimizer`` for foreach kernels, ``memcpy``,
    ``memset``, ``library`` for another library's GEMM, else ``other``.
    ``from_graph``: whether a CUDA graph replay launched each record; only
    those move the step's phase. Without it, or where no record came from a
    graph, every record does."""
    if from_graph is None or not any(from_graph):
        from_graph = [True] * len(names)
    out, phase = [], "fwd"
    for name, graph in zip(names, from_graph):
        base = base_name(name)
        low = name.lower()
        if base in OWN:
            label = OWN[base]
            if base == "quadruplet_bwd_kernel" and graph:
                phase = "bwd"
        elif base in LAYER:
            if not graph:
                label = "K1"
            else:
                if phase == "opt":
                    phase = "fwd"
                label = "K2" if phase == "bwd" else "K1"
        elif "multi_tensor_apply" in low or "foreach" in low:
            label = "optimizer"
            if phase == "bwd" and graph:
                phase = "opt"
        elif low.startswith("memcpy"):
            label = "memcpy"
        elif low.startswith("memset"):
            label = "memset"
        elif "gemm" in low or "cutlass" in low or "xmma" in low or "cublas" in low:
            label = "library"
        else:
            label = "other"
        out.append(label)
    return out
