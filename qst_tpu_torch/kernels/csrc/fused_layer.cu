// K1: one BERT encoder layer, forward — a chain of hand-written kernels.
//
// Replaces: qst_tpu/ops/fused_layer_pallas.py `_layer_kernel` (:111), the
// TPU kernel behind `fused_bert_layer` (:189). That kernel holds a block of
// sequences and the whole layer's weights in VMEM and runs QKV, attention,
// output projection, residual+LayerNorm, erf-GELU FFN and residual+LayerNorm
// in one body, so the (S, S) probabilities never reach HBM.
//
// What bounds it on the H100: the five projections, 2·M·(4H² + 2HF) FLOPs
// per layer (M = B·S tokens), against (M·H) activations in and out — at
// M = 32768 and MiniLM widths that is ~116 GFLOP over ~100 MB, far above the
// card's ~295 FLOP/byte bf16 ridge, so the tensor cores are the limit.
// Attention is small at S ≤ 128, a few percent of the operations at S = 384,
// and its probabilities must stay on chip.
//
// What this design does about it (bf16; layer_common.cuh has the details):
// - the projections run as one persistent, warp-specialised GEMM: 128x128
//   output tiles, a 4-stage ring of 64-deep k-steps filled by TMA (128-byte
//   swizzle, mbarriers, one producer thread), two consumer warpgroups that
//   take the block's tiles in turns on wgmma.m64n128k16 with f32
//   accumulators in registers, so one's epilogue runs under the other's
//   products; each consumer warp passes its accumulators through a slab of
//   its own in shared memory so that the bias, erf-GELU (the TPU kernel's
//   rational erf), dropout and residual are applied, loaded and stored row
//   by row as 8- and 16-byte vectors; Q, K and V are one GEMM over the
//   concatenated (H, 3H) weight, so a layer is seven launches;
// - attention runs one block per (sequence, head) on mma.sync.m16n8k16:
//   Q, K and V as bf16 tiles in shared memory (cp.async), a warp per 16
//   query rows with the whole score row in registers, the exact two-pass
//   softmax there, and the probabilities handed to P·V as register
//   fragments — they reach neither shared nor device memory; for
//   128 < S ≤ 512 a block per 64 query rows walks the keys in blocks of 64
//   with a running maximum and sum (attention_kb.cuh); MPNet's (nh·S, S)
//   relative bias (`rel_ref`, :154-155) is added after scale and mask bias
//   in both, a template flag, so BERT's kernels are the ones they were;
// - residual + LayerNorm with f32 statistics runs one warp per row.
// The f32 path (a SIMT FMA GEMM and a SIMT attention with f32 scores in
// shared memory) is kept as the comparison path that holds 1e-4.
// bf16 rounding happens where the TPU kernel rounds: q, k, v after the bias;
// the probabilities before P·V; ctx; the LN1 output; the GELU output; the
// layer output. Not yet: one kernel per layer (each activation of the chain
// still crosses device memory); clusters with TMA multicast or wider tiles
// (a 128x128 tile moves 32 KB from L2 into shared memory per 2 MFLOP).
//
// Training dropout runs in the kernels as the TPU kernel runs it
// (`_drop_mask`, :82-108, hashed in common.cuh): the attention
// probabilities are scaled after the softmax and before their cast, the
// out-projection and FFN-down outputs after the bias and before the
// residual (the EPI_BIAS_RESID_F32 epilogue). The masks are a pure function
// of (seed, b // nb, element, site), so K2 regenerates them bit for bit.
// The GEMMs, attention and LayerNorm live in layer_common.cuh, shared with K2.
#include "attention_kb.cuh"

namespace qst {

// wqkv is [Wq | Wk | Wv] as one (H, 3H) matrix, bqkv its (1, 3H) bias;
// tmp holds the f32 residual sum before each LayerNorm
template <typename T>
int fused_layer_forward(const T* x, const float* mask_bias, const float* rel, const T* wqkv,
                        const float* bqkv,
                        const T* wo, const float* bo, const float* ln1_g,
                        const float* ln1_b, const T* w1, const float* b1, const T* w2,
                        const float* b2, const float* ln2_g, const float* ln2_b,
                        T* qkv, T* ctx, float* tmp, T* y, T* inter, T* out, int B,
                        int S, int H, int F, int nh, float eps, const DropSite& attn_drop,
                        const DropSite& hid_drop, cudaStream_t st) {
  const int M = B * S, hd = H / nh;
  if (S > kMaxSeq || hd > kMaxHeadDim) return (int)cudaErrorInvalidValue;
  int err;
  EpiArgs ep;
  ep.bias = bqkv;
  if ((err = launch_gemm<T, EPI_BIAS>(x, wqkv, qkv, M, 3 * H, H, ep, st))) return err;
  if ((err = launch_attention<T>(qkv, mask_bias, rel, ctx, B, S, H, nh, attn_drop, st)))
    return err;

  EpiArgs res;
  res.bias = bo;
  res.resid = x;
  res.drop = hid_drop;
  res.drop_tag = 0;
  if ((err = launch_gemm<T, EPI_BIAS_RESID_F32>(ctx, wo, tmp, M, H, H, res, st))) return err;
  if ((err = launch_layernorm<T>(tmp, ln1_g, ln1_b, y, M, H, eps, st))) return err;
  EpiArgs up;
  up.bias = b1;
  if ((err = launch_gemm<T, EPI_BIAS_GELU>(y, w1, inter, M, F, H, up, st))) return err;
  res.bias = b2;
  res.resid = y;
  res.drop_tag = 1;
  if ((err = launch_gemm<T, EPI_BIAS_RESID_F32>(inter, w2, tmp, M, H, F, res, st))) return err;
  return launch_layernorm<T>(tmp, ln2_g, ln2_b, out, M, H, eps, st);
}

// The (rows, cols) keep-mask of `_drop_mask` under an already folded seed:
// the device function K1 and K2 use, written out for a bit-for-bit check.
__global__ void drop_mask_kernel(float* __restrict__ out, int rows, int cols, DropSite d,
                                 uint32_t tag) {
  const size_t n = (size_t)rows * cols;
  const uint32_t seed = (uint32_t)d.seed[0];
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = drop_keep(d, seed, (uint32_t)i, tag);
}

}  // namespace qst

using namespace qst;

extern "C" int qst_fused_layer_forward(
    int dtype, const void* x, const void* mask_bias, const void* rel, const void* wqkv,
    const void* bqkv, const void* wo, const void* bo, const void* ln1_g, const void* ln1_b, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* ln2_g,
    const void* ln2_b, void* qkv, void* ctx, void* tmp, void* y, void* inter,
    void* out, int B, int S, int H, int F, int nh, float eps, const void* seed, int nb,
    int attn_on, unsigned attn_thr, float attn_scale, int hid_on, unsigned hid_thr,
    float hid_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const DropSite ad = drop_site(seed, attn_on, attn_thr, attn_scale, nb, S);
  const DropSite hdp = drop_site(seed, hid_on, hid_thr, hid_scale, nb, S);
#define QST_F(p) reinterpret_cast<const float*>(p)
#define QST_LAYER(T)                                                               \
  fused_layer_forward<T>(                                                          \
      reinterpret_cast<const T*>(x), QST_F(mask_bias), QST_F(rel),                 \
      reinterpret_cast<const T*>(wqkv),                                            \
      QST_F(bqkv), reinterpret_cast<const T*>(wo), QST_F(bo), QST_F(ln1_g),        \
      QST_F(ln1_b), reinterpret_cast<const T*>(w1), QST_F(b1),                     \
      reinterpret_cast<const T*>(w2), QST_F(b2), QST_F(ln2_g), QST_F(ln2_b),       \
      reinterpret_cast<T*>(qkv), reinterpret_cast<T*>(ctx),                        \
      reinterpret_cast<float*>(tmp), reinterpret_cast<T*>(y),                      \
      reinterpret_cast<T*>(inter), reinterpret_cast<T*>(out), B, S, H, F, nh, eps, ad, \
      hdp, st)
  if (dtype == QST_F32) return QST_LAYER(float);
  if (dtype == QST_BF16) return QST_LAYER(bf16);
#undef QST_LAYER
#undef QST_F
  return (int)cudaErrorInvalidValue;
}

extern "C" int qst_drop_mask(void* out, int rows, int cols, const void* seed, unsigned thr,
                             float scale, unsigned tag, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const DropSite d = drop_site(seed, 1, thr, scale, 1, 1);
  drop_mask_kernel<<<264, 256, 0, st>>>(reinterpret_cast<float*>(out), rows, cols, d, tag);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
