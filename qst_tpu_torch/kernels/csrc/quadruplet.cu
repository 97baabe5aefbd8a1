// K3: the fused γ-quadruplet loss, forward and backward.
//
// Replaces: qst_tpu/ops/quadruplet_pallas.py `_kernel` (:33), the TPU kernel
// behind `_forward` (:64) and `fused_gamma_quadruplet_loss` (:92): one pass
// over the anchor, positive, part-positive and negative rows gives
// d(a,p), d(a,t), d(a,n) as ‖x − y + 1e-6‖₂, the three margin hinges and
// their γ-combination, and saves the (B, 3) distances for the backward,
// which qst_tpu writes in jnp (:124-160) and this file as a second kernel.
// p = 2 without swap only, as LossConfig enforces for the fused kernel.
//
// What bounds it on the H100: 4·B·D f32 read once (forward) or twice with
// 4·B·D written (backward) — 0.2 MB at B = 32, D = 384 — so it is a few
// microseconds of launch latency, not bandwidth or arithmetic: what counts
// is the number of launches and of host calls around them.
//
// What this design does about it: one launch each way. One warp per row,
// lanes striding over D with f32 sums reduced by shuffles, so no (B, D)
// difference tensor reaches device memory. The forward also writes the
// reduced loss (the sum, or the mean, of the per-example losses), added up in
// a fixed order (thread t the losses t, t + 1024, ... in turn, then a fixed
// tree), so two calls on the same inputs give the same bits. Up to a few
// hundred rows (a train step has 32) one block of 32 warps does it all and
// shares no state with any other launch. Above that the rows spread over the
// card and the block that finishes last, by a counter in device memory, adds
// up: the counter is the caller's, zeroed for this launch alone, so launches
// on different streams cannot disturb each other. The backward reads the
// saved distances instead of recomputing them, and the upstream gradient
// where autograd left it: a scalar on the device for a sum or a mean (times
// 1/B), one value an example otherwise.
#include "common.cuh"

namespace qst {

struct Margins {
  float gamma, w_c;         // γ and float32(1 − γ)
  float m_pn, m_pt, m_tn;   // pos-neg, pos-part, part-neg margins
};

constexpr float kEps = 1e-6f;
constexpr int kFwdWarps = 32;     // forward: a warp a row, rows a grid stride apart
constexpr int kRowsPerBlock = 8;  // backward: a warp a row

// reduce: 0 leaves `total` alone; else total[0] = total_scale · Σ loss
// (total_scale 1 for a sum, 1/B for a mean), written by the only block, or in
// a grid of several by the one that `counter` (one int, 0 at launch) shows
// to be last.
__global__ void __launch_bounds__(32 * kFwdWarps)
quadruplet_fwd_kernel(const float* __restrict__ a, const float* __restrict__ p,
                      const float* __restrict__ t, const float* __restrict__ n,
                      float* __restrict__ loss, float* __restrict__ dists,
                      float* __restrict__ total, unsigned int* __restrict__ counter, int B,
                      int D, Margins mg, int reduce, float total_scale) {
  __shared__ float partial[kFwdWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = blockIdx.x * kFwdWarps + warp; row < B; row += gridDim.x * kFwdWarps) {
    const size_t o = (size_t)row * D;
    float sp = 0.0f, st = 0.0f, sn = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float x = a[o + c];
      const float dp = x - p[o + c] + kEps, dt = x - t[o + c] + kEps, dn = x - n[o + c] + kEps;
      sp += dp * dp;
      st += dt * dt;
      sn += dn * dn;
    }
    const float d_ap = sqrtf(warp_sum(sp)), d_at = sqrtf(warp_sum(st)),
                d_an = sqrtf(warp_sum(sn));
    if (lane == 0) {
      const float la = fmaxf(d_ap - d_an + mg.m_pn, 0.0f);
      const float lb = fmaxf(d_at - d_an + mg.m_tn, 0.0f);
      const float lc = fmaxf(d_ap - d_at + mg.m_pt, 0.0f);
      loss[row] = la + mg.gamma * lb + mg.w_c * lc;
      dists[3 * row] = d_ap;
      dists[3 * row + 1] = d_at;
      dists[3 * row + 2] = d_an;
    }
  }
  if (!reduce) return;
  if (gridDim.x > 1) {  // the block that arrives last sees every block's losses
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  } else {
    __syncthreads();
  }
  const volatile float* all = loss;
  float s = 0.0f;
  for (int i = threadIdx.x; i < B; i += 32 * kFwdWarps) s += all[i];
  s = warp_sum(s);
  if (lane == 0) partial[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int w = 0; w < kFwdWarps; ++w) sum += partial[w];
    total[0] = sum * total_scale;
  }
}

// The gradients of Σ_i scale_i · loss_i, grads (4, B, D) = [da, dp, dt, dn].
// scale_i = upstream[i] if per_example, else upstream[0] · scale_const.
__global__ void __launch_bounds__(32 * kRowsPerBlock)
quadruplet_bwd_kernel(const float* __restrict__ a, const float* __restrict__ p,
                      const float* __restrict__ t, const float* __restrict__ n,
                      const float* __restrict__ dists, const float* __restrict__ upstream,
                      float* __restrict__ grads, int B, int D, Margins mg, int per_example,
                      float scale_const) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;
  const float d_ap = dists[3 * row], d_at = dists[3 * row + 1], d_an = dists[3 * row + 2];
  const float act_a = d_ap - d_an + mg.m_pn > 0.0f ? 1.0f : 0.0f;
  const float act_b = d_at - d_an + mg.m_tn > 0.0f ? 1.0f : 0.0f;
  const float act_c = d_ap - d_at + mg.m_pt > 0.0f ? 1.0f : 0.0f;
  const float s = per_example ? upstream[row] : scale_const * upstream[0];
  const float c_ap = (act_a + mg.w_c * act_c) * s;
  const float c_at = (mg.gamma * act_b - mg.w_c * act_c) * s;
  const float c_an = (-act_a - mg.gamma * act_b) * s;
  const float n_ap = fmaxf(d_ap, 1e-12f), n_at = fmaxf(d_at, 1e-12f), n_an = fmaxf(d_an, 1e-12f);
  const size_t o = (size_t)row * D, role = (size_t)B * D;
  for (int c = lane; c < D; c += 32) {
    const float x = a[o + c];
    const float u_ap = (x - p[o + c] + kEps) / n_ap;
    const float u_at = (x - t[o + c] + kEps) / n_at;
    const float u_an = (x - n[o + c] + kEps) / n_an;
    grads[o + c] = c_ap * u_ap + c_at * u_at + c_an * u_an;
    grads[role + o + c] = -c_ap * u_ap;
    grads[2 * role + o + c] = -c_at * u_at;
    grads[3 * role + o + c] = -c_an * u_an;
  }
}

}  // namespace qst

using namespace qst;

#define QST_F(x) reinterpret_cast<const float*>(x)

// loss (B,), dists (B, 3), total (1,) f32; reduce 0 none, 1 sum, 2 mean.
// counter: one int32 zeroed for this launch, or null: a sum or a mean is then
// taken by one block over all the rows
extern "C" int qst_quadruplet_forward(const void* a, const void* p, const void* t,
                                      const void* n, void* loss, void* dists, void* total,
                                      void* counter, int B, int D, int reduce, float gamma,
                                      float w_c, float m_pn, float m_pt, float m_tn,
                                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Margins mg{gamma, w_c, m_pn, m_pt, m_tn};
  if (B <= 0) return 0;
  const int blocks = reduce && counter == nullptr ? 1 : (B + kFwdWarps - 1) / kFwdWarps;
  quadruplet_fwd_kernel<<<blocks, 32 * kFwdWarps, 0, st>>>(
      QST_F(a), QST_F(p), QST_F(t), QST_F(n), reinterpret_cast<float*>(loss),
      reinterpret_cast<float*>(dists), reinterpret_cast<float*>(total),
      reinterpret_cast<unsigned int*>(counter), B, D, mg, reduce,
      reduce == 2 ? 1.0f / (float)B : 1.0f);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// upstream: (B,) when per_example, else one value scaled by scale_const;
// grads (4, B, D)
extern "C" int qst_quadruplet_backward(const void* a, const void* p, const void* t,
                                       const void* n, const void* dists, const void* upstream,
                                       void* grads, int B, int D, int per_example,
                                       float scale_const, float gamma, float w_c, float m_pn,
                                       float m_pt, float m_tn, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Margins mg{gamma, w_c, m_pn, m_pt, m_tn};
  if (B <= 0) return 0;
  quadruplet_bwd_kernel<<<(B + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, st>>>(
      QST_F(a), QST_F(p), QST_F(t), QST_F(n), QST_F(dists), QST_F(upstream),
      reinterpret_cast<float*>(grads), B, D, mg, per_example, scale_const);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

#undef QST_F
