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
// microseconds of launch latency, not bandwidth or arithmetic.
//
// What this design does about it: one warp per row, lanes striding over D
// with f32 sums reduced by shuffles, so one launch covers the batch and no
// (B, D) difference tensor reaches device memory; the backward reads the
// saved distances instead of recomputing them.
#include "common.cuh"

namespace qst {

struct Margins {
  float gamma, w_c;         // γ and float32(1 − γ)
  float m_pn, m_pt, m_tn;   // pos-neg, pos-part, part-neg margins
};

constexpr float kEps = 1e-6f;

__global__ void __launch_bounds__(256)
quadruplet_fwd_kernel(const float* __restrict__ a, const float* __restrict__ p,
                      const float* __restrict__ t, const float* __restrict__ n,
                      float* __restrict__ loss, float* __restrict__ dists, int B, int D,
                      Margins mg) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= B) return;
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

// scale: (B,) the upstream gradient of each example's loss (g/B for a mean)
__global__ void __launch_bounds__(256)
quadruplet_bwd_kernel(const float* __restrict__ a, const float* __restrict__ p,
                      const float* __restrict__ t, const float* __restrict__ n,
                      const float* __restrict__ dists, const float* __restrict__ scale,
                      float* __restrict__ da, float* __restrict__ dp, float* __restrict__ dt,
                      float* __restrict__ dn, int B, int D, Margins mg) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= B) return;
  const float d_ap = dists[3 * row], d_at = dists[3 * row + 1], d_an = dists[3 * row + 2];
  const float act_a = d_ap - d_an + mg.m_pn > 0.0f ? 1.0f : 0.0f;
  const float act_b = d_at - d_an + mg.m_tn > 0.0f ? 1.0f : 0.0f;
  const float act_c = d_ap - d_at + mg.m_pt > 0.0f ? 1.0f : 0.0f;
  const float s = scale[row];
  const float c_ap = (act_a + mg.w_c * act_c) * s;
  const float c_at = (mg.gamma * act_b - mg.w_c * act_c) * s;
  const float c_an = (-act_a - mg.gamma * act_b) * s;
  const float n_ap = fmaxf(d_ap, 1e-12f), n_at = fmaxf(d_at, 1e-12f), n_an = fmaxf(d_an, 1e-12f);
  const size_t o = (size_t)row * D;
  for (int c = lane; c < D; c += 32) {
    const float x = a[o + c];
    const float u_ap = (x - p[o + c] + kEps) / n_ap;
    const float u_at = (x - t[o + c] + kEps) / n_at;
    const float u_an = (x - n[o + c] + kEps) / n_an;
    da[o + c] = c_ap * u_ap + c_at * u_at + c_an * u_an;
    dp[o + c] = -c_ap * u_ap;
    dt[o + c] = -c_at * u_at;
    dn[o + c] = -c_an * u_an;
  }
}

}  // namespace qst

using namespace qst;

extern "C" int qst_quadruplet_forward(const void* a, const void* p, const void* t,
                                      const void* n, void* loss, void* dists, int B, int D,
                                      float gamma, float w_c, float m_pn, float m_pt,
                                      float m_tn, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Margins mg{gamma, w_c, m_pn, m_pt, m_tn};
#define QST_F(x) reinterpret_cast<const float*>(x)
  quadruplet_fwd_kernel<<<(B + 7) / 8, 256, 0, st>>>(
      QST_F(a), QST_F(p), QST_F(t), QST_F(n), reinterpret_cast<float*>(loss),
      reinterpret_cast<float*>(dists), B, D, mg);
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

extern "C" int qst_quadruplet_backward(const void* a, const void* p, const void* t,
                                       const void* n, const void* dists, const void* scale,
                                       void* da, void* dp, void* dt, void* dn, int B, int D,
                                       float gamma, float w_c, float m_pn, float m_pt,
                                       float m_tn, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const Margins mg{gamma, w_c, m_pn, m_pt, m_tn};
  quadruplet_bwd_kernel<<<(B + 7) / 8, 256, 0, st>>>(
      QST_F(a), QST_F(p), QST_F(t), QST_F(n), QST_F(dists), QST_F(scale),
      reinterpret_cast<float*>(da), reinterpret_cast<float*>(dp),
      reinterpret_cast<float*>(dt), reinterpret_cast<float*>(dn), B, D, mg);
#undef QST_F
  QST_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
