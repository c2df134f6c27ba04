// The per-ray render of one level, shared by the eval kernel (K1,
// fused_render.cu) and the training forward kernel (K3-fwd,
// fused_render_train.cu): PE + NeRF MLP + online alpha compositing.
//
// Each block owns TILE consecutive rays and loops over the S samples.  For
// each sample it forms xyz = o + d z, computes the recurrence PE in f32 (the
// direction PE once per ray, before the loop), runs the MLP of nerf_mlp.cuh
// with the activation tile in shared memory, and composites in registers:
// thread p of the block carries ray p's rgb, depth, weight sum and
// transmittance across the samples.  The per-sample weights are written
// (N, S) row-major, one row per ray.
//
// Compositing follows fused_render_t.py:84-120: delta = (z_{s+1} - z_s)*||d||
// with 1e10*||d|| on the last sample; alpha = 1 - exp(-delta relu(sigma));
// T *= 1 - alpha + 1e-10; white background rgb += 1 - sum(w).
//
// TRAIN adds what fused_render_train_t.py::_train_fwd_kernel (:86) adds: the
// sigma noise before the ReLU (:127-130, ``noise`` may be null) and the
// per-sample alpha and rgb stored beside w for the backward (:132-136).
#pragma once

#include "nerf_mlp.cuh"

namespace nerf {

// Rays [ray0, ray0 + RB) into t.rays (rays past n get o = 0, d = (0, 0, 1)),
// the zero padding of xpe and dpe, and the direction PE of every point of
// the P-point tile, whose point p belongs to ray p % RB (the production
// kernels: one point per ray, RB = P = TILE).  Returns ||d|| of the ray of
// point threadIdx.x (threads < P).  Ends unsynchronised: the caller's next
// barrier publishes dpe.
template <typename T, int P = TILE, int RB = P>
__device__ float load_rays_and_dir_pe(const Tile<T, P>& t, const float* __restrict__ rays, int ray0, int n) {
  using G = Grp<P>;
  const int tid = G::tid();
  for (int i = tid; i < RB * 6; i += G::THREADS) {
    const int p = i / 6, c = i % 6;
    t.rays[i] = ray0 + p < n ? rays[(size_t)(ray0 + p) * 6 + c] : (c == 5 ? 1.f : 0.f);
  }
  if (tid < P) {
    t.xpe[tid * Ld<T>::X + XYZ_CH] = to_cd<T>(0.f);
    for (int c = DIR_CH; c < DIR_PAD; ++c) t.dpe[tid * Ld<T>::D + c] = to_cd<T>(0.f);
  }
  G::sync();
  if (tid < P * 3) {
    const int p = tid / 3, c = tid % 3, r = RB == P ? p : p % RB;
    pe_channel<T>(t.rays[r * 6 + 3 + c], c, N_FREQS_DIR, t.dpe + p * Ld<T>::D);
  }
  float dnorm = 0.f;
  if (tid < P) {
    const int r = RB == P ? tid : tid % RB;
    const float dx = t.rays[r * 6 + 3], dy = t.rays[r * 6 + 4], dz = t.rays[r * 6 + 5];
    dnorm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  }
  return dnorm;
}

// PE of each point's sample into xpe ([P][Ld::X], t.xpe or another buffer),
// unsynchronised: point p is ray p % RB's sample s + (p / RB) * stride (z of
// rays past n is 1).
template <typename T, int P = TILE, int RB = P>
__device__ void point_pe(const Tile<T, P>& t, T* xpe, const float* __restrict__ z, int ray0, int n, int S,
                         int s, int stride) {
  const int tid = Grp<P>::tid();
  if (tid < P * 3) {
    const int p = tid / 3, c = tid % 3;
    const int r = RB == P ? p : p % RB, sp = RB == P ? s : s + p / RB * stride;
    const float zs = ray0 + r < n ? z[(size_t)(ray0 + r) * S + sp] : 1.f;
    const float x = __fadd_rn(t.rays[r * 6 + c], __fmul_rn(t.rays[r * 6 + 3 + c], zs));
    pe_channel<T>(x, c, N_FREQS_XYZ, xpe + p * Ld<T>::X);
  }
}

// PE of sample s of every ray of the tile into t.xpe, synchronised (see
// point_pe for RB < P).
template <typename T, int P = TILE, int RB = P>
__device__ void sample_pe(const Tile<T, P>& t, const float* __restrict__ z, int ray0, int n, int S, int s,
                          int stride = 0) {
  point_pe<T, P, RB>(t, t.xpe, z, ray0, n, S, s, stride);
  Grp<P>::sync();
}

// (z_{s+1} - z_s) * ||d||, 1e10 * ||d|| on the last sample.
__device__ __forceinline__ float interval(const float* __restrict__ zrow, int S, int s, float dnorm) {
  const float delta = s == S - 1 ? 1e10f : __fsub_rn(zrow[s + 1], zrow[s]);
  return __fmul_rn(delta, dnorm);
}

template <typename T, bool TRAIN>
__device__ void render_tile(const float* __restrict__ rays, const float* __restrict__ z,
                            const float* __restrict__ noise, const T* __restrict__ W,
                            const float* __restrict__ B, float* __restrict__ rgb_out,
                            float* __restrict__ depth_out, float* __restrict__ w_out,
                            float* __restrict__ alpha_out, float* __restrict__ rgb_s_out,
                            int n, int S, int new_act, int white_back, unsigned char* smem) {
  const Tile<T> t = carve<T>(smem);
  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * TILE;
  const float dnorm = load_rays_and_dir_pe<T>(t, rays, ray0, n);

  // compositing state of ray tid (threads tid < TILE)
  const int my = ray0 + tid;
  const bool live = tid < TILE && my < n;
  float trans = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, wsum = 0.f;

  for (int s = 0; s < S; ++s) {
    sample_pe<T>(t, z, ray0, n, S, s);
    mlp_tile<T>(t, W, B, new_act != 0);
    if (live) {
      const size_t at = (size_t)my * S + s;
      const float zs = z[at];
      const float delta = interval(z + (size_t)my * S, S, s, dnorm);
      float sig = t.sig[tid];
      if (TRAIN && noise != nullptr) sig = __fadd_rn(sig, noise[at]);
      const float alpha = __fsub_rn(1.f, expf(__fmul_rn(-delta, fmaxf(sig, 0.f))));
      const float w = __fmul_rn(alpha, trans);
      w_out[at] = w;
      if (TRAIN) {
        alpha_out[at] = alpha;
        rgb_s_out[at * 3 + 0] = t.rgb[tid * 3 + 0];
        rgb_s_out[at * 3 + 1] = t.rgb[tid * 3 + 1];
        rgb_s_out[at * 3 + 2] = t.rgb[tid * 3 + 2];
      }
      acc_r = __fadd_rn(acc_r, __fmul_rn(w, t.rgb[tid * 3 + 0]));
      acc_g = __fadd_rn(acc_g, __fmul_rn(w, t.rgb[tid * 3 + 1]));
      acc_b = __fadd_rn(acc_b, __fmul_rn(w, t.rgb[tid * 3 + 2]));
      acc_d = __fadd_rn(acc_d, __fmul_rn(w, zs));
      wsum = __fadd_rn(wsum, w);
      trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
    }
  }
  if (live) {
    if (white_back) {
      const float bg = __fsub_rn(1.f, wsum);
      acc_r = __fadd_rn(acc_r, bg);
      acc_g = __fadd_rn(acc_g, bg);
      acc_b = __fadd_rn(acc_b, bg);
    }
    rgb_out[(size_t)my * 3 + 0] = acc_r;
    rgb_out[(size_t)my * 3 + 1] = acc_g;
    rgb_out[(size_t)my * 3 + 2] = acc_b;
    depth_out[my] = acc_d;
  }
}

}  // namespace nerf
