// The render of one level in bf16 on Hopper, one kernel template for two
// kernels: train_fwd_sm90<true> is K3-fwd, the training forward with the
// residuals its backward reads (launched by fused_render_train_sm90.cu);
// train_fwd_sm90<false> is K1, the eval render (launched by
// fused_render_sm90.cu), which reads no noise and stores no residuals but
// the per-sample weights that K2 reads.  Both composite in the same order,
// so for the same rays, depths and weights K1 equals K3-fwd without noise
// bit for bit.
//
// Replaces, in bf16, render_level.cuh's render_tile<bf16, TRAIN> (which the
// float32 K3-fwd keeps).  The TPU kernels it stands for are
// sinnerf_tpu/ops/fused_render_train_t.py::_train_fwd_kernel (:86, through
// _run_fwd :417) and sinnerf_tpu/ops/fused_render_t.py::_render_kernel (:61,
// through fused_render_level :124).
//
// Persistent CTAs walk the ray tiles of RAYS = 128 rays.  Per tile: the rays
// and the direction PE (once); per sample s: xyz = o + d z and its
// recurrence PE in f32 (cast to bf16, as render_level.cuh), the MLP of
// mlp_wgmma.cuh, then online alpha compositing in registers.  Each ray's
// compositing state stays with the four threads that hold its row of the
// accumulators (the row's thread with lane % 4 == 0 writes), carried across
// the samples.  The sigma noise, and the residuals w, alpha and rgb_s, are
// exactly as render_tile<T, true> writes them; TRAIN = false drops them.
//
// Bound: operations, 593,408 multiply-adds per point (K1's); the weights'
// 1.2 MB come from L2 once per 128 points, and the card's L2 bandwidth per
// SM is what a 128-point tile leans on (see the note in mlp_wgmma.cuh).
// Tested as the port's other kernels are: the CPU tests run their plain
// versions as before (tests/test_torch_k3_sm90.py pins the slab layout); on
// the card, python3 chip_smoke.py builds, checks and times them.
#pragma once

#include "mlp_wgmma.cuh"
#include "render_level.cuh"

namespace nerf {
namespace k3 {

// Shared memory of the forward (ops/sm90_layout.py FWD_SMEM): the activation
// tile, the sample PE, the direction PE, a 3-stage weight ring, then rays
// [128][6] f32 and the ring's barriers.
struct FwdSmem {
  static constexpr int STAGES = 3;
  static constexpr int ACT = 0, XPE = ACT_BYTES, DPE = XPE + PE_BYTES, RING = DPE + PE_BYTES;
  static constexpr int SMALL = RING + STAGES * STAGE_BYTES;
  static constexpr int RAYS_F = SMALL, BARS = SMALL + 6144;
  static constexpr int BYTES = SMALL + SMALL_BYTES + ALIGN;
};

__device__ __forceinline__ float rgb_act(float a, bool new_act) {
  return new_act ? widened_sigmoid(a) : sigmoid(a);
}

template <bool TRAIN>
__global__ void __launch_bounds__(CTA_THREADS, 1)
train_fwd_sm90(const float* __restrict__ rays, const float* __restrict__ z, const float* __restrict__ noise,
               const unsigned char* __restrict__ slabs, const float* __restrict__ B, float* __restrict__ rgb_out,
               float* __restrict__ depth_out, float* __restrict__ w_out, float* __restrict__ alpha_out,
               float* __restrict__ rgb_s_out, int n, int S, int new_act, int white_back) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  using L = FwdSmem;
  float* rays_s = reinterpret_cast<float*>(sm + L::RAYS_F);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + L::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int n_tiles = (n + RAYS - 1) / RAYS;

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMER_THREADS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int s = 0; s < S; ++s)
          produce(slabs, sm + L::RING, full, empty, L::STAGES, it, N_FWD_SLABS, [](int j) { return j; });
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const Lane ln;
  Ring ring{sm + L::RING, full, empty, L::STAGES};
  const bf16* heads = reinterpret_cast<const bf16*>(slabs + HEAD_OFF);
  unsigned char* act = sm + L::ACT;
  unsigned char* xpe = sm + L::XPE;
  unsigned char* dpe = sm + L::DPE;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray0 = tile * RAYS;
    consumers_sync();  // the previous tile's readers of the rays are done
    load_rays(rays, ray0, n, rays_s);
    consumers_sync();
    dir_pe(ln, rays_s, dpe);
    float dn[2], trans[2], acc_r[2], acc_g[2], acc_b[2], acc_d[2], wsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dn[i] = ray_norm(rays_s, ln.row(i));
      trans[i] = 1.f;
      acc_r[i] = acc_g[i] = acc_b[i] = acc_d[i] = wsum[i] = 0.f;
    }
    for (int s = 0; s < S; ++s) {
      sample_pe_sw(ln, rays_s, z, ray0, n, S, s, xpe);
      sm90::fence_proxy_async();
      ln.wg_sync();
      MlpOut o;
      mlp_pass(ring, ln, act, xpe, dpe, heads, B, new_act != 0, KeepNone(), o);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int my = ray0 + ln.row(i);
        if (my >= n) continue;
        const size_t at = (size_t)my * S + s;
        const float zs = z[at];
        const float delta = interval(z + (size_t)my * S, S, s, dn[i]);
        float sig = o.sig[i];
        if (TRAIN && noise != nullptr) sig = __fadd_rn(sig, noise[at]);
        const float alpha = __fsub_rn(1.f, expf(__fmul_rn(-delta, fmaxf(sig, 0.f))));
        const float w = __fmul_rn(alpha, trans[i]);
        const float r = rgb_act(o.rpre[i][0], new_act), g = rgb_act(o.rpre[i][1], new_act),
                    b = rgb_act(o.rpre[i][2], new_act);
        if (ln.q == 0) {
          w_out[at] = w;
          if (TRAIN) {
            alpha_out[at] = alpha;
            rgb_s_out[at * 3 + 0] = r;
            rgb_s_out[at * 3 + 1] = g;
            rgb_s_out[at * 3 + 2] = b;
          }
        }
        acc_r[i] = __fadd_rn(acc_r[i], __fmul_rn(w, r));
        acc_g[i] = __fadd_rn(acc_g[i], __fmul_rn(w, g));
        acc_b[i] = __fadd_rn(acc_b[i], __fmul_rn(w, b));
        acc_d[i] = __fadd_rn(acc_d[i], __fmul_rn(w, zs));
        wsum[i] = __fadd_rn(wsum[i], w);
        trans[i] = __fmul_rn(trans[i], __fadd_rn(__fsub_rn(1.f, alpha), 1e-10f));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int my = ray0 + ln.row(i);
      if (my >= n || ln.q != 0) continue;
      if (white_back) {
        const float bg = __fsub_rn(1.f, wsum[i]);
        acc_r[i] = __fadd_rn(acc_r[i], bg);
        acc_g[i] = __fadd_rn(acc_g[i], bg);
        acc_b[i] = __fadd_rn(acc_b[i], bg);
      }
      rgb_out[(size_t)my * 3 + 0] = acc_r[i];
      rgb_out[(size_t)my * 3 + 1] = acc_g[i];
      rgb_out[(size_t)my * 3 + 2] = acc_b[i];
      depth_out[my] = acc_d[i];
    }
  }
}

}  // namespace k3
}  // namespace nerf
