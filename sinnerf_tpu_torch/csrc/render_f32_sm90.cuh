// The render of one level in float32 on Hopper, one kernel template for two
// kernels: render_f32_sm90<true> is K3-fwd f32, the training forward with the
// residuals its backward reads (launched by f32_train_sm90.cu);
// render_f32_sm90<false> is K1 f32, the eval render (launched by
// fused_render_sm90.cu), which reads no noise and stores no residuals but
// the per-sample weights that K2 reads.  Both composite in the same order,
// so for the same rays, depths and weights K1 f32 equals K3-fwd f32 without
// noise bit for bit, and the float32 K3-bwd (mlp_backward_f32_sm90.cuh),
// which recomputes with the same body, sees the forward's own sigma gate and
// ReLU masks.  This is render_level_sm90.cuh's pairing of the bf16 kernels,
// on mlp_f32_sm90.cuh's FFMA body.
//
// Replaces, in float32, render_level.cuh's render_tile<float, TRAIN> (which
// the earlier kernels of fused_render.cu and fused_render_train.cu keep).
// The TPU kernels it stands for are
// sinnerf_tpu/ops/fused_render_train_t.py::_train_fwd_kernel (:86, through
// _run_fwd :417) and sinnerf_tpu/ops/fused_render_t.py::_render_kernel (:61,
// through fused_render_level :124).
//
// Bound: operations, 593,408 multiply-adds per point at the 67 TFLOP/s f32
// peak.  Persistent CTAs walk ray tiles of RAYS = 128 rays; per sample the
// PE, the MLP of mlp_f32_sm90.cuh and the compositing, whose state thread
// r < 128 carries for ray r.  The sigma noise, and the residuals w, alpha and
// rgb_s, are exactly as render_tile<float, true> writes them.
// Tested as the port's other kernels are: the CPU tests run the plain
// versions and pin the slab layout (tests/test_torch_k1_sm90.py,
// tests/test_torch_f32_bwd_sm90.py); on the card, python3 chip_smoke.py
// builds, checks and times them.
#pragma once

#include "mlp_f32_sm90.cuh"
#include "render_level_sm90.cuh"

namespace nerf {
namespace f32s {

// The f32 kernels load their rays with mlp_wgmma.cuh's load_rays: one tile, the same consumers
static_assert(RAYS == k3::RAYS && CONSUMERS == k3::CONSUMER_THREADS, "f32 tiles");

// The barriers of a CTA's weight ring: a full barrier (one arrival, the
// producer's, and the copy's bytes) and an empty one (one arrival per
// consumer warp) per stage.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

// Eight consumer warps run the MLP of mlp_f32_sm90.cuh on the tile's 128
// rays per sample; consumer thread r < 128 carries ray r's compositing state
// across the samples.
template <bool TRAIN>
__global__ void __launch_bounds__(CTA_THREADS, 1)
render_f32_sm90(const float* __restrict__ rays, const float* __restrict__ z, const float* __restrict__ noise,
                const unsigned char* __restrict__ slabs, const float* __restrict__ B, float* __restrict__ rgb_out,
                float* __restrict__ depth_out, float* __restrict__ w_out, float* __restrict__ alpha_out,
                float* __restrict__ rgb_s_out, int n, int S, int new_act, int white_back) {
  extern __shared__ __align__(16) unsigned char sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Smem::BARS);
  uint64_t* empty = full + STAGES;
  init_ring(full, empty);
  const int n_tiles = (n + RAYS - 1) / RAYS;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int s = 0; s < S; ++s) produce_pass(slabs, sm + Smem::RING, full, empty, it);
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const Map m;
  Ring ring{sm + Smem::RING, full, empty};
  float* act = reinterpret_cast<float*>(sm + Smem::ACT);
  float* pe = reinterpret_cast<float*>(sm + Smem::PE);
  float* rays_s = reinterpret_cast<float*>(sm + Smem::RAYS_F);
  float* sigp = reinterpret_cast<float*>(sm + Smem::SIGP);
  float* rgbp = reinterpret_cast<float*>(sm + Smem::RGBP);
  const float* heads = reinterpret_cast<const float*>(slabs + HEAD_OFF);
  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray0 = tile * RAYS;
    consumers_sync();  // the previous tile's readers of the rays are done
    k3::load_rays(rays, ray0, n, rays_s);  // the same 128 rays by the same 256 consumers
    consumers_sync();
    const int my = ray0 + tid;
    const bool live = tid < RAYS && my < n;
    const float dnorm = tid < RAYS ? k3::ray_norm(rays_s, tid) : 0.f;
    float trans = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, wsum = 0.f;
    for (int s = 0; s < S; ++s) {
      sample_pe(rays_s, z, ray0, n, S, s, pe);
      consumers_sync();
      mlp_pass(ring, m, act, pe, rays_s, heads, B, new_act != 0, sigp, rgbp);
      if (live) {
        const size_t ix = (size_t)my * S + s;
        const float zs = z[ix];
        const float delta = interval(z + (size_t)my * S, S, s, dnorm);
        float sig = __fadd_rn(__fadd_rn(sigp[tid], sigp[RAYS + tid]), B[BSIG]);
        if (TRAIN && noise != nullptr) sig = __fadd_rn(sig, noise[ix]);
        float rgb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rgb[c] = k3::rgb_act(__fadd_rn(__fadd_rn(rgbp[tid * 3 + c], rgbp[(RAYS + tid) * 3 + c]), B[BRGB + c]),
                               new_act != 0);
        const float alpha = __fsub_rn(1.f, expf(__fmul_rn(-delta, fmaxf(sig, 0.f))));
        const float w = __fmul_rn(alpha, trans);
        w_out[ix] = w;
        if (TRAIN) {
          alpha_out[ix] = alpha;
          rgb_s_out[ix * 3 + 0] = rgb[0];
          rgb_s_out[ix * 3 + 1] = rgb[1];
          rgb_s_out[ix * 3 + 2] = rgb[2];
        }
        acc_r = __fadd_rn(acc_r, __fmul_rn(w, rgb[0]));
        acc_g = __fadd_rn(acc_g, __fmul_rn(w, rgb[1]));
        acc_b = __fadd_rn(acc_b, __fmul_rn(w, rgb[2]));
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
}

}  // namespace f32s
}  // namespace nerf
