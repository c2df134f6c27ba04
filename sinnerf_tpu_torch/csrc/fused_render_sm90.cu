// K1 on Hopper: the eval render of one level (PE + NeRF MLP + online alpha
// compositing, per-sample weights for K2), in both compute dtypes.
//
// Replaces the TPU kernel sinnerf_tpu/ops/fused_render_t.py::_render_kernel
// (:61), called through fused_render_level (:124).  Wrapper, plain version
// and launch counter: ops/fused_render.py; the weights' slab layouts and the
// launch plan: ops/sm90_layout.py.  The earlier K1 (fused_render.cu, 64-ray
// blocks on nerf_mlp.cuh's wmma and FMA bodies) is kept beside it for the
// alternating timing rounds of chip_smoke.py.
//
// Bound: operations, 593,408 multiply-adds (1.19 MFLOP) per point: a 504x378
// image at 64 + 128 samples is 48.8M points, 58 TFLOP, 59 ms at an H100 SXM's
// 989 TFLOP/s bf16 dense peak and 0.87 s at its 67 TFLOP/s f32 peak.
//   * bfloat16: train_fwd_sm90<false> (render_level_sm90.cuh, the K3-fwd
//     kernel without its noise and residuals) on mlp_wgmma.cuh's body:
//     wgmma over weights streamed as pre-swizzled slabs through shared memory
//     by bulk copies, 128 points per weight read.  For the same inputs it
//     equals K3-fwd without noise bit for bit.
//   * float32: render_f32_sm90 below on mlp_f32_sm90.cuh's body: FFMA in
//     float32 from a register tile of 8 points x 16 outputs per thread, the
//     activations K-major in shared memory, the weights streamed as
//     pre-transposed slabs by bulk copies.
// Both are persistent: at most one CTA per SM, each walking ray tiles of 128
// rays gridDim.x apart; per tile the rays (and in bf16 the direction PE)
// once, per sample the PE, the MLP and the compositing of
// render_level.cuh's render_tile, in the same order.
// Tested as the port's other kernels are: the CPU tests run the plain
// version and pin both slab layouts and the launch plan
// (tests/test_torch_k1_sm90.py); on the card, python3 chip_smoke.py builds,
// checks and times them.
#include "mlp_f32_sm90.cuh"
#include "render_level_sm90.cuh"

using namespace nerf;

// The f32 kernel loads its rays with mlp_wgmma.cuh's load_rays: one tile, the same consumers
static_assert(f32s::RAYS == k3::RAYS && f32s::CONSUMERS == k3::CONSUMER_THREADS, "K1 tiles");

// The float32 render: eight consumer warps run the MLP of mlp_f32_sm90.cuh
// on the tile's 128 rays per sample; consumer thread r < 128 carries ray r's
// compositing state across the samples.
__global__ void __launch_bounds__(f32s::CTA_THREADS, 1)
render_f32_sm90(const float* __restrict__ rays, const float* __restrict__ z, const unsigned char* __restrict__ slabs,
                const float* __restrict__ B, float* __restrict__ rgb_out, float* __restrict__ depth_out,
                float* __restrict__ w_out, int n, int S, int new_act, int white_back) {
  using namespace nerf::f32s;
  extern __shared__ __align__(16) unsigned char sm[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + Smem::BARS);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMER_WARPS);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
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
        const float sig = __fadd_rn(__fadd_rn(sigp[tid], sigp[RAYS + tid]), B[BSIG]);
        float rgb[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rgb[c] = k3::rgb_act(__fadd_rn(__fadd_rn(rgbp[tid * 3 + c], rgbp[(RAYS + tid) * 3 + c]), B[BRGB + c]),
                               new_act != 0);
        const float alpha = __fsub_rn(1.f, expf(__fmul_rn(-delta, fmaxf(sig, 0.f))));
        const float w = __fmul_rn(alpha, trans);
        w_out[ix] = w;
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

static int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

extern "C" {

// rays (n, 6) f32 [o, d]; z (n, s) f32 ascending; slabs: the weights as
// ops/sm90_layout.py lays them out for the dtype (slab_buffer, bf16, when
// use_bf16; slab_buffer_f32 else); b packed f32 biases.  Writes rgb (n, 3),
// depth (n,) and weights (n, s), all f32, with at most ``blocks`` CTAs.
// Returns the launch's cudaError_t.
int k1_sm90(const void* rays, const void* z, const void* slabs, const void* b, void* rgb, void* depth,
            void* weights, int n, int s, int blocks, int use_bf16, int new_act, int white_back, void* stream) {
  const int tiles = (n + f32s::RAYS - 1) / f32s::RAYS;
  const int grid = tiles < blocks ? tiles : blocks;
  if (use_bf16) {
    int e = set_smem((const void*)k3::train_fwd_sm90<false>, k3::FwdSmem::BYTES);
    if (e) return e;
    if (tiles == 0) return 0;
    k3::train_fwd_sm90<false><<<grid, k3::CTA_THREADS, k3::FwdSmem::BYTES, (cudaStream_t)stream>>>(
        (const float*)rays, (const float*)z, nullptr, (const unsigned char*)slabs, (const float*)b, (float*)rgb,
        (float*)depth, (float*)weights, nullptr, nullptr, n, s, new_act, white_back);
  } else {
    int e = set_smem((const void*)render_f32_sm90, f32s::Smem::BYTES);
    if (e) return e;
    if (tiles == 0) return 0;
    render_f32_sm90<<<grid, f32s::CTA_THREADS, f32s::Smem::BYTES, (cudaStream_t)stream>>>(
        (const float*)rays, (const float*)z, (const unsigned char*)slabs, (const float*)b, (float*)rgb,
        (float*)depth, (float*)weights, n, s, new_act, white_back);
  }
  return (int)cudaGetLastError();
}

// Shared memory and threads of one CTA, and the slab buffer's size in values
// of the dtype: the wrapper holds them against ops/sm90_layout.py.
int k1_sm90_smem_bytes(int use_bf16) { return use_bf16 ? k3::FwdSmem::BYTES : f32s::Smem::BYTES; }
int k1_sm90_threads(int use_bf16) { return use_bf16 ? k3::CTA_THREADS : f32s::CTA_THREADS; }
int k1_sm90_slab_elems(int use_bf16) { return use_bf16 ? k3::SLAB_BUFFER_ELEMS : f32s::SLAB_BUFFER_ELEMS; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
