// K3 in bf16 on Hopper: the training render of one level, forward and
// backward, redesigned around wgmma over weights staged in shared memory.
//
// Replaces the TPU kernels of sinnerf_tpu/ops/fused_render_train_t.py:
// _train_fwd_kernel (:86, through _run_fwd :417) and _train_bwd_kernel (:164,
// through _frlt_bwd :509), for the bfloat16 compute dtype; float32 stays on
// fused_render_train.cu.  The functions, inputs, outputs, residuals and cast
// points are fused_render_train.cu's.  Wrapper (the autograd Function,
// launch counters, plain versions): ops/fused_render_train.py; the weights'
// slab layout and the launch plan: ops/sm90_layout.py.
//
// Bound: operations.  1.19 MFLOP per point forward, 3.48 backward, at the
// 989 TFLOP/s bf16 dense peak.  What the design does about what held the
// wmma kernels back:
// * Products: wgmma.m64n256k16 / m64n128k16 / m64n64k16 with f32
//   accumulators in registers, both operands from 128-byte-swizzled shared
//   memory (sm90_primitives.cuh), issued by two consumer warpgroups of 64
//   points each.
// * Weight bytes per point: a producer warpgroup streams 64-column K-slabs of
//   the weights (pre-swizzled on the host) through a ring of shared-memory
//   stages with 1-D bulk copies and full/empty mbarriers; both consumer
//   warpgroups use each slab, 128 points per read from L2 where the wmma body
//   read every fragment once per 64 points (mlp_wgmma.cuh).
// * The dW flush: each dW element is reduced over the tile's 128 points in a
//   wgmma accumulator and leaves as one lane of a red.global.add.v4.f32:
//   147,456 vector reductions (589,824 sums) per 128 points where the wmma
//   body issued 589,824 scalar atomics per 64 (mlp_backward_wgmma.cuh).
// * Kept activations: the backward's recompute copies each layer's tile to
//   per-CTA global scratch (L2) by bulk stores and brings it back per layer
//   by one bulk load.
//
// Also here: k3_sm90_probe, a one-warpgroup check of the wgmma descriptors,
// the swizzle and the vector flush against a plain product (the card tests).
// Tested as the port's other kernels are: the CPU tests run their plain
// versions as before (tests/test_torch_k3_sm90.py pins the slab layout); on
// the card, python3 chip_smoke.py builds, checks and times them.
#include "mlp_backward_wgmma.cuh"
#include "render_level_sm90.cuh"

using namespace nerf;
using namespace nerf::k3;

// ------------------------------------------------------------------- probe
// mode 0: out[64][256] = A[0:64, 0:64] W^T, W the 256 x 64 slab image in w
//         (the forward's product: both operands K-major);
// mode 1: out[64][64] = A[0:64, :] W, the slab read as the 256 x 64 MN-major
//         B (the backward's input gradient);
// mode 2: out[64][256] += A[:, 0:64]^T C over 128 rows, both MN-major, by
//         the vector flush (the weight gradient);
// mode 3: the same with C's first 64 columns (the PE blocks' gradient).
// A and C are row-major bf16 [128][256]; out is float32, zeroed for 2 and 3.
__global__ void __launch_bounds__(128, 1)
k3_probe_kernel(int mode, const bf16* __restrict__ a, const bf16* __restrict__ c,
                const unsigned char* __restrict__ w, float* out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  unsigned char* ta = sm;
  unsigned char* tc = sm + ACT_BYTES;
  unsigned char* slab = sm + 2 * ACT_BYTES;
  for (int e = threadIdx.x; e < RAYS * WIDTH; e += 128) {
    const int r = e / WIDTH, k = e % WIDTH;
    *reinterpret_cast<bf16*>(ta + sw_off(r, k)) = a[e];
    *reinterpret_cast<bf16*>(tc + sw_off(r, k)) = c[e];
  }
  for (int e = threadIdx.x; e < STAGE_BYTES / 16; e += 128)
    reinterpret_cast<int4*>(slab)[e] = reinterpret_cast<const int4*>(w)[e];
  sm90::fence_proxy_async();
  __syncthreads();
  const Lane ln;
  auto put = [&](const float* acc, int n) {
    for (int j = 0; j < n / 8; ++j)
      for (int i = 0; i < 2; ++i)
        for (int e = 0; e < 2; ++e) out[(ln.r0 + 8 * i) * n + 8 * j + 2 * ln.q + e] = acc[4 * j + 2 * i + e];
  };
  if (mode == 0) {
    float acc[128];
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sm90::mma_m64n256<0, 0>(acc, sm90::desc_sw128(ta + 32 * k, 0, 1024), sm90::desc_sw128(slab + 32 * k, 0, 1024),
                              k > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    put(acc, 256);
  } else if (mode == 1) {
    float acc[32];
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 16; ++t)
      sm90::mma_m64n64<0, 1>(acc, sm90::desc_sw128(ta + (t >> 2) * ACT_BLOCK + (t & 3) * 32, 0, 1024),
                             sm90::desc_sw128(slab + t * 16 * ROW_BYTES, 0, 1024), t > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    put(acc, 64);
  } else if (mode == 2) {
    float acc[128];
    wgrad_product<256>(acc, ta, 0, tc);
    flush<256>(acc, ln, out, 256);
  } else {
    float acc[32];
    wgrad_product<64>(acc, ta, 0, tc);
    flush<64>(acc, ln, out, 64);
  }
}

// ------------------------------------------------------------------ launches
static int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int ABLATE>
static int launch_bwd(const void* rays, const void* z, const void* noise, const void* slabs, const void* b,
                      const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb, const void* g_depth,
                      const void* g_w, void* dsig_part, void* scratch, void* dw, void* db, int n, int s, int blocks,
                      int chunks, int new_act, int white_back, void* stream) {
  if (chunks < 1 || s % chunks != 0) return (int)cudaErrorInvalidValue;
  int e = set_smem((const void*)train_bwd_sm90<ABLATE>, BwdSmem::BYTES);
  if (e) return e;
  const int units = (n + RAYS - 1) / RAYS * chunks;
  if (units == 0) return 0;
  train_bwd_sm90<ABLATE><<<units < blocks ? units : blocks, CTA_THREADS, BwdSmem::BYTES, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)z, (const float*)noise, (const unsigned char*)slabs, (const float*)b,
      (const float*)w_res, (const float*)a_res, (const float*)rgb_res, (const float*)g_rgb, (const float*)g_depth,
      (const float*)g_w, (float*)dsig_part, (unsigned char*)scratch, (float*)dw, (float*)db, n, s, chunks, new_act,
      white_back);
  return (int)cudaGetLastError();
}

extern "C" {

// rays (n, 6) f32 [o, d]; z (n, s) f32 ascending; noise (n, s) f32 or null;
// slabs: ops/sm90_layout.py::slab_buffer (bf16); b packed f32 biases.
// Writes rgb (n, 3), depth (n,), weights (n, s) and the residuals alpha
// (n, s) and rgb_s (n, s, 3), all f32, with at most ``blocks`` CTAs.
// Returns the launch's cudaError_t.
int k3_sm90_fwd(const void* rays, const void* z, const void* noise, const void* slabs, const void* b, void* rgb,
                void* depth, void* weights, void* alpha, void* rgb_s, int n, int s, int blocks, int new_act,
                int white_back, void* stream) {
  int e = set_smem((const void*)train_fwd_sm90<true>, FwdSmem::BYTES);
  if (e) return e;
  const int tiles = (n + RAYS - 1) / RAYS;
  if (tiles == 0) return 0;
  train_fwd_sm90<true><<<tiles < blocks ? tiles : blocks, CTA_THREADS, FwdSmem::BYTES, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)z, (const float*)noise, (const unsigned char*)slabs, (const float*)b,
      (float*)rgb, (float*)depth, (float*)weights, (float*)alpha, (float*)rgb_s, n, s, new_act, white_back);
  return (int)cudaGetLastError();
}

// The forward's inputs and residuals and the cotangents g_rgb (n, 3),
// g_depth (n,), g_w (n, s) -> dw (packed weight layout, f32) and db (packed
// bias layout), both ADDED INTO: zero them first.  dsig_part (n, s) f32
// scratch; scratch holds ``blocks`` times k3_sm90_scratch_bytes().  Each ray
// tile's samples are cut into ``chunks`` equal ranges (a divisor of s), and
// the CTAs walk the (tile, range) units (ops/sm90_layout.py::launch_plan).
int k3_sm90_bwd(const void* rays, const void* z, const void* noise, const void* slabs, const void* b,
                const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb, const void* g_depth,
                const void* g_w, void* dsig_part, void* scratch, void* dw, void* db, int n, int s, int blocks,
                int chunks, int new_act, int white_back, void* stream) {
  return launch_bwd<0>(rays, z, noise, slabs, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w, dsig_part, scratch, dw,
                       db, n, s, blocks, chunks, new_act, white_back, stream);
}

// k3_sm90_bwd with one part removed on purpose, for timing only
// (mlp_backward_wgmma.cuh Ablate): ``ablate`` ABL_FLUSH (1) skips the weight
// gradients' reductions into dw and nothing else, ABL_WGRAD (2) the
// weight-gradient products and their flush.  The gradients are then wrong.
int k3_sm90_bwd_ablated(const void* rays, const void* z, const void* noise, const void* slabs, const void* b,
                        const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb,
                        const void* g_depth, const void* g_w, void* dsig_part, void* scratch, void* dw, void* db, int n,
                        int s, int blocks, int chunks, int new_act, int white_back, int ablate, void* stream) {
  switch (ablate) {
    case ABL_FLUSH:
      return launch_bwd<ABL_FLUSH>(rays, z, noise, slabs, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w, dsig_part,
                                   scratch, dw, db, n, s, blocks, chunks, new_act, white_back, stream);
    case ABL_WGRAD:
      return launch_bwd<ABL_WGRAD>(rays, z, noise, slabs, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w, dsig_part,
                                   scratch, dw, db, n, s, blocks, chunks, new_act, white_back, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int k3_sm90_probe(int mode, const void* a, const void* c, const void* w, void* out, void* stream) {
  const int bytes = 2 * ACT_BYTES + STAGE_BYTES + ALIGN;
  int e = set_smem((const void*)k3_probe_kernel, bytes);
  if (e) return e;
  k3_probe_kernel<<<1, 128, bytes, (cudaStream_t)stream>>>(mode, (const bf16*)a, (const bf16*)c,
                                                           (const unsigned char*)w, (float*)out);
  return (int)cudaGetLastError();
}

// Shared memory of one CTA (bwd != 0: the backward's), global scratch of one
// backward CTA, and the slab buffer's size in bf16 values: the wrapper holds
// them against ops/sm90_layout.py.
int k3_sm90_smem_bytes(int bwd) { return bwd ? BwdSmem::BYTES : FwdSmem::BYTES; }
long long k3_sm90_scratch_bytes() { return (long long)BWD_SCRATCH; }
int k3_sm90_slab_elems() { return SLAB_BUFFER_ELEMS; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
