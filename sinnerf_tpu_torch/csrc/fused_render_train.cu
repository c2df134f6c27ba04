// K3: the training render of one level, forward and backward.
//
// Replaces the TPU kernels of sinnerf_tpu/ops/fused_render_train_t.py:
// _train_fwd_kernel (:86, called through _run_fwd :417) and _train_bwd_kernel
// (:164, called through _frlt_bwd :509).  Wrapper (a torch.autograd.Function),
// plain versions and launch counters: ops/fused_render_train.py.
//
// No training path runs these kernels: it runs the Hopper kernels of
// fused_render_train_sm90.cu in bfloat16 and f32_train_sm90.cu in float32.
// They stay as the earlier bodies: the bfloat16 forward (wmma) gives the
// kernel experiment X2 its residuals, the bfloat16 backward is X2's
// ``base``, and chip_smoke.py times the float32 pair beside the Hopper ones.
//
// K3-fwd is render_level.cuh's render_tile with TRAIN set: K1's work plus the
// sigma noise, and alpha and rgb stored per sample beside w as residuals.
// Bound: operations, 593,408 multiply-adds per point, as K1.
//
// K3-bwd computes the gradients of the 14 packed weight blocks and 12 biases
// from the cotangents of (rgb, depth, weights); rays, depths and noise get no
// gradient.  Per sample s of a ray (fused_render_train_t.py:26-29):
//   c_s       = <g_rgb, rgb_s> + g_depth z_s + g_w_s - white_back sum(g_rgb)
//   dL/da_s   = c_s T_s - S_s / max(1 - a_s + 1e-10, 1e-10),  S_s = sum_{j>s} c_j w_j
//   dL/dsig_s = dL/da_s (1 - a_s) delta_s [sigma_s + noise_s > 0]
//   dL/drgb_s = w_s g_rgb
// A block owns TILE consecutive rays at a time (a persistent grid walks the
// ray tiles).  Stage A: thread p walks ray p's samples downwards and writes
// -S_s/u_s to a (N, S) buffer.  Stage B, upwards over the samples: recompute
// the MLP with the forward's own routine (mlp_tile, so sigma and with it the
// gate round as they did in the forward), then backpropagate layer by layer
// with mlp_backward.cuh's mlp_backward_tile, which the per-point MLP's
// backward (K4-bwd, fused_mlp.cu) shares.
//
// Bound: operations.  Per point 593,408 multiply-adds of recompute, 556,544
// of dgrad (no gradient reaches x or the direction PE) and 589,312 of wgrad
// (the direction-PE block once per ray): 3.48 MFLOP per point.
//
// What the design does about the three things that do not fit:
// * Activations.  The backward needs x, h1..h8, f and the direction branch
//   of the whole tile at once; in bf16 that is 327 KB, more than a block's
//   shared memory.  The recompute runs in shared memory exactly as the
//   forward does and copies each layer's output to a per-block scratch in
//   global memory (9 x TILE x 256, 0.3 MB in bf16, 0.6 MB in f32), which a
//   block reads back within microseconds, from L2.  The deltas ping-pong
//   between two shared-memory tiles (the activation tile is free once the
//   recompute is done).
// * The gradient accumulator.  594,560 f32 sums (2.4 MB) fit in no block.
//   Each block reduces a layer's dW over its TILE points in registers
//   (wmma accumulators in bf16, a register-blocked FMA loop in f32) and adds
//   the tile's sum to the one global accumulator with red.global.add.f32
//   (atomicAdd whose result is unused).  The order of those adds changes from
//   run to run, so the gradient's last bits do.  That is 594,560 adds per 64
//   points; a later version can reduce over more points per flush.
// * The direction-PE block (wdx).  Its input is constant along a ray, so the
//   f32 sum over samples of the cast delta is kept per ray (global scratch)
//   and contracted with the direction PE once per ray tile, in f32.
//
// Cast points follow _train_bwd_kernel: every delta is cast to the compute
// dtype before both of its products; ReLU masks read the cast activation;
// sums run in f32.
#include "train_backward.cuh"

using namespace nerf;

// ------------------------------------------------------------------- K3-fwd
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
train_fwd_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                 const float* __restrict__ noise, const T* __restrict__ W,
                 const float* __restrict__ B, float* __restrict__ rgb_out,
                 float* __restrict__ depth_out, float* __restrict__ w_out,
                 float* __restrict__ alpha_out, float* __restrict__ rgb_s_out,
                 int n, int S, int new_act, int white_back) {
  extern __shared__ __align__(128) unsigned char smem[];
  render_tile<T, true>(rays, z, noise, W, B, rgb_out, depth_out, w_out, alpha_out, rgb_s_out,
                       n, S, new_act, white_back, smem);
}

// ------------------------------------------------------------------- K3-bwd
// The body, its per-block scratch (BwdScratch) and the stage-A/B sweeps are
// train_backward.cuh's train_bwd_tiles, which the X2 variants share.
template <typename T>
__global__ void __launch_bounds__(THREADS, bwd_blocks_per_sm<T>())
train_bwd_kernel(const float* __restrict__ rays, const float* __restrict__ z,
                 const float* __restrict__ noise, const T* __restrict__ W,
                 const float* __restrict__ B, const float* __restrict__ w_res,
                 const float* __restrict__ a_res, const float* __restrict__ rgb_res,
                 const float* __restrict__ g_rgb, const float* __restrict__ g_depth,
                 const float* __restrict__ g_w, float* dsig_part, unsigned char* scratch,
                 float* dW, float* dB, int n, int S, int new_act, int white_back) {
  extern __shared__ __align__(128) unsigned char smem[];
  train_bwd_tiles<T>(rays, z, noise, W, B, w_res, a_res, rgb_res, g_rgb, g_depth, g_w, dsig_part, scratch, dW,
                     dB, n, S, new_act, white_back, smem);
}

// ------------------------------------------------------------------ launches
template <typename T>
static int launch_fwd(const void* rays, const void* z, const void* noise, const void* w, const void* b,
                      void* rgb, void* depth, void* weights, void* alpha, void* rgb_s, int n, int s,
                      int new_act, int white_back, void* stream) {
  const size_t bytes = tile_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(train_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const dim3 grid((n + TILE - 1) / TILE);
  train_fwd_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)z, (const float*)noise, (const T*)w, (const float*)b,
      (float*)rgb, (float*)depth, (float*)weights, (float*)alpha, (float*)rgb_s, n, s, new_act,
      white_back);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const void* rays, const void* z, const void* noise, const void* w, const void* b,
                      const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb,
                      const void* g_depth, const void* g_w, void* dsig_part, void* scratch, void* dw,
                      void* db, int n, int s, int blocks, int new_act, int white_back, void* stream) {
  const size_t bytes = bwd_smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(train_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const int n_tiles = (n + TILE - 1) / TILE;
  const dim3 grid(n_tiles < blocks ? n_tiles : blocks);
  train_bwd_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)z, (const float*)noise, (const T*)w, (const float*)b,
      (const float*)w_res, (const float*)a_res, (const float*)rgb_res, (const float*)g_rgb,
      (const float*)g_depth, (const float*)g_w, (float*)dsig_part, (unsigned char*)scratch,
      (float*)dw, (float*)db, n, s, new_act, white_back);
  return (int)cudaGetLastError();
}

extern "C" {

// rays (n, 6) f32 [o, d]; z (n, s) f32 ascending; noise (n, s) f32 or null;
// w packed weights (bf16 when use_bf16, else f32); b packed f32 biases.
// Writes rgb (n, 3), depth (n,), weights (n, s) and the residuals alpha
// (n, s) and rgb_s (n, s, 3), all f32.  Returns the launch's cudaError_t.
int fused_render_level_train_fwd(const void* rays, const void* z, const void* noise, const void* w,
                                 const void* b, void* rgb, void* depth, void* weights, void* alpha,
                                 void* rgb_s, int n, int s, int use_bf16, int new_act, int white_back,
                                 void* stream) {
  if (use_bf16)
    return launch_fwd<bf16>(rays, z, noise, w, b, rgb, depth, weights, alpha, rgb_s, n, s, new_act,
                            white_back, stream);
  return launch_fwd<float>(rays, z, noise, w, b, rgb, depth, weights, alpha, rgb_s, n, s, new_act,
                           white_back, stream);
}

// Bytes of global scratch one block of the backward needs.
long long fused_render_level_train_bwd_scratch_bytes(int use_bf16) {
  return (long long)(use_bf16 ? BwdScratch<bf16>::BYTES : BwdScratch<float>::BYTES);
}

// The forward's inputs and residuals (weights, alpha, rgb_s) and the
// cotangents g_rgb (n, 3), g_depth (n,), g_w (n, s) -> dw (packed weight
// layout, f32) and db (packed bias layout), both ADDED INTO: zero them first.
// dsig_part is (n, s) f32 scratch; scratch holds ``blocks`` times
// fused_render_level_train_bwd_scratch_bytes, and at most ``blocks`` blocks
// are launched.
int fused_render_level_train_bwd(const void* rays, const void* z, const void* noise, const void* w,
                                 const void* b, const void* w_res, const void* a_res,
                                 const void* rgb_res, const void* g_rgb, const void* g_depth,
                                 const void* g_w, void* dsig_part, void* scratch, void* dw, void* db,
                                 int n, int s, int blocks, int use_bf16, int new_act, int white_back,
                                 void* stream) {
  if (use_bf16) return (int)cudaErrorNotSupported;  // fused_render_train_sm90.cu
  return launch_bwd<float>(rays, z, noise, w, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w,
                           dsig_part, scratch, dw, db, n, s, blocks, new_act, white_back, stream);
}

int nerf_packed_weight_size() { return W_SIZE; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
