// K1: fused per-ray render of one level (eval path): PE + NeRF MLP + online
// alpha compositing.
//
// Replaces the TPU kernel sinnerf_tpu/ops/fused_render_t.py::_render_kernel
// (:61), called through fused_render_level (:124).  Wrapper, plain version and
// launch counter: ops/fused_render.py.
//
// Each block owns TILE consecutive rays and loops over the S samples.  For
// each sample it forms xyz = o + d z, computes the recurrence PE in f32 (the
// direction PE once per ray, before the loop), runs the MLP of nerf_mlp.cuh
// with the activation tile in shared memory, and composites in registers:
// thread p of the block carries ray p's rgb, depth, weight sum and
// transmittance across the samples.  The per-sample weights are written
// (N, S) row-major, one row per ray, for the resample kernel.
//
// Compositing follows fused_render_t.py:84-120: delta = (z_{s+1} - z_s)*||d||
// with 1e10*||d|| on the last sample; alpha = 1 - exp(-delta relu(sigma));
// T *= 1 - alpha + 1e-10; white background rgb += 1 - sum(w).
//
// Bound: compute.  593,408 multiply-adds (1.19 MFLOP) per point; a 504x378
// image at 64 + 128 samples is 190,512 x (64 + 192) = 48.8M points, 58 TFLOP:
// 59 ms at an H100 SXM's 989 TFLOP/s bf16 dense peak, 0.87 s at its 67
// TFLOP/s f32 peak outside the tensor cores.  Device-memory traffic is a few
// hundred bytes per ray plus the 1.2/2.4 MB of weights, read from L2.  The
// design keeps everything per point on chip; the weights are re-read from L2
// by every block for every sample, TILE points per read.
#include "nerf_mlp.cuh"

using namespace nerf;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
render_kernel(const float* __restrict__ rays, const float* __restrict__ z,
              const T* __restrict__ W, const float* __restrict__ B,
              float* __restrict__ rgb_out, float* __restrict__ depth_out,
              float* __restrict__ w_out, int n, int S, int new_act, int white_back) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T> t = carve<T>(smem);
  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * TILE;

  // rays of the tile; rays past n get o = 0, d = (0, 0, 1), z = 1 (unread)
  for (int i = tid; i < TILE * 6; i += THREADS) {
    const int p = i / 6, c = i % 6;
    t.rays[i] = ray0 + p < n ? rays[(size_t)(ray0 + p) * 6 + c] : (c == 5 ? 1.f : 0.f);
  }
  if (tid < TILE) {
    t.xpe[tid * Ld<T>::X + XYZ_CH] = to_cd<T>(0.f);
    for (int c = DIR_CH; c < DIR_PAD; ++c) t.dpe[tid * Ld<T>::D + c] = to_cd<T>(0.f);
  }
  __syncthreads();
  if (tid < TILE * 3) {
    const int p = tid / 3, c = tid % 3;
    pe_channel<T>(t.rays[p * 6 + 3 + c], c, N_FREQS_DIR, t.dpe + p * Ld<T>::D);
  }

  // compositing state of ray tid (threads tid < TILE)
  const int my = ray0 + tid;
  const bool live = tid < TILE && my < n;
  float dnorm = 0.f, trans = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f, wsum = 0.f;
  if (tid < TILE) {
    const float dx = t.rays[tid * 6 + 3], dy = t.rays[tid * 6 + 4], dz = t.rays[tid * 6 + 5];
    dnorm = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
  }

  for (int s = 0; s < S; ++s) {
    if (tid < TILE * 3) {
      const int p = tid / 3, c = tid % 3;
      const float zs = ray0 + p < n ? z[(size_t)(ray0 + p) * S + s] : 1.f;
      const float x = __fadd_rn(t.rays[p * 6 + c], __fmul_rn(t.rays[p * 6 + 3 + c], zs));
      pe_channel<T>(x, c, N_FREQS_XYZ, t.xpe + p * Ld<T>::X);
    }
    __syncthreads();
    mlp_tile<T>(t, W, B, new_act != 0);
    if (live) {
      const float zs = z[(size_t)my * S + s];
      float delta = s == S - 1 ? 1e10f : __fsub_rn(z[(size_t)my * S + s + 1], zs);
      delta = __fmul_rn(delta, dnorm);
      const float alpha = __fsub_rn(1.f, expf(__fmul_rn(-delta, fmaxf(t.sig[tid], 0.f))));
      const float w = __fmul_rn(alpha, trans);
      w_out[(size_t)my * S + s] = w;
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

template <typename T>
static int launch(const void* rays, const void* z, const void* w, const void* b, void* rgb,
                  void* depth, void* weights, int n, int s, int new_act, int white_back,
                  void* stream) {
  const size_t bytes = tile_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(render_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const dim3 grid((n + TILE - 1) / TILE);
  render_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)z, (const T*)w, (const float*)b, (float*)rgb,
      (float*)depth, (float*)weights, n, s, new_act, white_back);
  return (int)cudaGetLastError();
}

extern "C" {

// rays (n, 6) f32 [o, d]; z (n, s) f32 ascending; w packed weights (bf16 when
// use_bf16, else f32); b packed f32 biases.  Writes rgb (n, 3), depth (n,),
// weights (n, s), all f32.  Returns the cudaError_t of the launch.
int fused_render_level(const void* rays, const void* z, const void* w, const void* b, void* rgb,
                       void* depth, void* weights, int n, int s, int use_bf16, int new_act,
                       int white_back, void* stream) {
  if (use_bf16)
    return launch<bf16>(rays, z, w, b, rgb, depth, weights, n, s, new_act, white_back, stream);
  return launch<float>(rays, z, w, b, rgb, depth, weights, n, s, new_act, white_back, stream);
}

// Layout constants, so the wrapper can check them against its packing.
int nerf_packed_weight_size() { return W_SIZE; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
