// K1: fused per-ray render of one level (eval path): PE + NeRF MLP + online
// alpha compositing.
//
// Replaces the TPU kernel sinnerf_tpu/ops/fused_render_t.py::_render_kernel
// (:61), called through fused_render_level (:124).  Wrapper, plain version and
// launch counter: ops/fused_render.py.  The body is render_level.cuh's
// render_tile, which the training forward kernel shares; its note says how a
// block walks its rays and samples.
//
// Bound: compute.  593,408 multiply-adds (1.19 MFLOP) per point; a 504x378
// image at 64 + 128 samples is 190,512 x (64 + 192) = 48.8M points, 58 TFLOP:
// 59 ms at an H100 SXM's 989 TFLOP/s bf16 dense peak, 0.87 s at its 67
// TFLOP/s f32 peak outside the tensor cores.  Device-memory traffic is a few
// hundred bytes per ray plus the 1.2/2.4 MB of weights, read from L2.  The
// design keeps everything per point on chip; the weights are re-read from L2
// by every block for every sample, TILE points per read.
#include "render_level.cuh"

using namespace nerf;

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
render_kernel(const float* __restrict__ rays, const float* __restrict__ z,
              const T* __restrict__ W, const float* __restrict__ B,
              float* __restrict__ rgb_out, float* __restrict__ depth_out,
              float* __restrict__ w_out, int n, int S, int new_act, int white_back) {
  extern __shared__ __align__(128) unsigned char smem[];
  render_tile<T, false>(rays, z, nullptr, W, B, rgb_out, depth_out, w_out, nullptr, nullptr,
                        n, S, new_act, white_back, smem);
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
