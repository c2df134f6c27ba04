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
//   * float32: render_f32_sm90<false> (render_f32_sm90.cuh, the float32
//     K3-fwd kernel without its noise and residuals) on mlp_f32_sm90.cuh's
//     body: FFMA in float32 from a register tile of 8 points x 16 outputs
//     per thread, the activations K-major in shared memory, the weights
//     streamed as pre-transposed slabs by bulk copies.  For the same inputs
//     it equals K3-fwd f32 without noise bit for bit.
// Both are persistent: at most one CTA per SM, each walking ray tiles of 128
// rays gridDim.x apart; per tile the rays (and in bf16 the direction PE)
// once, per sample the PE, the MLP and the compositing of
// render_level.cuh's render_tile, in the same order.
// Tested as the port's other kernels are: the CPU tests run the plain
// version and pin both slab layouts and the launch plan
// (tests/test_torch_k1_sm90.py); on the card, python3 chip_smoke.py builds,
// checks and times them.
#include "render_f32_sm90.cuh"

using namespace nerf;

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
    int e = set_smem((const void*)f32s::render_f32_sm90<false>, f32s::Smem::BYTES);
    if (e) return e;
    if (tiles == 0) return 0;
    f32s::render_f32_sm90<false><<<grid, f32s::CTA_THREADS, f32s::Smem::BYTES, (cudaStream_t)stream>>>(
        (const float*)rays, (const float*)z, nullptr, (const unsigned char*)slabs, (const float*)b, (float*)rgb,
        (float*)depth, (float*)weights, nullptr, nullptr, n, s, new_act, white_back);
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
