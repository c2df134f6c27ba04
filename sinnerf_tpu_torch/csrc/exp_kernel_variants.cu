// X1: the forward-kernel variants of K4-fwd (the per-point PE + NeRF MLP).
//
// Replaces the TPU kernel of scripts/exp_kernel_variants.py::make_variant
// (:79, kernel :82-148, call :168), an experiment on the forward's design.
// Wrapper, plain versions, launch counter and the experiment's entry point:
// sinnerf_tpu_torch/scripts/exp_kernel_variants.py.
//
// One kernel, exp_fwd_kernel<IN_PE, ILP, TP>, over K4-fwd's body
// (nerf_mlp.cuh's mlp_tile, bf16 only, as JAX's variants):
//   IN_PE  true: the PE of raw xyz/dir computed in the kernel, as production
//          fused_mlp.cu does (load_points).  false: pre-encoded bf16 PE rows
//          read from global memory in the port's interleaved layout,
//          xpe (n, 64) and dpe (n, 32), the PE's cost left outside.
//   ILP    the block's TP points split into ILP groups of TP/ILP points, each
//          run by its own warps through the whole MLP and meeting at its own
//          named barrier (bar.sync 1+g), so that one group's bias/activation/
//          cast epilogue and PE run while another group's products issue:
//          the GPU reading of JAX's "one slice's epilogue overlaps the
//          other's matmul".
//   TP     points per block, 64 (256 threads, two blocks per SM) or 128 (512
//          threads, one block per SM): the stand-ins for JAX's tile 4096 and
//          8192.  Four threads per point keep every warp at the production
//          kernel's 8 accumulator fragments.
// <true, 1, 64> is production K4-fwd.  The tail of the last block is masked
// (JAX's grid drops it).
//
// Bound: operations, 593,408 multiply-adds per point (1.19 MFLOP), as K4-fwd:
// 10.07 ms for 8,388,608 points at 989 TFLOP/s.  The bytes (24 or 192 per
// point in, 16 out) need 0.5 ms at 3.35 TB/s.
#include "nerf_mlp.cuh"

using namespace nerf;

// Pre-encoded PE rows of points [p0, p0 + P) into t.xpe and t.dpe, 16 bytes
// a thread (zeros past n).  Ends synchronised.
template <typename G>
__device__ void load_pe(const Tile<bf16, G::POINTS>& t, const bf16* __restrict__ xpe,
                        const bf16* __restrict__ dpe, int p0, int n) {
  constexpr int XV = XYZ_PAD * 2 / 16, DV = DIR_PAD * 2 / 16;  // 16-byte vectors per row
  for (int i = G::tid(); i < G::POINTS * (XV + DV); i += G::THREADS) {
    const int p = i / (XV + DV), c = i % (XV + DV);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + p < n)
      v = c < XV ? reinterpret_cast<const uint4*>(xpe + (size_t)(p0 + p) * XYZ_PAD)[c]
                 : reinterpret_cast<const uint4*>(dpe + (size_t)(p0 + p) * DIR_PAD)[c - XV];
    if (c < XV)
      reinterpret_cast<uint4*>(t.xpe + p * Ld<bf16>::X)[c] = v;
    else
      reinterpret_cast<uint4*>(t.dpe + p * Ld<bf16>::D)[c - XV] = v;
  }
  G::sync();
}

template <bool IN_PE, int ILP, int TP>
__global__ void __launch_bounds__(4 * TP, TP == TILE ? 2 : 1)
exp_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ dirs, const bf16* __restrict__ xpe,
               const bf16* __restrict__ dpe, const bf16* __restrict__ W, const float* __restrict__ B,
               float* __restrict__ out, int n, int new_act) {
  using G = Grp<TP / ILP, ILP == 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<bf16, G::POINTS> t = carve<bf16, TP>(smem).template part<G::POINTS>(G::index());
  const int p0 = blockIdx.x * TP + G::index() * G::POINTS, q = G::tid();
  if constexpr (IN_PE)
    load_points<bf16, G>(t, xyz, dirs, p0, n);
  else
    load_pe<G>(t, xpe, dpe, p0, n);
  mlp_tile<bf16, KeepNothing, false, G>(t, W, B, new_act != 0);
  if (q < G::POINTS && p0 + q < n) {
    for (int c = 0; c < 3; ++c) out[(size_t)(p0 + q) * 4 + c] = t.rgb[q * 3 + c];
    out[(size_t)(p0 + q) * 4 + 3] = t.sig[q];
  }
}

template <bool IN_PE, int ILP, int TP>
static int launch(const void* xyz, const void* dirs, const void* xpe, const void* dpe, const void* w,
                  const void* b, void* out, int n, int new_act, void* stream) {
  const size_t bytes = tile_bytes<bf16, TP>();
  cudaError_t e = cudaFuncSetAttribute(exp_fwd_kernel<IN_PE, ILP, TP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  exp_fwd_kernel<IN_PE, ILP, TP><<<(n + TP - 1) / TP, 4 * TP, bytes, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)dirs, (const bf16*)xpe, (const bf16*)dpe, (const bf16*)w,
      (const float*)b, (float*)out, n, new_act);
  return (int)cudaGetLastError();
}

extern "C" {

// One variant of the grid (JAX's names): base <false, 1, 64>, ilp2
// <false, 2, 64>, pe <true, 1, 64>, pe_ilp2 <true, 2, 64>, pe_ilp4
// <true, 4, 64>, pe_ilp2_t2x <true, 2, 128>.  in_pe: xyz, dirs (n, 3) f32;
// else xpe (n, 64), dpe (n, 32) bf16, 16-byte aligned.  w packed bf16
// weights, b packed f32 biases.  Writes out (n, 4) [rgb, sigma] f32.
// Returns the launch's cudaError_t, cudaErrorInvalidValue for a variant that
// is not built.
int exp_kernel_variant(int in_pe, int ilp, int tile, const void* xyz, const void* dirs, const void* xpe,
                       const void* dpe, const void* w, const void* b, void* out, int n, int new_act,
                       void* stream) {
  const int key = (in_pe ? 1000 : 0) + ilp * 100 + tile / 32;
  switch (key) {
    case 102: return launch<false, 1, 64>(xyz, dirs, xpe, dpe, w, b, out, n, new_act, stream);
    case 202: return launch<false, 2, 64>(xyz, dirs, xpe, dpe, w, b, out, n, new_act, stream);
    case 1102: return launch<true, 1, 64>(xyz, dirs, xpe, dpe, w, b, out, n, new_act, stream);
    case 1202: return launch<true, 2, 64>(xyz, dirs, xpe, dpe, w, b, out, n, new_act, stream);
    case 1402: return launch<true, 4, 64>(xyz, dirs, xpe, dpe, w, b, out, n, new_act, stream);
    case 1204: return launch<true, 2, 128>(xyz, dirs, xpe, dpe, w, b, out, n, new_act, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int nerf_packed_weight_size() { return W_SIZE; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
