// X2: the pipelining experiments on K3-bwd, the training render's backward.
//
// Replaces the TPU kernel of scripts/exp_bwd_pipeline.py::run_variant (:326,
// kernel _exp_bwd_kernel :73-323, call :369): a parameterised copy of the
// production backward (no noise, black background, new activation, bf16)
// with exact restructurings and timing ablations.  Wrapper, plain versions,
// launch counter and the experiment's entry point:
// sinnerf_tpu_torch/scripts/exp_bwd_pipeline.py.
//
// One kernel, exp_bwd_kernel<RB, NS, Opt>, over the production body
// (train_backward.cuh's train_bwd_tiles, whose note says what each axis
// changes).  The variants (JAX's names):
//   base        <64, 1, exact>: the production kernel, nothing removed
//   two_stream  <32, 2, exact> and <64, 2, exact>: two samples of each ray
//               per MLP tile (JAX's r_tile 512 and 1024 as 32 and 64 rays x
//               2 samples), exact
//   pe_pipe     <64, 1, PE_PIPE>: sample s+1's PE during sample s's
//               backward, exact
//   no_db       no bias sums
//   no_mask     no ReLU masks of the trunk (the sigma gate stays)
//   no_dw       no weight-gradient products (dwdx is still written)
//   mxu_floor   x = 0.01 in all 64 PE columns, no masks, no bias sums
//   cheap_pe    x = bf16(z 0.01) in all 64 columns
// The last five compute other gradients on purpose: they time what each
// part costs.
//
// Bound: operations.  Exact variants: 3.48 MFLOP per point, K3-bwd's (11.06
// ms at 16,384 rays x 192 samples, 989 TFLOP/s); no_dw drops the 589,312
// multiply-adds of wgrad per point (7.32 ms).
#include "train_backward.cuh"

using namespace nerf;

struct AblNoDb {
  static constexpr bool NO_DB = true, NO_DW = false, NO_MASK = false;
};
struct AblNoMask {
  static constexpr bool NO_DB = false, NO_DW = false, NO_MASK = true;
};
struct AblNoDw {
  static constexpr bool NO_DB = false, NO_DW = true, NO_MASK = false;
};
struct AblFloor {
  static constexpr bool NO_DB = true, NO_DW = false, NO_MASK = true;
};

// Variant ids of the C interface (the wrapper's VARIANT_IDS).
enum Variant { V_BASE = 0, V_NO_DB = 1, V_NO_MASK = 2, V_NO_DW = 3, V_MXU_FLOOR = 4, V_CHEAP_PE = 5, V_PE_PIPE = 6 };

template <int RB, int NS, typename Opt>
__global__ void __launch_bounds__(4 * RB * NS, RB * NS == TILE ? 2 : 1)
exp_bwd_kernel(const float* __restrict__ rays, const float* __restrict__ z, const float* __restrict__ noise,
               const bf16* __restrict__ W, const float* __restrict__ B, const float* __restrict__ w_res,
               const float* __restrict__ a_res, const float* __restrict__ rgb_res,
               const float* __restrict__ g_rgb, const float* __restrict__ g_depth,
               const float* __restrict__ g_w, float* dsig_part, unsigned char* scratch, float* dW, float* dB,
               int n, int S, int new_act, int white_back) {
  extern __shared__ __align__(128) unsigned char smem[];
  train_bwd_tiles<bf16, RB, NS, Opt>(rays, z, noise, W, B, w_res, a_res, rgb_res, g_rgb, g_depth, g_w, dsig_part,
                                     scratch, dW, dB, n, S, new_act, white_back, smem);
}

struct Args {
  const void *rays, *z, *w, *b, *w_res, *a_res, *rgb_res, *g_rgb, *g_depth, *g_w;
  void *dsig_part, *scratch, *dw, *db;
  int n, s, blocks, new_act;
  void* stream;
};

template <int RB, int NS, typename Opt>
static int launch(const Args& a) {
  constexpr int P = RB * NS;
  const size_t bytes = train_bwd_smem_bytes<bf16, P, Opt::PE_PIPE>();
  cudaError_t e = cudaFuncSetAttribute(exp_bwd_kernel<RB, NS, Opt>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (a.n == 0) return 0;
  const int n_tiles = (a.n + RB - 1) / RB;
  const dim3 grid(n_tiles < a.blocks ? n_tiles : a.blocks);
  // no noise and a black background, as JAX's experiment (the body reads
  // both at run time, as the production kernel does)
  exp_bwd_kernel<RB, NS, Opt><<<grid, 4 * P, bytes, (cudaStream_t)a.stream>>>(
      (const float*)a.rays, (const float*)a.z, nullptr, (const bf16*)a.w, (const float*)a.b,
      (const float*)a.w_res, (const float*)a.a_res, (const float*)a.rgb_res, (const float*)a.g_rgb,
      (const float*)a.g_depth, (const float*)a.g_w, (float*)a.dsig_part, (unsigned char*)a.scratch,
      (float*)a.dw, (float*)a.db, a.n, a.s, a.new_act, 0);
  return (int)cudaGetLastError();
}

using Base = BwdOptions<>;
using NoDb = BwdOptions<AblNoDb>;
using NoMask = BwdOptions<AblNoMask>;
using NoDw = BwdOptions<AblNoDw>;
using Floor = BwdOptions<AblFloor, X_CONST>;
using CheapPe = BwdOptions<Exact, X_CHEAP>;
using PePipe = BwdOptions<Exact, X_PE, true>;

// The instantiated kernels: (variant, rays per block, samples of a ray per
// MLP tile, options).
#define EXP_BWD_KERNELS(X)      \
  X(V_BASE, 64, 1, Base)          \
  X(V_BASE, 32, 2, Base)          \
  X(V_BASE, 64, 2, Base)          \
  X(V_NO_DB, 64, 1, NoDb)         \
  X(V_NO_MASK, 64, 1, NoMask)     \
  X(V_NO_DW, 64, 1, NoDw)         \
  X(V_MXU_FLOOR, 64, 1, Floor)    \
  X(V_CHEAP_PE, 64, 1, CheapPe)   \
  X(V_PE_PIPE, 64, 1, PePipe)

extern "C" {

// Bytes of global scratch one block of a variant needs, -1 when the
// variant is not built.  Blocks per SM: 2 for 64-point tiles, 1 for 128.
long long exp_bwd_pipeline_scratch_bytes(int variant, int rays, int streams) {
#define X(V, RB, NS, OPT) \
  if (variant == V && rays == RB && streams == NS) return (long long)BwdScratch<bf16, RB * NS, RB>::BYTES;
  EXP_BWD_KERNELS(X)
#undef X
  return -1;
}

// The production backward's inputs (no noise, white_back off) for variant
// ``variant`` at ``rays`` rays per block and ``streams`` samples of a ray per
// MLP tile -> dw, db (packed layouts, f32), ADDED INTO: zero them first.
// dsig_part (n, s) f32 scratch; scratch holds ``blocks`` times
// exp_bwd_pipeline_scratch_bytes.  s must be a multiple of ``streams``.
// Returns the launch's cudaError_t, cudaErrorInvalidValue for a variant
// that is not built.
int exp_bwd_pipeline(int variant, int rays, int streams, const void* rays_od, const void* z, const void* w,
                     const void* b, const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb,
                     const void* g_depth, const void* g_w, void* dsig_part, void* scratch, void* dw, void* db,
                     int n, int s, int blocks, int new_act, void* stream) {
  if (streams < 1 || s % streams != 0) return (int)cudaErrorInvalidValue;
  const Args a{rays_od, z, w, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w,
               dsig_part, scratch, dw, db, n, s, blocks, new_act, stream};
#define X(V, RB, NS, OPT) \
  if (variant == V && rays == RB && streams == NS) return launch<RB, NS, OPT>(a);
  EXP_BWD_KERNELS(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

int nerf_packed_weight_size() { return W_SIZE; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
