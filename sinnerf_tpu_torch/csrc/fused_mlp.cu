// K4: the per-point PE + NeRF MLP, forward and backward.
//
// Replaces the TPU kernels of sinnerf_tpu/ops/fused_mlp_t.py: _kernel_t
// (:232, called through _forward_t :255) and _bwd_kernel_t (:298, called
// through _backward_t :436, PE adjoint _pe_bwd :160).  Wrapper (a
// torch.autograd.Function), plain versions and launch counters:
// ops/fused_mlp.py.  Its callers are K1's backward (the deterministic
// training render), the renderer's test_time branch (sigma only) and the
// fast_eval=False / fast_train=False branches.  Of the kernels here only
// K4-fwd bf16 runs on those paths: K4-fwd f32 and K4-bwd f32 run
// f32_train_sm90.cu (mlp_f32_sm90.cuh, mlp_backward_f32_sm90.cuh), K4-bwd
// bf16 fused_mlp_sm90.cu (mlp_backward_wgmma.cuh).  mlp_fwd_kernel<float>
// and mlp_bwd_kernel in both dtypes stay built, on no path, for
// chip_smoke.py's timing rounds.
//
// K4-fwd is K1 without the compositing: a block owns TILE consecutive points,
// computes the PE of each point's xyz and of its own direction (not once per
// ray) and runs nerf_mlp.cuh's mlp_tile.  The sigma-only variant stops after
// the sigma head.  Bound: operations, 593,408 multiply-adds per point
// (1.19 MFLOP), as K1.
//
// K4-bwd recomputes the tile with the same mlp_tile (so the ReLU masks and
// casts round as in the forward), then runs mlp_backward.cuh's
// mlp_backward_tile from the per-point cotangents of rgb and sigma, the MLP
// half of K3-bwd.  Beyond K3-bwd it computes the direction-PE block's dW per
// point and the input gradient: dxpe = W1^T da1 + W5x^T da5 (64 columns) and
// ddpe = Wdx^T da_d (32 columns) in f32, then the exact adjoint of the PE
// recurrence per input channel.  Bound: operations, 3 x 593,408 multiply-adds
// per point (recompute, dgrad with the input gradient, wgrad): 3.56 MFLOP.
//
// What the design does about what does not fit (as K3-bwd, whose note says
// more): the kept activations of a tile go to a per-block scratch in global
// memory (read back from L2) on a persistent grid, and each tile's dW/db is
// added into one f32 accumulator with red.global.add.f32, so the gradient's
// last bits change from run to run.  The tail tile is masked: its points get
// zero cotangents and write nothing.
#include "mlp_backward.cuh"

using namespace nerf;

// out[p][k] (add: +=) sum_o D[p][o] Wg[o][k] for k < K, an f32 sum of the cast
// delta D (shared, [TILE][ldd]) against an (O, K) row-major weight block: the
// gradient of a layer's PE input.  Each (p, k) is one thread's, the same
// thread in every call, so a second call may add to the first's result.
template <typename T, int O, int K>
__device__ void input_grad(const T* D, int ldd, const T* __restrict__ Wg, float* out, bool add) {
  for (int e = threadIdx.x; e < TILE * K; e += THREADS) {
    const int p = e / K, k = e % K;
    float s = 0.f;
    for (int o = 0; o < O; ++o) s = fmaf(to_f(D[p * ldd + o]), to_f(Wg[(size_t)o * K + k]), s);
    out[e] = add ? __fadd_rn(s, out[e]) : s;
  }
}

// What K4-bwd adds to the MLP backward: the direction-PE block's dW per point
// and the gradients of both PE inputs (into the block's global scratch).
template <typename T>
struct InputGrad {
  Tile<T> t;
  const T* W;
  float* dW;
  float* dxpe;  // [TILE][XYZ_PAD]
  float* ddpe;  // [TILE][DIR_PAD]
  __device__ void dir_delta(int, T) const {}
  __device__ void dir_done(const T* dad) const {
    wgrad<T, HALF, DIR_PAD>(t, dad, t.dpe, Ld<T>::D, dW + WDX);
    input_grad<T, HALF, DIR_PAD>(dad, Ld<T>::A, W + WDX, ddpe, false);
  }
  __device__ void trunk_delta(int l, const T* d) const {
    if (l == 5) input_grad<T, WIDTH, XYZ_PAD>(d, Ld<T>::A, W + W5X, dxpe, false);
    if (l == 1) input_grad<T, WIDTH, XYZ_PAD>(d, Ld<T>::A, W + W1, dxpe, true);  // W1^T da1 + W5x^T da5
  }
};

// Per-block scratch of K4-bwd in global memory: the kept activations
// [N_KEPT][TILE][Ld::A], the direction layer's f32 pre-activation
// [TILE][HALF] and the f32 gradients of the PE rows [TILE][XYZ_PAD] and
// [TILE][DIR_PAD].
template <typename T>
struct MlpBwdScratch {
  static constexpr size_t KEPT = (size_t)N_KEPT * TILE * Ld<T>::A;
  static constexpr size_t BYTES = KEPT * sizeof(T) + TILE * (HALF + XYZ_PAD + DIR_PAD) * sizeof(float);
};

// ------------------------------------------------------------------- K4-fwd
template <typename T, bool SIGMA_ONLY>
__global__ void __launch_bounds__(THREADS, 2)
mlp_fwd_kernel(const float* __restrict__ xyz, const float* __restrict__ dirs, const T* __restrict__ W,
               const float* __restrict__ B, float* __restrict__ out, int n, int new_act) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T> t = carve<T>(smem);
  const int p0 = blockIdx.x * TILE, p = p0 + threadIdx.x;
  load_points<T>(t, xyz, SIGMA_ONLY ? nullptr : dirs, p0, n);
  mlp_tile<T, KeepNothing, SIGMA_ONLY>(t, W, B, new_act != 0);
  if (threadIdx.x < TILE && p < n) {
    if (SIGMA_ONLY) {
      out[p] = t.sig[threadIdx.x];
    } else {
      for (int c = 0; c < 3; ++c) out[(size_t)p * 4 + c] = t.rgb[threadIdx.x * 3 + c];
      out[(size_t)p * 4 + 3] = t.sig[threadIdx.x];
    }
  }
}

// ------------------------------------------------------------------- K4-bwd
template <typename T>
__global__ void __launch_bounds__(THREADS, bwd_blocks_per_sm<T>())
mlp_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ dirs, const T* __restrict__ W,
               const float* __restrict__ B, const float* __restrict__ g, unsigned char* scratch,
               float* dW, float* dB, float* __restrict__ dxyz, float* __restrict__ ddir, int n,
               int new_act) {
  constexpr int LA = Ld<T>::A;
  extern __shared__ __align__(128) unsigned char smem[];
  const Tile<T> t = carve<T>(smem);
  T* const extra = reinterpret_cast<T*>(smem + tile_bytes<T>());  // the second delta tile
  float* const darg = reinterpret_cast<float*>(extra + TILE * LA);  // [TILE][3] cast da_rgb
  float* const gsig = darg + 3 * TILE;                               // [TILE] cast dL/dsigma
  float* const rpre = gsig + TILE;                                   // [TILE][3] rgb pre-activation

  unsigned char* const mine = scratch + (size_t)blockIdx.x * MlpBwdScratch<T>::BYTES;
  T* const kept = reinterpret_cast<T*>(mine);
  float* const dpre = reinterpret_cast<float*>(mine + MlpBwdScratch<T>::KEPT * sizeof(T));
  float* const dxpe = dpre + TILE * HALF;
  float* const ddpe = dxpe + TILE * XYZ_PAD;
  const Keep<T> keep{t.act, kept, dpre, rpre};
  const InputGrad<T> hooks{t, W, dW, dxpe, ddpe};

  const int tid = threadIdx.x;
  const int n_tiles = (n + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * TILE;
    __syncthreads();  // the previous tile's readers of t.rays are done
    load_points<T>(t, xyz, dirs, p0, n);
    mlp_tile<T, Keep<T>>(t, W, B, new_act != 0, keep);
    if (tid < TILE) {  // head cotangents: g = [d rgb, d sigma], zero past n
      const bool live = p0 + tid < n;
      const float* gp = g + (size_t)(p0 + tid) * 4;
      gsig[tid] = live ? to_f(to_cd<T>(gp[3])) : 0.f;
      for (int ch = 0; ch < 3; ++ch) {
        const float dr = live ? __fmul_rn(gp[ch], rgb_act_slope(rpre[tid * 3 + ch], new_act != 0)) : 0.f;
        darg[tid * 3 + ch] = to_f(to_cd<T>(dr));
      }
    }
    __syncthreads();
    mlp_backward_tile<T>(t, extra, darg, gsig, W, kept, dpre, dW, dB, new_act != 0, hooks);
    if (tid < TILE * 3) {  // the PE adjoints, one thread per (point, channel)
      const int p = tid / 3, c = tid % 3;
      if (p0 + p < n) {
        const size_t at = (size_t)(p0 + p) * 3 + c;
        dxyz[at] = pe_adjoint<N_FREQS_XYZ>(t.rays[p * 6 + c], c, dxpe + p * XYZ_PAD);
        if (ddir != nullptr) ddir[at] = pe_adjoint<N_FREQS_DIR>(t.rays[p * 6 + 3 + c], c, ddpe + p * DIR_PAD);
      }
    }
  }
}

// ------------------------------------------------------------------ launches
template <typename T, bool SIGMA_ONLY>
static int launch_fwd(const void* xyz, const void* dirs, const void* w, const void* b, void* out, int n,
                      int new_act, void* stream) {
  const size_t bytes = tile_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(mlp_fwd_kernel<T, SIGMA_ONLY>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const dim3 grid((n + TILE - 1) / TILE);
  mlp_fwd_kernel<T, SIGMA_ONLY><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)dirs, (const T*)w, (const float*)b, (float*)out, n, new_act);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd(const void* xyz, const void* dirs, const void* w, const void* b, const void* g,
                      void* scratch, void* dw, void* db, void* dxyz, void* ddir, int n, int blocks,
                      int new_act, void* stream) {
  const size_t bytes = bwd_smem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(mlp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const int n_tiles = (n + TILE - 1) / TILE;
  const dim3 grid(n_tiles < blocks ? n_tiles : blocks);
  mlp_bwd_kernel<T><<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)dirs, (const T*)w, (const float*)b, (const float*)g,
      (unsigned char*)scratch, (float*)dw, (float*)db, (float*)dxyz, (float*)ddir, n, new_act);
  return (int)cudaGetLastError();
}

extern "C" {

// xyz (n, 3) f32; dirs (n, 3) f32, unread when sigma_only; w packed weights
// (bf16 when use_bf16, else f32); b packed f32 biases.  Writes out (n, 4)
// [rgb, sigma] f32, or (n,) sigma when sigma_only.  Returns the launch's
// cudaError_t.
int fused_nerf_mlp_fwd(const void* xyz, const void* dirs, const void* w, const void* b, void* out, int n,
                       int use_bf16, int sigma_only, int new_act, void* stream) {
  if (use_bf16)
    return sigma_only ? launch_fwd<bf16, true>(xyz, dirs, w, b, out, n, new_act, stream)
                      : launch_fwd<bf16, false>(xyz, dirs, w, b, out, n, new_act, stream);
  return sigma_only ? launch_fwd<float, true>(xyz, dirs, w, b, out, n, new_act, stream)
                    : launch_fwd<float, false>(xyz, dirs, w, b, out, n, new_act, stream);
}

// Bytes of global scratch one block of the backward needs.
long long fused_nerf_mlp_bwd_scratch_bytes(int use_bf16) {
  return (long long)(use_bf16 ? MlpBwdScratch<bf16>::BYTES : MlpBwdScratch<float>::BYTES);
}

// The forward's inputs (dirs null: zero directions, the sigma-only case) and
// the cotangent g (n, 4) f32 [d rgb, d sigma] -> dw (packed weight layout,
// f32) and db (packed bias layout), both ADDED INTO: zero them first; dxyz
// (n, 3) and, unless null, ddir (n, 3) f32, written.  scratch holds
// ``blocks`` times fused_nerf_mlp_bwd_scratch_bytes, and at most ``blocks``
// blocks are launched.
int fused_nerf_mlp_bwd(const void* xyz, const void* dirs, const void* w, const void* b, const void* g,
                       void* scratch, void* dw, void* db, void* dxyz, void* ddir, int n, int blocks,
                       int use_bf16, int new_act, void* stream) {
  if (use_bf16)
    return launch_bwd<bf16>(xyz, dirs, w, b, g, scratch, dw, db, dxyz, ddir, n, blocks, new_act, stream);
  return launch_bwd<float>(xyz, dirs, w, b, g, scratch, dw, db, dxyz, ddir, n, blocks, new_act, stream);
}

int nerf_packed_weight_size() { return W_SIZE; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
