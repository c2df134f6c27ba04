// K0: positional encoding + the 13-product NeRF MLP for a tile of points,
// shared by the render kernels.
//
// Replaces the shared body of the TPU kernels in
// sinnerf_tpu/ops/fused_mlp_t.py: _pe_fwd (:135), _pe_concat (:150) and
// mlp_from_pe (:189), with weights packed by pack_weights_t (:72).  The
// packing here is ops/fused_mlp.py::pack_weights (offsets below).
//
// Bound: about 593k multiply-adds (1.19 MFLOP) per point; the weights
// (1.2 MB in bf16, 2.4 MB in f32) do not fit in shared memory and are read per
// layer from global memory, where they stay in L2.  The work is compute-bound:
// a tile of P points reuses every weight P times.  The activation tile
// (P x 256) stays in shared memory for all 13 products.
//
// A tile of P points is run by a group of 4P threads (Grp): by default the
// whole block, P = TILE = 64 and 256 threads, as every production kernel
// runs it.  The experiment kernels (exp_kernel_variants.cu,
// exp_bwd_pipeline.cu) also run 128-point tiles (512 threads, so that each
// warp keeps the same 8 accumulator fragments) and split a block into
// groups that meet at named barriers of their own.
//   float32:  register-blocked FMA, 8 points x (256/32) outputs per thread,
//             weights staged through shared memory in slabs of 16 columns.
//   bfloat16: nvcuda::wmma 16x16x16 bf16 fragments with float accumulators,
//             B fragments loaded straight from global (L2) memory.
//
// Cast points follow mlp_from_pe: the PE is evaluated in f32 then cast to the
// compute dtype; activations are cast after every ReLU and after
// xyz_encoding_final; products accumulate in f32; biases, the sigma head and
// the rgb/direction epilogues are f32.  The PE columns are in the reference's
// interleaved order [x, sin f0 x, cos f0 x, sin f1 x, ...], matching the
// reference-layout weight columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace nerf {

using bf16 = __nv_bfloat16;

constexpr int WIDTH = 256;
constexpr int HALF = 128;
constexpr int XYZ_CH = 63;
constexpr int XYZ_PAD = 64;
constexpr int DIR_CH = 27;
constexpr int DIR_PAD = 32;
constexpr int N_FREQS_XYZ = 10;
constexpr int N_FREQS_DIR = 4;
constexpr int PE_RESTART = 4;

// Packed weight offsets in elements (ops/fused_mlp.py WEIGHT_LAYOUT); every
// block is (out, in_padded) row-major.
constexpr int W1 = 0;
constexpr int W2 = W1 + WIDTH * XYZ_PAD;
constexpr int W3 = W2 + WIDTH * WIDTH;
constexpr int W4 = W3 + WIDTH * WIDTH;
constexpr int W5H = W4 + WIDTH * WIDTH;
constexpr int W5X = W5H + WIDTH * WIDTH;
constexpr int W6 = W5X + WIDTH * XYZ_PAD;
constexpr int W7 = W6 + WIDTH * WIDTH;
constexpr int W8 = W7 + WIDTH * WIDTH;
constexpr int WFIN = W8 + WIDTH * WIDTH;
constexpr int WDH = WFIN + WIDTH * WIDTH;
constexpr int WDX = WDH + HALF * WIDTH;
constexpr int WRGB = WDX + HALF * DIR_PAD;
constexpr int WSIG = WRGB + 3 * HALF;
constexpr int W_SIZE = WSIG + WIDTH;
static_assert(W_SIZE == 594560, "packed weight size must match ops/fused_mlp.py");

// Packed bias offsets (ops/fused_mlp.py BIAS_LAYOUT), float32.
constexpr int B1 = 0;
constexpr int B2 = 256;
constexpr int B3 = 512;
constexpr int B4 = 768;
constexpr int B5 = 1024;
constexpr int B6 = 1280;
constexpr int B7 = 1536;
constexpr int B8 = 1792;
constexpr int BFIN = 2048;
constexpr int BD = 2304;
constexpr int BRGB = 2432;
constexpr int BSIG = 2435;

constexpr int TILE = 64;       // points per block of the production kernels
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SLAB = 16;       // weight columns per staged slab (f32 path)
constexpr int SLAB_LD = WIDTH + 1;

// The threads that run one tile of P points: four per point, and the
// barrier they meet at.  WHOLE: the whole block (__syncthreads).  Else one
// of the block's equal groups: group g owns threads [4Pg, 4P(g + 1)) and
// named barrier 1 + g, so that one group's epilogue and PE can run while
// another group's products issue.
template <int P = TILE, bool WHOLE = true>
struct Grp {
  static constexpr int POINTS = P;
  static constexpr int THREADS = 4 * P;
  static constexpr int WARPS = THREADS / 32;
  static_assert(P % 16 == 0, "a tile is whole 16-point fragments");
  __device__ static unsigned tid() { return WHOLE ? threadIdx.x : threadIdx.x % THREADS; }
  __device__ static unsigned index() { return WHOLE ? 0u : threadIdx.x / THREADS; }
  __device__ static void sync() {
    if constexpr (WHOLE)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(1 + index()), "r"(THREADS) : "memory");
  }
};
using Block = Grp<>;

enum Act { ACT_RELU = 0, ACT_NONE = 1, ACT_SSP = 2 };

// Row strides of the shared tiles.  The bf16 strides keep wmma's 32-byte
// fragment alignment and spread rows over banks; the f32 path reads them
// as broadcasts and needs no padding.
template <typename T> struct Ld;
template <> struct Ld<float> {
  static constexpr int A = WIDTH, X = XYZ_PAD, D = DIR_PAD;
  template <int P> __host__ __device__ static constexpr int scratch() { return SLAB * SLAB_LD; }  // weight slab
};
template <> struct Ld<bf16> {
  static constexpr int A = WIDTH + 8, X = XYZ_PAD + 8, D = DIR_PAD + 8;
  template <int P> __host__ __device__ static constexpr int scratch() { return Grp<P>::WARPS * 256; }  // a 16x16 f32 tile per warp
};

template <typename T, int P = TILE>
struct Tile {
  T* act;          // [P][Ld::A]  activations
  T* xpe;          // [P][Ld::X]  PE of the sample positions
  T* dpe;          // [P][Ld::D]  PE of the ray directions
  float* scratch;  // Ld::scratch<P>() floats
  float* sig;      // [P]
  float* rgb;      // [P][3]
  float* rays;     // [P][6]      o, d
  // The rows of group g of Q-point groups (bf16: each group's warps keep
  // their own scratch).
  template <int Q>
  __device__ Tile<T, Q> part(int g) const {
    static_assert(std::is_same<T, bf16>::value && P % Q == 0, "bf16 tiles split into equal groups");
    Tile<T, Q> s;
    s.act = act + g * Q * Ld<T>::A;
    s.xpe = xpe + g * Q * Ld<T>::X;
    s.dpe = dpe + g * Q * Ld<T>::D;
    s.scratch = scratch + g * Ld<T>::template scratch<Q>();
    s.sig = sig + g * Q;
    s.rgb = rgb + 3 * g * Q;
    s.rays = rays + 6 * g * Q;
    return s;
  }
};

template <typename T, int P = TILE>
__host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(T) * P * (Ld<T>::A + Ld<T>::X + Ld<T>::D) +
         sizeof(float) * (Ld<T>::template scratch<P>() + P + 3 * P + 6 * P);
}

template <typename T, int P = TILE>
__device__ Tile<T, P> carve(unsigned char* smem) {
  Tile<T, P> t;
  t.act = reinterpret_cast<T*>(smem);
  t.xpe = t.act + P * Ld<T>::A;
  t.dpe = t.xpe + P * Ld<T>::X;
  t.scratch = reinterpret_cast<float*>(t.dpe + P * Ld<T>::D);
  t.sig = t.scratch + Ld<T>::template scratch<P>();
  t.rgb = t.sig + P;
  t.rays = t.rgb + 3 * P;
  return t;
}

template <typename T> __device__ __forceinline__ T to_cd(float v);
template <> __device__ __forceinline__ float to_cd<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 to_cd<bf16>(float v) { return __float2bfloat16_rn(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// The intrinsics below (__fmul_rn, __fadd_rn, ...) keep nvcc from contracting
// a multiply and an add into one FMA, so the arithmetic rounds where the plain
// PyTorch version rounds.
__device__ __forceinline__ float shifted_softplus(float x) {
  float sx = __fsub_rn(x, 1.f);
  return __fadd_rn(log1pf(expf(-fabsf(sx))), fmaxf(sx, 0.f));
}

__device__ __forceinline__ float widened_sigmoid(float x) {
  return __fmul_rn(0.5f, __fadd_rn(1.f, __fmul_rn(1.002f, tanhf(__fmul_rn(0.5f, x)))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__device__ __forceinline__ float epilogue(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_SSP) return shifted_softplus(v);
  return v;
}

// PE of input channel c (value x) of one point into its interleaved row:
// row[c] = x, row[3+6k+c] = sin(2^k x), row[6+6k+c] = cos(2^k x), by the
// double-angle recurrence with an exact restart every PE_RESTART frequencies.
template <typename T>
__device__ void pe_channel(float x, int c, int n_freqs, T* row) {
  row[c] = to_cd<T>(x);
  float s = 0.f, co = 0.f;
  for (int k = 0; k < n_freqs; ++k) {
    if (k % PE_RESTART == 0) {
      float xk = __fmul_rn(x, (float)(1 << k));
      s = sinf(xk);
      co = cosf(xk);
    } else {
      float s2 = __fmul_rn(2.f, s);
      float ns = __fmul_rn(s2, co);
      co = __fsub_rn(1.f, __fmul_rn(s2, s));
      s = ns;
    }
    row[3 + 6 * k + c] = to_cd<T>(s);
    row[6 + 6 * k + c] = to_cd<T>(co);
  }
}

// The points [p0, p0 + P) into t.rays as [xyz, dir] (points past n, and the
// directions when dirs is null, are zeros), the zero padding of xpe and dpe,
// and the PE of both.  Ends synchronised.
template <typename T, typename G = Block>
__device__ void load_points(const Tile<T, G::POINTS>& t, const float* __restrict__ xyz,
                            const float* __restrict__ dirs, int p0, int n) {
  constexpr int P = G::POINTS;
  const int tid = G::tid();
  for (int i = tid; i < P * 6; i += G::THREADS) {
    const int p = i / 6, c = i % 6;
    float v = 0.f;
    if (p0 + p < n) {
      if (c < 3) v = xyz[(size_t)(p0 + p) * 3 + c];
      else if (dirs != nullptr) v = dirs[(size_t)(p0 + p) * 3 + c - 3];
    }
    t.rays[i] = v;
  }
  if (tid < P) {
    t.xpe[tid * Ld<T>::X + XYZ_CH] = to_cd<T>(0.f);
    for (int c = DIR_CH; c < DIR_PAD; ++c) t.dpe[tid * Ld<T>::D + c] = to_cd<T>(0.f);
  }
  G::sync();
  if (tid < P * 3) {
    const int p = tid / 3, c = tid % 3;
    pe_channel<T>(t.rays[p * 6 + c], c, N_FREQS_XYZ, t.xpe + p * Ld<T>::X);
    pe_channel<T>(t.rays[p * 6 + 3 + c], c, N_FREQS_DIR, t.dpe + p * Ld<T>::D);
  }
  G::sync();
}

// ---------------------------------------------------------------- f32 path
// acc[i][j] holds point (warp*8 + i), output (lane + 32*j).
template <typename G, int O>
__device__ void gemm_f32(float (&acc)[8][O / 32], const float* A, int lda, int K,
                         const float* __restrict__ W, float* slab) {
  const int ty = G::tid() >> 5, tx = G::tid() & 31;
  for (int k0 = 0; k0 < K; k0 += SLAB) {
    G::sync();  // the previous slab's readers are done
    for (int idx = G::tid(); idx < O * SLAB; idx += G::THREADS) {
      int o = idx / SLAB, kk = idx % SLAB;
      slab[kk * SLAB_LD + o] = __ldg(W + (size_t)o * K + k0 + kk);
    }
    G::sync();
#pragma unroll
    for (int kk = 0; kk < SLAB; ++kk) {
      float a[8], w[O / 32];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = A[(ty * 8 + i) * lda + k0 + kk];
#pragma unroll
      for (int j = 0; j < O / 32; ++j) w[j] = slab[kk * SLAB_LD + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < O / 32; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
}

template <typename G, int O>
__device__ void layer_f32(const Tile<float, G::POINTS>& t, const float* A1, int lda1, int K1, const float* W1g,
                          const float* A2, int lda2, int K2, const float* W2g,
                          const float* __restrict__ bias, int act, float* dst, float* pre) {
  constexpr int NJ = O / 32;
  const int ty = G::tid() >> 5, tx = G::tid() & 31;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  gemm_f32<G, O>(acc, A1, lda1, K1, W1g, t.scratch);
  if (K2 > 0) gemm_f32<G, O>(acc, A2, lda2, K2, W2g, t.scratch);
  G::sync();  // every read of the inputs is done before dst is written
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      int o = tx + 32 * j;
      const float v = __fadd_rn(acc[i][j], __ldg(bias + o));
      if (pre) pre[(ty * 8 + i) * O + o] = v;
      dst[(ty * 8 + i) * Ld<float>::A + o] = epilogue(v, act);
    }
  G::sync();
}

// --------------------------------------------------------------- bf16 path
namespace wm = nvcuda::wmma;
using FragAcc = wm::fragment<wm::accumulator, 16, 16, 16, float>;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;

// The calling warp owns output columns [w*NT*16, (w+1)*NT*16) for M*16
// points (A's first M*16 rows).
// B(k, o) = W[o][k]: the (out, in) row-major weight read as col-major B.
template <int M, int NT>
__device__ void mma_bf16(FragAcc (&acc)[M][NT], const bf16* A, int lda, int K,
                         const bf16* __restrict__ W, int warp) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    FragB b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      wm::load_matrix_sync(b[n], W + (size_t)((warp * NT + n) * 16) * K + k0, K);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      FragA a;
      wm::load_matrix_sync(a, A + m * 16 * lda + k0, lda);
#pragma unroll
      for (int n = 0; n < NT; ++n) wm::mma_sync(acc[m][n], a, b[n], acc[m][n]);
    }
  }
}

// The group's warps tile the (points x O) output: OW warps along the
// outputs (all of them while O / 16 allows), PW along the points.
template <typename G, int O>
__device__ void layer_bf16(const Tile<bf16, G::POINTS>& t, const bf16* A1, int lda1, int K1, const bf16* W1g,
                           const bf16* A2, int lda2, int K2, const bf16* W2g,
                           const float* __restrict__ bias, int act, bf16* dst, float* pre) {
  constexpr int OW = O / 16 < G::WARPS ? O / 16 : G::WARPS, PW = G::WARPS / OW;
  constexpr int M = G::POINTS / 16 / PW, NT = O / 16 / OW;
  const int warp = G::tid() >> 5, lane = G::tid() & 31;
  const int wn = PW == 1 ? warp : warp % OW, r0 = PW == 1 ? 0 : warp / OW * M * 16;  // first output, point
  FragAcc acc[M][NT];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) wm::fill_fragment(acc[m][n], 0.f);
  mma_bf16<M, NT>(acc, A1 + r0 * lda1, lda1, K1, W1g, wn);
  if (K2 > 0) mma_bf16<M, NT>(acc, A2 + r0 * lda2, lda2, K2, W2g, wn);
  G::sync();  // every read of the inputs is done before dst is written
  float* sc = t.scratch + warp * 256;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      wm::store_matrix_sync(sc, acc[m][n], 16, wm::mem_row_major);
      __syncwarp();
      const int o0 = (wn * NT + n) * 16;
      for (int e = lane; e < 256; e += 32) {
        int r = r0 + m * 16 + (e >> 4), c = e & 15;
        const float v = __fadd_rn(sc[e], __ldg(bias + o0 + c));
        if (pre) pre[r * O + o0 + c] = v;
        dst[r * Ld<bf16>::A + o0 + c] = to_cd<bf16>(epilogue(v, act));
      }
      __syncwarp();
    }
  G::sync();
}

// ------------------------------------------------------------------ shared
// dst = act(A1 W1g^T + A2 W2g^T + bias) in the compute dtype; ``pre``, when
// given, receives the f32 pre-activation as [P][O].
template <typename T, typename G, int O>
__device__ __forceinline__ void layer(const Tile<T, G::POINTS>& t, const T* A1, int lda1, int K1, const T* W1g,
                                      const T* A2, int lda2, int K2, const T* W2g,
                                      const float* bias, int act, T* dst, float* pre = nullptr) {
  if constexpr (std::is_same<T, float>::value)
    layer_f32<G, O>(t, A1, lda1, K1, W1g, A2, lda2, K2, W2g, bias, act, dst, pre);
  else
    layer_bf16<G, O>(t, A1, lda1, K1, W1g, A2, lda2, K2, W2g, bias, act, dst, pre);
}

// sigma = h8 . wsig + bsig, four threads per point.
template <typename T, typename G>
__device__ void sigma_head(const Tile<T, G::POINTS>& t, const T* __restrict__ W, const float* __restrict__ B) {
  const int p = G::tid() >> 2, q = G::tid() & 3;
  const T* a = t.act + p * Ld<T>::A + q * 64;
  const T* w = W + WSIG + q * 64;
  float s = 0.f;
  for (int k = 0; k < 64; ++k) s = fmaf(to_f(a[k]), to_f(w[k]), s);
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  if (q == 0) t.sig[p] = __fadd_rn(s, B[BSIG]);
}

// rgb = act(d . wrgb + brgb), one thread per (point, channel).
template <typename T, typename G>
__device__ void rgb_head(const Tile<T, G::POINTS>& t, const T* __restrict__ W, const float* __restrict__ B,
                         bool new_act, float* pre) {
  if (G::tid() < G::POINTS * 3) {
    const int p = G::tid() / 3, c = G::tid() % 3;
    const T* a = t.act + p * Ld<T>::A;
    const T* w = W + WRGB + c * HALF;
    float s = 0.f;
    for (int k = 0; k < HALF; ++k) s = fmaf(to_f(a[k]), to_f(w[k]), s);
    float v = __fadd_rn(s, B[BRGB + c]);
    if (pre) pre[p * 3 + c] = v;
    t.rgb[p * 3 + c] = new_act ? widened_sigmoid(v) : sigmoid(v);
  }
  G::sync();
}

// What the backward kernel keeps of a forward pass; the eval kernel keeps
// nothing.  ``layer_done(i)`` runs after trunk layer i = 1..8 and after
// xyz_encoding_final (i = 9), with the layer's output in t.act.
struct KeepNothing {
  __device__ void layer_done(int) const {}
  __device__ float* dir_pre() const { return nullptr; }  // [P][HALF] f32
  __device__ float* rgb_pre() const { return nullptr; }  // [P][3] f32
};

// The MLP on the tile's xpe/dpe -> t.sig, t.rgb, run by the group G.
// Expects xpe and dpe written and synchronised; returns with sig and rgb
// visible to every thread of the group and the direction branch's activation
// in t.act[:, 0:HALF].  SIGMA_ONLY stops after the sigma head (dpe unread,
// t.rgb unwritten).
template <typename T, typename Keep = KeepNothing, bool SIGMA_ONLY = false, typename G = Block>
__device__ void mlp_tile(const Tile<T, G::POINTS>& t, const T* __restrict__ W, const float* __restrict__ B,
                         bool new_act, const Keep& keep = Keep()) {
  constexpr int LA = Ld<T>::A, LX = Ld<T>::X, LD = Ld<T>::D;
  const T* none = nullptr;
  layer<T, G, WIDTH>(t, t.xpe, LX, XYZ_PAD, W + W1, none, 0, 0, none, B + B1, ACT_RELU, t.act);
  keep.layer_done(1);
  layer<T, G, WIDTH>(t, t.act, LA, WIDTH, W + W2, none, 0, 0, none, B + B2, ACT_RELU, t.act);
  keep.layer_done(2);
  layer<T, G, WIDTH>(t, t.act, LA, WIDTH, W + W3, none, 0, 0, none, B + B3, ACT_RELU, t.act);
  keep.layer_done(3);
  layer<T, G, WIDTH>(t, t.act, LA, WIDTH, W + W4, none, 0, 0, none, B + B4, ACT_RELU, t.act);
  keep.layer_done(4);
  layer<T, G, WIDTH>(t, t.act, LA, WIDTH, W + W5H, t.xpe, LX, XYZ_PAD, W + W5X, B + B5, ACT_RELU, t.act);
  keep.layer_done(5);
  layer<T, G, WIDTH>(t, t.act, LA, WIDTH, W + W6, none, 0, 0, none, B + B6, ACT_RELU, t.act);
  keep.layer_done(6);
  layer<T, G, WIDTH>(t, t.act, LA, WIDTH, W + W7, none, 0, 0, none, B + B7, ACT_RELU, t.act);
  keep.layer_done(7);
  layer<T, G, WIDTH>(t, t.act, LA, WIDTH, W + W8, none, 0, 0, none, B + B8, ACT_RELU, t.act);
  keep.layer_done(8);
  // sigma reads h8 before xyz_encoding_final overwrites it: the layer's own
  // barrier before its epilogue orders the two
  sigma_head<T, G>(t, W, B);
  if constexpr (SIGMA_ONLY) {
    G::sync();
    return;
  }
  layer<T, G, WIDTH>(t, t.act, LA, WIDTH, W + WFIN, none, 0, 0, none, B + BFIN, ACT_NONE, t.act);
  keep.layer_done(9);
  layer<T, G, HALF>(t, t.act, LA, WIDTH, W + WDH, t.dpe, LD, DIR_PAD, W + WDX, B + BD,
                 new_act ? ACT_SSP : ACT_RELU, t.act, keep.dir_pre());
  rgb_head<T, G>(t, W, B, new_act, keep.rgb_pre());
}

}  // namespace nerf
