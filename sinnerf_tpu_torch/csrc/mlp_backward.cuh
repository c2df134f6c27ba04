// The backward of the NeRF MLP over a tile of points, shared by the
// training render's backward (K3-bwd, fused_render_train.cu) and the
// per-point MLP's backward (K4-bwd, fused_mlp.cu): on the paths, the bf16
// K4-bwd; in float32 those now run mlp_backward_f32_sm90.cuh.
//
// After mlp_tile has recomputed the tile with a Keep (each layer's cast
// output copied to a per-block scratch in global memory), mlp_backward_tile
// carries the cast head cotangents back through every layer and adds each
// tile's dW/db into one f32 accumulator with red.global.add.f32.
//
// dgrad, wgrad and bias_grad are the three products of a layer's backward.
// bf16 runs nvcuda::wmma 16x16x16 fragments with f32 accumulators, f32 a
// register-blocked FMA loop.  Cast points follow _bwd_kernel_t
// (fused_mlp_t.py:298) and _train_bwd_kernel (fused_render_train_t.py:164):
// every delta is cast to the compute dtype before both of its products; ReLU
// masks read the cast activation; sums run in f32.
//
// Like mlp_tile, every routine runs on a tile of P points with 4P threads,
// the whole block (P = TILE in the production kernels).  The Abl options
// remove parts of the backward on purpose, for the timing ablations of
// exp_bwd_pipeline.cu; the production kernels take Exact.
#pragma once

#include "nerf_mlp.cuh"

namespace nerf {

constexpr int N_KEPT = 9;  // h1..h8 and the output of xyz_encoding_final

// Shared memory of the backward: the forward's tile, one more delta tile and
// the per-point head cotangents (da_rgb [P][3], g_sig [P]) and rgb
// pre-activation [P][3].
template <typename T, int P = TILE>
__host__ __device__ constexpr size_t bwd_smem_bytes() {
  return tile_bytes<T, P>() + sizeof(T) * P * Ld<T>::A + sizeof(float) * 7 * P;
}

// What the backward removes: Exact removes nothing.  NO_DB drops every bias
// sum, NO_DW every weight-gradient product, NO_MASK the ReLU masks of the
// trunk (h1..h8).
struct Exact {
  static constexpr bool NO_DB = false, NO_DW = false, NO_MASK = false;
};

template <typename T, int P = TILE>
struct Keep {
  const T* act;  // the tile's activations (shared memory)
  T* kept;
  float* dpre;
  float* rpre;
  __device__ void layer_done(int i) const {
    T* dst = kept + (size_t)(i - 1) * P * Ld<T>::A;
    for (int e = Grp<P>::tid(); e < P * WIDTH; e += Grp<P>::THREADS) {
      const int at = (e / WIDTH) * Ld<T>::A + e % WIDTH;
      dst[at] = act[at];
    }
  }
  __device__ float* dir_pre() const { return dpre; }
  __device__ float* rgb_pre() const { return rpre; }
};

// Epilogues of a dgrad product: what becomes of the f32 sum v at point p,
// channel k before it is cast.
struct EpiNone {
  __device__ float operator()(int, int, float v) const { return v; }
};
template <typename T>
struct EpiMask {  // ReLU mask of the cast activation h
  const T* h;
  __device__ float operator()(int p, int k, float v) const {
    return to_f(h[p * Ld<T>::A + k]) > 0.f ? v : 0.f;
  }
};
template <typename T, bool MASK = true>
struct EpiSigmaMask {  // + g_sig[p] wsig[k], then the mask of h8
  const T* h;
  const float* gsig;
  const T* wsig;
  __device__ float operator()(int p, int k, float v) const {
    v = __fadd_rn(v, __fmul_rn(gsig[p], to_f(wsig[k])));
    if constexpr (!MASK) return v;
    return to_f(h[p * Ld<T>::A + k]) > 0.f ? v : 0.f;
  }
};

// ---- dgrad: dst[p][k] = cast(epi(sum_o D[p][o] Wg[o][k])), k < WIDTH.
// D (shared) is [P][ldd] with O channels; Wg is the (O, WIDTH) row-major
// weight block; dst is another [P][Ld::A] tile.
template <typename G, int O, typename Epi>
__device__ void dgrad_f32(const float* D, int ldd, const float* __restrict__ Wg, const Epi& epi,
                          float* dst) {
  const int ty = G::tid() >> 5, tx = G::tid() & 31;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int o = 0; o < O; ++o) {
    float a[8], w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = D[(ty * 8 + i) * ldd + o];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = __ldg(Wg + (size_t)o * WIDTH + tx + 32 * j);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = ty * 8 + i, k = tx + 32 * j;
      dst[p * Ld<float>::A + k] = epi(p, k, acc[i][j]);
    }
  G::sync();
}

using FragBRow = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragACol = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major>;

template <typename G, int O, typename Epi>
__device__ void dgrad_bf16(const bf16* D, int ldd, const bf16* __restrict__ Wg, const Epi& epi,
                           bf16* dst, float* scratch) {
  constexpr int M = G::POINTS / 16, NT = WIDTH / 16 / G::WARPS;
  const int warp = G::tid() >> 5, lane = G::tid() & 31;
  FragAcc acc[M][NT];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) wm::fill_fragment(acc[m][n], 0.f);
  for (int o0 = 0; o0 < O; o0 += 16) {
    FragBRow b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      wm::load_matrix_sync(b[n], Wg + (size_t)o0 * WIDTH + (warp * NT + n) * 16, WIDTH);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      FragA a;
      wm::load_matrix_sync(a, D + m * 16 * ldd + o0, ldd);
#pragma unroll
      for (int n = 0; n < NT; ++n) wm::mma_sync(acc[m][n], a, b[n], acc[m][n]);
    }
  }
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      wm::store_matrix_sync(sc, acc[m][n], 16, wm::mem_row_major);
      __syncwarp();
      const int k0 = (warp * NT + n) * 16;
      for (int e = lane; e < 256; e += 32) {
        const int p = m * 16 + (e >> 4), k = k0 + (e & 15);
        dst[p * Ld<bf16>::A + k] = to_cd<bf16>(epi(p, k, sc[e]));
      }
      __syncwarp();
    }
  G::sync();
}

template <typename T, int O, typename Epi, int P>
__device__ __forceinline__ void dgrad(const Tile<T, P>& t, const T* D, const T* Wg, const Epi& epi,
                                      T* dst) {
  if constexpr (std::is_same<T, float>::value)
    dgrad_f32<Grp<P>, O>(D, Ld<T>::A, Wg, epi, dst);
  else
    dgrad_bf16<Grp<P>, O>(D, Ld<T>::A, Wg, epi, dst, t.scratch);
}

// ---- wgrad: dW[o][k] += sum_p D[p][o] A[p][k], o < O, k < KIN.  D (shared)
// is the cast delta tile, A the cast layer input (shared, or the block's
// global scratch: read with plain loads, it was written in this launch).
// The tile's sum goes to the global accumulator with one add per element.
template <typename G, int O, int KIN>
__device__ void wgrad_f32(const float* D, int ldd, const float* A, int lda, float* dW) {
  constexpr int NJ = KIN / 32;
  const int ty = G::tid() >> 5, tx = G::tid() & 31;
  for (int q = 0; q < O / 64; ++q) {
    const int o0 = q * 64 + ty * 8;
    float acc[8][NJ];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int p = 0; p < G::POINTS; ++p) {
      float d[8], a[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = D[p * ldd + o0 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) a[j] = A[p * lda + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(d[i], a[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) atomicAdd(dW + (size_t)(o0 + i) * KIN + tx + 32 * j, acc[i][j]);
  }
}

template <typename G, int O, int KIN>
__device__ void wgrad_bf16(const bf16* D, int ldd, const bf16* A, int lda, float* dW,
                           float* scratch) {
  // OW warps along the outputs (all of them while O / 16 allows), KW along the inputs
  constexpr int OW = O / 16 < G::WARPS ? O / 16 : G::WARPS, KW = G::WARPS / OW;
  constexpr int MPW = O / 16 / OW;  // rows of 16 outputs per warp
  constexpr int KF = KIN / 16 / KW;  // fragments of 16 inputs per warp
  constexpr int NG = KF < 4 ? KF : 4;  // fragments of 16 inputs per pass
  static_assert(MPW >= 1 && KF >= 1 && KF % NG == 0, "wgrad tile shape");
  const int warp = G::tid() >> 5, lane = G::tid() & 31;
  const int wo = KW == 1 ? warp : warp % OW, k0 = KW == 1 ? 0 : warp / OW * KF;
  float* sc = scratch + warp * 256;
  for (int n0 = k0; n0 < k0 + KF; n0 += NG) {
    FragAcc acc[MPW][NG];
#pragma unroll
    for (int m = 0; m < MPW; ++m)
#pragma unroll
      for (int g = 0; g < NG; ++g) wm::fill_fragment(acc[m][g], 0.f);
    for (int p0 = 0; p0 < G::POINTS; p0 += 16) {
      FragACol a[MPW];  // (o, p) = D[p][o]: the delta tile read column-major
#pragma unroll
      for (int m = 0; m < MPW; ++m)
        wm::load_matrix_sync(a[m], D + p0 * ldd + (wo * MPW + m) * 16, ldd);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        FragBRow b;
        wm::load_matrix_sync(b, A + p0 * lda + (n0 + g) * 16, lda);
#pragma unroll
        for (int m = 0; m < MPW; ++m) wm::mma_sync(acc[m][g], a[m], b, acc[m][g]);
      }
    }
#pragma unroll
    for (int m = 0; m < MPW; ++m)
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        wm::store_matrix_sync(sc, acc[m][g], 16, wm::mem_row_major);
        __syncwarp();
        float* out = dW + (size_t)((wo * MPW + m) * 16) * KIN + (n0 + g) * 16;
        for (int e = lane; e < 256; e += 32) atomicAdd(out + (size_t)(e >> 4) * KIN + (e & 15), sc[e]);
        __syncwarp();
      }
  }
}

template <typename T, int O, int KIN, int P>
__device__ __forceinline__ void wgrad(const Tile<T, P>& t, const T* D, const T* A, int lda, float* dW) {
  if constexpr (std::is_same<T, float>::value)
    wgrad_f32<Grp<P>, O, KIN>(D, Ld<T>::A, A, lda, dW);
  else
    wgrad_bf16<Grp<P>, O, KIN>(D, Ld<T>::A, A, lda, dW, t.scratch);
}

// db[o] += sum_p D[p][o], in f32.
template <typename T, int O, int P = TILE>
__device__ void bias_grad(const T* D, float* db) {
  for (int o = Grp<P>::tid(); o < O; o += Grp<P>::THREADS) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s = __fadd_rn(s, to_f(D[p * Ld<T>::A + o]));
    atomicAdd(db + o, s);
  }
}

// The rgb head's activation slope at its f32 pre-activation a:
// 0.2505 (1 - tanh(a/2)^2) for the widened sigmoid, s (1 - s) for the sigmoid.
__device__ __forceinline__ float rgb_act_slope(float a, bool new_act) {
  if (new_act) {
    const float tt = tanhf(__fmul_rn(0.5f, a));
    return __fmul_rn(0.2505f, __fsub_rn(1.f, __fmul_rn(tt, tt)));
  }
  const float sg = sigmoid(a);
  return __fmul_rn(sg, __fsub_rn(1.f, sg));
}

// dL/dx of input channel c (value x) from the gradient row g of its PE
// (interleaved: g[c] for x, g[3+6k+c] for sin 2^k x, g[6+6k+c] for cos): the
// exact adjoint of pe_channel's recurrence, _pe_bwd (fused_mlp_t.py:160-181)
// in the same order of operations, f32.
template <int F>
__device__ float pe_adjoint(float x, int c, const float* g) {
  float s[F], co[F];
#pragma unroll
  for (int k = 0; k < F; ++k) {  // the forward's values, as pe_channel computes them
    if (k % PE_RESTART == 0) {
      const float xk = __fmul_rn(x, (float)(1 << k));
      s[k] = sinf(xk);
      co[k] = cosf(xk);
    } else {
      const float s2 = __fmul_rn(2.f, s[k - 1]);
      s[k] = __fmul_rn(s2, co[k - 1]);
      co[k] = __fsub_rn(1.f, __fmul_rn(s2, s[k - 1]));
    }
  }
  float dx = g[c], ds_next = 0.f, dc_next = 0.f;
#pragma unroll
  for (int k = F - 1; k >= 0; --k) {
    float ds = g[3 + 6 * k + c], dc = g[6 + 6 * k + c];
    if (k + 1 < F && (k + 1) % PE_RESTART != 0) {  // level k+1 came from level k
      ds = __fsub_rn(__fadd_rn(ds, __fmul_rn(2.f, __fmul_rn(co[k], ds_next))),
                     __fmul_rn(4.f, __fmul_rn(s[k], dc_next)));
      dc = __fadd_rn(dc, __fmul_rn(2.f, __fmul_rn(s[k], ds_next)));
    }
    if (k % PE_RESTART == 0)  // exact level: s = sin(2^k x), c = cos(2^k x)
      dx = __fadd_rn(dx, __fmul_rn((float)(1 << k), __fsub_rn(__fmul_rn(co[k], ds), __fmul_rn(s[k], dc))));
    ds_next = ds;
    dc_next = dc;
  }
  return dx;
}

template <typename T>
constexpr int bwd_blocks_per_sm() {
  return sizeof(T) == 2 ? 2 : 1;
}


// Backpropagate the tile from the cast head cotangents darg [P][3]
// (da_rgb) and gsig [P] (dL/dsigma), both written and synchronised by the
// caller, through the direction branch, xyz_encoding_final, the sigma head
// and trunk layers 8 down to 1.  Adds dW/db of every block but wdx.  Uses
// t.act and ``extra`` (another [P][Ld::A] tile) for the deltas.  The
// caller's Hooks see:
//   dir_delta(e, v)    element e = p * HALF + k of the cast direction delta
//   dir_done(da_d)     the whole cast direction delta [P][Ld::A], synced
//   trunk_delta(l, d)  the cast delta of trunk layer l, before its products
template <typename T, typename Abl = Exact, typename Hooks, int P>
__device__ void mlp_backward_tile(const Tile<T, P>& t, T* extra, const float* darg, const float* gsig,
                                  const T* __restrict__ W, const T* kept, const float* dpre,
                                  float* dW, float* dB, bool new_act, const Hooks& hooks) {
  using G = Grp<P>;
  constexpr int LA = Ld<T>::A, LX = Ld<T>::X;
  constexpr bool DB = !Abl::NO_DB, DW = !Abl::NO_DW;
  const int tid = G::tid();
  const auto kept_layer = [&](int i) { return kept + (size_t)(i - 1) * P * LA; };  // h_i, f = 9
  // rgb head and direction layer: da_d = cast(wrgb^T da_rgb * act'(a_d))
  for (int e = tid; e < P * HALF; e += G::THREADS) {
    const int p = e / HALF, k = e % HALF;
    float dd = __fmul_rn(to_f(W[WRGB + k]), darg[p * 3]);
    dd = fmaf(to_f(W[WRGB + HALF + k]), darg[p * 3 + 1], dd);
    dd = fmaf(to_f(W[WRGB + 2 * HALF + k]), darg[p * 3 + 2], dd);
    const float a = dpre[e];
    const float slope = new_act ? sigmoid(__fsub_rn(a, 1.f)) : (a > 0.f ? 1.f : 0.f);
    const T v = to_cd<T>(__fmul_rn(dd, slope));
    extra[p * LA + k] = v;
    hooks.dir_delta(e, v);
  }
  if constexpr (DW)
    for (int e = tid; e < 3 * HALF; e += G::THREADS) {  // dwrgb = da_rgb^T d_act
      const int ch = e / HALF, k = e % HALF;
      float sum = 0.f;
      for (int p = 0; p < P; ++p) sum = fmaf(darg[p * 3 + ch], to_f(t.act[p * LA + k]), sum);
      atomicAdd(dW + WRGB + e, sum);
    }
  if (DB && (tid < 3 || tid == 32)) {  // dbrgb, dbsig
    float sum = 0.f;
    for (int p = 0; p < P; ++p) sum = __fadd_rn(sum, tid < 3 ? darg[p * 3 + tid] : gsig[p]);
    atomicAdd(dB + (tid < 3 ? BRGB + tid : BSIG), sum);
  }
  G::sync();  // da_d is whole; d_act in t.act has been read
  hooks.dir_done(extra);

  const T* h8 = kept_layer(8);
  if constexpr (DB) bias_grad<T, HALF, P>(extra, dB + BD);
  if constexpr (DW) wgrad<T, HALF, WIDTH>(t, extra, kept_layer(9), LA, dW + WDH);
  dgrad<T, HALF>(t, extra, W + WDH, EpiNone(), t.act);  // df
  if constexpr (DB) bias_grad<T, WIDTH, P>(t.act, dB + BFIN);
  if constexpr (DW) wgrad<T, WIDTH, WIDTH>(t, t.act, h8, LA, dW + WFIN);
  if constexpr (DW)
    for (int k = tid; k < WIDTH; k += G::THREADS) {  // dwsig = g_sig^T h8
      float sum = 0.f;
      for (int p = 0; p < P; ++p) sum = fmaf(gsig[p], to_f(h8[p * LA + k]), sum);
      atomicAdd(dW + WSIG + k, sum);
    }
  dgrad<T, WIDTH>(t, t.act, W + WFIN, EpiSigmaMask<T, !Abl::NO_MASK>{h8, gsig, W + WSIG}, extra);  // da8

  // the trunk, layers 8 down to 1: the delta of layer l is in ``cur``
  constexpr int WOFF[9] = {0, W1, W2, W3, W4, W5H, W6, W7, W8};
  constexpr int BOFF[9] = {0, B1, B2, B3, B4, B5, B6, B7, B8};
  T* cur = extra;
  T* other = t.act;
  for (int l = 8; l >= 1; --l) {
    if constexpr (DB) bias_grad<T, WIDTH, P>(cur, dB + BOFF[l]);
    hooks.trunk_delta(l, cur);
    if (DW && l == 5) wgrad<T, WIDTH, XYZ_PAD>(t, cur, t.xpe, LX, dW + W5X);
    if (l == 1) {
      if constexpr (DW) wgrad<T, WIDTH, XYZ_PAD>(t, cur, t.xpe, LX, dW + W1);
      break;
    }
    if constexpr (DW) wgrad<T, WIDTH, WIDTH>(t, cur, kept_layer(l - 1), LA, dW + WOFF[l]);
    if constexpr (Abl::NO_MASK)
      dgrad<T, WIDTH>(t, cur, W + WOFF[l], EpiNone(), other);
    else
      dgrad<T, WIDTH>(t, cur, W + WOFF[l], EpiMask<T>{kept_layer(l - 1)}, other);
    T* const swap = cur;
    cur = other;
    other = swap;
  }
  G::sync();  // every reader of xpe, the deltas and the kept layers is done
}

}  // namespace nerf
