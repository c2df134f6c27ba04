// The backward of the NeRF MLP in full float32 on Hopper's CUDA cores: one
// body for the float32 K3-bwd (the training render's backward) and the
// float32 K4-bwd (the per-point MLP's backward), both in f32_train_sm90.cu.
//
// Replaces, in float32, mlp_backward.cuh's mlp_backward_tile<float> (FMA
// loops on 64-point tiles, weights by scalar __ldg, one scalar atomic per dW
// element per tile), which the bf16 K4-bwd and the experiment kernels keep.
// The TPU kernels it stands for are
// sinnerf_tpu/ops/fused_render_train_t.py::_train_bwd_kernel (:164, through
// _frlt_bwd :509) and sinnerf_tpu/ops/fused_mlp_t.py::_bwd_kernel_t (:298,
// through _backward_t :436).  The functions, inputs, outputs and cast points
// are those of fused_render_train.cu and fused_mlp.cu (see their notes); in
// float32 every cast is the identity.
//
// Bound: operations, at the 67 TFLOP/s f32 peak: per point 593,408
// multiply-adds of recompute, 556,544 of dgrad and 589,312 of wgrad (K3), and
// K4's 3 x 593,408 with its input gradient.  FFMA only, no TF32.
//
// A CTA is mlp_f32_sm90.cuh's: two consumer warpgroups (eight warps, 240
// registers a thread after setmaxnreg) and one producer thread in a third
// warpgroup (24 registers: the 168 of the launch less what the consumers
// take, 128 x 144 = 256 x 72; any more and their setmaxnreg.inc waits
// forever), a tile of RAYS = 128 points (K3: one sample of
// 128 rays; K4: 128 consecutive points); persistent CTAs walk the tiles.  Per
// tile (per sample in K3):
//   1. Recompute with mlp_f32_sm90.cuh's mlp_trunk and dir_product, the
//      forward's own body (K1 f32 and K3-fwd f32, render_f32_sm90.cuh), so
//      that sigma's gate and every ReLU round as in the forward.  KeepBwd
//      takes each trunk layer's output from the epilogue's registers to the
//      CTA's global scratch, and each ReLU's mask (one bit per value, 16 bytes
//      a thread and layer).
//   2. The heads: dL/dsigma and da_rgb per point; the direction delta da_d
//      straight from the direction layer's accumulators, still in registers,
//      and dW_rgb from them; K3 sums da_d per ray in global scratch
//      (SumDirDelta's role) for one product with the direction PE per ray
//      tile.
//   3. Per layer, from the direction layer down to layer 1, with the delta D
//      (O x 128, float32) in shared memory, K-major [o][point]:
//        wgrad  dW[o][k] += sum_p D[o][p] A[p][k] over the tile's 128 points,
//               the layer input A streamed back from scratch through the
//               weight ring; thread tile 8 outputs x 16 inputs, two passes
//               over a 256 x 256 block (its 65,536 sums are twice the
//               consumers' 32,768 accumulators);
//        flush  each sum leaves the CTA once per tile as a lane of a
//               red.global.add.v4.f32 (mlp_backward.cuh: one scalar atomic per
//               64 points): 16,384 vector reductions per trunk layer and tile;
//        dgrad  next[p][k] = sum_o D[o][p] W[o][k]: the forward's product with
//               the roles of the rows swapped, D the K-major operand and the
//               weights streamed as slabs of 16 *output* rows x every input,
//               the packed row-major blocks cut by rows
//               (ops/sm90_layout.py F32_DGRAD_SLABS): the 128 x 256 result
//               fills the consumers' 128 accumulators, as a forward layer's;
//        epilogue  the ReLU mask (its bits from scratch), sigma's term at
//               layer 8, written in place over D after a barrier, once wgrad
//               and dgrad have read it; bias sums in f32.
//   4. K4: the direction-PE block's dW per point, the input gradients
//      dxpe = W1^T da1 + W5x^T da5 (the dgrad product at 64 columns) and
//      ddpe = Wdx^T da_d, then pe_adjoint per (point, channel).
//
// Shared memory (BwdSmem; a CTA may take 232,448 bytes):
//   activations, then the delta tile D   256 x 128 x 4          131,072
//   PE tile (sample PE, then direction PE) 64 x 128 x 4          32,768
//   ring of 3 stages                      3 x 16,384             49,152
//   rays, head partials, g_sigma, da_rgb, K3's transmittance per
//   ray, 6 mbarriers                                              9,792
//   total                                                       222,784
// A second 128 KB tile does not fit beside D, the PE tile and the ring, so
// the layer inputs A of wgrad come back from global scratch, where the
// recompute wrote them from registers, point-major in two 128-wide halves
// ([half][point][128]), so that a 16 KB ring stage holds 32 points x 128
// inputs and a warp's float4 loads of 32 consecutive inputs are one
// wavefront.  (The forward's [k][point] tile moved by a bulk store would put
// the inputs a warp reads in 16 different rows: bank conflicts.)  The other
// way, 64-point tiles, halves each weight slab's reuse and doubles the flush.
// The masks need no A at all: one 128-bit load per thread and layer.
// Per tile the ring carries 154 forward slabs (2.4 MB), 136 dgrad slabs
// (2.2 MB; K4 32 more of 4 KB) and 76 slabs of A (1.2 MB).  The kept tiles
// are 9 x 128 KB per CTA, 156 MB over 132 CTAs, beyond the 50 MB L2: the
// round trip is timed apart by the ABL_SCRATCH instantiation.
//
// Register tiles (consumer thread t, warp w = t / 32, lane l, q = l / 8,
// og = l % 8):
//   dgrad  Map's 8 points x 16 outputs: per D row two float4 of points (one
//          wavefront: the warp's 4 point groups) and four of weights (128
//          contiguous bytes), 128 FFMA: 21.3 FFMA per LDS.128;
//   wgrad  outputs o = 32 (w mod 4 or w) + 4 i + q (i < 8), inputs
//          4 og + 32 j + e (j < 4) of a 128-wide half: per 4 points 8 float4
//          of D (rows of 4 consecutive o, one wavefront) and 16 of A (one
//          wavefront each, the q groups broadcast), 512 FFMA: 21.3 per
//          LDS.128.
// D's point chunks are xor-swizzled by the row's low three bits (d_sw), so
// that both hold and the epilogue's float4 stores take the least, four
// wavefronts per 512 bytes (tests/test_torch_f32_bwd_sm90.py mirrors them).
//
// Nondeterminism: the dW/db sums of the tiles meet in global memory by
// atomics in an order that changes from run to run, so the gradient's last
// bits do.
// Tested as the port's other kernels are: the CPU tests run the plain
// versions and pin the slab sets, the scratch layout and the lane maps
// (tests/test_torch_f32_bwd_sm90.py); on the card, python3 chip_smoke.py
// builds, checks and times them.
#pragma once

#include "render_f32_sm90.cuh"
#include "train_backward.cuh"

namespace nerf {
namespace f32b {

using namespace f32s;
using f32s::fresh;

// Timing ablations (the kernels' ABLATE; 0, the one instantiation the
// training path launches, computes the gradient): each removes one part and
// nothing else.  The gradient is then wrong.
enum Ablate {
  ABL_FLUSH = 1,    // the weight gradients' vector reductions into dW
  ABL_SCRATCH = 2,  // the kept tiles' round trip: no stores, A from one 64 KB region
};

constexpr int A_PTS = 32;                       // points of one A slab of a 128-wide half
constexpr int HALF_FLOATS = RAYS * HALF;        // one half of a kept tile, [point][128]
constexpr int KEPT_FLOATS = 2 * HALF_FLOATS;    // one kept tile
constexpr int N_BWD_SLABS_K3 = 212;             // per tile: A 76, dgrad 136
constexpr int N_BWD_SLABS_K4 = N_BWD_SLABS_K3 + 32;  // and the input gradient's 32

// Global scratch of one CTA (bytes; ops/sm90_layout.py F32_BWD_SCRATCH).
struct Scratch {
  static constexpr int KEPT = 0;                                // h1..h8, f
  static constexpr int XPE = KEPT + N_KEPT * KEPT_FLOATS * 4;  // the sample PE [point][64]
  static constexpr int MASKS = XPE + RAYS * XYZ_PAD * 4;       // [8][CONSUMERS] uint4
  static constexpr int EXTRA = MASKS + 8 * CONSUMERS * 16;     // K3: da_d per ray; K4: dxpe, ddpe
  static constexpr int BYTES = EXTRA + RAYS * HALF * 4;
};
static_assert(Scratch::BYTES == 1310720 && RAYS * (XYZ_PAD + DIR_PAD) * 4 <= RAYS * HALF * 4, "f32 bwd scratch");

// Shared memory (ops/sm90_layout.py F32_BWD_SMEM): mlp_f32_sm90.cuh's regions,
// the per-point head cotangents and K3's transmittance per ray.
struct BwdSmem {
  static constexpr int ACT = 0, PE = Smem::PE, RING = Smem::RING, RAYS_F = Smem::RAYS_F, SIGP = Smem::SIGP,
                       RGBP = Smem::RGBP;
  static constexpr int GSIG = Smem::BARS, DARG = GSIG + RAYS * 4, TRANS = DARG + RAYS * 3 * 4;
  static constexpr int BARS = TRANS + RAYS * 4;
  static constexpr int BYTES = BARS + 64;
};
static_assert(BwdSmem::BYTES == 222784 && BwdSmem::BYTES <= 232448, "f32 bwd shared memory");

// Point p of the delta tile's row o lies at o * RAYS + (p ^ d_sw(o)): the
// row's four-point chunks xor-swizzled by its low three bits.
__device__ __forceinline__ int d_sw(int o) { return (o & 7) << 2; }

// A copy of the thread map that the compiler cannot prove equal to ``m``
// (mlp_f32_sm90.cuh's fresh): the addresses computed from it are computed
// where they are used, not held in registers across the tile, sample and
// layer loops.
__device__ __forceinline__ Map fresh(const Map& m) {
  Map f = m;
  asm volatile("" : "+r"(f.lane), "+r"(f.wc), "+r"(f.og), "+r"(f.p0));
  return f;
}

// Packed-weight offsets of trunk layer l = 2..8's block (w5h for 5) and bias.
__host__ __device__ constexpr int trunk_w(int l) {
  return l <= 5 ? W2 + (l - 2) * WIDTH * WIDTH : W6 + (l - 6) * WIDTH * WIDTH;
}
__device__ __forceinline__ int trunk_b(int l) { return B1 + (l - 1) * WIDTH; }

// ------------------------------------------------------------------ recompute
// What the recompute keeps of trunk layer l (h1..h8, f = 9): the thread's
// 8 points x 16 outputs, point-major by 128-wide halves, and (h1..h8) the
// ReLU mask, bit 16 (pi % 2) + oi of word pi / 2.
template <bool TILES>
struct KeepBwd {
  static constexpr bool FRESH = true;
  float* kept;
  uint4* masks;
  __device__ void layer(int l, const Map& map, const float (&acc)[8][16]) const {
    const Map m = fresh(map);
    if (TILES) {
      float* dst = kept + (size_t)(l - 1) * KEPT_FLOATS + m.wc * HALF_FLOATS + 4 * m.og;
#pragma unroll
      for (int pi = 0; pi < 8; ++pi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float4*>(dst + m.point(pi) * HALF + 32 * j) =
              make_float4(acc[pi][4 * j], acc[pi][4 * j + 1], acc[pi][4 * j + 2], acc[pi][4 * j + 3]);
    }
    if (l <= 8) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int pi = 0; pi < 8; ++pi)
#pragma unroll
        for (int oi = 0; oi < 16; ++oi)
          if (acc[pi][oi] > 0.f) w[pi >> 1] |= 1u << ((pi & 1) * 16 + oi);
      masks[(l - 1) * CONSUMERS + fresh_tid()] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    sm90::fence_proxy_async_global();  // the producer's bulk copies read the tiles back
  }
};

// The sample PE of the tile (pe, [k][point]) to scratch as [point][64], the
// A of the wgrads of w1 and w5x.  The caller has synchronised pe.
__device__ __forceinline__ void store_xpe(const float* pe, float* xpe) {
  const int t = fresh_tid(), p = t & (RAYS - 1), k0 = 32 * (t >> 7);
#pragma unroll
  for (int k = 0; k < 32; k += 4)
    *reinterpret_cast<float4*>(xpe + p * XYZ_PAD + k0 + k) =
        make_float4(pe[at(k0 + k, p)], pe[at(k0 + k + 1, p)], pe[at(k0 + k + 2, p)], pe[at(k0 + k + 3, p)]);
  sm90::fence_proxy_async_global();
}

// ------------------------------------------------------------------ producer
// The slabs of one tile's backward, in the order the consumers take them:
// per layer the A slabs of its wgrad (from the CTA's scratch), then (K4,
// layers 5 and 1) the input gradient's 4 KB slabs, then its dgrad slabs
// (rows of the packed weights).  A table built at compile time, so that the
// producer thread only walks it.
constexpr int SRC_KEPT = 0, SRC_WEIGHTS = 1;
struct SlabTable {
  int off[N_BWD_SLABS_K4];    // bytes from the scratch's or the packed weights' start
  int bytes[N_BWD_SLABS_K4];
  int src[N_BWD_SLABS_K4];    // SRC_KEPT or SRC_WEIGHTS
};

__host__ __device__ constexpr SlabTable bwd_table(bool k4) {
  SlabTable t{};
  int i = 0;
  const auto add = [&](int src, int off, int bytes) {
    t.src[i] = src;
    t.off[i] = off;
    t.bytes[i] = bytes;
    ++i;
  };
  const auto a_slab = [&](int tile, int h, int c) {
    add(SRC_KEPT, (tile * KEPT_FLOATS + h * HALF_FLOATS) * 4 + c * STAGE_BYTES, STAGE_BYTES);
  };
  const auto rows = [&](int off, int n_rows, int cols) {
    for (int r = 0; r < n_rows / KS; ++r) add(SRC_WEIGHTS, (off + r * KS * cols) * 4, KS * cols * 4);
  };
  for (int c = 0; c < 4; ++c)
    for (int h = 0; h < 2; ++h) a_slab(8, h, c);  // f, both halves per point chunk
  rows(WDH, HALF, WIDTH);
  for (int h = 0; h < 2; ++h)
    for (int c = 0; c < 4; ++c) a_slab(7, h, c);  // h8
  rows(WFIN, WIDTH, WIDTH);
  for (int l = 8; l >= 1; --l) {
    if (l > 1)
      for (int h = 0; h < 2; ++h)
        for (int c = 0; c < 4; ++c) a_slab(l - 2, h, c);  // h_{l-1}
    if (l == 5 || l == 1)
      for (int c = 0; c < 2; ++c) add(SRC_KEPT, Scratch::XPE + c * STAGE_BYTES, STAGE_BYTES);
    if (k4 && (l == 5 || l == 1)) rows(l == 5 ? W5X : W1, WIDTH, XYZ_PAD);
    if (l > 1) rows(trunk_w(l), WIDTH, WIDTH);
  }
  return t;
}

__host__ __device__ constexpr int table_len(const SlabTable& t) {
  int n = 0;
  while (n < N_BWD_SLABS_K4 && t.bytes[n] != 0) ++n;
  return n;
}
static_assert(table_len(bwd_table(false)) == N_BWD_SLABS_K3 && table_len(bwd_table(true)) == N_BWD_SLABS_K4,
              "backward slab counts must match ops/sm90_layout.py f32_bwd_slabs");

__constant__ SlabTable BWD_TABLES[2] = {bwd_table(false), bwd_table(true)};  // K3, K4

// The producer's walk of one tile's backward slabs.  ABL_SCRATCH reads every
// A slab from the scratch's first 64 KB instead.
template <bool K4, int ABLATE>
__device__ __forceinline__ void produce_bwd(const unsigned char* kept, const unsigned char* w, unsigned char* stages,
                                            uint64_t* full, uint64_t* empty, uint32_t& it) {
  constexpr int N = K4 ? N_BWD_SLABS_K4 : N_BWD_SLABS_K3;
#pragma unroll 1
  for (int i = 0; i < N; ++i, ++it) {
    const int s = it % STAGES;
    const int bytes = BWD_TABLES[K4].bytes[i], off = BWD_TABLES[K4].off[i];
    const unsigned char* src = BWD_TABLES[K4].src[i] == SRC_KEPT
                                   ? kept + (ABLATE & ABL_SCRATCH ? off % (4 * STAGE_BYTES) : off)
                                   : w + off;
    sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&full[s], bytes);
    sm90::bulk_load(stages + s * STAGE_BYTES, src, bytes, &full[s]);
  }
}

// ------------------------------------------------------------------ products
// acc[i][t] += sum over the slabs' points of D[o_i][p] A[p][k_t], o_i = ob +
// 4 i + q, k_t = 4 og + 32 (t / 4) + t % 4 of a slab row of ``ld`` floats.
// The warp uses slab j when j % every == mine; slab j holds the points
// [(j / every) pts, + pts).  Every warp waits for and releases every slab.
template <int TK>
__device__ __forceinline__ void wgrad_slabs(float (&acc)[8][TK], Ring& ring, const Map& map, const float* D, int ob,
                                            int n_slabs, int every, int mine, int pts, int ld) {
  const Map m = fresh(map);
  const int q = m.lane >> 3;
  for (int j = 0; j < n_slabs; ++j) {
    const float* a = ring.wait() + 4 * m.og;
    if (j % every == mine) {
      const int p0 = (j / every) * pts;
#pragma unroll 1
      for (int pp = 0; pp < pts; pp += 4) {
        float4 dv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // rows ob + 4 i + q: (row & 7) = 4 (i & 1) + q
          const int o = ob + 4 * i + q;
          dv[i] = *reinterpret_cast<const float4*>(D + o * RAYS + ((p0 + pp) ^ d_sw(4 * (i & 1) + q)));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float av[TK];
#pragma unroll
          for (int t = 0; t < TK / 4; ++t) {
            const float4 x = *reinterpret_cast<const float4*>(a + (pp + e) * ld + 32 * t);
            av[4 * t] = x.x;
            av[4 * t + 1] = x.y;
            av[4 * t + 2] = x.z;
            av[4 * t + 3] = x.w;
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float d = e == 0 ? dv[i].x : e == 1 ? dv[i].y : e == 2 ? dv[i].z : dv[i].w;
#pragma unroll
            for (int t = 0; t < TK; ++t) acc[i][t] = fmaf(d, av[t], acc[i][t]);
          }
        }
      }
    }
    ring.release(m);
  }
}

// The thread's wgrad sums into dW (row stride ld, inputs from k0) as vector
// reductions: four neighbouring inputs of one output each.
template <int TK>
__device__ __forceinline__ void flush(const float (&acc)[8][TK], const Map& map, float* dW, int ob, int ld, int k0) {
  const Map m = fresh(map);
  const int q = m.lane >> 3;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int t = 0; t < TK / 4; ++t)
      sm90::red_add_v4(dW + (size_t)(ob + 4 * i + q) * ld + k0 + 4 * m.og + 32 * t, acc[i][4 * t], acc[i][4 * t + 1],
                       acc[i][4 * t + 2], acc[i][4 * t + 3]);
}

// acc (Map's 8 points x O / 16 outputs) = sum over the n slabs' 16 rows each
// of D[o][p] W[o][k]: mlp_f32_sm90.cuh's product with D (swizzled by d_sw)
// as the K-major operand and the ring's [16][O] row slabs.
template <int O>
__device__ __forceinline__ void dgrad_product(float (&acc)[8][O / 16], Ring& ring, const Map& map, const float* D,
                                              int n) {
  constexpr int NJ = O / 64;
  const Map m = fresh(map);
  zero(acc);
  const int ob = (O / 2) * m.wc + 4 * m.og;
  for (int j = 0; j < n; ++j) {
    const float* w = ring.wait() + ob;
    const float* d = D + j * KS * RAYS;
#pragma unroll 1
    for (int k4 = 0; k4 < KS; k4 += 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int sw = d_sw((k4 & 4) + kk);  // rows 16 j + k4 + kk
        const float4 x0 = *reinterpret_cast<const float4*>(d + (k4 + kk) * RAYS + (m.p0 ^ sw));
        const float4 x1 = *reinterpret_cast<const float4*>(d + (k4 + kk) * RAYS + ((m.p0 + 16) ^ sw));
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        float wv[4 * NJ];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float4 t = *reinterpret_cast<const float4*>(w + (k4 + kk) * O + 32 * jj);
          wv[4 * jj] = t.x;
          wv[4 * jj + 1] = t.y;
          wv[4 * jj + 2] = t.z;
          wv[4 * jj + 3] = t.w;
        }
#pragma unroll
        for (int pi = 0; pi < 8; ++pi)
#pragma unroll
          for (int oi = 0; oi < 4 * NJ; ++oi) acc[pi][oi] = fmaf(x[pi], wv[oi], acc[pi][oi]);
      }
    }
    ring.release(m);
  }
}

// The dgrad result as the next delta, in place over D (every reader of D has
// passed a barrier): the mask of the layer input's ReLU (``mask``: its bits,
// when ``masked``) and at layer 8 sigma's term g_sig[p] wsig[k] before it.
__device__ __forceinline__ void store_delta(const float (&acc)[8][16], const Map& map, float* D, bool masked,
                                            uint4 mask, const float* gsig, const float* __restrict__ wsig) {
  const Map m = fresh(map);
  const uint32_t mw[4] = {mask.x, mask.y, mask.z, mask.w};
#pragma unroll
  for (int oi = 0; oi < 16; ++oi) {
    const int k = m.out<WIDTH>(oi);
    const float ws = wsig ? __ldg(wsig + k) : 0.f;
    float v[8];
#pragma unroll
    for (int pi = 0; pi < 8; ++pi) {
      v[pi] = acc[pi][oi];
      if (wsig) v[pi] = __fadd_rn(v[pi], __fmul_rn(gsig[m.point(pi)], ws));
      if (masked && !((mw[pi >> 1] >> ((pi & 1) * 16 + oi)) & 1u)) v[pi] = 0.f;
    }
    float* row = D + k * RAYS;
    *reinterpret_cast<float4*>(row + (m.p0 ^ d_sw(k))) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(row + ((m.p0 + 16) ^ d_sw(k))) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// db[o] += sum over the tile's points of D[o][p], o < O, in f32.
__device__ __forceinline__ void bias_sum(const float* D, int O, float* db) {
  const int o = fresh_tid();
  if (o >= O) return;
  const float* row = D + o * RAYS;
  float s = 0.f;
#pragma unroll 4
  for (int c = 0; c < RAYS; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(row + (c ^ d_sw(o)));
    s = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(s, x.x), x.y), x.z), x.w);
  }
  atomicAdd(db + o, s);
}

// ------------------------------------------------------------------ the heads
// From the direction layer's accumulators (Map's 8 points x 8 outputs) and
// the cast head cotangents da_rgb (darg [point][3], synchronised): the
// direction delta da_d = cast(wrgb^T da_rgb * act'(a_d)) into D's rows
// 0..127, dW_rgb += da_rgb^T d over the tile's points, and with ``dad`` (K3)
// the per-ray f32 sum of da_d (``first``: the ray tile's first sample).
__device__ __forceinline__ void dir_delta(const float (&acc)[8][8], const Map& map, const float* __restrict__ B,
                                          const float* __restrict__ wrgb, bool new_act, const float* darg, float* D,
                                          float* dW, float* dad, bool first) {
  const Map m = fresh(map);
  float g[8][3];
#pragma unroll
  for (int pi = 0; pi < 8; ++pi)
#pragma unroll
    for (int c = 0; c < 3; ++c) g[pi][c] = darg[m.point(pi) * 3 + c];
  float v[8][8], dw[8][3];
#pragma unroll
  for (int oi = 0; oi < 8; ++oi) {
    const int o = m.out<HALF>(oi);
    const float b = __ldg(B + BD + o);
    const float w0 = __ldg(wrgb + o), w1 = __ldg(wrgb + HALF + o), w2 = __ldg(wrgb + 2 * HALF + o);
    dw[oi][0] = dw[oi][1] = dw[oi][2] = 0.f;
#pragma unroll
    for (int pi = 0; pi < 8; ++pi) {
      const float a = __fadd_rn(acc[pi][oi], b);
      const float d = epilogue(a, new_act ? ACT_SSP : ACT_RELU);
      const float slope = new_act ? sigmoid(__fsub_rn(a, 1.f)) : (a > 0.f ? 1.f : 0.f);
      float dd = __fmul_rn(w0, g[pi][0]);
      dd = fmaf(w1, g[pi][1], dd);
      dd = fmaf(w2, g[pi][2], dd);
      v[pi][oi] = __fmul_rn(dd, slope);
#pragma unroll
      for (int c = 0; c < 3; ++c) dw[oi][c] = fmaf(g[pi][c], d, dw[oi][c]);
    }
    float* row = D + o * RAYS;
    *reinterpret_cast<float4*>(row + (m.p0 ^ d_sw(o))) = make_float4(v[0][oi], v[1][oi], v[2][oi], v[3][oi]);
    *reinterpret_cast<float4*>(row + ((m.p0 + 16) ^ d_sw(o))) = make_float4(v[4][oi], v[5][oi], v[6][oi], v[7][oi]);
  }
  if (dad != nullptr)  // K3: the thread's points and outputs are the same every sample
#pragma unroll
    for (int pi = 0; pi < 8; ++pi)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float4* at_d = reinterpret_cast<float4*>(dad + m.point(pi) * HALF + m.out<HALF>(4 * j));
        float4 x = make_float4(v[pi][4 * j], v[pi][4 * j + 1], v[pi][4 * j + 2], v[pi][4 * j + 3]);
        if (!first) {
          const float4 y = *at_d;
          x = make_float4(__fadd_rn(y.x, x.x), __fadd_rn(y.y, x.y), __fadd_rn(y.z, x.z), __fadd_rn(y.w, x.w));
        }
        *at_d = x;
      }
  // dW_rgb: over the warp's four point groups by xor shuffles, then one
  // vector reduction per channel and four outputs from point group 0
#pragma unroll
  for (int oi = 0; oi < 8; ++oi)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dw[oi][c] = __fadd_rn(dw[oi][c], __shfl_xor_sync(0xffffffffu, dw[oi][c], 8));
      dw[oi][c] = __fadd_rn(dw[oi][c], __shfl_xor_sync(0xffffffffu, dw[oi][c], 16));
    }
  if ((m.lane >> 3) == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        sm90::red_add_v4(dW + WRGB + c * HALF + m.out<HALF>(4 * j), dw[4 * j][c], dw[4 * j + 1][c], dw[4 * j + 2][c],
                         dw[4 * j + 3][c]);
}

// dbrgb and dbsig: sums over the tile's points of da_rgb and g_sig.
__device__ __forceinline__ void head_bias_sums(const float* darg, const float* gsig, float* dB) {
  const int t = threadIdx.x;
  if (t < 3 || t == 32) {
    float s = 0.f;
    for (int p = 0; p < RAYS; ++p) s = __fadd_rn(s, t < 3 ? darg[p * 3 + t] : gsig[p]);
    atomicAdd(dB + (t < 3 ? BRGB + t : BSIG), s);
  }
}

// dW_dx[o][c] += sum_p da_d[o][p] dpe[c][p], o < 128, c < 32: ``dd(o, p)``
// gives the delta (K4: D per point; K3: the per-ray sum), the direction PE
// lies in pe's rows 0..31.
template <typename F>
__device__ __forceinline__ void dir_pe_wgrad(const F& dd, const float* pe, float* dW) {
  const int t = fresh_tid(), o = t & (HALF - 1), c0 = 16 * (t >> 7);
  float s[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) s[c] = 0.f;
#pragma unroll 1
  for (int p = 0; p < RAYS; p += 4) {
    const float d[4] = {dd(o, p), dd(o, p + 1), dd(o, p + 2), dd(o, p + 3)};
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(pe + at(c0 + c, p));
      s[c] = fmaf(d[0], x.x, s[c]);
      s[c] = fmaf(d[1], x.y, s[c]);
      s[c] = fmaf(d[2], x.z, s[c]);
      s[c] = fmaf(d[3], x.w, s[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 16; c += 4)
    sm90::red_add_v4(dW + WDX + o * DIR_PAD + c0 + c, s[c], s[c + 1], s[c + 2], s[c + 3]);
}

// K4: ddpe[p][c] = sum_o da_d[o][p] Wdx[o][c] into scratch [point][32].
__device__ __forceinline__ void dir_input_grad(const float* D, const float* __restrict__ W, float* ddp) {
  const int t = fresh_tid(), p = t & (RAYS - 1), c0 = 16 * (t >> 7);
  float g[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) g[c] = 0.f;
#pragma unroll 2
  for (int o = 0; o < HALF; ++o) {
    const float d = D[o * RAYS + (p ^ d_sw(o))];
#pragma unroll
    for (int c = 0; c < 16; c += 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(W + WDX + o * DIR_PAD + c0 + c));
      g[c] = fmaf(d, w.x, g[c]);
      g[c + 1] = fmaf(d, w.y, g[c + 1]);
      g[c + 2] = fmaf(d, w.z, g[c + 2]);
      g[c + 3] = fmaf(d, w.w, g[c + 3]);
    }
  }
#pragma unroll
  for (int c = 0; c < 16; c += 4)
    *reinterpret_cast<float4*>(ddp + p * DIR_PAD + c0 + c) = make_float4(g[c], g[c + 1], g[c + 2], g[c + 3]);
}

// ------------------------------------------------------------------ layers
// The backward of the tile from the direction delta in D (rows 0..127,
// synchronised) down through layer 1: every block's dW and db but wrgb's,
// wdx's and the heads' biases.  K4 also: wdx's dW per point, ddpe into
// ``ddp`` and dxpe into ``dxp`` ([point][64], scratch).  Consumes the tile's
// backward slabs (produce_bwd).
template <bool K4, int ABLATE>
__device__ __forceinline__ void backward_layers(Ring& ring, const Map& m, float* D, const float* pe,
                                                const float* gsig, const float* kept, const uint4* masks,
                                                const float* __restrict__ W, const float* __restrict__ wsig,
                                                float* dW, float* dB, float* dxp, float* ddp) {
  constexpr bool FLUSH = !(ABLATE & ABL_FLUSH);
  const int tid = fresh_tid(), w = tid >> 5;
  // the direction layer: dwdh = da_d^T f (f's halves by warpgroup), then df = da_d wdh
  bias_sum(D, HALF, dB + BD);
  {
    float acc[8][16];
    zero(acc);
    wgrad_slabs<16>(acc, ring, m, D, 32 * (w & 3), 8, 2, m.wc, A_PTS, HALF);
    if (FLUSH) flush<16>(acc, m, dW + WDH, 32 * (w & 3), WIDTH, HALF * m.wc);
  }
  if constexpr (K4) {
    dir_pe_wgrad([&](int o, int p) { return D[o * RAYS + (p ^ d_sw(o))]; }, pe, dW);
    dir_input_grad(D, W, ddp);
  }
  {
    float acc[8][16];
    dgrad_product<WIDTH>(acc, ring, m, D, HALF / KS);
    consumers_sync();  // every reader of da_d is done
    store_delta(acc, m, D, false, uint4{}, nullptr, nullptr);
  }
  consumers_sync();

  // xyz_encoding_final: dwfin = df^T h8, dwsig = g_sig^T h8, then
  // da8 = mask(h8) (df wfin + g_sig wsig)
  bias_sum(D, WIDTH, dB + BFIN);
  for (int h = 0; h < 2; ++h) {
    float acc[8][16];
    zero(acc);
    wgrad_slabs<16>(acc, ring, m, D, 32 * w, 4, 1, 0, A_PTS, HALF);
    if (FLUSH) flush<16>(acc, m, dW + WFIN, 32 * w, WIDTH, HALF * h);
  }
  {
    const int t = fresh_tid();
    const float* h8 = kept + 7 * KEPT_FLOATS + (t >> 7) * HALF_FLOATS + (t & (HALF - 1));
    float s = 0.f;
#pragma unroll 4
    for (int p = 0; p < RAYS; ++p) s = fmaf(gsig[p], h8[p * HALF], s);
    atomicAdd(dW + WSIG + t, s);
  }
  {
    const uint4 mk = masks[7 * CONSUMERS + tid];
    float acc[8][16];
    dgrad_product<WIDTH>(acc, ring, m, D, WIDTH / KS);
    consumers_sync();
    store_delta(acc, m, D, true, mk, gsig, wsig);
  }
  consumers_sync();

  // the trunk, layers 8 down to 1: the delta of layer l is in D
#pragma unroll 1
  for (int l = 8; l >= 1; --l) {
    bias_sum(D, WIDTH, dB + trunk_b(l));
    if (l > 1)
      for (int h = 0; h < 2; ++h) {
        float acc[8][16];
        zero(acc);
        wgrad_slabs<16>(acc, ring, m, D, 32 * w, 4, 1, 0, A_PTS, HALF);
        if (FLUSH) flush<16>(acc, m, dW + trunk_w(l), 32 * w, WIDTH, HALF * h);
      }
    if (l == 5 || l == 1) {  // the PE block: dw5x or dw1 = da^T x
      float acc[8][8];
      zero(acc);
      wgrad_slabs<8>(acc, ring, m, D, 32 * w, 2, 1, 0, 2 * A_PTS, XYZ_PAD);
      if (FLUSH) flush<8>(acc, m, dW + (l == 5 ? W5X : W1), 32 * w, XYZ_PAD, 0);
      if constexpr (K4) {  // dxpe = W1^T da1 + W5x^T da5, thread-owned in scratch
        float g[8][4];
        dgrad_product<XYZ_PAD>(g, ring, m, D, WIDTH / KS);
        const Map f = fresh(m);
#pragma unroll
        for (int pi = 0; pi < 8; ++pi) {
          float4* at_g = reinterpret_cast<float4*>(dxp + f.point(pi) * XYZ_PAD + f.out<XYZ_PAD>(0));
          float4 v = make_float4(g[pi][0], g[pi][1], g[pi][2], g[pi][3]);
          if (l == 1) {
            const float4 o = *at_g;
            v = make_float4(__fadd_rn(v.x, o.x), __fadd_rn(v.y, o.y), __fadd_rn(v.z, o.z), __fadd_rn(v.w, o.w));
          }
          *at_g = v;
        }
      }
    }
    if (l == 1) break;
    const uint4 mk = masks[(l - 2) * CONSUMERS + tid];  // h_{l-1}
    float acc[8][16];
    dgrad_product<WIDTH>(acc, ring, m, D, WIDTH / KS);
    consumers_sync();
    store_delta(acc, m, D, true, mk, nullptr, nullptr);
    consumers_sync();
  }
}

}  // namespace f32b
}  // namespace nerf
