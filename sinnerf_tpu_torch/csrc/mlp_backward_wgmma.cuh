// K3-bwd bf16 on Hopper: the training render's backward over a ray tile
// (fused_render_train_sm90.cu holds the kernel).  Its products, flush,
// direction delta, heads' gradients and per-tile dwdx are also K4-bwd
// bf16's (fused_mlp_sm90.cu, whose note gives the differences).
//
// Replaces, in bf16, train_backward.cuh's train_bwd_tiles<bf16> with
// mlp_backward.cuh's wmma products (which X2 and the earlier K4-bwd kernels,
// on no path, keep).  The TPU kernel it stands for is
// sinnerf_tpu/ops/fused_render_train_t.py::_train_bwd_kernel (:164, through
// _frlt_bwd :509).  The function, its inputs, outputs and cast points are
// fused_render_train.cu's (see the note there).
//
// Bound: operations, 3.48 MFLOP per point (recompute, dgrad, wgrad).
//
// A CTA (two consumer warpgroups of 64 rays, one producer warpgroup) owns a
// unit: a tile of 128 rays and one of ``chunks`` equal ranges of its samples
// (ops/sm90_layout.py::launch_plan picks chunks from the shape; 1 when the
// tiles fit on the SMs); persistent CTAs walk the units.  Only the
// transmittance and the per-ray direction-delta sum carry from one sample to
// the next: a unit rebuilds its starting transmittance by the same product,
// in the same order, and flushes its own partial sum.  Per unit, stage A
// (the descending suffix sums into dsig_part, from the last sample down to
// the range's first, written for the range) is train_backward.cuh's.  Per
// sample of the range, upwards:
//   1. Recompute with mlp_wgmma.cuh's mlp_pass, the forward's own body, so
//      that sigma's gate and every ReLU round as they did in the forward.
//      Each trunk layer's output tile is copied to the CTA's global scratch
//      (it stays in L2) by bulk stores; the direction PE is recomputed into
//      the delta tile, which is free then.
//   2. The head: dL/dsigma (gated) and da_rgb per ray, cast; the direction
//      delta straight from the direction layer's accumulators, still in
//      registers; its f32 per-ray sum over the unit's samples stays in global
//      scratch (SumDirDelta's role) and meets the direction PE once per unit.
//   3. Per layer, from the direction layer down to layer 1, with the delta
//      D (128 x O, bf16) in shared memory and the layer's input A brought
//      back from scratch by one 64 KB bulk copy:
//        wgrad  dW += D^T A over the tile's 128 points: wgmma with both
//               operands MN-major (the transpose bits), each warpgroup 128
//               output rows, m64n256 (m64n64 for the PE blocks);
//        flush  each thread's accumulators leave as red.global.add.v4.f32,
//               four neighbouring sums per instruction after one shuffle:
//               a dW element is reduced over 128 points before it leaves the
//               CTA (the wmma body: 64 points, one scalar atomic each), so
//               the reductions per point drop eightfold;
//        dgrad  D W over the ring's slabs read again, MN-major: the same
//               swizzled bytes as the forward, no second copy;
//        epilogue  the mask of the cast activation (and sigma's term for
//               layer 8), cast, in place over D once both warpgroups'
//               wgrads have read it; bias sums in f32 from the cast delta.
//
// Shared memory (BwdSmem, ops/sm90_layout.py BWD_SMEM): the activation tile
// (also each layer's input), the delta tile, the sample PE, a 2-stage ring,
// rays, the per-ray head cotangents and the unit's starting transmittance.
// Tested as the port's other kernels are: the CPU tests run their plain
// versions as before (tests/test_torch_k3_sm90.py pins the slab layout); on
// the card, python3 chip_smoke.py builds, checks and times them.
#pragma once

#include "mlp_wgmma.cuh"
#include "train_backward.cuh"

namespace nerf {
namespace k3 {

struct BwdSmem {
  static constexpr int STAGES = 2;
  static constexpr int X = 0, Y = ACT_BYTES, XPE = 2 * ACT_BYTES, RING = XPE + PE_BYTES;
  static constexpr int SMALL = RING + STAGES * STAGE_BYTES;
  static constexpr int RAYS_F = SMALL, GSIG = SMALL + 3072, DARG = GSIG + 512, TRANS = DARG + 1536;
  static constexpr int BARS = SMALL + 6144;
  static constexpr int BYTES = SMALL + SMALL_BYTES + ALIGN;
};

// Global scratch of one CTA: the 9 kept tiles, then the per-ray f32 sum of
// the direction delta [128][HALF].
constexpr size_t BWD_SCRATCH = (size_t)N_KEPT * ACT_BYTES + (size_t)RAYS * HALF * sizeof(float);

// Timing ablations of the backward (train_bwd_sm90's ABLATE; 0, the one
// instantiation the training path launches, computes the gradient): each
// removes one part and nothing else, so that the part's share of the time is
// read, not guessed.  The gradient is then wrong.
enum Ablate {
  ABL_FLUSH = 1,  // the weight gradients' reductions into dW
  ABL_WGRAD = 2,  // the weight-gradient products (and their flush)
  // the kernel experiment X2's (exp_bwd_pipeline_sm90.cu), one part each:
  ABL_DB = 4,         // the bias sums (bias_sum, dbrgb, dbsig)
  ABL_MASK = 8,       // the trunk's ReLU masks (h1..h8) in the dgrad epilogues
  ABL_HEAD_DW = 16,   // the heads' weight gradients dwrgb and dwsig
  ABL_CONST_PE = 32,  // the sample's PE: a constant 0.01 tile (once per tile)
  ABL_CHEAP_PE = 64,  // the sample's PE: bf16(z 0.01) in every column
  // X2's exact restructuring pe_pipe (the gradient is the production one):
  // sample s+1's PE is formed while sample s's last wgrad (W1's) is in
  // flight, into X (free then), and copied into the PE tile when s+1 starts
  PIPE_PE = 128,
};

__device__ __forceinline__ float tile_at(const unsigned char* tile, int r, int c) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + sw_off(r, c)));
}

// The thread's accumulators (a 64 x N tile) added to dst, row-major with row
// stride ``ld`` floats, as 16-byte vector reductions: lanes 2m and 2m + 1
// swap half their pairs, so that each holds four neighbouring columns of one
// row.
template <int N>
__device__ __forceinline__ void flush(const float (&acc)[N / 2], const Lane& ln, float* dst, int ld) {
  const bool odd = ln.q & 1;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * ln.q;
    const float a0 = acc[4 * j], a1 = acc[4 * j + 1], b0 = acc[4 * j + 2], b1 = acc[4 * j + 3];
    const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
    if (!odd) sm90::red_add_v4(dst + (size_t)ln.r0 * ld + c, a0, a1, r0, r1);
    else sm90::red_add_v4(dst + (size_t)(ln.r0 + 8) * ld + c - 2, r0, r1, b0, b1);
  }
}

// acc = D[:, 64 ch .. 64 ch + 63]^T A over the tile's 128 points: D and A are
// swizzled tiles read MN-major, A's N columns in 64-wide blocks.
template <int N>
__device__ __forceinline__ void wgrad_product(float (&acc)[N / 2], const unsigned char* D, int ch,
                                              const unsigned char* A) {
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int t = 0; t < RAYS / 16; ++t) {
    const uint64_t da = sm90::desc_sw128(D + ch * ACT_BLOCK + t * 16 * ROW_BYTES, ACT_BLOCK, 1024);
    const uint64_t db = sm90::desc_sw128(A + t * 16 * ROW_BYTES, ACT_BLOCK, 1024);
    if constexpr (N == 256) sm90::mma_m64n256<1, 1>(acc, da, db, t > 0);
    else sm90::mma_m64n64<1, 1>(acc, da, db, t > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
}

// dW rows [64 ch, 64 ch + 64) of a block with ``kin`` input columns.
template <int N>
__device__ __forceinline__ void wgrad(const Lane& ln, const unsigned char* D, int ch, const unsigned char* A,
                                      float* dW, int kin, bool do_flush) {
  float acc[N / 2];
  wgrad_product<N>(acc, D, ch, A);
  if (do_flush) flush<N>(acc, ln, dW + (size_t)ch * 64 * kin, kin);
}

// acc[j] = D(the warpgroup's rows) W_j for the NS slabs j of a block in
// the ring (four, or one), each 64 output columns; the reduction runs over
// KS * 16 rows of D (its columns).
template <int KS, int NS = 4>
__device__ __forceinline__ void dgrad(float (&acc)[NS][32], Ring& ring, const Lane& ln, const unsigned char* D) {
  const unsigned char* d = D + ln.g * WG_ROWS * ROW_BYTES;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const unsigned char* w = ring.wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;  // the old values are dead: no live range across wgrad
    sm90::fence_regs(acc[j]);
    sm90::wgmma_fence();
#pragma unroll
    for (int t = 0; t < KS; ++t)
      sm90::mma_m64n64<0, 1>(acc[j], sm90::desc_sw128(d + (t >> 2) * ACT_BLOCK + (t & 3) * 32, 0, 1024),
                             sm90::desc_sw128(w + t * 16 * ROW_BYTES, 0, 1024), t > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc[j]);
    ring.release(ln);
  }
}

// The warpgroup's rows of D = cast(epi(row, column, acc)).
template <typename Epi>
__device__ __forceinline__ void dgrad_store(const float (&acc)[4][32], const Lane& ln, unsigned char* D,
                                            const Epi& epi) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ln.row(i), c = 64 * j + 8 * jj + 2 * ln.q;
        const float v0 = epi(r, c, acc[j][4 * jj + 2 * i]), v1 = epi(r, c + 1, acc[j][4 * jj + 2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(D + sw_off(r, c)) = __floats2bfloat162_rn(v0, v1);
      }
}

struct EpiPass {
  __device__ float operator()(int, int, float v) const { return v; }
};
struct EpiMaskTile {  // the ReLU mask of the cast activation h (a swizzled tile)
  const unsigned char* h;
  __device__ float operator()(int r, int c, float v) const { return tile_at(h, r, c) > 0.f ? v : 0.f; }
};
struct EpiSigmaTile {  // + g_sig[r] wsig[c], no mask (ABL_MASK)
  const float* gsig;
  const bf16* wsig;
  __device__ float operator()(int r, int c, float v) const {
    return __fadd_rn(v, __fmul_rn(gsig[r], __bfloat162float(wsig[c])));
  }
};
struct EpiSigmaMaskTile {  // + g_sig[r] wsig[c], then the mask of h8
  const unsigned char* h;
  const float* gsig;
  const bf16* wsig;
  __device__ float operator()(int r, int c, float v) const {
    v = __fadd_rn(v, __fmul_rn(gsig[r], __bfloat162float(wsig[c])));
    return tile_at(h, r, c) > 0.f ? v : 0.f;
  }
};

// sum over the tile's points p of term(p), in f32: four interleaved partial
// sums, so that the additions do not wait on each other.
template <typename F>
__device__ __forceinline__ float point_sum(F term) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int p = 0; p < RAYS; p += 4)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = __fadd_rn(s[k], term(p + k));
  return __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
}

// db[c] += sum over the tile's points of D[p][c], c < O, in f32.
__device__ __forceinline__ void bias_sum(const unsigned char* D, int O, float* db) {
  const int c = threadIdx.x;
  if (c < O) atomicAdd(db + c, point_sum([&](int p) { return tile_at(D, p, c); }));
}

// The tile ``src`` of the global scratch into X: one bulk copy, issued by
// the first consumer thread once every reader of X has passed a barrier.
__device__ __forceinline__ void reload(unsigned char* X, const unsigned char* src, uint64_t* xbar, uint32_t& phase) {
  if (threadIdx.x == 0) {
    sm90::fence_proxy_async();
    sm90::mbar_arrive_expect_tx(xbar, ACT_BYTES);
    sm90::bulk_load(X, src, ACT_BYTES, xbar);
  }
  sm90::mbar_wait(xbar, phase);
  phase ^= 1;
}

// The direction delta da_d = cast(wrgb^T da_rgb * act'(a_d)) from the
// direction layer's accumulators (o.dacc) and the cast da_rgb of the
// thread's rows (dr), into Y over the direction PE (the warpgroup's own
// rows, its products done), and its per-ray f32 sum into ``dad``
// ([RAYS][HALF], global; ``first``: the sum starts).
__device__ __forceinline__ void dir_delta(const Lane& ln, const MlpOut& o, const float (&dr)[2][3],
                                          const float* __restrict__ B, const bf16* wrgb, bool new_act,
                                          unsigned char* Y, float* dad, bool first) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * ln.q;
    const float2 bd = __ldg(reinterpret_cast<const float2*>(B + BD + c));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float dd = __fmul_rn(__bfloat162float(wrgb[c + e]), dr[i][0]);
        dd = fmaf(__bfloat162float(wrgb[HALF + c + e]), dr[i][1], dd);
        dd = fmaf(__bfloat162float(wrgb[2 * HALF + c + e]), dr[i][2], dd);
        const float a = __fadd_rn(o.dacc[4 * j + 2 * i + e], e ? bd.y : bd.x);
        const float slope = new_act ? sigmoid(__fsub_rn(a, 1.f)) : (a > 0.f ? 1.f : 0.f);
        v[e] = __fmul_rn(dd, slope);
      }
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
      const int r = ln.row(i);
      *reinterpret_cast<__nv_bfloat162*>(Y + sw_off(r, c)) = h;
      float2* acc_d = reinterpret_cast<float2*>(dad + r * HALF + c);
      float2 sum = first ? make_float2(0.f, 0.f) : *acc_d;
      sum.x = __fadd_rn(sum.x, __low2float(h));
      sum.y = __fadd_rn(sum.y, __high2float(h));
      *acc_d = sum;
    }
  }
}

// The heads' weight and bias gradients, in f32 over the tile's points: d in
// X, da_d in Y, the cast per-point cotangents in darg_s and gsig_s (all
// synchronised).
// DB, DW false: X2's ablations of the bias sums and of the weight gradient.
template <bool DB = true, bool DW = true>
__device__ __forceinline__ void head_grads(const unsigned char* X, const unsigned char* Y, const float* darg_s,
                                           const float* gsig_s, float* dW, float* dB) {
  if constexpr (DW)
    for (int e = threadIdx.x; e < 3 * HALF; e += CONSUMER_THREADS) {  // dwrgb = da_rgb^T d
      const int ch = e / HALF, k = e % HALF;
      atomicAdd(dW + WRGB + e, point_sum([&](int p) { return __fmul_rn(darg_s[p * 3 + ch], tile_at(X, p, k)); }));
    }
  if constexpr (DB) {
    if (threadIdx.x < 3 || threadIdx.x == 32) {  // dbrgb, dbsig
      const int ch = threadIdx.x;
      atomicAdd(dB + (ch < 3 ? BRGB + ch : BSIG),
                point_sum([&](int p) { return ch < 3 ? darg_s[p * 3 + ch] : gsig_s[p]; }));
    }
    bias_sum(Y, HALF, dB + BD);
  }
}

// dwdx = dad^T d_pe, one f32 product per tile of rays (K3: the direction
// delta summed over the samples) or points (K4): the cast direction PE again,
// into X (free: every reader of X has passed a barrier).
__device__ __forceinline__ void dir_pe_wgrad(const Lane& ln, const float* rays_s, unsigned char* X, const float* dad,
                                             float* dW) {
  dir_pe(ln, rays_s, X);
  consumers_sync();
  for (int e = threadIdx.x; e < HALF * DIR_PAD; e += CONSUMER_THREADS) {
    const int o = e / DIR_PAD, c = e % DIR_PAD;
    atomicAdd(dW + WDX + e, point_sum([&](int p) { return __fmul_rn(dad[p * HALF + o], tile_at(X, p, c)); }));
  }
}

// X2's PE tiles (train_bwd_sm90's ABL_CONST_PE, ABL_CHEAP_PE): the
// warpgroup's rows of ``xpe``, every column bf16(0.01), or bf16(z 0.01) of
// the row's sample (z of rays past n is 1).  Unfenced.
__device__ __forceinline__ void const_pe(const Lane& ln, const float* __restrict__ z, int ray0, int n, int S, int s,
                                         bool cheap, unsigned char* xpe) {
  for (int e = ln.t; e < WG_ROWS * 8; e += 128) {
    const int r = ln.g * WG_ROWS + e / 8;
    const float zs = cheap && ray0 + r < n ? z[(size_t)(ray0 + r) * S + s] : 1.f;
    const __nv_bfloat162 v = __float2bfloat162_rn(cheap ? __fmul_rn(zs, 0.01f) : 0.01f);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
    *reinterpret_cast<uint4*>(xpe + r * ROW_BYTES + (e % 8) * 16) = make_uint4(u, u, u, u);
  }
}

// PIPE_PE: the warpgroup's rows of a 64-column swizzled tile copied to
// ``dst`` (the same layout).
__device__ __forceinline__ void copy_pe_rows(const Lane& ln, const unsigned char* src, unsigned char* dst) {
  const int base = ln.g * WG_ROWS * ROW_BYTES;
  for (int i = ln.t; i < WG_ROWS * ROW_BYTES / 16; i += 128)
    reinterpret_cast<int4*>(dst + base)[i] = reinterpret_cast<const int4*>(src + base)[i];
}

// PIPE_PE's layer 1: dW1 rows of both of the warpgroup's blocks (K3's wgrad
// over the tile's 128 points), both products in flight while ``between``
// runs, then flushed.
template <typename F>
__device__ __forceinline__ void wgrad_pe_overlapped(const Lane& ln, const unsigned char* D, const unsigned char* A,
                                                    float* dW, F&& between) {
  float a0[32], a1[32];
  sm90::fence_regs(a0);
  sm90::fence_regs(a1);
  sm90::wgmma_fence();
#pragma unroll
  for (int t = 0; t < RAYS / 16; ++t)
    sm90::mma_m64n64<1, 1>(a0, sm90::desc_sw128(D + 2 * ln.g * ACT_BLOCK + t * 16 * ROW_BYTES, ACT_BLOCK, 1024),
                           sm90::desc_sw128(A + t * 16 * ROW_BYTES, ACT_BLOCK, 1024), t > 0);
#pragma unroll
  for (int t = 0; t < RAYS / 16; ++t)
    sm90::mma_m64n64<1, 1>(a1, sm90::desc_sw128(D + (2 * ln.g + 1) * ACT_BLOCK + t * 16 * ROW_BYTES, ACT_BLOCK, 1024),
                           sm90::desc_sw128(A + t * 16 * ROW_BYTES, ACT_BLOCK, 1024), t > 0);
  sm90::wgmma_commit();
  between();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(a0);
  sm90::fence_regs(a1);
  flush<64>(a0, ln, dW + (size_t)2 * ln.g * 64 * XYZ_PAD, XYZ_PAD);
  flush<64>(a1, ln, dW + (size_t)(2 * ln.g + 1) * 64 * XYZ_PAD, XYZ_PAD);
}

// The barriers of a backward CTA: a full (one arrival, the producer's, and
// the copy's bytes) and an empty one (one arrival per consumer warpgroup) per
// ring stage, and the reload's.
__device__ __forceinline__ void init_bwd_barriers(uint64_t* full, uint64_t* empty, uint64_t* xbar) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < BwdSmem::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init(xbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
}

template <int ABLATE>
__global__ void __launch_bounds__(CTA_THREADS, 1)
train_bwd_sm90(const float* __restrict__ rays, const float* __restrict__ z, const float* __restrict__ noise,
               const unsigned char* __restrict__ slabs, const float* __restrict__ B,
               const float* __restrict__ w_res, const float* __restrict__ a_res,
               const float* __restrict__ rgb_res, const float* __restrict__ g_rgb,
               const float* __restrict__ g_depth, const float* __restrict__ g_w, float* dsig_part,
               unsigned char* scratch, float* dW, float* dB, int n, int S, int chunks, int new_act,
               int white_back) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  using L = BwdSmem;
  float* rays_s = reinterpret_cast<float*>(sm + L::RAYS_F);
  float* gsig_s = reinterpret_cast<float*>(sm + L::GSIG);
  float* darg_s = reinterpret_cast<float*>(sm + L::DARG);
  float* trans_s = reinterpret_cast<float*>(sm + L::TRANS);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + L::STAGES;
  uint64_t* xbar = empty + L::STAGES;
  init_bwd_barriers(full, empty, xbar);
  const int n_units = (n + RAYS - 1) / RAYS * chunks, span = S / chunks;  // units of span samples

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMER_THREADS) {
      uint32_t it = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x)
        for (int s = 0; s < span; ++s) {
          produce(slabs, sm + L::RING, full, empty, L::STAGES, it, N_FWD_SLABS, [](int j) { return j; });
          produce(slabs, sm + L::RING, full, empty, L::STAGES, it, N_BWD_SLABS, [](int j) { return bwd_slab(j); });
        }
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const Lane ln;
  Ring ring{sm + L::RING, full, empty, L::STAGES};
  const bf16* heads = reinterpret_cast<const bf16*>(slabs + HEAD_OFF);
  const bf16* wrgb = heads;
  const bf16* wsig = heads + 3 * HALF;
  unsigned char* X = sm + L::X;
  unsigned char* Y = sm + L::Y;
  unsigned char* xpe = sm + L::XPE;
  unsigned char* const kept = scratch + (size_t)blockIdx.x * BWD_SCRATCH;
  float* const dad = reinterpret_cast<float*>(kept + (size_t)N_KEPT * ACT_BYTES);
  constexpr bool do_flush = !(ABLATE & (ABL_FLUSH | ABL_WGRAD)), do_wgrad = !(ABLATE & ABL_WGRAD);
  constexpr bool do_db = !(ABLATE & ABL_DB), do_mask = !(ABLATE & ABL_MASK), do_head_dw = !(ABLATE & ABL_HEAD_DW);
  uint32_t xphase = 0;
  constexpr int WOFF[9] = {0, W1, W2, W3, W4, W5H, W6, W7, W8};
  constexpr int BOFF[9] = {0, B1, B2, B3, B4, B5, B6, B7, B8};

  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const int ray0 = unit / chunks * RAYS, s0 = unit % chunks * span, s1 = s0 + span;
    consumers_sync();  // the previous unit's readers of the rays, X, dad and trans_s are done
    load_rays(rays, ray0, n, rays_s);
    const int row = threadIdx.x % RAYS, ray = ray0 + row;
    if (threadIdx.x < RAYS && ray < n) {  // stage A, downwards from the last sample
      const float gr = g_rgb[(size_t)ray * 3], gg = g_rgb[(size_t)ray * 3 + 1], gb = g_rgb[(size_t)ray * 3 + 2];
      const float gsum = __fadd_rn(__fadd_rn(gr, gg), gb);
      float suffix = 0.f;
      for (int s = S - 1; s >= s0; --s) {
        const size_t at = (size_t)ray * S + s;
        const float c = weight_cotangent(rgb_res + at * 3, gr, gg, gb, g_depth[ray], z[at], g_w[at], gsum, white_back);
        if (s < s1) {
          const float u = fmaxf(__fadd_rn(__fsub_rn(1.f, a_res[at]), 1e-10f), 1e-10f);
          dsig_part[at] = __fdiv_rn(-suffix, u);
        }
        suffix = __fadd_rn(suffix, __fmul_rn(c, w_res[at]));
      }
    } else if (threadIdx.x >= RAYS) {  // meanwhile the transmittance at s0, upwards, as the sample loop forms it
      float t = 1.f;
      for (int s = 0; ray < n && s < s0; ++s)
        t = __fmul_rn(t, __fadd_rn(__fsub_rn(1.f, a_res[(size_t)ray * S + s]), 1e-10f));
      trans_s[row] = t;
    }
    consumers_sync();
    float dn[2], trans[2], g3[2][3], gd[2], gsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ln.row(i), my = ray0 + r;
      dn[i] = ray_norm(rays_s, r);
      trans[i] = trans_s[r];
      for (int ch = 0; ch < 3; ++ch) g3[i][ch] = my < n ? g_rgb[(size_t)my * 3 + ch] : 0.f;
      gd[i] = my < n ? g_depth[my] : 0.f;
      gsum[i] = __fadd_rn(__fadd_rn(g3[i][0], g3[i][1]), g3[i][2]);
    }

    for (int s = s0; s < s1; ++s) {
      // 1. recompute, keeping h1..h8 and f; the direction PE into Y
      dir_pe(ln, rays_s, Y);
      if constexpr ((ABLATE & (ABL_CONST_PE | ABL_CHEAP_PE)) != 0) {
        if ((ABLATE & ABL_CHEAP_PE) != 0 || s == s0) const_pe(ln, z, ray0, n, S, s, (ABLATE & ABL_CHEAP_PE) != 0, xpe);
      } else if constexpr ((ABLATE & PIPE_PE) != 0) {
        if (s == s0) sample_pe_sw(ln, rays_s, z, ray0, n, S, s, xpe);
        else copy_pe_rows(ln, X, xpe);  // formed during the previous sample's layer 1
      } else {
        sample_pe_sw(ln, rays_s, z, ray0, n, S, s, xpe);
      }
      sm90::fence_proxy_async();
      ln.wg_sync();
      MlpOut o;
      mlp_pass(ring, ln, X, xpe, Y, heads, B, new_act != 0, KeepTiles{kept}, o);
      if (ln.leader()) sm90::bulk_wait();  // the kept tiles are in global memory

      // 2. the head: the gated dL/dsigma and da_rgb per ray, cast
      float gs[2], dr[2][3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ln.row(i), my = ray0 + r;
        float ds = 0.f, d3[3] = {0.f, 0.f, 0.f};
        if (my < n) {
          const size_t at = (size_t)my * S + s;
          const float delta = interval(z + (size_t)my * S, S, s, dn[i]);
          const float w_s = w_res[at], a_s = a_res[at];
          const float c = weight_cotangent(rgb_res + at * 3, g3[i][0], g3[i][1], g3[i][2], gd[i], z[at], g_w[at],
                                           gsum[i], white_back);
          const float da_alpha = __fadd_rn(__fmul_rn(c, trans[i]), dsig_part[at]);
          float sig = o.sig[i];
          if (noise != nullptr) sig = __fadd_rn(sig, noise[at]);
          if (sig > 0.f) ds = __fmul_rn(__fmul_rn(da_alpha, __fsub_rn(1.f, a_s)), delta);
          for (int ch = 0; ch < 3; ++ch)
            d3[ch] = __fmul_rn(__fmul_rn(w_s, g3[i][ch]), rgb_act_slope(o.rpre[i][ch], new_act != 0));
          trans[i] = __fmul_rn(trans[i], __fadd_rn(__fsub_rn(1.f, a_s), 1e-10f));
        }
        gs[i] = __bfloat162float(__float2bfloat16_rn(ds));
        for (int ch = 0; ch < 3; ++ch) dr[i][ch] = __bfloat162float(__float2bfloat16_rn(d3[ch]));
        if (ln.q == 0) {
          gsig_s[r] = gs[i];
          for (int ch = 0; ch < 3; ++ch) darg_s[r * 3 + ch] = dr[i][ch];
        }
      }
      dir_delta(ln, o, dr, B, wrgb, new_act != 0, Y, dad, s == s0);
      sm90::fence_proxy_async();
      consumers_sync();  // da_d, d (in X), g_sig and da_rgb of every ray

      head_grads<do_db, do_head_dw>(X, Y, darg_s, gsig_s, dW, dB);
      consumers_sync();  // every reader of d in X is done

      // 3. the direction layer: dwdh = da_d^T f, then df = da_d wdh
      float acc[4][32];
      reload(X, kept + 8 * (size_t)ACT_BYTES, xbar, xphase);
      if constexpr (do_wgrad) wgrad<256>(ln, Y, ln.g, X, dW + WDH, WIDTH, do_flush);
      dgrad<8>(acc, ring, ln, Y);
      consumers_sync();  // both warpgroups' wgrads have read Y
      dgrad_store(acc, ln, Y, EpiPass());
      sm90::fence_proxy_async();
      consumers_sync();

      // xyz_encoding_final: dwfin = df^T h8, dwsig = g_sig^T h8, then
      // da8 = mask(h8) (df wfin + g_sig wsig)
      if constexpr (do_db) bias_sum(Y, WIDTH, dB + BFIN);
      reload(X, kept + 7 * (size_t)ACT_BYTES, xbar, xphase);
      if constexpr (do_head_dw) {
        const int k = threadIdx.x;
        atomicAdd(dW + WSIG + k, point_sum([&](int p) { return __fmul_rn(gsig_s[p], tile_at(X, p, k)); }));
      }
      for (int ch = 2 * ln.g; do_wgrad && ch < 2 * ln.g + 2; ++ch) wgrad<256>(ln, Y, ch, X, dW + WFIN, WIDTH, do_flush);
      dgrad<16>(acc, ring, ln, Y);
      consumers_sync();
      if constexpr (do_mask) dgrad_store(acc, ln, Y, EpiSigmaMaskTile{X, gsig_s, wsig});
      else dgrad_store(acc, ln, Y, EpiSigmaTile{gsig_s, wsig});
      sm90::fence_proxy_async();
      consumers_sync();

      // the trunk, layers 8 down to 1: the delta of layer l is in Y
      for (int l = 8; l >= 1; --l) {
        if constexpr (do_db) bias_sum(Y, WIDTH, dB + BOFF[l]);
        if (l == 1) {
          if constexpr ((ABLATE & PIPE_PE) != 0) {  // sample s + 1's PE into X while W1's products run
            wgrad_pe_overlapped(ln, Y, xpe, dW + W1, [&] {
              if (s + 1 < s1) sample_pe_sw(ln, rays_s, z, ray0, n, S, s + 1, X);
            });
          } else {
            for (int ch = 2 * ln.g; do_wgrad && ch < 2 * ln.g + 2; ++ch)
              wgrad<64>(ln, Y, ch, xpe, dW + W1, XYZ_PAD, do_flush);
          }
          break;
        }
        reload(X, kept + (size_t)(l - 2) * ACT_BYTES, xbar, xphase);  // h_{l-1}
        for (int ch = 2 * ln.g; do_wgrad && ch < 2 * ln.g + 2; ++ch) {
          wgrad<256>(ln, Y, ch, X, dW + WOFF[l], WIDTH, do_flush);
          if (l == 5) wgrad<64>(ln, Y, ch, xpe, dW + W5X, XYZ_PAD, do_flush);
        }
        dgrad<16>(acc, ring, ln, Y);
        consumers_sync();
        if constexpr (do_mask) dgrad_store(acc, ln, Y, EpiMaskTile{X});
        else dgrad_store(acc, ln, Y, EpiPass());
        sm90::fence_proxy_async();
        consumers_sync();
      }
      consumers_sync();  // every reader of xpe, X and Y is done before the next sample writes them
    }

    dir_pe_wgrad(ln, rays_s, X, dad, dW);  // the unit's part of dwdx
  }
}

}  // namespace k3
}  // namespace nerf
