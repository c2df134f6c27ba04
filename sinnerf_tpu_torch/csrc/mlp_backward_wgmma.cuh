// K3-bwd bf16 on Hopper: the training render's backward over a ray tile
// (fused_render_train_sm90.cu holds the kernel).
//
// Replaces, in bf16, train_backward.cuh's train_bwd_tiles<bf16> with
// mlp_backward.cuh's wmma products (which K4-bwd, the float32 K3-bwd and X2
// keep).  The TPU kernel it stands for is
// sinnerf_tpu/ops/fused_render_train_t.py::_train_bwd_kernel (:164, through
// _frlt_bwd :509).  The function, its inputs, outputs and cast points are
// fused_render_train.cu's (see the note there).
//
// Bound: operations, 3.48 MFLOP per point (recompute, dgrad, wgrad).
//
// A CTA (two consumer warpgroups of 64 rays, one producer warpgroup) owns a
// tile of 128 rays; persistent CTAs walk the tiles.  Per tile, stage A (the
// descending suffix sums into dsig_part) is train_backward.cuh's.  Per
// sample, upwards:
//   1. Recompute with mlp_wgmma.cuh's mlp_pass, the forward's own body, so
//      that sigma's gate and every ReLU round as they did in the forward.
//      Each trunk layer's output tile is copied to the CTA's global scratch
//      (it stays in L2) by bulk stores; the direction PE is recomputed into
//      the delta tile, which is free then.
//   2. The head: dL/dsigma (gated) and da_rgb per ray, cast; the direction
//      delta straight from the direction layer's accumulators, still in
//      registers; its f32 per-ray sum over samples stays in global scratch
//      (SumDirDelta's role) and meets the direction PE once per tile.
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
// rays and the per-ray head cotangents.
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
  static constexpr int RAYS_F = SMALL, GSIG = SMALL + 3072, DARG = GSIG + 512, BARS = SMALL + 6144;
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

// acc[j] = D(the warpgroup's rows) W_j for the four slabs j of a block in
// the ring, each 64 output columns; the reduction runs over KS * 16 rows of
// D (its columns).
template <int KS>
__device__ __forceinline__ void dgrad(float (&acc)[4][32], Ring& ring, const Lane& ln, const unsigned char* D) {
  const unsigned char* d = D + ln.g * WG_ROWS * ROW_BYTES;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
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

template <int ABLATE>
__global__ void __launch_bounds__(CTA_THREADS, 1)
train_bwd_sm90(const float* __restrict__ rays, const float* __restrict__ z, const float* __restrict__ noise,
               const unsigned char* __restrict__ slabs, const float* __restrict__ B,
               const float* __restrict__ w_res, const float* __restrict__ a_res,
               const float* __restrict__ rgb_res, const float* __restrict__ g_rgb,
               const float* __restrict__ g_depth, const float* __restrict__ g_w, float* dsig_part,
               unsigned char* scratch, float* dW, float* dB, int n, int S, int new_act, int white_back) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  using L = BwdSmem;
  float* rays_s = reinterpret_cast<float*>(sm + L::RAYS_F);
  float* gsig_s = reinterpret_cast<float*>(sm + L::GSIG);
  float* darg_s = reinterpret_cast<float*>(sm + L::DARG);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + L::STAGES;
  uint64_t* xbar = empty + L::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init(xbar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int n_tiles = (n + RAYS - 1) / RAYS;

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMER_THREADS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int s = 0; s < S; ++s) {
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
  uint32_t xphase = 0;
  constexpr int WOFF[9] = {0, W1, W2, W3, W4, W5H, W6, W7, W8};
  constexpr int BOFF[9] = {0, B1, B2, B3, B4, B5, B6, B7, B8};

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray0 = tile * RAYS;
    consumers_sync();  // the previous tile's readers of the rays, X and dad are done
    load_rays(rays, ray0, n, rays_s);
    if (threadIdx.x < RAYS && ray0 + (int)threadIdx.x < n) {  // stage A, downwards
      const int my = ray0 + threadIdx.x;
      const float gr = g_rgb[(size_t)my * 3], gg = g_rgb[(size_t)my * 3 + 1], gb = g_rgb[(size_t)my * 3 + 2];
      const float gsum = __fadd_rn(__fadd_rn(gr, gg), gb);
      float suffix = 0.f;
      for (int s = S - 1; s >= 0; --s) {
        const size_t at = (size_t)my * S + s;
        const float c = weight_cotangent(rgb_res + at * 3, gr, gg, gb, g_depth[my], z[at], g_w[at], gsum, white_back);
        const float u = fmaxf(__fadd_rn(__fsub_rn(1.f, a_res[at]), 1e-10f), 1e-10f);
        dsig_part[at] = __fdiv_rn(-suffix, u);
        suffix = __fadd_rn(suffix, __fmul_rn(c, w_res[at]));
      }
    }
    consumers_sync();
    float dn[2], trans[2], g3[2][3], gd[2], gsum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ln.row(i), my = ray0 + r;
      dn[i] = ray_norm(rays_s, r);
      trans[i] = 1.f;
      for (int ch = 0; ch < 3; ++ch) g3[i][ch] = my < n ? g_rgb[(size_t)my * 3 + ch] : 0.f;
      gd[i] = my < n ? g_depth[my] : 0.f;
      gsum[i] = __fadd_rn(__fadd_rn(g3[i][0], g3[i][1]), g3[i][2]);
    }

    for (int s = 0; s < S; ++s) {
      // 1. recompute, keeping h1..h8 and f; the direction PE into Y
      dir_pe(ln, rays_s, Y);
      sample_pe_sw(ln, rays_s, z, ray0, n, S, s, xpe);
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
      // the direction delta da_d = cast(wrgb^T da_rgb * act'(a_d)) from the
      // direction layer's accumulators, into Y over the direction PE (the
      // warpgroup's own rows, its products done), and its per-ray f32 sum
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
          float2 sum = s == 0 ? make_float2(0.f, 0.f) : *acc_d;
          sum.x = __fadd_rn(sum.x, __low2float(h));
          sum.y = __fadd_rn(sum.y, __high2float(h));
          *acc_d = sum;
        }
      }
      sm90::fence_proxy_async();
      consumers_sync();  // da_d, d (in X), g_sig and da_rgb of every ray

      // the heads' weight and bias gradients, in f32 over the tile's points
      for (int e = threadIdx.x; e < 3 * HALF; e += CONSUMER_THREADS) {  // dwrgb = da_rgb^T d
        const int ch = e / HALF, k = e % HALF;
        atomicAdd(dW + WRGB + e, point_sum([&](int p) { return __fmul_rn(darg_s[p * 3 + ch], tile_at(X, p, k)); }));
      }
      if (threadIdx.x < 3 || threadIdx.x == 32) {  // dbrgb, dbsig
        const int ch = threadIdx.x;
        atomicAdd(dB + (ch < 3 ? BRGB + ch : BSIG), point_sum([&](int p) { return ch < 3 ? darg_s[p * 3 + ch] : gsig_s[p]; }));
      }
      bias_sum(Y, HALF, dB + BD);
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
      bias_sum(Y, WIDTH, dB + BFIN);
      reload(X, kept + 7 * (size_t)ACT_BYTES, xbar, xphase);
      {
        const int k = threadIdx.x;
        atomicAdd(dW + WSIG + k, point_sum([&](int p) { return __fmul_rn(gsig_s[p], tile_at(X, p, k)); }));
      }
      for (int ch = 2 * ln.g; do_wgrad && ch < 2 * ln.g + 2; ++ch) wgrad<256>(ln, Y, ch, X, dW + WFIN, WIDTH, do_flush);
      dgrad<16>(acc, ring, ln, Y);
      consumers_sync();
      dgrad_store(acc, ln, Y, EpiSigmaMaskTile{X, gsig_s, wsig});
      sm90::fence_proxy_async();
      consumers_sync();

      // the trunk, layers 8 down to 1: the delta of layer l is in Y
      for (int l = 8; l >= 1; --l) {
        bias_sum(Y, WIDTH, dB + BOFF[l]);
        if (l == 1) {
          for (int ch = 2 * ln.g; do_wgrad && ch < 2 * ln.g + 2; ++ch)
            wgrad<64>(ln, Y, ch, xpe, dW + W1, XYZ_PAD, do_flush);
          break;
        }
        reload(X, kept + (size_t)(l - 2) * ACT_BYTES, xbar, xphase);  // h_{l-1}
        for (int ch = 2 * ln.g; do_wgrad && ch < 2 * ln.g + 2; ++ch) {
          wgrad<256>(ln, Y, ch, X, dW + WOFF[l], WIDTH, do_flush);
          if (l == 5) wgrad<64>(ln, Y, ch, xpe, dW + W5X, XYZ_PAD, do_flush);
        }
        dgrad<16>(acc, ring, ln, Y);
        consumers_sync();
        dgrad_store(acc, ln, Y, EpiMaskTile{X});
        sm90::fence_proxy_async();
        consumers_sync();
      }
      consumers_sync();  // every reader of xpe, X and Y is done before the next sample writes them
    }

    // dwdx = (sum_s da_d)^T d_pe, one f32 product per ray tile: the cast
    // direction PE again, into X
    dir_pe(ln, rays_s, X);
    consumers_sync();
    for (int e = threadIdx.x; e < HALF * DIR_PAD; e += CONSUMER_THREADS) {
      const int o = e / DIR_PAD, c = e % DIR_PAD;
      atomicAdd(dW + WDX + e, point_sum([&](int p) { return __fmul_rn(dad[p * HALF + o], tile_at(X, p, c)); }));
    }
  }
}

}  // namespace k3
}  // namespace nerf
