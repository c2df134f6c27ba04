// X2 on Hopper: the pipelining experiments on K3-bwd bf16, as instantiations
// of the production kernel (mlp_backward_wgmma.cuh's train_bwd_sm90) and one
// restructured loop beside it.
//
// Replaces the TPU kernel of scripts/exp_bwd_pipeline.py::run_variant (:326,
// kernel _exp_bwd_kernel :73-323, call :369): the production backward (no
// noise, black background, new activation, bf16) with timing ablations and
// exact restructurings.  The first port, exp_bwd_pipeline.cu (wmma),
// stays built on no path for the timing rounds.  Wrapper, plain versions,
// launch counter and the experiment's entry point:
// sinnerf_tpu_torch/scripts/exp_bwd_pipeline.py.
//
// The variants (JAX's names; train_bwd_sm90's Ablate bits):
//   base        train_bwd_sm90<0>, the production instantiation
//   no_db       ABL_DB: no bias sums
//   no_mask     ABL_MASK: no ReLU mask of h1..h8 in the dgrad epilogues
//               (sigma's term at layer 8 and the sigma gate stay)
//   no_dw       ABL_WGRAD | ABL_HEAD_DW: no weight-gradient products, no
//               flush, no dwrgb or dwsig (dwdx is still summed)
//   mxu_floor   ABL_CONST_PE | ABL_MASK | ABL_DB: a constant 0.01 PE tile
//               (formed once per tile), no masks, no bias sums
//   cheap_pe    ABL_CHEAP_PE: bf16(z 0.01) in every PE column
//   pe_pipe     PIPE_PE, exact: sample s+1's PE formed while sample s's
//               layer-1 wgrad products are in flight (into X, free then),
//               copied into the PE tile when s+1 starts
//   two_stream  two_stream_sm90<RB>, exact, below
// The five ablations compute other gradients on purpose: they time what the
// part costs.
//
// two_stream: stage A also folds the ascending transmittance into
// dsig_part, which then holds the whole dL/dalpha of every sample (JAX's
// :125-140), so the samples' chains are independent.  The CTA's 128-row
// tile holds two streams, one per consumer warpgroup: rows 0-63 run samples
// of the first half [0, S/2), rows 64-127 of the second [S/2, S), of the
// same rays.  Each warpgroup then runs its chain alone: its own rows' wgrad
// (all 256 output rows of dW over its 64 points, four m64n256 products of K
// = 64 where the production kernel has each warpgroup take half the output
// rows over both warpgroups' 128 points, so twice the flushed sums), bias
// and head sums, kept tiles reloaded by its own bulk copies and barrier, and
// named-barrier syncs of its own: no barrier couples the two warpgroups
// inside a pass, so one chain's epilogue (mask, cast, bias sums, flush) runs
// while the other's wgmmas are in flight, as far as the weight ring (2
// stages, released by both) lets them drift.  JAX's tiles r_tile 1024 and
// 512 are RB = 64 and 32 rays: at 64 a warpgroup holds one sample of each
// ray per pass, at 32 two consecutive samples of its stream (a warpgroup's
// wgmma is 64 rows; 32 rays x 1 sample would leave half of it idle).  A
// stream's last pass may hold samples past its half (S/2 odd at RB = 32):
// those rows are dead, as rays past n are (zero cotangents, nothing
// written).  S must be even.  The map of a row to its (ray, sample) is
// StreamMap; tests/test_torch_exp_bwd_pipeline.py's stream_rows mirrors it.
//
// Bound: operations.  Exact variants: 3.48 MFLOP per point, K3-bwd's (11.06
// ms at 16,384 rays x 192 samples, 989 TFLOP/s); no_dw drops the 589,312
// multiply-adds of wgrad per point (7.32 ms).
#include "mlp_backward_wgmma.cuh"
#include "render_level_sm90.cuh"

using namespace nerf;
using namespace nerf::k3;

// Variant ids of the C interface (the wrapper's VARIANT_IDS).
enum Variant { V_BASE = 0, V_NO_DB = 1, V_NO_MASK = 2, V_NO_DW = 3, V_MXU_FLOOR = 4, V_CHEAP_PE = 5, V_PE_PIPE = 6 };

// -------------------------------------------------------------- two_stream
// Row r of a pass p of a tile of RB rays from ray0: stream r / 64, ray ray0
// + (r % 64) % RB, sample stream * half + p * (64 / RB) + (r % 64) / RB.
template <int RB>
struct StreamMap {
  int ray0, n, half, p;
  __device__ int ray(int r) const { return ray0 + (r & 63) % RB; }
  __device__ int slot(int r) const { return p * (64 / RB) + (r & 63) / RB; }
  __device__ int sample(int r) const { return (r >> 6) * half + slot(r); }
  __device__ bool valid(int r) const { return ray(r) < n && slot(r) < half; }
};

// The PE of each of the warpgroup's rows' (ray, sample) into ``xpe``
// (column 63 zero; z of a dead row is 1), as sample_pe_sw.  Unfenced.
template <int RB>
__device__ __forceinline__ void stream_pe(const Lane& ln, const float* rays, const float* __restrict__ z,
                                          const StreamMap<RB>& m, int S, unsigned char* xpe) {
  for (int e = ln.t; e < WG_ROWS * 3; e += 128) {
    const int r = ln.g * WG_ROWS + e / 3, c = e % 3;
    const float zs = m.valid(r) ? z[(size_t)m.ray(r) * S + m.sample(r)] : 1.f;
    pe_channel_sw(__fadd_rn(rays[r * 6 + c], __fmul_rn(rays[r * 6 + 3 + c], zs)), c, N_FREQS_XYZ, xpe, r);
  }
  if (ln.t < WG_ROWS)
    *reinterpret_cast<bf16*>(xpe + sw_off(ln.g * WG_ROWS + ln.t, XYZ_CH)) = __float2bfloat16_rn(0.f);
}

// sum over the warpgroup's 64 rows p of term(p), in f32 (point_sum's order
// over half the rows).
template <typename F>
__device__ __forceinline__ float wg_point_sum(const Lane& ln, F term) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  const int p0 = ln.g * WG_ROWS;
#pragma unroll 8
  for (int p = 0; p < WG_ROWS; p += 4)
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = __fadd_rn(s[k], term(p0 + p + k));
  return __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
}

// db[c] += sum over the warpgroup's rows of D[p][c], c < O.
__device__ __forceinline__ void bias_sum_wg(const Lane& ln, const unsigned char* D, int O, float* db) {
  for (int c = ln.t; c < O; c += 128) atomicAdd(db + c, wg_point_sum(ln, [&](int p) { return tile_at(D, p, c); }));
}

// head_grads over the warpgroup's rows.
__device__ __forceinline__ void head_grads_wg(const Lane& ln, const unsigned char* X, const unsigned char* Y,
                                              const float* darg_s, const float* gsig_s, float* dW, float* dB) {
  for (int e = ln.t; e < 3 * HALF; e += 128) {  // dwrgb = da_rgb^T d
    const int ch = e / HALF, k = e % HALF;
    atomicAdd(dW + WRGB + e, wg_point_sum(ln, [&](int p) { return __fmul_rn(darg_s[p * 3 + ch], tile_at(X, p, k)); }));
  }
  if (ln.t < 3 || ln.t == 32) {  // dbrgb, dbsig
    const int ch = ln.t;
    atomicAdd(dB + (ch < 3 ? BRGB + ch : BSIG),
              wg_point_sum(ln, [&](int p) { return ch < 3 ? darg_s[p * 3 + ch] : gsig_s[p]; }));
  }
  bias_sum_wg(ln, Y, HALF, dB + BD);
}

// dW rows [64 ch, 64 ch + 64) += D[rows, 64 ch ..]^T A[rows] over the
// warpgroup's 64 rows (four 16-row steps), both operands MN-major, flushed.
template <int N>
__device__ __forceinline__ void wgrad_wg(const Lane& ln, const unsigned char* D, int ch, const unsigned char* A,
                                         float* dW, int kin) {
  float acc[N / 2];
  const int rows = ln.g * WG_ROWS * ROW_BYTES;
  sm90::fence_regs(acc);
  sm90::wgmma_fence();
#pragma unroll
  for (int t = 0; t < WG_ROWS / 16; ++t) {
    const uint64_t da = sm90::desc_sw128(D + ch * ACT_BLOCK + rows + t * 16 * ROW_BYTES, ACT_BLOCK, 1024);
    const uint64_t db = sm90::desc_sw128(A + rows + t * 16 * ROW_BYTES, ACT_BLOCK, 1024);
    if constexpr (N == 256) sm90::mma_m64n256<1, 1>(acc, da, db, t > 0);
    else sm90::mma_m64n64<1, 1>(acc, da, db, t > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  flush<N>(acc, ln, dW + (size_t)ch * 64 * kin, kin);
}

// The warpgroup's rows of the kept tile ``src`` into X: four bulk copies
// (one per 64-column block) by its first thread, on its own barrier.
__device__ __forceinline__ void reload_wg(const Lane& ln, unsigned char* X, const unsigned char* src, uint64_t* bar,
                                          uint32_t& phase) {
  if (ln.leader()) {
    const int rows = ln.g * WG_ROWS * ROW_BYTES;
    sm90::fence_proxy_async();
    sm90::mbar_arrive_expect_tx(bar, 4 * WG_ROWS * ROW_BYTES);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      sm90::bulk_load(X + b * ACT_BLOCK + rows, src + b * ACT_BLOCK + rows, WG_ROWS * ROW_BYTES, bar);
  }
  sm90::mbar_wait(bar, phase);
  phase ^= 1;
}

template <int RB>
__global__ void __launch_bounds__(CTA_THREADS, 1)
two_stream_sm90(const float* __restrict__ rays, const float* __restrict__ z, const unsigned char* __restrict__ slabs,
                const float* __restrict__ B, const float* __restrict__ w_res, const float* __restrict__ a_res,
                const float* __restrict__ rgb_res, const float* __restrict__ g_rgb, const float* __restrict__ g_depth,
                const float* __restrict__ g_w, float* dsig_part, unsigned char* scratch, float* dW, float* dB, int n,
                int S, int new_act) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  using L = BwdSmem;
  float* rays_s = reinterpret_cast<float*>(sm + L::RAYS_F);
  float* gsig_s = reinterpret_cast<float*>(sm + L::GSIG);
  float* darg_s = reinterpret_cast<float*>(sm + L::DARG);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + L::STAGES;
  uint64_t* xbar = empty + L::STAGES;  // one per consumer warpgroup
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init(&xbar[0], 1);
    sm90::mbar_init(&xbar[1], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int n_tiles = (n + RB - 1) / RB, half = S / 2, passes = (half + 64 / RB - 1) / (64 / RB);

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMER_THREADS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int p = 0; p < passes; ++p) {
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
  uint64_t* const mybar = xbar + ln.g;
  uint32_t xphase = 0;
  constexpr int WOFF[9] = {0, W1, W2, W3, W4, W5H, W6, W7, W8};
  constexpr int BOFF[9] = {0, B1, B2, B3, B4, B5, B6, B7, B8};

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray0 = tile * RB;
    consumers_sync();  // the previous tile's readers of the rays, X and dad are done
    for (int i = threadIdx.x; i < RAYS * 6; i += CONSUMER_THREADS) {  // row r holds ray ray0 + (r % 64) % RB
      const int r = i / 6, c = i % 6, my = ray0 + (r & 63) % RB;
      rays_s[i] = my < n ? rays[(size_t)my * 6 + c] : (c == 5 ? 1.f : 0.f);
    }
    if (threadIdx.x < RB && ray0 + (int)threadIdx.x < n) {  // stage A: the whole dL/dalpha of every sample
      const int my = ray0 + threadIdx.x;
      const float gr = g_rgb[(size_t)my * 3], gg = g_rgb[(size_t)my * 3 + 1], gb = g_rgb[(size_t)my * 3 + 2];
      const float gsum = __fadd_rn(__fadd_rn(gr, gg), gb);
      float suffix = 0.f;
      for (int s = S - 1; s >= 0; --s) {  // downwards: -S_s / u_s
        const size_t at = (size_t)my * S + s;
        const float c = weight_cotangent(rgb_res + at * 3, gr, gg, gb, g_depth[my], z[at], g_w[at], gsum, 0);
        const float u = fmaxf(__fadd_rn(__fsub_rn(1.f, a_res[at]), 1e-10f), 1e-10f);
        dsig_part[at] = __fdiv_rn(-suffix, u);
        suffix = __fadd_rn(suffix, __fmul_rn(c, w_res[at]));
      }
      float trans = 1.f;
      for (int s = 0; s < S; ++s) {  // upwards: + c_s T_s, as the production kernel's head adds it
        const size_t at = (size_t)my * S + s;
        const float c = weight_cotangent(rgb_res + at * 3, gr, gg, gb, g_depth[my], z[at], g_w[at], gsum, 0);
        dsig_part[at] = __fadd_rn(__fmul_rn(c, trans), dsig_part[at]);
        trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a_res[at]), 1e-10f));
      }
    }
    consumers_sync();
    float dn[2], g3[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ln.row(i), my = ray0 + (r & 63) % RB;
      dn[i] = ray_norm(rays_s, r);
      for (int ch = 0; ch < 3; ++ch) g3[i][ch] = my < n ? g_rgb[(size_t)my * 3 + ch] : 0.f;
    }

    for (int p = 0; p < passes; ++p) {
      const StreamMap<RB> m{ray0, n, half, p};
      // 1. recompute, keeping h1..h8 and f; the direction PE into Y
      dir_pe(ln, rays_s, Y);
      stream_pe(ln, rays_s, z, m, S, xpe);
      sm90::fence_proxy_async();
      ln.wg_sync();
      MlpOut o;
      mlp_pass(ring, ln, X, xpe, Y, heads, B, new_act != 0, KeepTiles{kept}, o);
      if (ln.leader()) sm90::bulk_wait();  // the kept tiles are in global memory

      // 2. the head: the gated dL/dsigma and da_rgb per row, cast
      float dr[2][3];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ln.row(i);
        float ds = 0.f, d3[3] = {0.f, 0.f, 0.f};
        if (m.valid(r)) {
          const int my = m.ray(r), s = m.sample(r);
          const size_t at = (size_t)my * S + s;
          const float delta = interval(z + (size_t)my * S, S, s, dn[i]);
          const float w_s = w_res[at], a_s = a_res[at];
          if (o.sig[i] > 0.f) ds = __fmul_rn(__fmul_rn(dsig_part[at], __fsub_rn(1.f, a_s)), delta);
          for (int ch = 0; ch < 3; ++ch)
            d3[ch] = __fmul_rn(__fmul_rn(w_s, g3[i][ch]), rgb_act_slope(o.rpre[i][ch], new_act != 0));
        }
        const float gs = __bfloat162float(__float2bfloat16_rn(ds));
        for (int ch = 0; ch < 3; ++ch) dr[i][ch] = __bfloat162float(__float2bfloat16_rn(d3[ch]));
        if (ln.q == 0) {
          gsig_s[r] = gs;
          for (int ch = 0; ch < 3; ++ch) darg_s[r * 3 + ch] = dr[i][ch];
        }
      }
      dir_delta(ln, o, dr, B, wrgb, new_act != 0, Y, dad, p == 0);
      sm90::fence_proxy_async();
      ln.wg_sync();  // da_d, d (in X), g_sig and da_rgb of the warpgroup's rows

      head_grads_wg(ln, X, Y, darg_s, gsig_s, dW, dB);
      ln.wg_sync();  // every reader of d in X is done

      // 3. the direction layer: dwdh = da_d^T f, then df = da_d wdh
      float acc[4][32];
      reload_wg(ln, X, kept + 8 * (size_t)ACT_BYTES, mybar, xphase);
      for (int ch = 0; ch < 2; ++ch) wgrad_wg<256>(ln, Y, ch, X, dW + WDH, WIDTH);
      dgrad<8>(acc, ring, ln, Y);
      ln.wg_sync();
      dgrad_store(acc, ln, Y, EpiPass());
      sm90::fence_proxy_async();
      ln.wg_sync();

      // xyz_encoding_final: dwfin = df^T h8, dwsig = g_sig^T h8, then
      // da8 = mask(h8) (df wfin + g_sig wsig)
      bias_sum_wg(ln, Y, WIDTH, dB + BFIN);
      reload_wg(ln, X, kept + 7 * (size_t)ACT_BYTES, mybar, xphase);
      for (int k = ln.t; k < WIDTH; k += 128)
        atomicAdd(dW + WSIG + k, wg_point_sum(ln, [&](int q) { return __fmul_rn(gsig_s[q], tile_at(X, q, k)); }));
      for (int ch = 0; ch < 4; ++ch) wgrad_wg<256>(ln, Y, ch, X, dW + WFIN, WIDTH);
      dgrad<16>(acc, ring, ln, Y);
      ln.wg_sync();
      dgrad_store(acc, ln, Y, EpiSigmaMaskTile{X, gsig_s, wsig});
      sm90::fence_proxy_async();
      ln.wg_sync();

      // the trunk, layers 8 down to 1: the delta of layer l is in Y
      for (int l = 8; l >= 1; --l) {
        bias_sum_wg(ln, Y, WIDTH, dB + BOFF[l]);
        if (l == 1) {
          for (int ch = 0; ch < 4; ++ch) wgrad_wg<64>(ln, Y, ch, xpe, dW + W1, XYZ_PAD);
          break;
        }
        reload_wg(ln, X, kept + (size_t)(l - 2) * ACT_BYTES, mybar, xphase);  // h_{l-1}
        for (int ch = 0; ch < 4; ++ch) {
          wgrad_wg<256>(ln, Y, ch, X, dW + WOFF[l], WIDTH);
          if (l == 5) wgrad_wg<64>(ln, Y, ch, xpe, dW + W5X, XYZ_PAD);
        }
        dgrad<16>(acc, ring, ln, Y);
        ln.wg_sync();
        dgrad_store(acc, ln, Y, EpiMaskTile{X});
        sm90::fence_proxy_async();
        ln.wg_sync();
      }
      ln.wg_sync();  // every reader of the warpgroup's rows of xpe, X and Y is done before the next pass
    }
    consumers_sync();
    dir_pe_wgrad(ln, rays_s, X, dad, dW);  // both streams' rows of a ray meet here
  }
}

// ------------------------------------------------------------------ launches
struct Args {
  const void *rays, *z, *slabs, *b, *w_res, *a_res, *rgb_res, *g_rgb, *g_depth, *g_w;
  void *dsig_part, *scratch, *dw, *db;
  int n, s, blocks, new_act;
  void* stream;
};

template <int ABLATE>
static int launch_ablated(const Args& a) {
  cudaError_t e = cudaFuncSetAttribute((const void*)train_bwd_sm90<ABLATE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.n + RAYS - 1) / RAYS;
  if (tiles == 0) return 0;
  // no noise and a black background, as JAX's experiment
  train_bwd_sm90<ABLATE><<<tiles < a.blocks ? tiles : a.blocks, CTA_THREADS, BwdSmem::BYTES, (cudaStream_t)a.stream>>>(
      (const float*)a.rays, (const float*)a.z, nullptr, (const unsigned char*)a.slabs, (const float*)a.b,
      (const float*)a.w_res, (const float*)a.a_res, (const float*)a.rgb_res, (const float*)a.g_rgb,
      (const float*)a.g_depth, (const float*)a.g_w, (float*)a.dsig_part, (unsigned char*)a.scratch, (float*)a.dw,
      (float*)a.db, a.n, a.s, a.new_act, 0);
  return (int)cudaGetLastError();
}

template <int RB>
static int launch_two_stream(const Args& a) {
  cudaError_t e = cudaFuncSetAttribute((const void*)two_stream_sm90<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       BwdSmem::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.n + RB - 1) / RB;
  if (tiles == 0) return 0;
  two_stream_sm90<RB><<<tiles < a.blocks ? tiles : a.blocks, CTA_THREADS, BwdSmem::BYTES, (cudaStream_t)a.stream>>>(
      (const float*)a.rays, (const float*)a.z, (const unsigned char*)a.slabs, (const float*)a.b, (const float*)a.w_res,
      (const float*)a.a_res, (const float*)a.rgb_res, (const float*)a.g_rgb, (const float*)a.g_depth,
      (const float*)a.g_w, (float*)a.dsig_part, (unsigned char*)a.scratch, (float*)a.dw, (float*)a.db, a.n, a.s,
      a.new_act);
  return (int)cudaGetLastError();
}

extern "C" {

// Variant ``variant`` (VARIANT_IDS; two_stream is base at 2 streams) at
// ``rays`` rays per tile and ``streams`` streams: 128 x 1 for base and the
// ablations, 64 x 2 and 32 x 2 for two_stream.  The production backward's
// inputs (no noise, black background; slabs: ops/sm90_layout.py::slab_buffer
// bf16) -> dw, db (packed layouts, f32), ADDED INTO: zero them first.
// dsig_part (n, s) f32 scratch; scratch holds ``blocks`` times
// exp_bwd_sm90_scratch_bytes(); at most ``blocks`` CTAs.  s must be even at
// 2 streams.  Returns the launch's cudaError_t, cudaErrorInvalidValue for a
// variant that is not built.
int exp_bwd_sm90(int variant, int rays, int streams, const void* rays_od, const void* z, const void* slabs,
                 const void* b, const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb,
                 const void* g_depth, const void* g_w, void* dsig_part, void* scratch, void* dw, void* db, int n,
                 int s, int blocks, int new_act, void* stream) {
  const Args a{rays_od, z, slabs, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w,
               dsig_part, scratch, dw, db, n, s, blocks, new_act, stream};
  if (streams == 2) {
    if (variant != V_BASE || s % 2 != 0) return (int)cudaErrorInvalidValue;
    if (rays == 64) return launch_two_stream<64>(a);
    if (rays == 32) return launch_two_stream<32>(a);
    return (int)cudaErrorInvalidValue;
  }
  if (streams != 1 || rays != RAYS) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case V_BASE: return launch_ablated<0>(a);
    case V_NO_DB: return launch_ablated<ABL_DB>(a);
    case V_NO_MASK: return launch_ablated<ABL_MASK>(a);
    case V_NO_DW: return launch_ablated<ABL_WGRAD | ABL_HEAD_DW>(a);
    case V_MXU_FLOOR: return launch_ablated<ABL_CONST_PE | ABL_MASK | ABL_DB>(a);
    case V_CHEAP_PE: return launch_ablated<ABL_CHEAP_PE>(a);
    case V_PE_PIPE: return launch_ablated<PIPE_PE>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory and global scratch of one CTA (every variant's), and the
// slab buffer's size in bf16 values: the wrapper holds them against
// ops/sm90_layout.py.
int exp_bwd_sm90_smem_bytes() { return BwdSmem::BYTES; }
long long exp_bwd_sm90_scratch_bytes() { return (long long)BWD_SCRATCH; }
int exp_bwd_sm90_slab_elems() { return SLAB_BUFFER_ELEMS; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
