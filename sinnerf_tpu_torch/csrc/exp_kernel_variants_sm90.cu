// X1 on Hopper: the forward-kernel variants of K4-fwd bf16, on the
// production forward body (mlp_wgmma.cuh's mlp_pass, K4-fwd bf16's CTA).
//
// Replaces the TPU kernel of scripts/exp_kernel_variants.py::make_variant
// (:79, kernel :82-148, call :168), an experiment on the forward's design.
// The first port, exp_kernel_variants.cu (nerf_mlp.cuh's wmma body),
// stays built on no path for the timing rounds.  Wrapper, plain versions,
// launch counter and the experiment's entry point:
// sinnerf_tpu_torch/scripts/exp_kernel_variants.py.
//
// The grid's three axes (JAX's names), on the production CTA (two consumer
// warpgroups of 64 points, one producer warpgroup streaming the 39 weight
// slabs through a 3-stage ring; FwdSmem):
//   IN_PE    true: each point's PE formed in the kernel, as production
//            (point_pe_sw, dir_pe).  false: pre-encoded bf16 PE rows (the
//            port's interleaved order), laid out on the host as each tile's
//            swizzled XPE and DPE images (ops/sm90_layout.py's pattern), one
//            32 KB bulk copy per tile by the producer into the two adjacent
//            tiles, on a full/free mbarrier pair: the PE's cost stays
//            outside the kernel, as in JAX's base.
//   ILP      1: both warpgroups walk the ring in step (production).  2: the
//            warpgroups are offset (ping-pong): warpgroup 1 starts a layer's
//            products only after warpgroup 0 has finished that layer's
//            second slab (named barriers 4 and 5), so one's f32 epilogue (bias,
//            activation, cast, swizzled store) runs while the other's wgmmas
//            issue; the 3-stage ring, whose stages both must release, keeps
//            warpgroup 0 at most three slabs ahead.  4: four slices in
//            flight, two per warpgroup: the m64n256 accumulators (128
//            registers) do not double within 240 registers, so each
//            warpgroup runs a trunk layer's N = 256 as two m64n128 halves
//            (two accumulator arrays, each slab's halves two commit groups),
//            and after the last slab forms the first half's bias, activation
//            and cast in registers while the second half's wgmmas run
//            (stored to the tile once both are done, as the products read
//            it); with the offset of 2.
//   tile     128 points per weight byte read from L2 (production), or 256:
//            a 2-CTA cluster whose rank-0 producer multicasts each slab into
//            both CTAs' rings (cp.async.bulk ... .multicast::cluster); each
//            stage's empty barrier on rank 0 takes the releases of all four
//            consumer warpgroups (rank 1's by remote arrivals), rank 1's
//            producer only posts each stage's expected bytes.  The partners
//            walk tile pairs (2 c, 2 c + 1, ...): both run every pair, the
//            second CTA of an odd count's last pair a tile past the points
//            (no store), and rank 0's producer waits for the last releases
//            before it exits.  A 256-point CTA does not fit: a 256 x 256
//            activation tile and the ring exceed 227 KB.
// <true, 1, 128> (pe) is production K4-fwd bf16 itself, k4_fwd_sm90<false>
// (k4_fwd_sm90.cuh).  The tail of the last tile is masked (JAX's grid drops
// it).  Every variant rounds as production does: with the same PE rows the
// outputs are equal bit for bit.
//
// Bound: operations, 593,408 multiply-adds per point (1.19 MFLOP), as
// K4-fwd: 10.07 ms for 8,388,608 points at 989 TFLOP/s.  The bytes (24 or
// 256 per point in, 16 out) need 0.7 ms at 3.35 TB/s.
#include "k4_fwd_sm90.cuh"

// ------------------------------------------------------------ the cluster
// The consumer side of the ring in a 2-CTA cluster: a stage is released on
// the CTA's own empty barrier and, from rank 1, on rank 0's (which takes four
// arrivals: its producer is the one that overwrites both CTAs' stage).
struct ClusterRing : Ring {
  uint32_t rank;
  __device__ void release(const Lane& ln) {
    if (ln.leader()) {
      sm90::mbar_arrive(&empty[it % n_stages]);
      if (rank == 1) sm90::mbar_arrive_cluster(&empty[it % n_stages], 0);
    }
    ++it;
  }
};

// The producer of a 2-CTA cluster: rank 0 multicasts ``count`` slabs into
// both CTAs (once all four warpgroups released the stage), rank 1 posts the
// bytes each of its stages expects (once its own warpgroups released it).
__device__ void produce_cluster(uint32_t rank, const unsigned char* __restrict__ slabs, unsigned char* stages,
                                uint64_t* full, uint64_t* empty, int n_stages, uint32_t& it, int count) {
  for (int j = 0; j < count; ++j, ++it) {
    const int s = it % n_stages;
    sm90::mbar_wait(&empty[s], ((it / n_stages) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&full[s], slab_bytes(j));
    if (rank == 0)
      sm90::bulk_load_multicast(stages + s * STAGE_BYTES, slabs + slab_offset(j), slab_bytes(j), &full[s], 3);
  }
}

// ------------------------------------------------------------- the body
// Named barriers 1-3 are mlp_wgmma.cuh's.  The offset's signals alternate
// between two, layer by layer (ten layers a pass): warpgroup 0 cannot signal
// twice on one before warpgroup 1 has waited on it, since the ring keeps it
// within three slabs of warpgroup 1 and every layer but the first has four.
constexpr int PINGPONG_BAR = 4;

// A layer's start under ILP >= 2: warpgroup 1 waits for warpgroup 0's signal
// of that layer (the ``layer``-th of the pass).
template <int ILP>
__device__ __forceinline__ void layer_turn(const Lane& ln, int layer) {
  if constexpr (ILP >= 2)
    if (ln.g == 1) sm90::named_sync(PINGPONG_BAR + (layer & 1), CONSUMER_THREADS);
}

__device__ __forceinline__ void layer_signal(const Lane& ln, int layer) {
  if (ln.g == 0) sm90::named_arrive(PINGPONG_BAR + (layer & 1), CONSUMER_THREADS);
}

// mlp_wgmma.cuh's product with the ILP hook: warpgroup 0 signals layer
// ``layer`` after slab ``signal_after`` (-1: none).
template <int N, typename R>
__device__ __forceinline__ void product_x1(float (&acc)[N / 2], R& ring, const Lane& ln, const unsigned char* a,
                                           int slabs, bool first, int ks_last, int layer, int signal_after) {
  for (int j = 0; j < slabs; ++j) {
    const unsigned char* w = ring.wait();
    const int ks = j == slabs - 1 ? ks_last : 4;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < ks)
        mma_kk<N>(acc, sm90::desc_sw128(a + j * ACT_BLOCK + 32 * k, 0, 1024), sm90::desc_sw128(w + 32 * k, 0, 1024),
                  (first && j == 0 && k == 0) ? 0 : 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    ring.release(ln);
    if (j == signal_after) layer_signal(ln, layer);
  }
}

// ILP 4: a trunk layer's products (N = 256) as two m64n128 halves, acc0 the
// outputs 0-127 and acc1 128-255, each slab's halves as two commit groups.
// With LAST the call returns after the last slab's first half is done and
// its second still in flight (the slab unreleased): split_epilogue finishes.
template <bool LAST, typename R>
__device__ __forceinline__ void product_halves(float (&acc0)[64], float (&acc1)[64], R& ring, const Lane& ln,
                                               const unsigned char* a, int slabs, bool first, int layer,
                                               int signal_after) {
  for (int j = 0; j < slabs; ++j) {
    const unsigned char* w = ring.wait();
    sm90::fence_regs(acc0);
    sm90::fence_regs(acc1);
    sm90::wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sm90::mma_m64n128<0, 0>(acc0, sm90::desc_sw128(a + j * ACT_BLOCK + 32 * k, 0, 1024),
                              sm90::desc_sw128(w + 32 * k, 0, 1024), (first && j == 0 && k == 0) ? 0 : 1);
    sm90::wgmma_commit();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sm90::mma_m64n128<0, 0>(acc1, sm90::desc_sw128(a + j * ACT_BLOCK + 32 * k, 0, 1024),
                              sm90::desc_sw128(w + 128 * ROW_BYTES + 32 * k, 0, 1024),
                              (first && j == 0 && k == 0) ? 0 : 1);
    sm90::wgmma_commit();
    if (LAST && j == slabs - 1) {
      sm90::wgmma_wait<1>();
      sm90::fence_regs(acc0);
    } else {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      ring.release(ln);
    }
    if (j == signal_after) layer_signal(ln, layer);
  }
}

// trunk_epilogue after product_halves<true>: the first half's bias,
// activation and cast in registers while the second half's wgmmas run, then
// both stored, the sigma head summed in trunk_epilogue's order.
template <typename R>
__device__ __forceinline__ void split_epilogue(const float (&acc0)[64], float (&acc1)[64], R& ring, const Lane& ln,
                                               unsigned char* tile, const float* __restrict__ bias, int act,
                                               const bf16* wsig, float bsig, float* sig) {
  __nv_bfloat162 h[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * ln.q));
#pragma unroll
    for (int i = 0; i < 2; ++i)
      h[j][i] = __floats2bfloat162_rn(epilogue(__fadd_rn(acc0[4 * j + 2 * i], b.x), act),
                                      epilogue(__fadd_rn(acc0[4 * j + 2 * i + 1], b.y), act));
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc1);
  ring.release(ln);
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int c = 8 * j + 2 * ln.q;
    float w0 = 0.f, w1 = 0.f;
    if (wsig) {
      w0 = to_f(wsig[c]);
      w1 = to_f(wsig[c + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      __nv_bfloat162 v;
      if (j < 16) {
        v = h[j][i];
        *reinterpret_cast<__nv_bfloat162*>(tile + sw_off(ln.row(i), c)) = v;
      } else {
        const int k = 4 * (j - 16) + 2 * i;
        v = store_act(tile, ln.row(i), c, acc1[k], acc1[k + 1], bias, act);
      }
      if (wsig) {
        s[i] = fmaf(__low2float(v), w0, s[i]);
        s[i] = fmaf(__high2float(v), w1, s[i]);
      }
    }
  }
  if (wsig) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v = s[i];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      sig[i] = __fadd_rn(v, bsig);
    }
  }
}

// mlp_pass (KeepNone) with the ILP hooks: the same products, epilogues and
// heads in the same order, so the outputs round as production's.
template <int ILP, typename R>
__device__ __forceinline__ void mlp_pass_x1(R& ring, const Lane& ln, unsigned char* act, const unsigned char* xpe,
                                            const unsigned char* dpe, const bf16* __restrict__ heads,
                                            const float* __restrict__ B, bool new_act, MlpOut& out) {
  const int rows = ln.g * WG_ROWS * ROW_BYTES;
  constexpr int BOFF[10] = {0, B1, B2, B3, B4, B5, B6, B7, B8, BFIN};
  constexpr int SIG = ILP >= 2 ? 1 : -1;  // warpgroup 0 signals after a layer's second slab
  const bf16* wrgb = heads;
  const bf16* wsig = heads + 3 * HALF;
  for (int l = 1; l <= 9; ++l) {
    layer_turn<ILP>(ln, l - 1);
    const int act_fn = l == 9 ? ACT_NONE : ACT_RELU;
    if constexpr (ILP == 4) {
      float acc0[64], acc1[64];
      if (l == 1) {
        product_halves<true>(acc0, acc1, ring, ln, xpe + rows, 1, true, 0, 0);
      } else if (l == 5) {
        product_halves<false>(acc0, acc1, ring, ln, act + rows, 4, true, 4, SIG);
        product_halves<true>(acc0, acc1, ring, ln, xpe + rows, 1, false, 4, -1);
      } else {
        product_halves<true>(acc0, acc1, ring, ln, act + rows, 4, true, l - 1, SIG);
      }
      split_epilogue(acc0, acc1, ring, ln, act, B + BOFF[l], act_fn, l == 8 ? wsig : nullptr, B[BSIG], out.sig);
    } else {
      float acc[128];
      if (l == 1) product_x1<256>(acc, ring, ln, xpe + rows, 1, true, 4, 0, ILP >= 2 ? 0 : -1);
      else product_x1<256>(acc, ring, ln, act + rows, 4, true, 4, l - 1, SIG);
      if (l == 5) product_x1<256>(acc, ring, ln, xpe + rows, 1, false, 4, 4, -1);
      trunk_epilogue(acc, ln, act, B + BOFF[l], act_fn, l == 8 ? wsig : nullptr, B[BSIG], out.sig);
    }
    sm90::fence_proxy_async();
    ln.wg_sync();
  }
  // the direction layer: f (K = 256) and the direction PE (32 columns)
  layer_turn<ILP>(ln, 9);
  product_x1<128>(out.dacc, ring, ln, act + rows, 4, true, 4, 9, SIG);
  product_x1<128>(out.dacc, ring, ln, dpe + rows, 1, false, 2, 9, -1);
  float s[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * ln.q;
    float w[3][2];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      w[ch][0] = to_f(wrgb[ch * HALF + c]);
      w[ch][1] = to_f(wrgb[ch * HALF + c + 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 h = store_act(act, ln.row(i), c, out.dacc[4 * j + 2 * i], out.dacc[4 * j + 2 * i + 1],
                                         B + BD, new_act ? ACT_SSP : ACT_RELU);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        s[i][ch] = fmaf(__low2float(h), w[ch][0], s[i][ch]);
        s[i][ch] = fmaf(__high2float(h), w[ch][1], s[i][ch]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float v = s[i][ch];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      out.rpre[i][ch] = __fadd_rn(v, B[BRGB + ch]);
    }
  sm90::fence_proxy_async();
  ln.wg_sync();
}

template <bool IN_PE, int ILP, bool CLUSTER>
__global__ void __launch_bounds__(CTA_THREADS, 1)
x1_fwd_sm90(const float* __restrict__ xyz, const float* __restrict__ dirs, const unsigned char* __restrict__ pe_tiles,
            const unsigned char* __restrict__ slabs, const float* __restrict__ B, float* __restrict__ out, int n,
            int new_act) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  using L = FwdSmem;
  float* rays_s = reinterpret_cast<float*>(sm + L::RAYS_F);  // [RAYS][6]: xyz, dir
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + L::STAGES;
  uint64_t* pe_full = empty + L::STAGES;
  uint64_t* pe_free = pe_full + 1;
  const uint32_t rank = CLUSTER ? sm90::cluster_rank() : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CLUSTER && rank == 0 ? 4 : 2);
    }
    sm90::mbar_init(pe_full, 1);
    sm90::mbar_init(pe_free, 2);
    sm90::mbar_fence_init();
  }
  if constexpr (CLUSTER) sm90::cluster_sync();  // the partner's barriers exist before any arrival or copy
  else __syncthreads();
  const int n_tiles = (n + RAYS - 1) / RAYS;
  // the tile walk: one tile apart per CTA, or pairs of tiles per cluster
  const int first = CLUSTER ? 2 * (int)(blockIdx.x / 2) + (int)rank : (int)blockIdx.x;
  const int step = CLUSTER ? 2 * (int)(gridDim.x / 2) : (int)gridDim.x;
  const int lead = CLUSTER ? (int)rank : 0;  // tile - lead is the pair's first tile

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMER_THREADS) {
      uint32_t it = 0, pe_it = 0;
      for (int tile = first; tile - lead < n_tiles; tile += step) {
        if constexpr (!IN_PE) {
          sm90::mbar_wait(pe_free, (pe_it++ & 1) ^ 1);
          sm90::mbar_arrive_expect_tx(pe_full, 2 * PE_BYTES);
          sm90::bulk_load(sm + L::XPE, pe_tiles + (size_t)tile * 2 * PE_BYTES, 2 * PE_BYTES, pe_full);
        }
        if constexpr (CLUSTER) produce_cluster(rank, slabs, sm + L::RING, full, empty, L::STAGES, it, N_FWD_SLABS);
        else produce(slabs, sm + L::RING, full, empty, L::STAGES, it, N_FWD_SLABS, [](int j) { return j; });
      }
      if (CLUSTER && rank == 0)  // every warpgroup of both CTAs has released its last slabs
        for (int j = 0; j < L::STAGES; ++j, ++it) sm90::mbar_wait(&empty[it % L::STAGES], ((it / L::STAGES) & 1) ^ 1);
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const Lane ln;
  using R = typename std::conditional<CLUSTER, ClusterRing, Ring>::type;
  R ring;
  ring.stages = sm + L::RING;
  ring.full = full;
  ring.empty = empty;
  ring.n_stages = L::STAGES;
  if constexpr (CLUSTER) ring.rank = rank;
  const bf16* heads = reinterpret_cast<const bf16*>(slabs + HEAD_OFF);
  unsigned char* act = sm + L::ACT;
  unsigned char* xpe = sm + L::XPE;
  unsigned char* dpe = sm + L::DPE;
  uint32_t pe_phase = 0;

  for (int tile = first; tile - lead < n_tiles; tile += step) {
    const int p0 = tile * RAYS;
    if constexpr (IN_PE) {
      // the warpgroup's points [xyz, dir] (zeros past n), then their PE
      for (int i = ln.t; i < WG_ROWS * 6; i += 128) {
        const int p = ln.g * WG_ROWS + i / 6, ch = i % 6;
        float v = 0.f;
        if (p0 + p < n) v = ch < 3 ? xyz[(size_t)(p0 + p) * 3 + ch] : dirs[(size_t)(p0 + p) * 3 + ch - 3];
        rays_s[p * 6 + ch] = v;
      }
      ln.wg_sync();
      dir_pe(ln, rays_s, dpe);
      point_pe_sw(ln, rays_s, xpe);
      sm90::fence_proxy_async();
      ln.wg_sync();
    } else {
      sm90::mbar_wait(pe_full, pe_phase);
      pe_phase ^= 1;
    }
    MlpOut o;
    mlp_pass_x1<ILP>(ring, ln, act, xpe, dpe, heads, B, new_act != 0, o);
    if constexpr (!IN_PE)
      if (ln.leader()) sm90::mbar_arrive(pe_free);  // the warpgroup's products have read its PE rows
    // [rgb, sigma] of the row, as k4_fwd_sm90 stores them
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = p0 + ln.row(i);
      if (p >= n) continue;
      const float pre = ln.q == 0 ? o.rpre[i][0] : ln.q == 1 ? o.rpre[i][1] : o.rpre[i][2];
      out[(size_t)p * 4 + ln.q] = ln.q == 3 ? o.sig[i] : rgb_act(pre, new_act != 0);
    }
  }
}

// ------------------------------------------------------------------ launches
template <bool IN_PE, int ILP, bool CLUSTER>
static int launch_x1(const void* xyz, const void* dirs, const void* pe_tiles, const void* slabs, const void* b,
                     void* out, int n, int blocks, int new_act, void* stream) {
  const void* kernel = (const void*)x1_fwd_sm90<IN_PE, ILP, CLUSTER>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + RAYS - 1) / RAYS;
  if (tiles == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.blockDim = dim3(CTA_THREADS);
  cfg.dynamicSmemBytes = FwdSmem::BYTES;
  cfg.stream = (cudaStream_t)stream;
  if (CLUSTER) {
    const int pairs = (tiles + 1) / 2, clusters = blocks / 2;
    if (clusters < 1) return (int)cudaErrorInvalidValue;
    cfg.gridDim = dim3(2 * (pairs < clusters ? pairs : clusters));
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  } else {
    cfg.gridDim = dim3(tiles < blocks ? tiles : blocks);
  }
  e = cudaLaunchKernelEx(&cfg, x1_fwd_sm90<IN_PE, ILP, CLUSTER>, (const float*)xyz, (const float*)dirs,
                         (const unsigned char*)pe_tiles, (const unsigned char*)slabs, (const float*)b, (float*)out, n,
                         new_act);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// One variant of the grid (JAX's names): base <false, 1, 128>, ilp2
// <false, 2, 128>, pe <true, 1, 128> (production K4-fwd bf16), pe_ilp2
// <true, 2, 128>, pe_ilp4 <true, 4, 128>, pe_ilp2_t2x <true, 2, 256>.
// in_pe: xyz, dirs (n, 3) f32; else pe_tiles, each 128-point tile's
// swizzled XPE and DPE images (2 x 16 KB; scripts/exp_kernel_variants.py
// pe_tiles).  slabs: ops/sm90_layout.py::slab_buffer (bf16); b packed f32
// biases.  Writes out (n, 4) [rgb, sigma] f32 with at most ``blocks`` CTAs
// (t2x: blocks / 2 clusters of 2).  Returns the launch's cudaError_t,
// cudaErrorInvalidValue for a variant that is not built.
int exp_x1_sm90(int in_pe, int ilp, int tile, const void* xyz, const void* dirs, const void* pe_tiles,
                const void* slabs, const void* b, void* out, int n, int blocks, int new_act, void* stream) {
  const int key = (in_pe ? 1000 : 0) + ilp * 100 + tile / 128;
  switch (key) {
    case 1101: {  // production K4-fwd bf16
      const cudaError_t e = cudaFuncSetAttribute((const void*)k4_fwd_sm90<false>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem::BYTES);
      if (e != cudaSuccess) return (int)e;
      const int tiles = (n + RAYS - 1) / RAYS;
      if (tiles == 0) return 0;
      k4_fwd_sm90<false><<<tiles < blocks ? tiles : blocks, CTA_THREADS, FwdSmem::BYTES, (cudaStream_t)stream>>>(
          (const float*)xyz, (const float*)dirs, (const unsigned char*)slabs, (const float*)b, (float*)out, n,
          new_act);
      return (int)cudaGetLastError();
    }
    case 101: return launch_x1<false, 1, false>(xyz, dirs, pe_tiles, slabs, b, out, n, blocks, new_act, stream);
    case 201: return launch_x1<false, 2, false>(xyz, dirs, pe_tiles, slabs, b, out, n, blocks, new_act, stream);
    case 1201: return launch_x1<true, 2, false>(xyz, dirs, pe_tiles, slabs, b, out, n, blocks, new_act, stream);
    case 1401: return launch_x1<true, 4, false>(xyz, dirs, pe_tiles, slabs, b, out, n, blocks, new_act, stream);
    case 1202: return launch_x1<true, 2, true>(xyz, dirs, pe_tiles, slabs, b, out, n, blocks, new_act, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The most 2-CTA clusters of pe_ilp2_t2x that the card runs at once (0 on
// an error): the wrapper's launch plan takes no more.
int exp_x1_sm90_max_clusters() {
  const void* kernel = (const void*)x1_fwd_sm90<true, 2, true>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem::BYTES) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(CTA_THREADS);
  cfg.dynamicSmemBytes = FwdSmem::BYTES;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) return 0;
  return clusters;
}

// Shared memory of one CTA (every variant's: K4-fwd bf16's) and the slab
// buffer's size in bf16 values: the wrapper holds them against
// ops/sm90_layout.py.
int exp_x1_sm90_smem_bytes() { return FwdSmem::BYTES; }
int exp_x1_sm90_slab_elems() { return SLAB_BUFFER_ELEMS; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
