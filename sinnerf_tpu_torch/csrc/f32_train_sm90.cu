// The float32 training kernels on Hopper: K3-fwd f32, K3-bwd f32, K4-fwd
// f32 and K4-bwd f32, FFMA in full float32 over weights streamed through
// shared memory by bulk copies.
//
// Replaces the float32 kernels of fused_render_train.cu (train_fwd_kernel
// and train_bwd_kernel <float>) and fused_mlp.cu (mlp_fwd_kernel<float> and
// mlp_bwd_kernel<float>) on the training paths; those stay built, on no
// path, for the alternating timing rounds of chip_smoke.py.  The TPU kernels
// they stand for are sinnerf_tpu/ops/fused_render_train_t.py::
// _train_fwd_kernel (:86, through _run_fwd :417) and _train_bwd_kernel (:164,
// through _frlt_bwd :509), and sinnerf_tpu/ops/fused_mlp_t.py::_kernel_t
// (:232, through _forward_t :255) and _bwd_kernel_t (:298, through
// _backward_t :436).  Wrappers, plain versions and launch counters:
// ops/fused_render_train.py (K3) and ops/fused_mlp.py (K4); the slab sets,
// scratch layout and launch plan: ops/sm90_layout.py.
//
// * K3-fwd f32 is render_f32_sm90<true> (render_f32_sm90.cuh): K1 f32 with
//   the sigma noise and the residuals alpha and rgb_s.  Bound: operations,
//   1.19 MFLOP per point.
// * K3-bwd f32 and K4-bwd f32 run mlp_backward_f32_sm90.cuh's body (its note
//   gives the design and the bound: 3.48 and 3.56 MFLOP per point).  K3-bwd
//   f32 recomputes with K3-fwd f32's own body, so its sigma gate and ReLU
//   masks are the forward's.
// * K4-fwd f32 is K4-bwd f32's recompute without keeping (recompute<0,
//   false>), so K4's forward and its backward's recompute are one body; the
//   sigma-only pass stops after the sigma head and streams the trunk's
//   slabs only.  Bound: operations, 1.19 MFLOP per point (the sigma-only
//   pass 0.98).
// All four refuse no shape: persistent CTAs walk tiles of 128 rays (K3) or
// points (K4); points and rays past n get zero cotangents and write nothing.
// Tested as the port's other kernels are: the CPU tests run the plain
// versions and pin the layouts (tests/test_torch_f32_bwd_sm90.py); on the
// card, python3 chip_smoke.py builds, checks and times them.
#include "mlp_backward_f32_sm90.cuh"

using namespace nerf;
using namespace nerf::f32b;

// The carved shared memory and the ring of a backward CTA.
struct BwdCta {
  float* act;
  float* pe;
  float* rays;
  float* sigp;
  float* rgbp;
  float* gsig;
  float* darg;
  float* trans;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit BwdCta(unsigned char* sm)
      : act(reinterpret_cast<float*>(sm + BwdSmem::ACT)), pe(reinterpret_cast<float*>(sm + BwdSmem::PE)),
        rays(reinterpret_cast<float*>(sm + BwdSmem::RAYS_F)), sigp(reinterpret_cast<float*>(sm + BwdSmem::SIGP)),
        rgbp(reinterpret_cast<float*>(sm + BwdSmem::RGBP)), gsig(reinterpret_cast<float*>(sm + BwdSmem::GSIG)),
        darg(reinterpret_cast<float*>(sm + BwdSmem::DARG)), trans(reinterpret_cast<float*>(sm + BwdSmem::TRANS)),
        full(reinterpret_cast<uint64_t*>(sm + BwdSmem::BARS)),
        empty(full + STAGES) {}
  // the f32 pre-activation of rgb channel c at point p, as the forward sums it
  __device__ float rgb_pre(int p, int c, const float* __restrict__ B) const {
    return __fadd_rn(__fadd_rn(rgbp[p * 3 + c], rgbp[(RAYS + p) * 3 + c]), B[BRGB + c]);
  }
  __device__ float sigma(int p, const float* __restrict__ B) const {
    return __fadd_rn(__fadd_rn(sigp[p], sigp[RAYS + p]), B[BSIG]);
  }
};

// One pass of the MLP over a tile from the sample PE in c.pe (synchronised):
// the backwards' recompute (KEEP: keeping what they read in ``mine``) and
// K4-fwd's pass (no keeping; LAST 8, the sigma-only pass, stops after the
// sigma head).  Leaves the direction layer's accumulators in ``dacc`` and the
// heads' partial sums visible to every consumer.
template <int ABLATE, bool KEEP = true, int LAST = 9>
__device__ __forceinline__ void recompute(float (&dacc)[8][8], Ring& ring, const Map& m, const BwdCta& c,
                                          const float* __restrict__ heads, const float* __restrict__ B, bool new_act,
                                          unsigned char* mine) {
  if constexpr (KEEP) {
    constexpr bool TILES = !(ABLATE & ABL_SCRATCH);
    if (TILES) store_xpe(c.pe, reinterpret_cast<float*>(mine + Scratch::XPE));
    mlp_trunk(ring, m, c.act, c.pe, c.rays, heads, B, c.sigp,
              KeepBwd<TILES>{reinterpret_cast<float*>(mine + Scratch::KEPT), reinterpret_cast<uint4*>(mine + Scratch::MASKS)});
  } else {
    mlp_trunk<f32s::KeepNone, LAST>(ring, m, c.act, c.pe, c.rays, heads, B, c.sigp);
  }
  if constexpr (LAST == 9) {
    dir_product(dacc, ring, m, c.act, c.pe);
    dir_epilogue(dacc, m, B + BD, new_act ? ACT_SSP : ACT_RELU, heads, c.rgbp);
  }
  consumers_sync();
}

// K4's points [p0, p0 + 128) into c.rays as [xyz, dir] (zeros past n and for
// null dirs) and the PE of their xyz into c.pe (row 63 zero), by all consumer
// threads (``tid``), synchronised.  The caller has synchronised the previous
// tile's readers.
__device__ __forceinline__ void load_points(const BwdCta& c, const float* __restrict__ xyz,
                                            const float* __restrict__ dirs, int p0, int n, int tid) {
  for (int i = tid; i < RAYS * 6; i += CONSUMERS) {
    const int p = i / 6, ch = i % 6;
    float v = 0.f;
    if (p0 + p < n) {
      if (ch < 3) v = xyz[(size_t)(p0 + p) * 3 + ch];
      else if (dirs != nullptr) v = dirs[(size_t)(p0 + p) * 3 + ch - 3];
    }
    c.rays[i] = v;
  }
  consumers_sync();
  for (int e = tid; e < RAYS * 3; e += CONSUMERS) pe_channel_k(c.rays[(e / 3) * 6 + e % 3], e % 3, N_FREQS_XYZ, c.pe, e / 3);
  if (tid < RAYS) c.pe[at(XYZ_CH, tid)] = 0.f;
  consumers_sync();
}

// ------------------------------------------------------------------- K3-bwd
template <int ABLATE>
__global__ void __launch_bounds__(CTA_THREADS, 1)
k3_bwd_f32_sm90(const float* __restrict__ rays, const float* __restrict__ z, const float* __restrict__ noise,
                const unsigned char* __restrict__ slabs, const float* __restrict__ W, const float* __restrict__ B,
                const float* __restrict__ w_res, const float* __restrict__ a_res, const float* __restrict__ rgb_res,
                const float* __restrict__ g_rgb, const float* __restrict__ g_depth, const float* __restrict__ g_w,
                float* dsig_part, unsigned char* scratch, float* dW, float* dB, int n, int S, int new_act,
                int white_back) {
  extern __shared__ __align__(16) unsigned char sm[];
  const BwdCta c(sm);
  init_ring(c.full, c.empty);
  const int n_tiles = (n + RAYS - 1) / RAYS;
  unsigned char* const mine = scratch + (size_t)blockIdx.x * Scratch::BYTES;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int s = 0; s < S; ++s) {
          produce_pass(slabs, sm + BwdSmem::RING, c.full, c.empty, it);
          produce_bwd<false, ABLATE>(mine, reinterpret_cast<const unsigned char*>(W), sm + BwdSmem::RING, c.full,
                                     c.empty, it);
        }
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const Map m;
  Ring ring{sm + BwdSmem::RING, c.full, c.empty};
  const float* heads = reinterpret_cast<const float*>(slabs + HEAD_OFF);
  // the CTA's scratch, recomputed where it is used (fresh: no register holds
  // it across the tile)
  const auto mine_now = [&] { return scratch + (size_t)fresh((int)blockIdx.x) * Scratch::BYTES; };
  const auto dad_now = [&] { return reinterpret_cast<float*>(mine_now() + Scratch::EXTRA); };  // [RAYS][HALF]

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray0 = tile * RAYS;
    consumers_sync();  // the previous tile's readers of the rays, pe and dad are done
    for (int i = fresh_tid(); i < RAYS * 6; i += CONSUMERS) {  // k3::load_rays, its indices computed per tile
      const int p = i / 6, ch = i % 6;
      c.rays[i] = ray0 + p < n ? rays[(size_t)(ray0 + p) * 6 + ch] : (ch == 5 ? 1.f : 0.f);
    }
    {
      const int my = ray0 + fresh_tid();
      if (threadIdx.x < RAYS && my < n) {  // stage A, downwards: -S_s / u_s with S_s the suffix sum of c_j w_j
        const float gr = g_rgb[(size_t)my * 3], gg = g_rgb[(size_t)my * 3 + 1], gb = g_rgb[(size_t)my * 3 + 2];
        const float gsum = __fadd_rn(__fadd_rn(gr, gg), gb);
        float suffix = 0.f;
        for (int s = S - 1; s >= 0; --s) {
          const size_t at = (size_t)my * S + s;
          const float cs = weight_cotangent(rgb_res + at * 3, gr, gg, gb, g_depth[my], z[at], g_w[at], gsum, white_back);
          const float u = fmaxf(__fadd_rn(__fsub_rn(1.f, a_res[at]), 1e-10f), 1e-10f);
          dsig_part[at] = __fdiv_rn(-suffix, u);
          suffix = __fadd_rn(suffix, __fmul_rn(cs, w_res[at]));
        }
      }
      if (threadIdx.x < RAYS) c.trans[threadIdx.x] = 1.f;
    }
    consumers_sync();

    for (int s = 0; s < S; ++s) {
      sample_pe<true>(c.rays, z, fresh(ray0), n, S, s, c.pe);  // its addresses: no register across the samples
      consumers_sync();
      float dacc[8][8];
      recompute<ABLATE>(dacc, ring, m, c, heads, B, new_act != 0, mine_now());
      const int tid = fresh_tid(), my = ray0 + tid;
      if (tid < RAYS) {  // the head: the gated dL/dsigma and da_rgb of ray tid (the per-ray state in shared
                         // memory or read again: no register lives across the layers)
        float ds = 0.f, d3[3] = {0.f, 0.f, 0.f};
        if (my < n) {
          const size_t at = (size_t)my * S + s;
          const float g3[3] = {g_rgb[(size_t)my * 3], g_rgb[(size_t)my * 3 + 1], g_rgb[(size_t)my * 3 + 2]};
          const float gsum = __fadd_rn(__fadd_rn(g3[0], g3[1]), g3[2]);
          const float delta = interval(z + (size_t)my * S, S, s, k3::ray_norm(c.rays, tid));
          const float w_s = w_res[at], a_s = a_res[at], trans = c.trans[tid];
          const float cs =
              weight_cotangent(rgb_res + at * 3, g3[0], g3[1], g3[2], g_depth[my], z[at], g_w[at], gsum, white_back);
          const float da_alpha = __fadd_rn(__fmul_rn(cs, trans), dsig_part[at]);
          float sig = c.sigma(tid, B);
          if (noise != nullptr) sig = __fadd_rn(sig, noise[at]);
          if (sig > 0.f) ds = __fmul_rn(__fmul_rn(da_alpha, __fsub_rn(1.f, a_s)), delta);
          for (int ch = 0; ch < 3; ++ch)
            d3[ch] = __fmul_rn(__fmul_rn(w_s, g3[ch]), rgb_act_slope(c.rgb_pre(tid, ch, B), new_act != 0));
          c.trans[tid] = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a_s), 1e-10f));
        }
        c.gsig[tid] = ds;
        for (int ch = 0; ch < 3; ++ch) c.darg[tid * 3 + ch] = d3[ch];
      }
      consumers_sync();
      dir_delta(dacc, m, B, heads, new_act != 0, c.darg, c.act, dW, dad_now(), s == 0);
      head_bias_sums(c.darg, c.gsig, dB);
      consumers_sync();  // da_d is whole
      unsigned char* const mine = mine_now();
      backward_layers<false, ABLATE>(ring, m, c.act, c.pe, c.gsig, reinterpret_cast<const float*>(mine + Scratch::KEPT),
                                     reinterpret_cast<const uint4*>(mine + Scratch::MASKS), W, heads + 3 * HALF, dW, dB,
                                     nullptr, nullptr);
    }

    // dwdx = (sum_s da_d)^T d_pe, one f32 product per ray tile; the direction
    // PE is in pe's rows 0..31 since the last sample's recompute
    consumers_sync();
    const float* dad = dad_now();
    dir_pe_wgrad([&](int o, int p) { return dad[p * HALF + o]; }, c.pe, dW);
  }
}

// ------------------------------------------------------------------- K4-bwd
__global__ void __launch_bounds__(CTA_THREADS, 1)
k4_bwd_f32_sm90(const float* __restrict__ xyz, const float* __restrict__ dirs, const unsigned char* __restrict__ slabs,
                const float* __restrict__ W, const float* __restrict__ B, const float* __restrict__ g,
                unsigned char* scratch, float* dW, float* dB, float* __restrict__ dxyz, float* __restrict__ ddir, int n,
                int new_act) {
  extern __shared__ __align__(16) unsigned char sm[];
  const BwdCta c(sm);
  init_ring(c.full, c.empty);
  const int n_tiles = (n + RAYS - 1) / RAYS;
  unsigned char* const mine = scratch + (size_t)blockIdx.x * Scratch::BYTES;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        produce_pass(slabs, sm + BwdSmem::RING, c.full, c.empty, it);
        produce_bwd<true, 0>(mine, reinterpret_cast<const unsigned char*>(W), sm + BwdSmem::RING, c.full, c.empty,
                             it);
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const Map m;
  Ring ring{sm + BwdSmem::RING, c.full, c.empty};
  const float* heads = reinterpret_cast<const float*>(slabs + HEAD_OFF);
  const uint4* masks = reinterpret_cast<const uint4*>(mine + Scratch::MASKS);
  const float* kept = reinterpret_cast<const float*>(mine + Scratch::KEPT);
  float* const dxp = reinterpret_cast<float*>(mine + Scratch::EXTRA);  // [RAYS][XYZ_PAD]: dxpe
  float* const ddp = dxp + RAYS * XYZ_PAD;                              // [RAYS][DIR_PAD]: ddpe
  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * RAYS;
    consumers_sync();  // the previous tile's readers of the rays, dxp and ddp are done
    load_points(c, xyz, dirs, p0, n, tid);
    float dacc[8][8];
    recompute<0>(dacc, ring, m, c, heads, B, new_act != 0, mine);
    if (tid < RAYS) {  // head cotangents: g = [d rgb, d sigma], zero past n
      const bool live = p0 + tid < n;
      const float* gp = g + (size_t)(p0 + tid) * 4;
      c.gsig[tid] = live ? gp[3] : 0.f;
      for (int ch = 0; ch < 3; ++ch)
        c.darg[tid * 3 + ch] = live ? __fmul_rn(gp[ch], rgb_act_slope(c.rgb_pre(tid, ch, B), new_act != 0)) : 0.f;
    }
    consumers_sync();
    dir_delta(dacc, m, B, heads, new_act != 0, c.darg, c.act, dW, nullptr, false);
    head_bias_sums(c.darg, c.gsig, dB);
    consumers_sync();  // da_d is whole
    backward_layers<true, 0>(ring, m, c.act, c.pe, c.gsig, kept, masks, W, heads + 3 * HALF, dW, dB, dxp, ddp);
    consumers_sync();  // dxp and ddp are whole
    for (int e = tid; e < RAYS * 3; e += CONSUMERS) {  // the PE adjoints, one (point, channel) each
      const int p = e / 3, ch = e % 3;
      if (p0 + p < n) {
        const size_t at = (size_t)(p0 + p) * 3 + ch;
        dxyz[at] = pe_adjoint<N_FREQS_XYZ>(c.rays[p * 6 + ch], ch, dxp + p * XYZ_PAD);
        if (ddir != nullptr) ddir[at] = pe_adjoint<N_FREQS_DIR>(c.rays[p * 6 + 3 + ch], ch, ddp + p * DIR_PAD);
      }
    }
  }
}

// ------------------------------------------------------------------- K4-fwd
// K4-bwd's recompute without keeping, then [rgb, sigma] per point (rgb =
// act(rgb_pre), sigma raw, as the heads sum them), or with SIGMA_ONLY the
// pass up to the sigma head (N_SIGMA_SLABS) and sigma alone.
template <bool SIGMA_ONLY>
__global__ void __launch_bounds__(CTA_THREADS, 1)
k4_fwd_f32_sm90(const float* __restrict__ xyz, const float* __restrict__ dirs, const unsigned char* __restrict__ slabs,
                const float* __restrict__ B, float* __restrict__ out, int n, int new_act) {
  extern __shared__ __align__(16) unsigned char sm[];
  const BwdCta c(sm);
  init_ring(c.full, c.empty);
  const int n_tiles = (n + RAYS - 1) / RAYS;

  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        produce_pass(slabs, sm + BwdSmem::RING, c.full, c.empty, it, SIGMA_ONLY ? N_SIGMA_SLABS : N_SLABS);
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const Map m;
  Ring ring{sm + BwdSmem::RING, c.full, c.empty};
  const float* heads = reinterpret_cast<const float*>(slabs + HEAD_OFF);
  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * RAYS, p = p0 + tid;
    consumers_sync();  // the previous tile's readers of the rays and the heads' sums are done
    load_points(c, xyz, SIGMA_ONLY ? nullptr : dirs, p0, n, tid);
    float dacc[8][8];
    recompute<0, false, SIGMA_ONLY ? 8 : 9>(dacc, ring, m, c, heads, B, new_act != 0, nullptr);
    if (tid < RAYS && p < n) {
      if (SIGMA_ONLY) {
        out[p] = c.sigma(tid, B);
      } else {
        for (int ch = 0; ch < 3; ++ch) out[(size_t)p * 4 + ch] = k3::rgb_act(c.rgb_pre(tid, ch, B), new_act != 0);
        out[(size_t)p * 4 + 3] = c.sigma(tid, B);
      }
    }
  }
}

// ------------------------------------------------------------------ launches
static int set_smem(const void* kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

static int grid_of(int n, int blocks) {
  const int tiles = (n + RAYS - 1) / RAYS;
  return tiles < blocks ? tiles : blocks;
}

template <int ABLATE>
static int launch_k3_bwd(const void* rays, const void* z, const void* noise, const void* slabs, const void* w,
                         const void* b, const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb,
                         const void* g_depth, const void* g_w, void* dsig_part, void* scratch, void* dw, void* db,
                         int n, int s, int blocks, int new_act, int white_back, void* stream) {
  int e = set_smem((const void*)k3_bwd_f32_sm90<ABLATE>, BwdSmem::BYTES);
  if (e) return e;
  const int grid = grid_of(n, blocks);
  if (grid == 0) return 0;
  k3_bwd_f32_sm90<ABLATE><<<grid, CTA_THREADS, BwdSmem::BYTES, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)z, (const float*)noise, (const unsigned char*)slabs, (const float*)w,
      (const float*)b, (const float*)w_res, (const float*)a_res, (const float*)rgb_res, (const float*)g_rgb,
      (const float*)g_depth, (const float*)g_w, (float*)dsig_part, (unsigned char*)scratch, (float*)dw, (float*)db, n,
      s, new_act, white_back);
  return (int)cudaGetLastError();
}

extern "C" {

// K3-fwd f32.  rays (n, 6) f32 [o, d]; z (n, s) f32 ascending; noise (n, s)
// f32 or null; slabs: ops/sm90_layout.py::slab_buffer_f32; b packed f32
// biases.  Writes rgb (n, 3), depth (n,), weights (n, s) and the residuals
// alpha (n, s) and rgb_s (n, s, 3), all f32, with at most ``blocks`` CTAs.
// Returns the launch's cudaError_t.
int k3_f32_fwd(const void* rays, const void* z, const void* noise, const void* slabs, const void* b, void* rgb,
               void* depth, void* weights, void* alpha, void* rgb_s, int n, int s, int blocks, int new_act,
               int white_back, void* stream) {
  int e = set_smem((const void*)render_f32_sm90<true>, Smem::BYTES);
  if (e) return e;
  const int grid = grid_of(n, blocks);
  if (grid == 0) return 0;
  render_f32_sm90<true><<<grid, CTA_THREADS, Smem::BYTES, (cudaStream_t)stream>>>(
      (const float*)rays, (const float*)z, (const float*)noise, (const unsigned char*)slabs, (const float*)b,
      (float*)rgb, (float*)depth, (float*)weights, (float*)alpha, (float*)rgb_s, n, s, new_act, white_back);
  return (int)cudaGetLastError();
}

// K3-bwd f32.  The forward's inputs and residuals (weights, alpha, rgb_s),
// the cotangents g_rgb (n, 3), g_depth (n,), g_w (n, s); slabs as for the
// forward and w, pack_weights' float32 buffer (the dgrad slabs are its
// rows).  dw (packed weight layout) and db (packed bias layout), f32, are
// ADDED INTO: zero them first.  dsig_part (n, s) f32 scratch; scratch holds
// ``blocks`` times f32_bwd_scratch_bytes().
int k3_f32_bwd(const void* rays, const void* z, const void* noise, const void* slabs, const void* w, const void* b,
               const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb, const void* g_depth,
               const void* g_w, void* dsig_part, void* scratch, void* dw, void* db, int n, int s, int blocks,
               int new_act, int white_back, void* stream) {
  return launch_k3_bwd<0>(rays, z, noise, slabs, w, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w, dsig_part, scratch,
                          dw, db, n, s, blocks, new_act, white_back, stream);
}

// k3_f32_bwd with one part removed on purpose, for timing only
// (mlp_backward_f32_sm90.cuh Ablate): ABL_FLUSH (1) skips the weight
// gradients' vector reductions into dw, ABL_SCRATCH (2) the kept tiles'
// stores and reads them all from one 64 KB region.  The gradients are then
// wrong.
int k3_f32_bwd_ablated(const void* rays, const void* z, const void* noise, const void* slabs, const void* w,
                       const void* b, const void* w_res, const void* a_res, const void* rgb_res, const void* g_rgb,
                       const void* g_depth, const void* g_w, void* dsig_part, void* scratch, void* dw, void* db, int n,
                       int s, int blocks, int new_act, int white_back, int ablate, void* stream) {
  switch (ablate) {
    case ABL_FLUSH:
      return launch_k3_bwd<ABL_FLUSH>(rays, z, noise, slabs, w, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w,
                                      dsig_part, scratch, dw, db, n, s, blocks, new_act, white_back, stream);
    case ABL_SCRATCH:
      return launch_k3_bwd<ABL_SCRATCH>(rays, z, noise, slabs, w, b, w_res, a_res, rgb_res, g_rgb, g_depth, g_w,
                                        dsig_part, scratch, dw, db, n, s, blocks, new_act, white_back, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K4-bwd f32.  xyz (n, 3) f32; dirs (n, 3) f32 or null (zero directions, the
// sigma-only case); slabs and w as for k3_f32_bwd; b packed f32 biases; g
// (n, 4) f32 [d rgb, d sigma].  dw and db are ADDED INTO; dxyz (n, 3) and,
// unless null, ddir (n, 3) f32 are written.  scratch holds ``blocks`` times
// f32_bwd_scratch_bytes().
int k4_f32_bwd(const void* xyz, const void* dirs, const void* slabs, const void* w, const void* b, const void* g,
               void* scratch, void* dw, void* db, void* dxyz, void* ddir, int n, int blocks, int new_act,
               void* stream) {
  int e = set_smem((const void*)k4_bwd_f32_sm90, BwdSmem::BYTES);
  if (e) return e;
  const int grid = grid_of(n, blocks);
  if (grid == 0) return 0;
  k4_bwd_f32_sm90<<<grid, CTA_THREADS, BwdSmem::BYTES, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)dirs, (const unsigned char*)slabs, (const float*)w, (const float*)b,
      (const float*)g, (unsigned char*)scratch, (float*)dw, (float*)db, (float*)dxyz, (float*)ddir, n, new_act);
  return (int)cudaGetLastError();
}

// K4-fwd f32.  xyz (n, 3) f32; dirs (n, 3) f32, unread when sigma_only;
// slabs as for k3_f32_fwd; b packed f32 biases.  Writes out (n, 4) [rgb,
// sigma] f32, or (n,) sigma when sigma_only, with at most ``blocks`` CTAs.
int k4_f32_fwd(const void* xyz, const void* dirs, const void* slabs, const void* b, void* out, int n, int blocks,
               int sigma_only, int new_act, void* stream) {
  const void* kernel = sigma_only ? (const void*)k4_fwd_f32_sm90<true> : (const void*)k4_fwd_f32_sm90<false>;
  int e = set_smem(kernel, BwdSmem::BYTES);
  if (e) return e;
  const int grid = grid_of(n, blocks);
  if (grid == 0) return 0;
  if (sigma_only)
    k4_fwd_f32_sm90<true><<<grid, CTA_THREADS, BwdSmem::BYTES, (cudaStream_t)stream>>>(
        (const float*)xyz, nullptr, (const unsigned char*)slabs, (const float*)b, (float*)out, n, new_act);
  else
    k4_fwd_f32_sm90<false><<<grid, CTA_THREADS, BwdSmem::BYTES, (cudaStream_t)stream>>>(
        (const float*)xyz, (const float*)dirs, (const unsigned char*)slabs, (const float*)b, (float*)out, n, new_act);
  return (int)cudaGetLastError();
}

// Shared memory of one CTA (bwd != 0: the backward's), global scratch of one
// backward CTA, the backward's slabs per tile (k4: K4's) and the forward
// slab buffer's size in floats: the wrapper holds them against
// ops/sm90_layout.py.
int f32_sm90_smem_bytes(int bwd) { return bwd ? BwdSmem::BYTES : Smem::BYTES; }
long long f32_bwd_scratch_bytes() { return (long long)Scratch::BYTES; }
int f32_bwd_slabs(int k4) { return k4 ? N_BWD_SLABS_K4 : N_BWD_SLABS_K3; }
// The slabs K4-fwd f32 streams per tile (sigma_only: up to the sigma head).
int k4_f32_fwd_slabs(int sigma_only) { return sigma_only ? N_SIGMA_SLABS : N_SLABS; }
int f32_slab_elems() { return SLAB_BUFFER_ELEMS; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
