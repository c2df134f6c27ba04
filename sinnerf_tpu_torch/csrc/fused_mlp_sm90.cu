// K4 in bf16 on Hopper: the per-point MLP's forward and backward on the
// wgmma bodies of the bf16 training render (mlp_wgmma.cuh, and
// mlp_backward_wgmma.cuh for the backward): K3-fwd and K3-bwd bf16 at one
// sample per ray.
//
// Replaces, in bf16, fused_mlp.cu's mlp_fwd_kernel<bf16, ...> and
// mlp_bwd_kernel<bf16> (nvcuda::wmma on 64-point blocks, every block reading
// the whole weight set from global memory; the backward's input gradients as
// scalar FMA loops, one scalar atomic per dW element per 64 points), which
// stay built on no path for chip_smoke.py's timing rounds.  The TPU kernels
// they stand for are sinnerf_tpu/ops/fused_mlp_t.py::_kernel_t (:232, through
// _forward_t :255) and _bwd_kernel_t (:298, through _backward_t :436, PE
// adjoint _pe_bwd :160).  The function, its inputs, outputs and cast points
// are fused_mlp.cu's (see the note there).  Wrapper, plain versions and launch
// counters: ops/fused_mlp.py (launch_mlp_fwd, launch_mlp_bwd); slab order,
// scratch and launch plans: ops/sm90_layout.py (K4_SIGMA_SLABS,
// K4_BWD_SLABS, K4_BWD_SCRATCH, k4_fwd_launch_plan, k4_bwd_launch_plan).
//
// Bound: operations, 593,408 multiply-adds per point forward (1.19 MFLOP),
// 3 x 593,408 backward (recompute, dgrad with the input gradients, wgrad:
// 3.56 MFLOP), at the 989 TFLOP/s bf16 dense peak.
//
// K4-fwd (k4_fwd_sm90) is K4-bwd's recompute without keeping, on the
// forward's CTA (K3-fwd bf16's: two consumer warpgroups of 64 points, one
// producer warpgroup; shared memory FwdSmem, 3 ring stages, 205,824 bytes):
// persistent CTAs walk tiles of 128 consecutive points; per tile the points
// (as K4-bwd loads them), the recurrence PE of each point's xyz and of its
// own direction, mlp_pass with KeepNone, and [rgb_act(rgb_pre), sigma] of
// the points < n, each of a row's four threads storing one of the four
// values.  The producer streams the 39 slabs of FWD_SLABS per tile; the
// sigma-only pass (SIGMA_ONLY) runs layers 1..8 and the sigma head in its
// own loop (sigma_trunk: the rest of mlp_pass it does not run) over the
// first 30 slabs, w1 .. w8, and writes sigma: bit for bit the full pass's.
//
// K4-bwd (k4_bwd_sm90): a CTA is K3-bwd bf16's (shared memory BwdSmem,
// 222,208 bytes); persistent CTAs walk tiles of 128 consecutive points.  Per
// tile:
//   1. the points [xyz, dir] (zeros past n, and for null dirs: the
//      sigma-only case), the recurrence PE of each point's xyz and of its own
//      direction, then mlp_pass keeping h1..h8 and f in the CTA's scratch;
//   2. the head: gs = cast(g[3]), da_rgb = cast(g[0:3] act'(rgb_pre)), with
//      no sigma gate; the direction delta from the direction layer's
//      accumulators (dir_delta, its per-point f32 copy in scratch);
//   3. k4_layers: K3's wgrad, flush and dgrad per layer, and three more
//      one-slab MN-major dgrads (input_grad) over slabs K3 does not stream
//      (K4_BWD_SLABS): ddpe = da_d Wdx before the direction layer's dgrad
//      overwrites da_d, da5 W5x at layer 5 and + da1 W1 at layer 1 (dxpe),
//      f32 into scratch: no tile more in shared memory, which is full;
//   4. dwdx = da_d^T d_pe per point (K3's per-ray-tile f32 product, exact at
//      one sample), then the PE adjoints per (point, channel) into dxyz and
//      ddir.
// Points past n get zero cotangents and write nothing; the dW/db sums meet
// by atomics in an order that changes from run to run.
// Tested as the port's other kernels are: the CPU tests run the plain
// versions and pin the slab orders, the shared memory, the scratch and the
// launch plans (tests/test_torch_k4_sm90.py); on the card, python3
// chip_smoke.py builds, checks and times them.
#include "k4_fwd_sm90.cuh"
#include "mlp_backward_wgmma.cuh"

using namespace nerf;
using namespace nerf::k3;

// The slab walk of one tile's backward after its recompute's 39: the wdx
// slab (ddpe), the direction layer's and xyz_encoding_final's four each, w8,
// w7, w6, then the w5x slab (da5 W5x) before w5h's four, w4, w3, w2, and the
// w1 slab (da1 W1): indices into FWD_SLABS (ops/sm90_layout.py K4_BWD_SLABS).
constexpr int N_BWD_SLABS_K4 = N_BWD_SLABS + 3;
constexpr int W5X_SLAB = 17;  // w1's one slab, then four each of w2, w3, w4 and w5h
__host__ __device__ constexpr int k4_bwd_slab(int j) {
  return j == 0 ? N_FWD_SLABS - 1 : j <= 20 ? bwd_slab(j - 1) : j == 21 ? W5X_SLAB : j <= 37 ? bwd_slab(j - 2) : 0;
}

// Global scratch of one CTA (bytes): K3's (the 9 kept tiles, then da_d per
// point [RAYS][HALF] f32), then dxpe [RAYS][XYZ_PAD] and ddpe [RAYS][DIR_PAD]
// f32.
constexpr size_t K4_BWD_SCRATCH = BWD_SCRATCH + (size_t)RAYS * (XYZ_PAD + DIR_PAD) * sizeof(float);
static_assert(K4_BWD_SCRATCH == 704512, "K4 scratch must match ops/sm90_layout.py");

// out[p][c] (+)= sum_o D[p][o] W[o][c], c < C, for the warpgroup's rows p of
// D: W is the ring's next slab read as the MN-major B over KS 16-row steps
// (the dgrad of one slab), the f32 sums go to ``out`` ([RAYS][C], the CTA's
// global scratch).  An element is the same thread's in every call, so a call
// with ``add`` adds to an earlier call's result.
template <int KS, int C>
__device__ __forceinline__ void input_grad(Ring& ring, const Lane& ln, const unsigned char* D, float* out, bool add) {
  float acc[1][32];
  dgrad<KS, 1>(acc, ring, ln, D);
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float2* at = reinterpret_cast<float2*>(out + ln.row(i) * C + 8 * j + 2 * ln.q);
      float2 v = make_float2(acc[0][4 * j + 2 * i], acc[0][4 * j + 2 * i + 1]);
      if (add) {
        const float2 w = *at;
        v = make_float2(__fadd_rn(v.x, w.x), __fadd_rn(v.y, w.y));
      }
      *at = v;
    }
}

// Step 3 of K3-bwd bf16's note (its kernel, train_bwd_sm90, writes it out in
// its own body: called through a shared function it compiled to another
// stack frame) with K4's input gradients, from the direction delta in Y
// (every reader of d in X done) down through layer 1: every block's dW and db
// but wrgb's, wdx's and the heads' biases, and three one-slab dgrads over
// the slabs K3 does not stream: ddpe = da_d Wdx into ``ddp`` ([RAYS][DIR_PAD])
// before the direction layer's dgrad overwrites da_d, and dxpe = da5 W5x +
// da1 W1 into ``dxp`` ([RAYS][XYZ_PAD]), both f32 in the CTA's scratch.
template <int ABLATE>
__device__ __forceinline__ void k4_layers(Ring& ring, const Lane& ln, unsigned char* X, unsigned char* Y,
                                          const unsigned char* xpe, const unsigned char* kept, const float* gsig_s,
                                          const bf16* wsig, float* dW, float* dB, uint64_t* xbar, uint32_t& xphase,
                                          float* dxp, float* ddp) {
  constexpr bool do_flush = !(ABLATE & ABL_FLUSH);
  constexpr int WOFF[9] = {0, W1, W2, W3, W4, W5H, W6, W7, W8};
  constexpr int BOFF[9] = {0, B1, B2, B3, B4, B5, B6, B7, B8};
  // the direction layer: ddpe = da_d wdx, dwdh = da_d^T f, then df = da_d wdh
  float acc[4][32];
  input_grad<8, DIR_PAD>(ring, ln, Y, ddp, false);
  reload(X, kept + 8 * (size_t)ACT_BYTES, xbar, xphase);
  wgrad<256>(ln, Y, ln.g, X, dW + WDH, WIDTH, do_flush);
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
  for (int ch = 2 * ln.g; ch < 2 * ln.g + 2; ++ch) wgrad<256>(ln, Y, ch, X, dW + WFIN, WIDTH, do_flush);
  dgrad<16>(acc, ring, ln, Y);
  consumers_sync();
  dgrad_store(acc, ln, Y, EpiSigmaMaskTile{X, gsig_s, wsig});
  sm90::fence_proxy_async();
  consumers_sync();

  // the trunk, layers 8 down to 1: the delta of layer l is in Y
  for (int l = 8; l >= 1; --l) {
    bias_sum(Y, WIDTH, dB + BOFF[l]);
    if (l == 1) {
      for (int ch = 2 * ln.g; ch < 2 * ln.g + 2; ++ch) wgrad<64>(ln, Y, ch, xpe, dW + W1, XYZ_PAD, do_flush);
      input_grad<16, XYZ_PAD>(ring, ln, Y, dxp, true);  // + da1 W1
      break;
    }
    reload(X, kept + (size_t)(l - 2) * ACT_BYTES, xbar, xphase);  // h_{l-1}
    for (int ch = 2 * ln.g; ch < 2 * ln.g + 2; ++ch) {
      wgrad<256>(ln, Y, ch, X, dW + WOFF[l], WIDTH, do_flush);
      if (l == 5) wgrad<64>(ln, Y, ch, xpe, dW + W5X, XYZ_PAD, do_flush);
    }
    if (l == 5) input_grad<16, XYZ_PAD>(ring, ln, Y, dxp, false);  // da5 W5x
    dgrad<16>(acc, ring, ln, Y);
    consumers_sync();
    dgrad_store(acc, ln, Y, EpiMaskTile{X});
    sm90::fence_proxy_async();
    consumers_sync();
  }
}

template <int ABLATE>
__global__ void __launch_bounds__(CTA_THREADS, 1)
k4_bwd_sm90(const float* __restrict__ xyz, const float* __restrict__ dirs, const unsigned char* __restrict__ slabs,
            const float* __restrict__ B, const float* __restrict__ g, unsigned char* scratch, float* dW, float* dB,
            float* __restrict__ dxyz, float* __restrict__ ddir, int n, int new_act) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  using L = BwdSmem;
  float* rays_s = reinterpret_cast<float*>(sm + L::RAYS_F);  // [RAYS][6]: xyz, dir
  float* gsig_s = reinterpret_cast<float*>(sm + L::GSIG);
  float* darg_s = reinterpret_cast<float*>(sm + L::DARG);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + L::STAGES;
  uint64_t* xbar = empty + L::STAGES;
  init_bwd_barriers(full, empty, xbar);
  const int n_tiles = (n + RAYS - 1) / RAYS;

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMER_THREADS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        produce(slabs, sm + L::RING, full, empty, L::STAGES, it, N_FWD_SLABS, [](int j) { return j; });
        produce(slabs, sm + L::RING, full, empty, L::STAGES, it, N_BWD_SLABS_K4, [](int j) { return k4_bwd_slab(j); });
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
  unsigned char* const kept = scratch + (size_t)blockIdx.x * K4_BWD_SCRATCH;
  float* const dad = reinterpret_cast<float*>(kept + (size_t)N_KEPT * ACT_BYTES);
  float* const dxp = dad + RAYS * HALF;
  float* const ddp = dxp + RAYS * XYZ_PAD;
  uint32_t xphase = 0;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * RAYS;
    consumers_sync();  // the previous tile's readers of the points, X, dad, dxp and ddp are done
    for (int i = threadIdx.x; i < RAYS * 6; i += CONSUMER_THREADS) {  // [xyz, dir]; zeros past n and for null dirs
      const int p = i / 6, ch = i % 6;
      float v = 0.f;
      if (p0 + p < n) {
        if (ch < 3) v = xyz[(size_t)(p0 + p) * 3 + ch];
        else if (dirs != nullptr) v = dirs[(size_t)(p0 + p) * 3 + ch - 3];
      }
      rays_s[i] = v;
    }
    consumers_sync();

    // 1. recompute, keeping h1..h8 and f; the direction PE into Y
    dir_pe(ln, rays_s, Y);
    point_pe_sw(ln, rays_s, xpe);
    sm90::fence_proxy_async();
    ln.wg_sync();
    MlpOut o;
    mlp_pass(ring, ln, X, xpe, Y, heads, B, new_act != 0, KeepTiles{kept}, o);
    if (ln.leader()) sm90::bulk_wait();  // the kept tiles are in global memory

    // 2. the head: g = [d rgb, d sigma] per point, cast; zero past n
    float dr[2][3];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ln.row(i), p = p0 + r;
      float ds = 0.f, d3[3] = {0.f, 0.f, 0.f};
      if (p < n) {
        const float* gp = g + (size_t)p * 4;
        ds = gp[3];
        for (int ch = 0; ch < 3; ++ch) d3[ch] = __fmul_rn(gp[ch], rgb_act_slope(o.rpre[i][ch], new_act != 0));
      }
      const float gs = __bfloat162float(__float2bfloat16_rn(ds));
      for (int ch = 0; ch < 3; ++ch) dr[i][ch] = __bfloat162float(__float2bfloat16_rn(d3[ch]));
      if (ln.q == 0) {
        gsig_s[r] = gs;
        for (int ch = 0; ch < 3; ++ch) darg_s[r * 3 + ch] = dr[i][ch];
      }
    }
    dir_delta(ln, o, dr, B, wrgb, new_act != 0, Y, dad, true);
    sm90::fence_proxy_async();
    consumers_sync();  // da_d, d (in X), g_sig and da_rgb of every point
    head_grads(X, Y, darg_s, gsig_s, dW, dB);
    consumers_sync();  // every reader of d in X is done

    // 3. the layers with the input gradients into dxp and ddp
    k4_layers<ABLATE>(ring, ln, X, Y, xpe, kept, gsig_s, wsig, dW, dB, xbar, xphase, dxp, ddp);
    consumers_sync();  // every reader of xpe, X and Y is done

    // 4. dwdx per point, then the PE adjoints, one (point, channel) each
    dir_pe_wgrad(ln, rays_s, X, dad, dW);  // its barrier also makes dxp and ddp whole
    for (int e = threadIdx.x; e < RAYS * 3; e += CONSUMER_THREADS) {
      const int p = e / 3, ch = e % 3;
      if (p0 + p < n) {
        const size_t at = (size_t)(p0 + p) * 3 + ch;
        dxyz[at] = pe_adjoint<N_FREQS_XYZ>(rays_s[p * 6 + ch], ch, dxp + p * XYZ_PAD);
        if (ddir != nullptr) ddir[at] = pe_adjoint<N_FREQS_DIR>(rays_s[p * 6 + 3 + ch], ch, ddp + p * DIR_PAD);
      }
    }
  }
}

// ------------------------------------------------------------------ launches
template <int ABLATE>
static int launch_k4_bwd(const void* xyz, const void* dirs, const void* slabs, const void* b, const void* g, void* scratch,
                  void* dw, void* db, void* dxyz, void* ddir, int n, int blocks, int new_act, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute((const void*)k4_bwd_sm90<ABLATE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + RAYS - 1) / RAYS;
  if (tiles == 0) return 0;
  k4_bwd_sm90<ABLATE><<<tiles < blocks ? tiles : blocks, CTA_THREADS, BwdSmem::BYTES, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)dirs, (const unsigned char*)slabs, (const float*)b, (const float*)g,
      (unsigned char*)scratch, (float*)dw, (float*)db, (float*)dxyz, (float*)ddir, n, new_act);
  return (int)cudaGetLastError();
}

template <bool SIGMA_ONLY>
static int launch_k4_fwd(const void* xyz, const void* dirs, const void* slabs, const void* b, void* out, int n,
                         int blocks, int new_act, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute((const void*)k4_fwd_sm90<SIGMA_ONLY>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, FwdSmem::BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + RAYS - 1) / RAYS;
  if (tiles == 0) return 0;
  k4_fwd_sm90<SIGMA_ONLY><<<tiles < blocks ? tiles : blocks, CTA_THREADS, FwdSmem::BYTES, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)dirs, (const unsigned char*)slabs, (const float*)b, (float*)out, n, new_act);
  return (int)cudaGetLastError();
}

extern "C" {

// xyz (n, 3) f32; dirs (n, 3) f32, unread when sigma_only (may be null);
// slabs: ops/sm90_layout.py::slab_buffer (bf16); b packed f32 biases.
// Writes out (n, 4) [rgb, sigma] f32, or (n,) sigma when sigma_only.  At most
// ``blocks`` CTAs are launched.  Returns the launch's cudaError_t.
int k4_sm90_fwd(const void* xyz, const void* dirs, const void* slabs, const void* b, void* out, int n, int blocks,
                int sigma_only, int new_act, void* stream) {
  return sigma_only ? launch_k4_fwd<true>(xyz, nullptr, slabs, b, out, n, blocks, new_act, stream)
                    : launch_k4_fwd<false>(xyz, dirs, slabs, b, out, n, blocks, new_act, stream);
}


// xyz (n, 3) f32; dirs (n, 3) f32 or null (zero directions, the sigma-only
// case); slabs: ops/sm90_layout.py::slab_buffer (bf16); b packed f32
// biases; g (n, 4) f32 [d rgb, d sigma].  dw (packed weight layout) and db
// (packed bias layout), f32, are ADDED INTO: zero them first; dxyz (n, 3)
// and, unless null, ddir (n, 3) f32 are written.  scratch holds ``blocks``
// times k4_sm90_scratch_bytes(), and at most ``blocks`` CTAs are launched.
// Returns the launch's cudaError_t.
int k4_sm90_bwd(const void* xyz, const void* dirs, const void* slabs, const void* b, const void* g, void* scratch,
                void* dw, void* db, void* dxyz, void* ddir, int n, int blocks, int new_act, void* stream) {
  return launch_k4_bwd<0>(xyz, dirs, slabs, b, g, scratch, dw, db, dxyz, ddir, n, blocks, new_act, stream);
}

// k4_sm90_bwd without the weight gradients' reductions into dw (ABL_FLUSH,
// 1), for timing only: the gradients are then wrong.
int k4_sm90_bwd_ablated(const void* xyz, const void* dirs, const void* slabs, const void* b, const void* g,
                        void* scratch, void* dw, void* db, void* dxyz, void* ddir, int n, int blocks, int new_act,
                        int ablate, void* stream) {
  if (ablate != ABL_FLUSH) return (int)cudaErrorInvalidValue;
  return launch_k4_bwd<ABL_FLUSH>(xyz, dirs, slabs, b, g, scratch, dw, db, dxyz, ddir, n, blocks, new_act, stream);
}

// Shared memory of one CTA (the backward's, the forward's), global scratch
// of one CTA of the backward, the slab buffer's size in bf16 values, the
// backward's j-th slab (an index into the slab buffer's slabs; -1 past the
// last) and the slabs one tile of the forward streams (its j-th is slab j):
// the wrapper holds them against ops/sm90_layout.py.
int k4_sm90_smem_bytes() { return BwdSmem::BYTES; }
int k4_sm90_fwd_smem_bytes() { return FwdSmem::BYTES; }
int k4_sm90_fwd_slabs(int sigma_only) { return sigma_only ? N_SIGMA_SLABS : N_FWD_SLABS; }
long long k4_sm90_scratch_bytes() { return (long long)K4_BWD_SCRATCH; }
int k4_sm90_slab_elems() { return SLAB_BUFFER_ELEMS; }
int k4_sm90_bwd_slab(int j) { return j >= 0 && j < N_BWD_SLABS_K4 ? k4_bwd_slab(j) : -1; }

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
