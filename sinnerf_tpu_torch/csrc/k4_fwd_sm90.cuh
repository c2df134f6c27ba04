// K4-fwd bf16 on Hopper, k4_fwd_sm90 (launched by fused_mlp_sm90.cu, whose
// note describes it), and the per-point PE it shares with K4-bwd bf16: in a
// header so that the kernel experiment X1 (exp_kernel_variants_sm90.cu)
// launches the same kernel as its ``pe`` variant.
// Tested as the port's other kernels are: the CPU tests run their plain
// versions (tests/test_torch_k4_sm90.py pins the launch plans); on the card,
// python3 chip_smoke.py builds, checks and times them.
#pragma once

#include "render_level_sm90.cuh"

// In the global namespace, where fused_mlp_sm90.cu defined them before: the
// kernel keeps its symbol.
using namespace nerf;
using namespace nerf::k3;

// The recurrence PE of each of the warpgroup's points (rays [RAYS][6], xyz
// in its first three) into ``xpe`` (column 63 zero).  Unfenced.
__device__ __forceinline__ void point_pe_sw(const Lane& ln, const float* rays, unsigned char* xpe) {
  for (int e = ln.t; e < WG_ROWS * 3; e += 128) {
    const int r = ln.g * WG_ROWS + e / 3, c = e % 3;
    pe_channel_sw(rays[r * 6 + c], c, N_FREQS_XYZ, xpe, r);
  }
  if (ln.t < WG_ROWS)
    *reinterpret_cast<bf16*>(xpe + sw_off(ln.g * WG_ROWS + ln.t, XYZ_CH)) = __float2bfloat16_rn(0.f);
}

// The sigma-only pass stops after the sigma head: it streams the slabs of
// w1 .. w8, the first 30 of FWD_SLABS (ops/sm90_layout.py K4_SIGMA_SLABS).
constexpr int N_SIGMA_SLABS = 30;

// Layers 1..8 and the sigma head of mlp_pass, for the warpgroup's 64 points
// (xpe written and fenced by the caller): sig of the thread's two rows, as
// mlp_pass's layer 8 computes it.  Consumes N_SIGMA_SLABS slabs of the ring.
__device__ __forceinline__ void sigma_trunk(Ring& ring, const Lane& ln, unsigned char* act, const unsigned char* xpe,
                                            const bf16* __restrict__ wsig, const float* __restrict__ B,
                                            float (&sig)[2]) {
  const int rows = ln.g * WG_ROWS * ROW_BYTES;
  float acc[128];
  constexpr int BOFF[9] = {0, B1, B2, B3, B4, B5, B6, B7, B8};
  for (int l = 1; l <= 8; ++l) {
    if (l == 1) product<256>(acc, ring, ln, xpe + rows, 1, true);
    else product<256>(acc, ring, ln, act + rows, 4, true);
    if (l == 5) product<256>(acc, ring, ln, xpe + rows, 1, false);
    trunk_epilogue(acc, ln, act, B + BOFF[l], ACT_RELU, l == 8 ? wsig : nullptr, B[BSIG], sig);
    sm90::fence_proxy_async();
    ln.wg_sync();
  }
}

template <bool SIGMA_ONLY>
__global__ void __launch_bounds__(CTA_THREADS, 1)
k4_fwd_sm90(const float* __restrict__ xyz, const float* __restrict__ dirs, const unsigned char* __restrict__ slabs,
            const float* __restrict__ B, float* __restrict__ out, int n, int new_act) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = align_smem(smem_raw);
  using L = FwdSmem;
  float* rays_s = reinterpret_cast<float*>(sm + L::RAYS_F);  // [RAYS][6]: xyz, dir
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + L::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  const int n_tiles = (n + RAYS - 1) / RAYS;

  if (threadIdx.x >= CONSUMER_THREADS) {  // the producer warpgroup
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMER_THREADS) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        produce(slabs, sm + L::RING, full, empty, L::STAGES, it, SIGMA_ONLY ? N_SIGMA_SLABS : N_FWD_SLABS,
                [](int j) { return j; });
    }
    return;
  }
  sm90::setmaxnreg_inc<240>();
  const Lane ln;
  Ring ring{sm + L::RING, full, empty, L::STAGES};
  const bf16* heads = reinterpret_cast<const bf16*>(slabs + HEAD_OFF);
  unsigned char* act = sm + L::ACT;
  unsigned char* xpe = sm + L::XPE;
  unsigned char* dpe = sm + L::DPE;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int p0 = tile * RAYS;
    consumers_sync();  // the previous tile's readers of the points are done
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
    if (!SIGMA_ONLY) dir_pe(ln, rays_s, dpe);
    point_pe_sw(ln, rays_s, xpe);
    sm90::fence_proxy_async();
    ln.wg_sync();
    if (SIGMA_ONLY) {
      float sig[2];
      sigma_trunk(ring, ln, act, xpe, heads + 3 * HALF, B, sig);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = p0 + ln.row(i);
        if (p < n && ln.q == 0) out[p] = sig[i];
      }
    } else {
      MlpOut o;
      mlp_pass(ring, ln, act, xpe, dpe, heads, B, new_act != 0, KeepNone(), o);
      // [rgb, sigma] of the row: every thread of the row holds all four, the
      // row's thread q stores the q-th (four threads, 16 bytes in a row)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = p0 + ln.row(i);
        if (p >= n) continue;
        const float pre = ln.q == 0 ? o.rpre[i][0] : ln.q == 1 ? o.rpre[i][1] : o.rpre[i][2];  // no local array
        out[(size_t)p * 4 + ln.q] = ln.q == 3 ? o.sig[i] : rgb_act(pre, new_act != 0);
      }
    }
  }
}

