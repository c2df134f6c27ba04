// The body of K3-bwd, the training render's backward, shared by the
// production kernel (fused_render_train.cu, whose note gives the design and
// the bound) and the experiment variants of X2 (exp_bwd_pipeline.cu).
//
// train_bwd_tiles<T> with its defaults is the production kernel: a block
// owns RB = TILE rays at a time, one MLP tile of P = TILE points per sample.
// The variants change it along three axes, each a template parameter:
//   NS       samples of a ray per MLP tile (two_stream: 2).  Stage A then
//            folds the ascending transmittance in as well, so that dsig_part
//            holds the full dL/dalpha and the samples of a ray carry nothing
//            from one to the next; a tile holds samples s and s + S/NS of
//            each of its RB rays, P = RB x NS points, and each weight read
//            and each dW flush serve NS times as many points.
//   Opt::Abl parts of the MLP backward removed on purpose (mlp_backward.cuh);
//   Opt::X   the layer-1 input: the sample's PE (exact), the constant 0.01
//            in all 64 columns (mxu_floor) or bf16(z 0.01) (cheap_pe);
//   Opt::PE_PIPE  a second PE buffer: sample s+1's PE is computed during
//            sample s's backward (after layer 8's bias sum) instead of
//            before its recompute.
#pragma once

#include "mlp_backward.cuh"
#include "render_level.cuh"

namespace nerf {

enum XInput { X_PE = 0, X_CONST = 1, X_CHEAP = 2 };

template <typename A = Exact, int XI = X_PE, bool PIPE = false>
struct BwdOptions {
  using Abl = A;
  static constexpr int X = XI;
  static constexpr bool PE_PIPE = PIPE;
};

// Per-block scratch in global memory: the kept activations [N_KEPT][P][Ld::A]
// in the compute dtype, the direction layer's f32 pre-activation [P][HALF]
// and the per-ray f32 sum of its delta [RB][HALF].
template <typename T, int P = TILE, int RB = P>
struct BwdScratch {
  static constexpr size_t KEPT = (size_t)N_KEPT * P * Ld<T>::A;
  static constexpr size_t BYTES = KEPT * sizeof(T) + (P + RB) * HALF * sizeof(float);
};

// Shared memory of the body: the backward's, and a second PE buffer
// [P][Ld::X] with PE_PIPE.
template <typename T, int P, bool PIPE>
constexpr size_t train_bwd_smem_bytes() {
  return bwd_smem_bytes<T, P>() + (PIPE ? sizeof(T) * P * Ld<T>::X : 0);
}

// The direction-PE block's input is constant along a ray: keep the f32 sum
// over samples of the cast direction delta per ray, for one product per ray
// tile.  Point p of the tile belongs to ray p % RB.
template <typename T, int P = TILE, int RB = P>
struct SumDirDelta {
  float* dad;  // [RB][HALF]
  __device__ void dir_delta(int e, T v) const {
    const int at = RB == P ? e : e / HALF % RB * HALF + e % HALF;
    dad[at] = __fadd_rn(dad[at], to_f(v));
  }
  __device__ void dir_done(const T*) const {}
  __device__ void trunk_delta(int, const T*) const {}
};

// SumDirDelta that also writes the PE of sample s (when s < S) into
// ``next`` once layer 8's delta is known: the PE pipeline's hook.
template <typename T, int P, int RB>
struct SumDirDeltaNextPe : SumDirDelta<T, P, RB> {
  Tile<T, P> t;
  T* next;
  const float* z;
  int ray0, n, S, s;
  __device__ void trunk_delta(int l, const T*) const {
    if (l == 8 && s < S) point_pe<T, P, RB>(t, next, z, ray0, n, S, s, 0);
  }
};

// c_s = dL/dw_s of one sample.
__device__ __forceinline__ float weight_cotangent(const float* __restrict__ rgb_s, float gr, float gg,
                                                  float gb, float gd, float zs, float gw, float gsum,
                                                  int white_back) {
  float c = __fadd_rn(__fadd_rn(__fmul_rn(gr, rgb_s[0]), __fmul_rn(gg, rgb_s[1])), __fmul_rn(gb, rgb_s[2]));
  c = __fadd_rn(__fadd_rn(c, __fmul_rn(gd, zs)), gw);
  return white_back ? __fsub_rn(c, gsum) : c;
}

// The layer-1 input of the ablations that replace the PE: every column of
// each point's row, the pad column too.
template <typename T, int P, int RB, int XI>
__device__ void fill_x(const Tile<T, P>& t, const float* __restrict__ z, int ray0, int n, int S, int s,
                       int stride) {
  for (int e = Grp<P>::tid(); e < P * XYZ_PAD; e += Grp<P>::THREADS) {
    const int p = e / XYZ_PAD, r = p % RB;
    float v = 0.01f;
    if (XI == X_CHEAP) v = __fmul_rn(ray0 + r < n ? z[(size_t)(ray0 + r) * S + s + p / RB * stride] : 1.f, 0.01f);
    t.xpe[p * Ld<T>::X + e % XYZ_PAD] = to_cd<T>(v);
  }
  Grp<P>::sync();
}

template <typename T, int RB = TILE, int NS = 1, typename Opt = BwdOptions<>>
__device__ void train_bwd_tiles(const float* __restrict__ rays, const float* __restrict__ z,
                                const float* __restrict__ noise, const T* __restrict__ W,
                                const float* __restrict__ B, const float* __restrict__ w_res,
                                const float* __restrict__ a_res, const float* __restrict__ rgb_res,
                                const float* __restrict__ g_rgb, const float* __restrict__ g_depth,
                                const float* __restrict__ g_w, float* dsig_part, unsigned char* scratch,
                                float* dW, float* dB, int n, int S, int new_act, int white_back,
                                unsigned char* smem) {
  constexpr int P = RB * NS;
  using G = Grp<P>;
  using Abl = typename Opt::Abl;
  using Scratch = BwdScratch<T, P, RB>;
  constexpr int LA = Ld<T>::A, LD = Ld<T>::D;
  const Tile<T, P> t = carve<T, P>(smem);
  T* const extra = reinterpret_cast<T*>(smem + tile_bytes<T, P>());  // the second delta tile
  float* const darg = reinterpret_cast<float*>(extra + P * LA);     // [P][3] cast da_rgb
  float* const gsig = darg + 3 * P;                                  // [P] cast dL/dsigma
  float* const rpre = gsig + P;                                      // [P][3] rgb pre-activation
  Tile<T, P> t_next = t;  // PE_PIPE: the tile with the other PE buffer
  if constexpr (Opt::PE_PIPE) t_next.xpe = reinterpret_cast<T*>(smem + bwd_smem_bytes<T, P>());

  unsigned char* const mine = scratch + (size_t)blockIdx.x * Scratch::BYTES;
  T* const kept = reinterpret_cast<T*>(mine);
  float* const dpre = reinterpret_cast<float*>(mine + Scratch::KEPT * sizeof(T));
  float* const dad = dpre + P * HALF;
  const Keep<T, P> keep{t.act, kept, dpre, rpre};

  const int tid = G::tid();
  const int steps = S / NS;  // MLP tiles per ray tile
  const int n_tiles = (n + RB - 1) / RB;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int ray0 = tile * RB;
    __syncthreads();  // the previous tile's readers of rays, dpe and dad are done
    const float dnorm = load_rays_and_dir_pe<T, P, RB>(t, rays, ray0, n);
    const int my = ray0 + tid;
    const bool live = tid < RB && my < n;
    float gr = 0.f, gg = 0.f, gb = 0.f, gd = 0.f, gsum = 0.f;
    if (live) {
      gr = g_rgb[(size_t)my * 3 + 0];
      gg = g_rgb[(size_t)my * 3 + 1];
      gb = g_rgb[(size_t)my * 3 + 2];
      gd = g_depth[my];
      gsum = __fadd_rn(__fadd_rn(gr, gg), gb);
      // stage A, downwards: -S_s / u_s with S_s the suffix sum of c_j w_j
      float suffix = 0.f;
      for (int s = S - 1; s >= 0; --s) {
        const size_t at = (size_t)my * S + s;
        const float c = weight_cotangent(rgb_res + at * 3, gr, gg, gb, gd, z[at], g_w[at], gsum, white_back);
        const float u = fmaxf(__fadd_rn(__fsub_rn(1.f, a_res[at]), 1e-10f), 1e-10f);
        dsig_part[at] = __fdiv_rn(-suffix, u);
        suffix = __fadd_rn(suffix, __fmul_rn(c, w_res[at]));
      }
      if constexpr (NS > 1) {  // and upwards: + c_s T_s, the full dL/dalpha_s
        float trans = 1.f;
        for (int s = 0; s < S; ++s) {
          const size_t at = (size_t)my * S + s;
          const float c = weight_cotangent(rgb_res + at * 3, gr, gg, gb, gd, z[at], g_w[at], gsum, white_back);
          dsig_part[at] = __fadd_rn(__fmul_rn(c, trans), dsig_part[at]);
          trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a_res[at]), 1e-10f));
        }
      }
    }
    for (int e = tid; e < RB * HALF; e += G::THREADS) dad[e] = 0.f;
    if constexpr (Opt::X == X_CONST) fill_x<T, P, RB, X_CONST>(t, z, ray0, n, S, 0, 0);
    if constexpr (Opt::PE_PIPE) {
      if (tid < P) t_next.xpe[tid * Ld<T>::X + XYZ_CH] = to_cd<T>(0.f);
      sample_pe<T, P, RB>(t, z, ray0, n, S, 0);
    }

    // stage B, upwards
    float trans = 1.f;
    for (int s = 0; s < steps; ++s) {
      const Tile<T, P>& ts = Opt::PE_PIPE && (s & 1) ? t_next : t;
      if constexpr (Opt::X == X_PE && !Opt::PE_PIPE) sample_pe<T, P, RB>(t, z, ray0, n, S, s, steps);
      if constexpr (Opt::X == X_CHEAP) fill_x<T, P, RB, X_CHEAP>(t, z, ray0, n, S, s, steps);
      mlp_tile<T, Keep<T, P>, false, G>(ts, W, B, new_act != 0, keep);
      if (tid < P) {
        float ds = 0.f, dr[3] = {0.f, 0.f, 0.f};
        if constexpr (NS == 1) {  // thread p is ray p: the transmittance rides in a register
          if (live) {
            const size_t at = (size_t)my * S + s;
            const float delta = interval(z + (size_t)my * S, S, s, dnorm);
            const float w_s = w_res[at], a_s = a_res[at];
            const float c = weight_cotangent(rgb_res + at * 3, gr, gg, gb, gd, z[at], g_w[at], gsum, white_back);
            const float da_alpha = __fadd_rn(__fmul_rn(c, trans), dsig_part[at]);
            float sig = t.sig[tid];
            if (noise != nullptr) sig = __fadd_rn(sig, noise[at]);
            if (sig > 0.f) ds = __fmul_rn(__fmul_rn(da_alpha, __fsub_rn(1.f, a_s)), delta);
            const float g3[3] = {gr, gg, gb};
            for (int ch = 0; ch < 3; ++ch)
              dr[ch] = __fmul_rn(__fmul_rn(w_s, g3[ch]), rgb_act_slope(rpre[tid * 3 + ch], new_act != 0));
            trans = __fmul_rn(trans, __fadd_rn(__fsub_rn(1.f, a_s), 1e-10f));
          }
        } else {  // point p is ray p % RB's sample s + (p / RB) steps; dsig_part is dL/dalpha
          const int ray = ray0 + tid % RB, sp = s + tid / RB * steps;
          if (ray < n) {
            const size_t at = (size_t)ray * S + sp;
            const float delta = interval(z + (size_t)ray * S, S, sp, dnorm);
            const float w_s = w_res[at], a_s = a_res[at];
            float sig = t.sig[tid];
            if (noise != nullptr) sig = __fadd_rn(sig, noise[at]);
            if (sig > 0.f) ds = __fmul_rn(__fmul_rn(dsig_part[at], __fsub_rn(1.f, a_s)), delta);
            for (int ch = 0; ch < 3; ++ch)
              dr[ch] = __fmul_rn(__fmul_rn(w_s, g_rgb[(size_t)ray * 3 + ch]),
                                 rgb_act_slope(rpre[tid * 3 + ch], new_act != 0));
          }
        }
        gsig[tid] = to_f(to_cd<T>(ds));
        for (int ch = 0; ch < 3; ++ch) darg[tid * 3 + ch] = to_f(to_cd<T>(dr[ch]));
      }
      G::sync();

      if constexpr (Opt::PE_PIPE) {
        const SumDirDeltaNextPe<T, P, RB> hooks{{dad}, ts, (s & 1 ? t : t_next).xpe, z, ray0, n, S, s + 1};
        mlp_backward_tile<T, Abl>(ts, extra, darg, gsig, W, kept, dpre, dW, dB, new_act != 0, hooks);
      } else {
        mlp_backward_tile<T, Abl>(ts, extra, darg, gsig, W, kept, dpre, dW, dB, new_act != 0,
                                  SumDirDelta<T, P, RB>{dad});
      }
    }

    // dwdx = (sum_s da_d)^T d_pe, one f32 product per ray tile
    for (int e = tid; e < HALF * DIR_PAD; e += G::THREADS) {
      const int o = e / DIR_PAD, c = e % DIR_PAD;
      float sum = 0.f;
      for (int p = 0; p < RB; ++p) sum = fmaf(dad[p * HALF + o], to_f(t.dpe[p * LD + c]), sum);
      atomicAdd(dW + WDX + e, sum);
    }
  }
}

}  // namespace nerf
