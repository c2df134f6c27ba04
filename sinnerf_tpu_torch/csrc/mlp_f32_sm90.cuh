// The forward NeRF MLP on Hopper's CUDA cores in full float32: the body of
// the redesigned float32 eval render (K1 f32, fused_render_sm90.cu).
//
// Replaces, for K1 in float32, the float32 body of nerf_mlp.cuh (gemm_f32 /
// layer_f32), which K3-fwd f32, K4 and the experiment kernels keep.  There,
// for every 16 weight columns the whole block reads the slab with scalar
// __ldg, transposes it into shared memory and meets at two __syncthreads, and
// per k step a warp issues 16 scalar shared loads for 64 FFMA: shared-memory
// issue bound.  The TPU body it stands for is
// sinnerf_tpu/ops/fused_mlp_t.py::mlp_from_pe (:189) with _pe_fwd (:135).
//
// Precision: FFMA in float32 on the CUDA cores, cuBLAS's "highest"; no TF32.
// Bound: operations, 593,408 multiply-adds per point at the 67 TFLOP/s f32
// peak (128 FFMA per clock per SM).
//
// A CTA runs a tile of RAYS = 128 points (one sample of 128 rays) with three
// warpgroups: two consumer warpgroups (eight warps) and one producer
// warpgroup, of which one thread works.  Registers are per SM sub-partition
// (16,384 each, four per SM): nine warps put three on one of them and cap a
// thread at 168 registers, where the 128 accumulators spilled; with three
// warpgroups, setmaxnreg gives the consumers 240 and the producer 24.
//   * Weights: the producer thread streams the 154 slabs of one pass
//     (ops/sm90_layout.py F32_SLABS: KS = 16 input rows of a weight block with
//     every output column, transposed on the host to K-major [k][out] f32)
//     through a ring of STAGES shared-memory stages, one 1-D cp.async.bulk per
//     slab, with a full and an empty mbarrier per stage.  The consumers wait on
//     the full barrier and each warp releases the stage with one arrive: no
//     __ldg, no transpose and no block-wide barrier per slab.  Each weight
//     byte read from L2 serves 128 points.
//   * Activations: [k][point] f32, K-major, so that a thread's points are
//     float4 loads.  Point chunk c (points 4c..4c+3) of row k lies at chunk
//     c ^ 4 where bit 2 of k is set (at()): the products' loads stay 64
//     contiguous bytes, and the epilogue's float4 stores of a warp, 8 rows
//     apart by 4, spread over all 32 banks (4 wavefronts for 512 bytes).
//   * Register tile: consumer thread t (warp w = t / 32, lane l) owns 8
//     points x 16 outputs, 128 accumulators (8 x 8 in the 128-wide direction
//     layer): points 32 (w % 4) + 16 i + 4 (l / 8) + e, outputs
//     (O / 2) (w / 4) + 32 j + 4 (l % 8) + e.  Per k step it loads 2 float4
//     of activations (a warp's 4 point groups: 64 contiguous bytes, the rest
//     broadcast) and 4 of weights (its 8 output groups: 128 contiguous bytes)
//     and issues 128 FFMA: 21.3 FFMA per 128-bit shared load, no bank
//     conflict.
//   * Epilogues in place, after a named barrier of the 256 consumers: bias
//     add, ReLU (or nothing, or the shifted softplus), stored back over the
//     layer's input.  The sigma head (256 -> 1) is summed in layer 8's
//     epilogue and the rgb head (128 -> 3) in the direction layer's (whose
//     output goes nowhere else): each thread over its outputs, then over the
//     warp's 8 output groups by xor shuffles, then the two warp columns'
//     partial sums in shared memory, always in this order.
//
// Shared memory of one CTA (bytes; a CTA may take 232,448):
//   activations     256 x 128 x 4                  131,072
//   PE tile          64 x 128 x 4                   32,768
//   weight ring       3 x 16 x 256 x 4              49,152
//   rays 128 x 6 x 4, sigma partials 2 x 128 x 4,
//   rgb partials 2 x 128 x 3 x 4, 6 mbarriers        7,232
//   total                                          220,224
// The PE tile holds the sample PE (63 columns and a zero) for layers 1 and
// 5, then, recomputed per sample after layer 5, the direction PE (27 columns
// and 5 zeros) in its first 32 rows for the direction layer.  A separate
// 16 KB direction-PE tile would leave room for two stages only, and a fourth
// stage does not fit beside it either way.  One 16-row slab is 16 x 128 FFMA
// per consumer thread, ~4,096 clocks of the SM's FFMA issue, against ~1,000
// for its bulk copy from L2: the third stage absorbs the warps' skew.
// Tested as the port's other kernels are: the CPU tests run the plain
// version and pin the slab layout (tests/test_torch_k1_sm90.py); on the
// card, python3 chip_smoke.py builds, checks and times it.
#pragma once

#include "nerf_mlp.cuh"
#include "sm90_primitives.cuh"

namespace nerf {
namespace f32s {

constexpr int RAYS = 128;                    // points (rays) per CTA tile
constexpr int CONSUMERS = 256;               // eight consumer warps
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int CTA_THREADS = CONSUMERS + 128; // and the producer warpgroup
constexpr int KS = 16;                       // input rows per slab
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = KS * WIDTH * 4;  // the largest slab

// The slab buffer (ops/sm90_layout.py::slab_buffer_f32): 136 slabs of 256
// output columns (w1, w2-w4, w5h, w5x, w6-w8, wfin), then 18 of 128 (wdh,
// wdx), each [16][out] f32, then wrgb and wsig as packed.
constexpr int N_SLABS = 154;
constexpr int FULL_SLABS = 136;
constexpr int N_SIGMA_SLABS = FULL_SLABS - WIDTH / KS;  // w1 .. w8: what a pass up to sigma reads
constexpr int HEAD_OFF = FULL_SLABS * STAGE_BYTES + (N_SLABS - FULL_SLABS) * (STAGE_BYTES / 2);  // bytes
constexpr int SLAB_BUFFER_ELEMS = HEAD_OFF / 4 + 3 * HALF + WIDTH;
static_assert(HEAD_OFF == 2375680 && SLAB_BUFFER_ELEMS == W_SIZE,
              "f32 slab buffer layout must match ops/sm90_layout.py");

__host__ __device__ constexpr int slab_offset(int i) {
  return i < FULL_SLABS ? i * STAGE_BYTES : FULL_SLABS * STAGE_BYTES + (i - FULL_SLABS) * (STAGE_BYTES / 2);
}
__host__ __device__ constexpr int slab_bytes(int i) { return i < FULL_SLABS ? STAGE_BYTES : STAGE_BYTES / 2; }

// Byte offsets of the shared-memory regions (ops/sm90_layout.py K1_F32_SMEM).
struct Smem {
  static constexpr int ACT = 0;
  static constexpr int PE = ACT + WIDTH * RAYS * 4;
  static constexpr int RING = PE + XYZ_PAD * RAYS * 4;
  static constexpr int RAYS_F = RING + STAGES * STAGE_BYTES;
  static constexpr int SIGP = RAYS_F + RAYS * 6 * 4;
  static constexpr int RGBP = SIGP + 2 * RAYS * 4;
  static constexpr int BARS = RGBP + 2 * RAYS * 3 * 4;
  static constexpr int BYTES = BARS + 64;
};
static_assert(Smem::BYTES == 220224 && Smem::BYTES <= 232448, "K1 f32 shared memory");

// Element (row k, point p) of a [k][point] tile.
__device__ __forceinline__ int at(int k, int p) { return k * RAYS + (p ^ ((k & 4) << 2)); }

__device__ __forceinline__ void consumers_sync() { sm90::named_sync(1, CONSUMERS); }

// x, which the compiler cannot prove equal to x: what is computed from it
// (indices, addresses) is computed where it is used, not hoisted out of the
// tile and sample loops into registers that live across them (and spill in
// the backward's kernels, mlp_backward_f32_sm90.cuh).  The eval render does
// not take it: there it cost 4% (the PE loops lose their known trip count).
__device__ __forceinline__ int fresh(int x) {
  asm volatile("" : "+r"(x));
  return x;
}
__device__ __forceinline__ int fresh_tid() { return fresh((int)threadIdx.x); }

// The calling consumer thread's register tile.
struct Map {
  int lane;
  int wc;  // warp column: outputs [wc O / 2, (wc + 1) O / 2)
  int og;  // output group: columns 4 og .. 4 og + 3 of every 32
  int p0;  // first point; its points are p0 + 16 i + e, i < 2, e < 4
  __device__ Map()
      : lane(threadIdx.x & 31), wc(threadIdx.x >> 7), og(threadIdx.x & 7),
        p0(32 * ((threadIdx.x >> 5) & 3) + 4 * ((threadIdx.x & 31) >> 3)) {}
  __device__ int point(int pi) const { return p0 + 16 * (pi >> 2) + (pi & 3); }
  template <int O>
  __device__ int out(int oi) const { return (O / 2) * wc + 32 * (oi >> 2) + 4 * og + (oi & 3); }
};

// The consumer side of the weight ring: every consumer thread walks the same
// slab sequence, and each warp's lane 0 releases a stage once the warp's
// products on it are done.
struct Ring {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  uint32_t it = 0;
  __device__ const float* wait() {
    const int s = it % STAGES;
    sm90::mbar_wait(&full[s], (it / STAGES) & 1);
    return reinterpret_cast<const float*>(stages + s * STAGE_BYTES);
  }
  __device__ void release(const Map& m) {
    __syncwarp();
    if (m.lane == 0) sm90::mbar_arrive(&empty[it % STAGES]);
    ++it;
  }
};

// The producer: one thread streams the first ``count`` slabs of one pass
// (all of them, or the trunk's N_SIGMA_SLABS for a pass that stops at sigma).
__device__ __forceinline__ void produce_pass(const unsigned char* __restrict__ slabs, unsigned char* stages,
                                             uint64_t* full, uint64_t* empty, uint32_t& it, int count = N_SLABS) {
  for (int i = 0; i < count; ++i, ++it) {
    const int s = it % STAGES;
    sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&full[s], slab_bytes(i));
    sm90::bulk_load(stages + s * STAGE_BYTES, slabs + slab_offset(i), slab_bytes(i), &full[s]);
  }
}

// acc += A W^T over n1 slabs of A1's rows, then n2 of A2's ([k][point]
// tiles): each slab is KS rows of A against the ring's next [KS][O] stage.
template <int O>
__device__ __forceinline__ void product(float (&acc)[8][O / 16], Ring& ring, const Map& m, const float* A1, int n1,
                                        const float* A2, int n2) {
  constexpr int NJ = O / 64;  // float4 of outputs per thread and k
  const int ob = (O / 2) * m.wc + 4 * m.og;
  for (int j = 0; j < n1 + n2; ++j) {
    const float* w = ring.wait() + ob;
    const float* a = j < n1 ? A1 + j * KS * RAYS : A2 + (j - n1) * KS * RAYS;
#pragma unroll 1
    for (int k4 = 0; k4 < KS; k4 += 4) {
      // rows k4..k4+3 share bit 2: their point chunks are swapped together
      const int sw = (k4 & 4) << 2;
      const float* a0 = a + k4 * RAYS + (m.p0 ^ sw);
      const float* a1 = a + k4 * RAYS + ((m.p0 + 16) ^ sw);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 x0 = *reinterpret_cast<const float4*>(a0 + kk * RAYS);
        const float4 x1 = *reinterpret_cast<const float4*>(a1 + kk * RAYS);
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

template <int R, int C>
__device__ __forceinline__ void zero(float (&acc)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;
}

// A trunk layer's epilogue: the thread's points and outputs of ``act`` =
// act(acc + bias), left in ``acc`` too.  With ``wsig`` (layer 8) also the
// sigma head's partial sums h8 . wsig over the warp column's outputs, into
// sigp[wc][point].
__device__ __forceinline__ void trunk_epilogue(float (&acc)[8][16], const Map& m, float* act,
                                               const float* __restrict__ bias, int kind,
                                               const float* __restrict__ wsig, float* sigp) {
  float s[8];
#pragma unroll
  for (int pi = 0; pi < 8; ++pi) s[pi] = 0.f;
  const int sw = (m.og & 1) << 4;  // bit 2 of every output of the thread is og's bit 0
#pragma unroll
  for (int oi = 0; oi < 16; ++oi) {
    const int o = m.out<WIDTH>(oi);
    const float b = __ldg(bias + o);
    const float ws = wsig ? __ldg(wsig + o) : 0.f;
    float v[8];
#pragma unroll
    for (int pi = 0; pi < 8; ++pi) {
      v[pi] = epilogue(__fadd_rn(acc[pi][oi], b), kind);
      acc[pi][oi] = v[pi];
      if (wsig) s[pi] = fmaf(v[pi], ws, s[pi]);
    }
    *reinterpret_cast<float4*>(act + o * RAYS + (m.p0 ^ sw)) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(act + o * RAYS + ((m.p0 + 16) ^ sw)) = make_float4(v[4], v[5], v[6], v[7]);
  }
  if (wsig) {
#pragma unroll
    for (int pi = 0; pi < 8; ++pi) {
      s[pi] = __fadd_rn(s[pi], __shfl_xor_sync(0xffffffffu, s[pi], 1));
      s[pi] = __fadd_rn(s[pi], __shfl_xor_sync(0xffffffffu, s[pi], 2));
      s[pi] = __fadd_rn(s[pi], __shfl_xor_sync(0xffffffffu, s[pi], 4));
      if (m.og == 0) sigp[m.wc * RAYS + m.point(pi)] = s[pi];
    }
  }
}

// The direction layer's epilogue: d = act(acc + bd) of the thread's points
// and outputs, and the rgb head's partial sums d . wrgb over the warp
// column's outputs into rgbp[wc][point][3].
__device__ __forceinline__ void dir_epilogue(float (&acc)[8][8], const Map& m, const float* __restrict__ bias,
                                             int kind, const float* __restrict__ wrgb, float* rgbp) {
  float s[8][3];
#pragma unroll
  for (int pi = 0; pi < 8; ++pi) s[pi][0] = s[pi][1] = s[pi][2] = 0.f;
#pragma unroll
  for (int oi = 0; oi < 8; ++oi) {
    const int o = m.out<HALF>(oi);
    const float b = __ldg(bias + o);
    const float w[3] = {__ldg(wrgb + o), __ldg(wrgb + HALF + o), __ldg(wrgb + 2 * HALF + o)};
#pragma unroll
    for (int pi = 0; pi < 8; ++pi) {
      const float v = epilogue(__fadd_rn(acc[pi][oi], b), kind);
#pragma unroll
      for (int c = 0; c < 3; ++c) s[pi][c] = fmaf(v, w[c], s[pi][c]);
    }
  }
#pragma unroll
  for (int pi = 0; pi < 8; ++pi)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float v = s[pi][c];
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 4));
      if (m.og == 0) rgbp[(m.wc * RAYS + m.point(pi)) * 3 + c] = v;
    }
}

// ------------------------------------------------------------------ the PE
// nerf_mlp.cuh's pe_channel, the same arithmetic, into point p's column of a
// [k][point] tile.
__device__ __forceinline__ void pe_channel_k(float x, int c, int n_freqs, float* tile, int p) {
  tile[at(c, p)] = x;
  float s = 0.f, co = 0.f;
  for (int k = 0; k < n_freqs; ++k) {
    if (k % PE_RESTART == 0) {
      const float xk = __fmul_rn(x, (float)(1 << k));
      s = sinf(xk);
      co = cosf(xk);
    } else {
      const float s2 = __fmul_rn(2.f, s);
      const float ns = __fmul_rn(s2, co);
      co = __fsub_rn(1.f, __fmul_rn(s2, s));
      s = ns;
    }
    tile[at(3 + 6 * k + c, p)] = s;
    tile[at(6 + 6 * k + c, p)] = co;
  }
}

// The PE of sample s of the tile's rays (rays [RAYS][6] in shared memory,
// as mlp_wgmma.cuh's load_rays leaves them) into ``pe`` (row 63 zero): xyz =
// o + d z, z of rays past n is 1.  Unsynchronised.
template <bool FRESH = false>
__device__ __forceinline__ void sample_pe(const float* rays, const float* __restrict__ z, int ray0, int n, int S,
                                          int s, float* pe) {
  const int tid = FRESH ? fresh_tid() : (int)threadIdx.x;
  for (int e = tid; e < RAYS * 3; e += CONSUMERS) {
    const int r = e / 3, c = e % 3;
    const float zs = ray0 + r < n ? z[(size_t)(ray0 + r) * S + s] : 1.f;
    pe_channel_k(__fadd_rn(rays[r * 6 + c], __fmul_rn(rays[r * 6 + 3 + c], zs)), c, N_FREQS_XYZ, pe, r);
  }
  if (tid < RAYS) pe[at(XYZ_CH, tid)] = 0.f;
}

// The direction PE of the tile's rays into rows 0..31 of ``pe`` (27..31
// zero).  Unsynchronised.
template <bool FRESH = false>
__device__ __forceinline__ void dir_pe(const float* rays, float* pe) {
  const int tid = FRESH ? fresh_tid() : (int)threadIdx.x;
  for (int e = tid; e < RAYS * 3; e += CONSUMERS) {
    const int r = e / 3, c = e % 3;
    pe_channel_k(rays[r * 6 + 3 + c], c, N_FREQS_DIR, pe, r);
  }
  for (int e = tid; e < RAYS * (DIR_PAD - DIR_CH); e += CONSUMERS) pe[at(DIR_CH + e / RAYS, e % RAYS)] = 0.f;
}

// What a pass keeps of its trunk layers: nothing for the eval render.  The
// backward's recompute (mlp_backward_f32_sm90.cuh) keeps each layer's output
// from the thread's registers: layer(l, m, acc) runs after trunk layer l's
// epilogue (l = 9: xyz_encoding_final), before the consumers' barrier.
struct KeepNone {
  static constexpr bool FRESH = false;  // the thread indices of the PE: see fresh()
  __device__ void layer(int, const Map&, const float (&)[8][16]) const {}
};

// Trunk layers 1..LAST of one pass over the tile: the sample PE in ``pe``
// (written and synchronised by the caller) -> sigp, the sigma head's partial
// sums (sigma = sigp[0][p] + sigp[1][p] + bsig), and (LAST 9) f, the output
// of xyz_encoding_final, in ``act``; visible to every consumer on return,
// with (LAST 9) the direction PE in ``pe``.  Consumes the first 136 slabs of
// a pass (LAST 8, a pass that stops at sigma: N_SIGMA_SLABS).
template <typename Keep = KeepNone, int LAST = 9>
__device__ __forceinline__ void mlp_trunk(Ring& ring, const Map& m, float* act, float* pe, const float* rays,
                                          const float* __restrict__ heads, const float* __restrict__ B, float* sigp,
                                          const Keep& keep = Keep()) {
  constexpr int BOFF[10] = {0, B1, B2, B3, B4, B5, B6, B7, B8, BFIN};
  float acc[8][16];
  for (int l = 1; l <= LAST; ++l) {
    zero(acc);
    if (l == 1) product<WIDTH>(acc, ring, m, pe, XYZ_PAD / KS, nullptr, 0);
    else product<WIDTH>(acc, ring, m, act, WIDTH / KS, pe, l == 5 ? XYZ_PAD / KS : 0);
    consumers_sync();  // every read of the layer's inputs is done
    trunk_epilogue(acc, m, act, B + BOFF[l], l == 9 ? ACT_NONE : ACT_RELU, l == 8 ? heads + 3 * HALF : nullptr,
                   sigp);
    keep.layer(l, m, acc);
    if (LAST == 9 && l == 5) dir_pe<Keep::FRESH>(rays, pe);  // layer 5 read the sample PE for the last time
    consumers_sync();
  }
}

// The direction layer's product over f (in ``act``) and the direction PE (in
// ``pe``): the last 18 slabs of a pass.
__device__ __forceinline__ void dir_product(float (&acc)[8][8], Ring& ring, const Map& m, const float* act,
                                            const float* pe) {
  zero(acc);
  product<HALF>(acc, ring, m, act, WIDTH / KS, pe, DIR_PAD / KS);
}

// One pass of the MLP over the tile: mlp_trunk, then the direction layer and
// the heads -> sigp and rgbp, the heads' partial sums (the rgb pre-activation
// likewise rgbp[0][p] + rgbp[1][p] + brgb), visible to every consumer on
// return.  Consumes the N_SLABS slabs of one pass from the ring.
__device__ __forceinline__ void mlp_pass(Ring& ring, const Map& m, float* act, float* pe, const float* rays,
                                         const float* __restrict__ heads, const float* __restrict__ B, bool new_act,
                                         float* sigp, float* rgbp) {
  mlp_trunk(ring, m, act, pe, rays, heads, B, sigp);
  float acc[8][8];
  dir_product(acc, ring, m, act, pe);
  dir_epilogue(acc, m, B + BD, new_act ? ACT_SSP : ACT_RELU, heads, rgbp);
  consumers_sync();
}

}  // namespace f32s
}  // namespace nerf
