// The forward NeRF MLP on Hopper's wgmma, shared by the redesigned training
// render's forward (K3-fwd bf16) and its backward's recompute (K3-bwd bf16),
// fused_render_train_sm90.cu.  One body for both, so that the recompute
// rounds every activation, sigma and with it the sigma gate exactly as the
// forward did.
//
// Replaces, for these two kernels, the bf16 body of nerf_mlp.cuh (nvcuda::wmma
// 16x16x16 fragments, B loaded from L2 for every 64-point tile), which K1, K4
// and the experiment kernels keep.  The TPU body it stands for is
// sinnerf_tpu/ops/fused_mlp_t.py::mlp_from_pe (:189) with _pe_fwd (:135).
//
// A CTA runs a tile of RAYS = 128 points (one sample of 128 rays) with three
// warpgroups: two consumer warpgroups of 64 points each and one producer.
//   * Weights: the producer's one thread streams the 39 K-slabs of one pass
//     (ops/sm90_layout.py FWD_SLABS: 64 input columns of a block, every
//     output row, pre-swizzled on the host) through a ring of shared-memory
//     stages, one 1-D cp.async.bulk per slab, with an mbarrier pair (full,
//     empty) per stage.  Both consumer warpgroups read each slab: every
//     weight byte read from L2 serves 128 points, where the wmma body read it
//     once per 64-point block and fragment.  (A 2-CTA cluster multicasting
//     each slab would serve 256; it is left for a later change: its partner
//     CTAs must meet on shared barriers even past the last ray tile.)
//   * Activations: a 128 x 256 bf16 tile, 128-byte swizzled, the wgmma A
//     operand; each warpgroup reads and overwrites its own 64 rows only, so
//     the two never wait on each other inside the MLP.
//   * Products: wgmma.m64n256k16 (m64n128k16 for the direction layer), f32
//     accumulators in registers (128 a thread), scale-d 0 on a layer's first
//     product.  Layer 1: one slab (K = 64, the 63 PE columns and a zero);
//     layer 5: four trunk slabs and one PE slab into one accumulator; the
//     direction layer: four trunk slabs (N = 128) and the direction PE's 32
//     columns (27 and zeros).
//   * Epilogues on CUDA cores, at the cast points of mlp_from_pe: f32 bias
//     add, ReLU (or nothing, or the shifted softplus), bf16 cast, written back
//     in the swizzled layout.  The sigma head (256 -> 1) and the rgb head
//     (128 -> 3) are f32 dot products of the cast activations, each thread
//     over its 64 (or 32) columns, summed over the four threads of a row
//     with xor shuffles: no shared-memory round trip, and every thread of
//     the row ends with the same value.
// Bound: operations, 593,408 multiply-adds per point.
// Tested as the port's other kernels are: the CPU tests run their plain
// versions as before (tests/test_torch_k3_sm90.py pins the slab layout); on
// the card, python3 chip_smoke.py builds, checks and times them.
#pragma once

#include "nerf_mlp.cuh"
#include "sm90_primitives.cuh"

namespace nerf {
namespace k3 {

constexpr int RAYS = 128;          // points (rays) per CTA tile
constexpr int WG_ROWS = 64;        // points per consumer warpgroup
constexpr int CONSUMER_THREADS = 256;
constexpr int CTA_THREADS = 384;   // two consumer warpgroups and the producer's
constexpr int ROW_BYTES = 128;     // one swizzled row: 64 bf16 values
constexpr int ACT_BLOCK = RAYS * ROW_BYTES;  // one 64-column block of a tile
constexpr int ACT_BYTES = 4 * ACT_BLOCK;     // a 128 x 256 tile
constexpr int PE_BYTES = ACT_BLOCK;          // a 128 x 64 tile
constexpr int STAGE_BYTES = 256 * ROW_BYTES; // the largest slab
constexpr int SMALL_BYTES = 8192;
constexpr int ALIGN = 1024;                  // swizzle atoms start on 1,024 bytes

// The slab buffer (ops/sm90_layout.py::slab_buffer): 34 slabs of 256 rows
// (w1, w2-w4, w5h, w5x, w6-w8, wfin), then 5 of 128 rows (wdh, wdx), then
// wrgb and wsig as packed.
constexpr int N_FWD_SLABS = 39;
constexpr int N_BWD_SLABS = 36;
constexpr int FULL_SLABS = 34;
constexpr int HEAD_OFF = FULL_SLABS * STAGE_BYTES + 5 * STAGE_BYTES / 2;  // bytes
constexpr int SLAB_BUFFER_ELEMS = HEAD_OFF / 2 + 3 * HALF + WIDTH;
static_assert(HEAD_OFF == 1196032, "slab buffer layout must match ops/sm90_layout.py");

__host__ __device__ constexpr int slab_offset(int i) {
  return i < FULL_SLABS ? i * STAGE_BYTES : FULL_SLABS * STAGE_BYTES + (i - FULL_SLABS) * (STAGE_BYTES / 2);
}
__host__ __device__ constexpr int slab_bytes(int i) { return i < FULL_SLABS ? STAGE_BYTES : STAGE_BYTES / 2; }
// The backward's j-th slab (sm90_layout.py BWD_SLABS): four slabs each of wdh,
// wfin, w8, w7, w6, w5h, w4, w3, w2.
__host__ __device__ constexpr int bwd_slab(int j) {
  constexpr int first[9] = {34, 30, 26, 22, 18, 13, 9, 5, 1};
  return first[j / 4] + j % 4;
}

// The dynamic shared memory's base, rounded up to the swizzle atom.
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  const uint32_t a = sm90::smem_addr(raw);
  return raw + ((ALIGN - (a & (ALIGN - 1))) & (ALIGN - 1));
}

// Byte offset of (row r of the tile, column c) in a swizzled tile.
__device__ __forceinline__ int sw_off(int r, int c) {
  return (c >> 6) * ACT_BLOCK + r * ROW_BYTES + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// The calling consumer thread's place in the wgmma accumulator layout.
struct Lane {
  int g;     // consumer warpgroup, 0 or 1
  int t;     // thread within it
  int r0;    // its first row within the warpgroup's 64; the second is r0 + 8
  int q;     // lane % 4: columns 2q, 2q + 1 of every 8
  __device__ Lane() : g(threadIdx.x >> 7), t(threadIdx.x & 127), r0(((threadIdx.x & 127) >> 5) * 16 + ((threadIdx.x & 31) >> 2)), q(threadIdx.x & 3) {}
  __device__ int row(int i) const { return g * WG_ROWS + r0 + 8 * i; }  // row of the tile
  __device__ bool leader() const { return t == 0; }
  __device__ void wg_sync() const { sm90::named_sync(1 + g, 128); }
};

__device__ __forceinline__ void consumers_sync() { sm90::named_sync(3, CONSUMER_THREADS); }

// The consumer side of the weight ring.  Every consumer thread walks the
// same slab sequence; the warpgroup's thread 0 releases each stage once the
// warpgroup's products on it are done.
struct Ring {
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  int n_stages;
  uint32_t it = 0;
  __device__ const unsigned char* wait() {
    const int s = it % n_stages;
    sm90::mbar_wait(&full[s], (it / n_stages) & 1);
    return stages + s * STAGE_BYTES;
  }
  __device__ void release(const Lane& ln) {
    if (ln.leader()) sm90::mbar_arrive(&empty[it % n_stages]);
    ++it;
  }
};
// The producer: one thread streams ``count`` slabs, the schedule ``pick``.
template <typename Pick>
__device__ void produce(const unsigned char* __restrict__ slabs, unsigned char* stages, uint64_t* full,
                        uint64_t* empty, int n_stages, uint32_t& it, int count, Pick pick) {
  for (int j = 0; j < count; ++j, ++it) {
    const int s = it % n_stages;
    sm90::mbar_wait(&empty[s], ((it / n_stages) & 1) ^ 1);
    const int i = pick(j);
    sm90::mbar_arrive_expect_tx(&full[s], slab_bytes(i));
    sm90::bulk_load(stages + s * STAGE_BYTES, slabs + slab_offset(i), slab_bytes(i), &full[s]);
  }
}

template <int N>
__device__ __forceinline__ void mma_kk(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 256) sm90::mma_m64n256<0, 0>(d, da, db, scale_d);
  else sm90::mma_m64n128<0, 0>(d, da, db, scale_d);
}

// acc (+)= A W^T over ``slabs`` slabs of the ring: A is the warpgroup's 64
// rows of a swizzled tile (``a`` points at its first block, the rows
// included), K-major; each slab is 64 input columns, K-major, N rows.  ``ks``
// 16-column steps of the last slab (4, or 2 for the direction PE).
template <int N>
__device__ __forceinline__ void product(float (&acc)[N / 2], Ring& ring, const Lane& ln, const unsigned char* a,
                                        int slabs, bool first, int ks_last = 4) {
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
  }
}

// bf16 of a relu'd (ACT_RELU), raw (ACT_NONE) or softplus'd (ACT_SSP) bias sum,
// written to the tile at (row, c), (row, c + 1); returns the cast values.
__device__ __forceinline__ __nv_bfloat162 store_act(unsigned char* tile, int row, int c, float a0, float a1,
                                                    const float* __restrict__ bias, int act) {
  const float2 b = __ldg(reinterpret_cast<const float2*>(bias + c));
  const float v0 = epilogue(__fadd_rn(a0, b.x), act), v1 = epilogue(__fadd_rn(a1, b.y), act);
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(tile + sw_off(row, c)) = h;
  return h;
}

// A trunk layer's epilogue: the warpgroup's rows of ``tile`` = act(acc + bias).
// With ``wsig`` (layer 8) also the sigma head: sig[i] = h8 . wsig + bsig of
// the thread's rows, the same value in the row's four threads.
__device__ __forceinline__ void trunk_epilogue(float (&acc)[128], const Lane& ln, unsigned char* tile,
                                               const float* __restrict__ bias, int act, const bf16* wsig = nullptr,
                                               float bsig = 0.f, float* sig = nullptr) {
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
      const __nv_bfloat162 h = store_act(tile, ln.row(i), c, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1], bias, act);
      if (wsig) {
        s[i] = fmaf(__low2float(h), w0, s[i]);
        s[i] = fmaf(__high2float(h), w1, s[i]);
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

// What a pass of the MLP leaves for its caller: sigma and the rgb head's f32
// pre-activation of the thread's two rows, and the direction layer's
// accumulator (its f32 pre-activation is acc + bd: the backward's slope).
struct MlpOut {
  float sig[2];
  float rpre[2][3];
  float dacc[64];
};

// Keeping of each trunk layer's output (h1..h8, then xyz_encoding_final as
// the 9th) for the backward: the warpgroup's rows of the tile, as they lie
// in shared memory, copied to ``kept`` (9 tile images) by bulk stores.
struct KeepNone {
  __device__ void done(int, const unsigned char*, const Lane&) const {}
  __device__ void before_write(const Lane&) const {}
};
struct KeepTiles {
  unsigned char* kept;
  __device__ void done(int layer, const unsigned char* tile, const Lane& ln) const {
    sm90::fence_proxy_async();
    ln.wg_sync();
    if (ln.leader()) {
      unsigned char* dst = kept + (size_t)(layer - 1) * ACT_BYTES;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sm90::bulk_store(dst + b * ACT_BLOCK + ln.g * WG_ROWS * ROW_BYTES,
                         tile + b * ACT_BLOCK + ln.g * WG_ROWS * ROW_BYTES, WG_ROWS * ROW_BYTES);
      sm90::bulk_commit();
    }
  }
  // the previous layer's copies have read the tile before it is overwritten
  __device__ void before_write(const Lane& ln) const {
    if (ln.leader()) sm90::bulk_wait_read();
    ln.wg_sync();
  }
};

// One pass of the MLP over the warpgroup's 64 points: xpe and dpe (swizzled
// 128 x 64 tiles, written and fenced by the caller) -> out; ``act`` is the
// 128 x 256 activation tile, which ends holding the direction branch's
// output in columns 0..127.  Consumes 39 slabs of the ring.
template <typename Keep>
__device__ __forceinline__ void mlp_pass(Ring& ring, const Lane& ln, unsigned char* act, const unsigned char* xpe,
                                         const unsigned char* dpe, const bf16* __restrict__ heads,
                                         const float* __restrict__ B, bool new_act, const Keep& keep, MlpOut& out) {
  const int rows = ln.g * WG_ROWS * ROW_BYTES;  // the warpgroup's rows within each block
  float acc[128];
  constexpr int BOFF[10] = {0, B1, B2, B3, B4, B5, B6, B7, B8, BFIN};
  const bf16* wrgb = heads;
  const bf16* wsig = heads + 3 * HALF;
  for (int l = 1; l <= 9; ++l) {
    if (l == 1) product<256>(acc, ring, ln, xpe + rows, 1, true);
    else product<256>(acc, ring, ln, act + rows, 4, true);
    if (l == 5) product<256>(acc, ring, ln, xpe + rows, 1, false);
    if (l > 1) keep.before_write(ln);
    trunk_epilogue(acc, ln, act, B + BOFF[l], l == 9 ? ACT_NONE : ACT_RELU, l == 8 ? wsig : nullptr, B[BSIG],
                   out.sig);
    sm90::fence_proxy_async();
    keep.done(l, act, ln);
    ln.wg_sync();
  }
  // the direction layer: f (K = 256) and the direction PE (32 columns)
  product<128>(out.dacc, ring, ln, act + rows, 4, true);
  product<128>(out.dacc, ring, ln, dpe + rows, 1, false, 2);
  keep.before_write(ln);
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

// ------------------------------------------------------------------ the PE
// pe_channel (nerf_mlp.cuh), the same arithmetic, into row ``r`` of a
// swizzled 64-column tile.
__device__ __forceinline__ void pe_channel_sw(float x, int c, int n_freqs, unsigned char* tile, int r) {
  auto put = [&](int col, float v) { *reinterpret_cast<bf16*>(tile + sw_off(r, col)) = __float2bfloat16_rn(v); };
  put(c, x);
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
    put(3 + 6 * k + c, s);
    put(6 + 6 * k + c, co);
  }
}

// The direction PE of the warpgroup's 64 rays into ``dpe`` (columns 27..63
// zero), from rays [128][6] in shared memory.  Unfenced.
__device__ __forceinline__ void dir_pe(const Lane& ln, const float* rays, unsigned char* dpe) {
  for (int e = ln.t; e < WG_ROWS * 3; e += 128) {
    const int r = ln.g * WG_ROWS + e / 3, c = e % 3;
    pe_channel_sw(rays[r * 6 + 3 + c], c, N_FREQS_DIR, dpe, r);
  }
  for (int e = ln.t; e < WG_ROWS * (64 - DIR_CH); e += 128) {
    const int r = ln.g * WG_ROWS + e / (64 - DIR_CH), c = DIR_CH + e % (64 - DIR_CH);
    *reinterpret_cast<bf16*>(dpe + sw_off(r, c)) = __float2bfloat16_rn(0.f);
  }
}

// The PE of sample s of the warpgroup's rays into ``xpe`` (column 63 zero):
// xyz = o + d z, z of rays past n is 1.  Unfenced.
__device__ __forceinline__ void sample_pe_sw(const Lane& ln, const float* rays, const float* __restrict__ z,
                                             int ray0, int n, int S, int s, unsigned char* xpe) {
  for (int e = ln.t; e < WG_ROWS * 3; e += 128) {
    const int r = ln.g * WG_ROWS + e / 3, c = e % 3;
    const float zs = ray0 + r < n ? z[(size_t)(ray0 + r) * S + s] : 1.f;
    pe_channel_sw(__fadd_rn(rays[r * 6 + c], __fmul_rn(rays[r * 6 + 3 + c], zs)), c, N_FREQS_XYZ, xpe, r);
  }
  if (ln.t < WG_ROWS)
    *reinterpret_cast<bf16*>(xpe + sw_off(ln.g * WG_ROWS + ln.t, XYZ_CH)) = __float2bfloat16_rn(0.f);
}

// Rays [ray0, ray0 + 128) into rays [128][6] (rays past n: o = 0, d = (0, 0,
// 1)), by all consumer threads.  Unsynchronised.
__device__ __forceinline__ void load_rays(const float* __restrict__ src, int ray0, int n, float* rays) {
  for (int i = threadIdx.x; i < RAYS * 6; i += CONSUMER_THREADS) {
    const int p = i / 6, c = i % 6;
    rays[i] = ray0 + p < n ? src[(size_t)(ray0 + p) * 6 + c] : (c == 5 ? 1.f : 0.f);
  }
}

__device__ __forceinline__ float ray_norm(const float* rays, int r) {
  const float dx = rays[r * 6 + 3], dy = rays[r * 6 + 4], dz = rays[r * 6 + 5];
  return sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)));
}

}  // namespace k3
}  // namespace nerf
