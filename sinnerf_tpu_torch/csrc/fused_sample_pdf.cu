// K2: inverse-CDF importance resampling merged with the coarse depths.
//
// Replaces the TPU kernel sinnerf_tpu/ops/fused_sample_pdf_t.py::_kernel
// (:61, with _bitonic_merge_rows :47), called through fused_sample_pdf_merge
// (:132).  Wrapper, plain version and launch counters:
// ops/fused_sample_pdf.py.  Two kernels compute the same function, bit for
// bit: sample_pdf_lanes_kernel, on the path, and sample_pdf_merge_kernel, the
// first port, which stays built on no path for chip_smoke.py's timing rounds.
//
// The function, per ray:
//   pdf = (w[1:-1] + 1e-5) / sum, with the sum and the exclusive CDF taken in
//   sequential f32 order (the plain version uses the same order);
//   for each of the K u-values (det: i / max(K-1, 1); stochastic: (i + u_i)/K,
//   each a multiply by the f32 reciprocal)
//   a right-searchsorted over the monotone CDF, which equals the TPU kernel's
//   masked extrema (fused_sample_pdf_t.py:102-115), with the empty "above" set
//   clamped to the last CDF entry and bin and the denom < 1e-5 -> 1 guard,
//   gives the fine depth zf; the output row is sort(cat(z, zf)).
// The bitonic network was a TPU workaround and has no counterpart here.
//
// Bound: bytes.  It reads 2*S*4 B per ray (plus K*4 B of u when stochastic)
// and writes (S+K)*4 B: 1,280 B per ray at S = 64, K = 128 (1,792 B with u),
// 0.17 GB for a tile of 131,072 rays, 0.05 ms at an H100 SXM's 3.35 TB/s.
//
// sample_pdf_lanes_kernel: LANES = 16 lanes (half a warp) per ray, 16 rays in
// a block of 256 threads, each ray's rows in its own shared-memory rows
// (about 33 KB a block at S = 64, K = 128: six blocks, 48 warps, per SM).
// The first port ran one thread per ray in blocks of 32 (41 KB each, five
// warps per SM) through a binary search per sample and a serial two-pointer
// merge: bound by latency.  A draft that searched by binary lifting for
// every value (the bin over the CDF, the ranks over z and over zf) spent
// most of its time in those searches, bound by the instructions issued: so
// each lane here searches once and walks (chip_smoke.py times the kernel cut
// after its rows and after its CDF beside the whole).
// Per block:
//   1. each ray's z and w rows by float4 loads where the rows allow it, and
//      its bin edges 0.5 (z[j] + z[j + 1]);
//   2. the CDF of each ray in the first port's operations and order (the
//      same bits): warp 0's thread t takes ray t's sum in sequential order,
//      every lane divides its share of its ray's numerators by it, thread t
//      takes the 62 sequential adds (unrolled: only the adds wait on each
//      other); one warp issues the block's 16 serial walks once, where a warp
//      per two rays would issue them 8 times;
// then per ray, by its lanes:
//   3. lane l takes c = K / 16 consecutive fine samples: the bin of the first
//      by a search, of each next by a walk (the u ascend), zf_i, its rank
//      p_i = #(z <= zf_i) by a walk from its bin, zf_i to position i + p_i
//      and each coarse z_a with p_{i-1} <= a < p_i to a + i (z first on
//      ties); the lane's first sample takes the z after the previous lane's
//      last (a shuffle), the last lane those after zf_{K-1}: every position
//      written once, sort(cat(z, zf)) when zf ascends;
//   4. zf comes out ascending but where rounding leaves a sample at a bin
//      edge above the next one: a vote finds such a row, and lane 0 merges it
//      alone (an insertion sort, linear in the few inversions, and a
//      two-pointer merge);
//   5. the row back by float4 stores where the row allows it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float EPS = 1e-5f;

// ------------------------------------------------- the first port, on no path
// One thread per ray, RAYS rays per block.  The block stages its rays' z and
// w rows in shared memory with coalesced loads (rows padded by one float so a
// thread's walk along its own row is free of bank conflicts); per ray a
// binary search per sample, in ascending u, and a two-pointer merge with the
// ascending coarse z into a staged row, written back coalesced.
constexpr int RAYS = 32;

__host__ __device__ constexpr size_t smem_floats(int s, int k) {
  return (size_t)RAYS * ((s + 1) * 2 + (s + k + 1));
}

__global__ void __launch_bounds__(RAYS)
sample_pdf_merge_kernel(const float* __restrict__ z, const float* __restrict__ w,
                        const float* __restrict__ u, float* __restrict__ out, int n, int S,
                        int K, int det) {
  extern __shared__ float sm[];
  const int ls = S + 1, lo = S + K + 1;
  float* zs = sm;                // [RAYS][S+1] coarse z
  float* cs = zs + RAYS * ls;    // [RAYS][S+1] w, then the CDF in place
  float* os = cs + RAYS * ls;    // [RAYS][S+K+1] merged row
  const int ray0 = blockIdx.x * RAYS;
  const int nr = min(RAYS, n - ray0);

  for (int i = threadIdx.x; i < nr * S; i += RAYS) {
    const int r = i / S, j = i % S;
    zs[r * ls + j] = z[(size_t)ray0 * S + i];
    cs[r * ls + j] = w[(size_t)ray0 * S + i];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r < nr) {
    const float* zr = zs + r * ls;
    float* cr = cs + r * ls;
    float* orow = os + r * lo;
    const int m = S - 2;

    float sum = 0.f;
    for (int j = 0; j < m; ++j) sum = __fadd_rn(sum, __fadd_rn(cr[j + 1], EPS));
    // exclusive CDF in place: cr[j+1] (= w[j+1]) is read before it is written
    float c = 0.f;
    cr[0] = 0.f;
    for (int j = 0; j < m; ++j) {
      c = __fadd_rn(c, __fdiv_rn(__fadd_rn(cr[j + 1], EPS), sum));
      cr[j + 1] = c;
    }

    int a = 0, o = 0;  // merge cursors: coarse z, output row
    const float* ur = det ? nullptr : u + (size_t)(ray0 + r) * K;
    // u = i / (K-1) or (i + u_i) / K, as multiplies by the f32 reciprocal:
    // XLA evaluates the TPU kernel's divisions by constants that way
    const float rcp = __fdiv_rn(1.f, det ? (float)max(K - 1, 1) : (float)K);
    for (int i = 0; i < K; ++i) {
      const float uu = det ? __fmul_rn((float)i, rcp) : __fmul_rn(__fadd_rn((float)i, ur[i]), rcp);
      // count of CDF entries <= uu (right searchsorted), over cr[0..m]
      int lo_i = 0, hi_i = m + 1;
      while (lo_i < hi_i) {
        const int mid = (lo_i + hi_i) >> 1;
        if (cr[mid] <= uu) lo_i = mid + 1; else hi_i = mid;
      }
      const int below = max(lo_i - 1, 0), above = min(lo_i, m);
      const float cdf_lo = cr[below], cdf_hi = cr[above];
      const float b_lo = __fmul_rn(0.5f, __fadd_rn(zr[below], zr[below + 1]));
      const float b_hi = __fmul_rn(0.5f, __fadd_rn(zr[above], zr[above + 1]));
      float denom = __fsub_rn(cdf_hi, cdf_lo);
      if (denom < EPS) denom = 1.f;
      const float zf = __fadd_rn(b_lo, __fmul_rn(__fdiv_rn(__fsub_rn(uu, cdf_lo), denom),
                                                 __fsub_rn(b_hi, b_lo)));
      while (a < S && zr[a] <= zf) orow[o++] = zr[a++];
      orow[o++] = zf;
    }
    while (a < S) orow[o++] = zr[a++];
  }
  __syncthreads();

  const int L = S + K;
  for (int i = threadIdx.x; i < nr * L; i += RAYS)
    out[(size_t)ray0 * L + i] = os[(i / L) * lo + i % L];
}


// ------------------------------------------------------------ many lanes per ray
constexpr int LANES = 16;           // lanes per ray: half a warp
constexpr int RAYS_PER_BLOCK = 16;  // 256 threads

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Floats of shared memory per ray: the z row, the bin edges (z_mid), the w
// row (then the CDF; four floats more, so that warp 0's walks over the
// block's rows spread over the banks), the fine depths (read only where a
// row's fine depths come out of order) and the output row, each rounded up
// to 16 bytes.
struct Rows {
  int z, e, c, f, o;
  __host__ __device__ Rows(int s, int k)
      : z(round4(s)), e(round4(s)), c(round4(s) + 4), f(round4(k)), o(round4(s + k)) {}
  __host__ __device__ size_t bytes() const { return (size_t)RAYS_PER_BLOCK * (z + e + c + f + o) * sizeof(float); }
};

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// len floats, global -> shared (or back), by the ray's lanes: float4 when vec
__device__ __forceinline__ void copy_row(const float* __restrict__ src, float* __restrict__ dst, int len, bool vec,
                                         int lane) {
  if (vec) {
    for (int i = lane; i < len / 4; i += LANES)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = lane; i < len; i += LANES) dst[i] = src[i];
  }
}

// # of a[0, len) <= v, for ascending a
__device__ __forceinline__ int count_le(const float* a, int len, float v) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The fine depth of u-value uu in bin ``cnt`` (# of CDF entries <= uu), as
// the plain version computes it; er: the bin edges 0.5 (z[j] + z[j + 1]).
__device__ __forceinline__ float fine_depth(const float* cr, const float* er, int m, int cnt, float uu) {
  const int below = max(cnt - 1, 0), above = min(cnt, m);
  const float cdf_lo = cr[below], cdf_hi = cr[above];
  const float b_lo = er[below], b_hi = er[above];
  float denom = __fsub_rn(cdf_hi, cdf_lo);
  if (denom < EPS) denom = 1.f;
  return __fadd_rn(b_lo, __fmul_rn(__fdiv_rn(__fsub_rn(uu, cdf_lo), denom), __fsub_rn(b_hi, b_lo)));
}

__device__ __forceinline__ float u_value(const float* ur, int i, float rcp, bool det) {
  return det ? __fmul_rn((float)i, rcp) : __fmul_rn(__fadd_rn((float)i, ur[i]), rcp);
}

// Step 2 for the block: the CDF over each live ray's cr[0..m], in place, in
// the plain version's order: the block's 16 sequential sums by the 16
// threads of warp 0 (one warp issues them once, where a warp per two rays
// would issue them 8 times), every lane's share of the quotients, then the 16
// sequential adds (unrolled: only the adds wait on each other).  Ray t's sum
// waits in fs[t * f] (fs: the block's fine-depth rows, f floats each).
__device__ __forceinline__ void block_cdf(float* cs, int c_stride, float* fs, int f_stride, int m, int rays,
                                          bool live, int group, int lane) {
  const int t = threadIdx.x;
  const bool walker = t < rays;
  float* const ct = cs + t * c_stride;
  float* const cr = cs + group * c_stride;
  if (walker) {
    float sum = 0.f;
#pragma unroll 8
    for (int j = 1; j <= m; ++j) sum = __fadd_rn(sum, __fadd_rn(ct[j], EPS));
    fs[t * f_stride] = sum;
  }
  __syncthreads();
  if (live) {
    const float sum = fs[group * f_stride];
    for (int j = 1 + lane; j <= m; j += LANES) cr[j] = __fdiv_rn(__fadd_rn(cr[j], EPS), sum);
  }
  __syncthreads();
  if (walker) {
    float acc = 0.f;
    ct[0] = 0.f;
#pragma unroll 8
    for (int j = 1; j <= m; ++j) {
      acc = __fadd_rn(acc, ct[j]);
      ct[j] = acc;
    }
  }
  __syncthreads();
}

// Steps 3-4 for one ray, by its 16 lanes (mask: their half of the warp):
// zr its z row, er its bin edges, cr its CDF, fr room for its fine depths
// (lane 0's merge), orow its output row.
__device__ __forceinline__ void merge_row(const float* zr, const float* er, const float* cr, float* fr, float* orow,
                                          const float* __restrict__ ur, int S, int K, bool det, int lane,
                                          unsigned mask) {
  const int m = S - 2;
  // 3. lane l takes the fine samples [l c, l c + c), c = ceil(K / LANES), in
  //    order: the bin by one search for the first and a walk to each next
  //    (the u ascend; a search again where one does not), zf_i, its rank
  //    p_i = #(z <= zf_i) by a walk from the bin (z[0..below] <= zf_i), zf_i
  //    to i + p_i, and the coarse z_a with p_{i-1} <= a < p_i to a + i: those
  //    that lie between zf_{i-1} and zf_i, z first on ties
  const float rcp = __fdiv_rn(1.f, det ? (float)max(K - 1, 1) : (float)K);
  const int c = (K + LANES - 1) / LANES;
  const int first = min(lane * c, K), last = min(first + c, K);
  int cnt = 0, p = 0, p_first = S;
  float uu_prev = 0.f, zf_first = 0.f, zf = 0.f;
  bool inverted = false;
  for (int i = first; i < last; ++i) {
    const float uu = u_value(ur, i, rcp, det);
    if (i == first || uu < uu_prev) {
      cnt = count_le(cr, m + 1, uu);
    } else {
      while (cnt <= m && cr[cnt] <= uu) ++cnt;
    }
    uu_prev = uu;
    const float f = fine_depth(cr, er, m, cnt, uu);
    if (i == first) {
      zf_first = f;
    } else {
      inverted |= f < zf;
    }
    zf = f;
    const int p_prev = p;
    p = max(cnt, 1);  // z[0..below] <= zf: below + 1 of them at least
    while (p < S && zr[p] <= f) ++p;
    orow[i + p] = f;
    if (i == first) {
      p_first = p;
    } else {
      for (int a = p_prev; a < p; ++a) orow[a + i] = zr[a];
    }
  }
  // across lanes: the previous lane's last (lane 0: none, so from a = 0)
  const int p_last_prev = __shfl_up_sync(mask, p, 1, LANES);
  const float zf_last_prev = __shfl_up_sync(mask, zf, 1, LANES);
  if (first < last) {
    const int a0 = lane == 0 ? 0 : p_last_prev;
    if (lane > 0) inverted |= zf_first < zf_last_prev;
    for (int a = a0; a < p_first; ++a) orow[a + first] = zr[a];
    if (last == K)
      for (int a = p; a < S; ++a) orow[a + K] = zr[a];
  }

  // 4. zf comes out ascending but where rounding leaves a sample at a bin
  //    edge above the next one: then lane 0 merges the row alone (zf again,
  //    an insertion sort, linear in the few inversions, and a two-pointer
  //    merge), over every position the lanes wrote
  if (__any_sync(mask, inverted)) {
    __syncwarp(mask);
    if (lane == 0) {
      int b = 0;
      for (int i = 0; i < K; ++i) {
        const float uu = u_value(ur, i, rcp, det);
        fr[i] = fine_depth(cr, er, m, count_le(cr, m + 1, uu), uu);
      }
      for (int i = 1; i < K; ++i) {
        const float v = fr[i];
        int j = i - 1;
        for (; j >= 0 && fr[j] > v; --j) fr[j + 1] = fr[j];
        fr[j + 1] = v;
      }
      for (int i = 0; i < K; ++i) {
        for (; b < S && zr[b] <= fr[i]; ++b) orow[b + i] = zr[b];
        orow[b + i] = fr[i];
      }
      for (; b < S; ++b) orow[b + K] = zr[b];
    }
  }
}

// Timing cuts of the kernel (PARTS; PARTS_ALL, the one on the path):
// PARTS_ROWS loads the rows, takes the bin edges and stores the (unwritten)
// output row; PARTS_CDF adds step 2.  Separate instantiations: the path's
// kernel has no switch.
constexpr int PARTS_ROWS = 1, PARTS_CDF = 2, PARTS_ALL = 3;

template <int PARTS>
__global__ void __launch_bounds__(LANES * RAYS_PER_BLOCK)
sample_pdf_lanes_kernel(const float* __restrict__ z, const float* __restrict__ w, const float* __restrict__ u,
                        float* __restrict__ out, int n, int S, int K, int det) {
  extern __shared__ __align__(16) float smem[];
  const Rows rows(S, K);
  const int group = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int ray = blockIdx.x * RAYS_PER_BLOCK + group;
  const bool live = ray < n;
  float* const cs = smem + RAYS_PER_BLOCK * (rows.z + rows.e);  // the block's w, then CDF, rows
  float* const fs = cs + RAYS_PER_BLOCK * rows.c;                // the block's fine-depth rows
  float* zr = smem + group * rows.z;
  float* er = smem + RAYS_PER_BLOCK * rows.z + group * rows.e;
  float* cr = cs + group * rows.c;
  float* orow = fs + RAYS_PER_BLOCK * rows.f + group * rows.o;
  const unsigned mask = 0xffffu << (threadIdx.x & 16);  // the ray's half of the warp

  // 1. the rows, and the bin edges 0.5 (z[j] + z[j + 1])
  if (live) {
    const bool vin = S % 4 == 0 && aligned16(z) && aligned16(w);
    copy_row(z + (size_t)ray * S, zr, S, vin, lane);
    copy_row(w + (size_t)ray * S, cr, S, vin, lane);
    __syncwarp(mask);
    for (int j = lane; j <= S - 2; j += LANES) er[j] = __fmul_rn(0.5f, __fadd_rn(zr[j], zr[j + 1]));
  }
  __syncthreads();
  if constexpr (PARTS >= PARTS_CDF) {
    const int rays = min(RAYS_PER_BLOCK, n - (int)blockIdx.x * RAYS_PER_BLOCK);
    block_cdf(cs, rows.c, fs, rows.f, S - 2, rays, live, group, lane);
  }
  if (!live) return;  // the ray's lanes leave together; only __syncwarp below
  if constexpr (PARTS == PARTS_ALL) {
    const float* ur = det ? nullptr : u + (size_t)ray * K;
    merge_row(zr, er, cr, fs + group * rows.f, orow, ur, S, K, det != 0, lane, mask);
  }
  __syncwarp(mask);

  // 5. the row back
  const int L = S + K;
  float* dst = out + (size_t)ray * L;
  if (L % 4 == 0 && aligned16(out)) {
    for (int i = lane; i < L / 4; i += LANES)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(orow)[i];
  } else {
    for (int i = lane; i < L; i += LANES) dst[i] = orow[i];
  }
}

template <int PARTS>
int launch_lanes(const void* z, const void* w, const void* u, void* out, int n, int s, int k, int det, void* stream) {
  const size_t bytes = Rows(s, k).bytes();
  cudaError_t e = cudaFuncSetAttribute(sample_pdf_lanes_kernel<PARTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const dim3 grid((n + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK);
  sample_pdf_lanes_kernel<PARTS><<<grid, LANES * RAYS_PER_BLOCK, bytes, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)w, (const float*)u, (float*)out, n, s, k, det);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// z, w (n, s) f32, z ascending per row; u (n, k) f32 uniforms in [0, 1) when
// det == 0 (may be null when det != 0).  Writes out (n, s + k) f32, ascending
// per row.  Returns the cudaError_t of the launch.
int sample_pdf_lanes(const void* z, const void* w, const void* u, void* out, int n, int s, int k, int det,
                     void* stream) {
  return launch_lanes<PARTS_ALL>(z, w, u, out, n, s, k, det, stream);
}

// The kernel cut after its rows (parts PARTS_ROWS, 1) or after the CDF
// (PARTS_CDF, 2), for timing only: the output row is then not the result.
int sample_pdf_lanes_parts(const void* z, const void* w, const void* u, void* out, int n, int s, int k, int det,
                           int parts, void* stream) {
  if (parts == PARTS_ROWS) return launch_lanes<PARTS_ROWS>(z, w, u, out, n, s, k, det, stream);
  if (parts == PARTS_CDF) return launch_lanes<PARTS_CDF>(z, w, u, out, n, s, k, det, stream);
  return (int)cudaErrorInvalidValue;
}

// Lanes per ray, rays per block and the shared memory of a block at (s, k):
// the wrapper holds them against ops/fused_sample_pdf.py.
int sample_pdf_lanes_layout(int what) { return what == 0 ? LANES : what == 1 ? RAYS_PER_BLOCK : -1; }
long long sample_pdf_lanes_smem_bytes(int s, int k) { return (long long)Rows(s, k).bytes(); }

// The first port (one thread per ray), the same function and arguments.
int fused_sample_pdf_merge(const void* z, const void* w, const void* u, void* out, int n, int s,
                           int k, int det, void* stream) {
  const size_t bytes = smem_floats(s, k) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(sample_pdf_merge_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  if (n == 0) return 0;
  const dim3 grid((n + RAYS - 1) / RAYS);
  sample_pdf_merge_kernel<<<grid, RAYS, bytes, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)w, (const float*)u, (float*)out, n, s, k, det);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

}  // extern "C"
