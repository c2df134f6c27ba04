// K2: inverse-CDF importance resampling merged with the coarse depths.
//
// Replaces the TPU kernel sinnerf_tpu/ops/fused_sample_pdf_t.py::_kernel
// (:61, with _bitonic_merge_rows :47), called through fused_sample_pdf_merge
// (:132).  Wrapper, plain version and launch counter:
// ops/fused_sample_pdf.py.
//
// One thread per ray, RAYS rays per block.  The block stages its rays' z and
// w rows in shared memory with coalesced loads (rows padded by one float so a
// thread's walk along its own row is free of bank conflicts).  Per ray:
//   pdf = (w[1:-1] + 1e-5) / sum, with the sum and the exclusive CDF taken in
//   sequential f32 order (the plain version uses the same order);
//   for each of the K u-values (det: i / max(K-1, 1); stochastic: (i + u_i)/K,
//   each a multiply by the f32 reciprocal)
//   a right-searchsorted over the monotone CDF, which equals the TPU kernel's
//   masked extrema (fused_sample_pdf_t.py:102-115), with the empty "above" set
//   clamped to the last CDF entry and bin and the denom < 1e-5 -> 1 guard;
//   the u-values ascend, so the fine depths come out ascending and a
//   two-pointer merge with the ascending coarse z writes the (S + K) row.
// The row is staged in shared memory and written back coalesced.  The
// bitonic network was a TPU workaround and has no counterpart here.
//
// Bound: bytes.  It reads 2*S*4 B per ray (plus K*4 B of u when stochastic)
// and writes (S+K)*4 B: about 1.8 KB per ray at S = 64, K = 128, 0.34 GB for a
// 504x378 image, 0.1 ms at an H100 SXM's 3.35 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int RAYS = 32;
constexpr float EPS = 1e-5f;

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

}  // namespace

extern "C" {

// z, w (n, s) f32, z ascending per row; u (n, k) f32 uniforms in [0, 1) when
// det == 0 (may be null when det != 0).  Writes out (n, s + k) f32, ascending
// per row.  Returns the cudaError_t of the launch.
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
