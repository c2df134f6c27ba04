// Hopper (sm_90a) primitives of the redesigned training render kernels
// (fused_render_train_sm90.cu): inline-PTX wrappers only, no CUTLASS.
//
//   mbarrier       init, arrive, arrive with an expected transaction count,
//                  try-wait on a phase parity
//   bulk copies    1-D cp.async.bulk global -> shared (completes on an
//                  mbarrier) and shared -> global (a bulk group)
//   proxy fences   fence.proxy.async.shared::cta: generic-proxy writes to
//                  shared memory become visible to wgmma and the bulk copies;
//                  fence.proxy.async.global: those to global memory, to the
//                  bulk copies
//   wgmma          shared-memory descriptors with the 128-byte swizzle,
//                  fence / commit_group / wait_group, and
//                  mma_async m64nNk16 f32 += bf16 x bf16 for N = 64, 128, 256,
//                  each operand K-major or MN-major (the transpose bits)
//   setmaxnreg     register reallocation between warpgroups
//   red_add_v4     one 16-byte vector reduction into global memory
//   clusters       the CTA's rank, a cluster-wide barrier, an mbarrier
//                  arrival in a partner CTA, a bulk copy multicast to the
//                  cluster's CTAs; named-barrier arrival without waiting
//
// The 128-byte swizzle: a row of 64 bf16 values (128 bytes) holds eight
// 16-byte chunks, chunk c of row r at position c ^ (r % 8), the rows of a
// swizzle atom 128 bytes apart and every atom on a 1,024-byte boundary
// (ops/sm90_layout.py builds and tests the same byte order on the host).
// No TPU kernel corresponds to this file: it holds the building blocks of the
// Hopper K3 kernels, whose notes give what they replace and their bounds.
// Tested as the port's other kernels are: the CPU tests run their plain
// versions as before (tests/test_torch_k3_sm90.py pins the slab layout); on
// the card, python3 chip_smoke.py builds, checks and times them.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Spins until the phase of parity ``parity`` has completed.  A fresh barrier
// is in phase 0: waiting on parity 1 returns at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// -------------------------------------------------------------- bulk copies
// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory; completes ``bytes`` transactions on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// ``bytes`` from shared to global memory, in the thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(smem_addr(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;" ::: "memory"); }

// The thread's bulk stores have read their shared-memory sources.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); }

// The thread's bulk stores are complete (visible in global memory).
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;" ::: "memory"); }

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The thread's generic-proxy writes to global memory become visible to bulk
// copies that read them (after a barrier orders the copy's issue behind them).
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// ---------------------------------------------------------------- barriers
// Named barrier ``id`` over ``count`` threads (whole warps).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor with the 128-byte swizzle.  K-major: sbo is
// the stride of 8-row groups along M/N, lbo unused.  MN-major: lbo is the
// stride of 64-wide atoms along M/N, sbo that of 8-row groups along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo & 0x3FFFF) >> 4) << 16;
  d |= (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
  d |= (uint64_t)1 << 62;  // SWIZZLE_128B
  return d;
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads across a wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_R8(i) "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x N] (+)= A[64 x 16] B[16 x N]; scale_d = 0 overwrites d.  TA, TB: 1
// for an MN-major operand.  Accumulator layout (per thread t of the
// warpgroup, warp w = t / 32, lane l): d[4j + 2i + e] is row 16w + l/4 + 8i,
// column 8j + 2(l % 4) + e.
template <int TA, int TB>
__device__ __forceinline__ void mma_m64n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31},"
      " %32, %33, p, 1, 1, %35, %36;\n}"
      : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63},"
      " %64, %65, p, 1, 1, %67, %68;\n}"
      : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24), SM90_R8(32), SM90_R8(40), SM90_R8(48), SM90_R8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_m64n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
      "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
      "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127},"
      " %128, %129, p, 1, 1, %131, %132;\n}"
      : SM90_R8(0), SM90_R8(8), SM90_R8(16), SM90_R8(24), SM90_R8(32), SM90_R8(40), SM90_R8(48), SM90_R8(56),
        SM90_R8(64), SM90_R8(72), SM90_R8(80), SM90_R8(88), SM90_R8(96), SM90_R8(104), SM90_R8(112),
        SM90_R8(120)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

#undef SM90_R8

// ---------------------------------------------------------------- clusters
// (the kernel experiment X1's 2-CTA variant, exp_kernel_variants_sm90.cu)
// The CTA's rank within its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives, then waits for all:
// shared-memory writes before it (barrier inits included) are visible
// cluster-wide after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;" ::: "memory");
}

// One arrival on the mbarrier at ``bar``'s offset in the shared memory of
// the cluster's CTA ``rank``.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(remote) : "memory");
}

// bulk_load to the same offsets (``dst``, and ``bar`` for the bytes' arrival)
// in the shared memory of every CTA of the cluster whose bit is set in
// ``mask``.
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], %4;"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// Arrive at named barrier ``id`` (of ``count`` threads) without waiting: the
// signalling side of a bar.sync on the same id.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------- other
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(REGS));
}

// p[0..3] += (a, b, c, d) as one vector reduction (p 16-byte aligned):
// red.global.add.v4.f32, one instruction where four scalar atomics were.
__device__ __forceinline__ void red_add_v4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

}  // namespace sm90
