// Warp-level bf16 tensor-core helpers for Hopper (sm_90a), shared by the attention
// kernels of flash_attention.cu, short_attention.cu and window_attention.cu.
//
// Products are mma.sync m16n8k16 (bf16 operands, fp32 accumulators), operands loaded
// from shared memory with ldmatrix. A warp owns 16 rows of a product; in an
// accumulator fragment acc[n][4] a lane holds, for rows g = lane / 4 and g + 8, the
// columns 2t and 2t + 1 (t = lane % 4) of the 8-column tile n: acc[n][0..1] row g,
// acc[n][2..3] row g + 8. Shared-memory tiles are row-major bf16 with rows padded by
// 16 bytes (a row stride of 8 mod 64 elements), so ldmatrix reads no bank twice.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// Asynchronous 16-byte copy global -> shared (cp.async). A copy with inside == false
// reads nothing and fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool inside) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = inside ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until all but the newest PENDING groups of this thread have landed
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2**x on the special-function unit (two ulp): the kernels take their logits in base 2
// (scale * log2(e) folded into one multiply) and skip expf's range reduction.
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the four lanes that hold one fragment row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// acc[16 x 8*NT] += a[16 x 16*KS] . b[8*NT x 16*KS]^T, one warp; a and b row-major
// bf16 tiles in shared memory. Only the first nt (even, <= NT) column tiles are
// computed; the others are left as they are.
template <int KS, int NT>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const bf16* a, int lda, const bf16* b,
                                        int ldb, int nt = NT) {
  const int lane = threadIdx.x & 31;
  const bf16* ap = a + (lane % 8 + 8 * ((lane / 8) % 2)) * lda + 8 * (lane / 16);
  const bf16* bp = b + (lane % 8 + 8 * (lane / 16)) * ldb + 8 * ((lane / 8) % 2);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t fa[4];
    ldmatrix_x4(fa, ap + 16 * ks);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n < nt) {
        uint32_t fb[4];
        ldmatrix_x4(fb, bp + n * 8 * ldb + 16 * ks);
        mma_bf16(acc[n], fa, fb[0], fb[1]);
        mma_bf16(acc[n + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// acc[16 x 8*ND] += a . b[16*ks .. 16*ks + 16) for one A fragment a (16 x 16) and the
// rows 16*ks .. 16*ks + 15 of a row-major (K, 8*ND) tile b; ND may be odd.
template <int ND>
__device__ __forceinline__ void mma_b_rows(float (&acc)[ND][4], const uint32_t (&a)[4],
                                           const bf16* b, int ldb, int ks) {
  const int lane = threadIdx.x & 31;
  const bf16* bp = b + (16 * ks + lane % 8 + 8 * ((lane / 8) % 2)) * ldb + 8 * (lane / 16);
#pragma unroll
  for (int n = 0; n + 1 < ND; n += 2) {
    uint32_t fb[4];
    ldmatrix_x4_trans(fb, bp + n * 8);
    mma_bf16(acc[n], a, fb[0], fb[1]);
    mma_bf16(acc[n + 1], a, fb[2], fb[3]);
  }
  if (ND % 2) {
    uint32_t fb[2];
    ldmatrix_x2_trans(fb, b + (16 * ks + lane % 16) * ldb + 8 * (ND - 1));
    mma_bf16(acc[ND - 1], a, fb[0], fb[1]);
  }
}

// acc[16 x 8*NT] += a . b, one warp; a: 16 x 16*KS as A fragments in registers,
// b: (16*KS, 8*NT) row-major bf16 tile in shared memory.
template <int KS, int NT>
__device__ __forceinline__ void gemm_nn(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                        const bf16* b, int ldb) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) mma_b_rows<NT>(acc, a[ks], b, ldb, ks);
}

// The A fragment of k-step ks (columns 16*ks .. 16*ks + 15) of a 16-row operand in
// shared memory: a row-major (16, K) tile a[m][k], or, with TRANS, the operand's
// transpose stored row-major as a[k][m] (read with ldmatrix.trans).
template <bool TRANS>
__device__ __forceinline__ void load_a(uint32_t (&fa)[4], const bf16* a, int lda, int ks) {
  const int lane = threadIdx.x & 31;
  if (TRANS) {
    ldmatrix_x4_trans(fa, a + (16 * ks + lane % 8 + 8 * (lane / 16)) * lda + 8 * ((lane / 8) % 2));
  } else {
    ldmatrix_x4(fa, a + (lane % 8 + 8 * ((lane / 8) % 2)) * lda + 16 * ks + 8 * (lane / 16));
  }
}

// acc[16 x 8*ND] += A[:, 16*ks0 .. 16*ks1) . b[16*ks0 .. 16*ks1, :), one warp; A as
// load_a<TRANS> reads it, b a row-major (K, 8*ND) tile; both in shared memory.
template <int ND, bool TRANS>
__device__ __forceinline__ void gemm_smem(float (&acc)[ND][4], const bf16* a, int lda,
                                          const bf16* b, int ldb, int ks0, int ks1) {
  for (int ks = ks0; ks < ks1; ++ks) {
    uint32_t fa[4];
    load_a<TRANS>(fa, a, lda, ks);
    mma_b_rows<ND>(acc, fa, b, ldb, ks);
  }
}

// Rows row_lo and row_lo + 8 (if they are < rows) of a warp's accumulator, times mul,
// as bf16 into a tensor whose row r starts at dst + offset(r).
template <int ND, typename Offset>
__device__ __forceinline__ void store_acc(bf16* dst, Offset offset, const float (&acc)[ND][4],
                                          int row_lo, int rows, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row < rows) {
      bf16* out = dst + offset(row) + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

}  // namespace
