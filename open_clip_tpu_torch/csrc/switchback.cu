// SwitchBack int8 matmul with dequantization for Hopper (sm_90a).
//
// Replaces the TPU kernel open_clip_tpu/ops/switchback.py:_int8_matmul_kernel
// (launched by int8_matmul_dequant):
//
//     out[m, n] = out_dtype( (float(sum_k qx[m, k] * qw[n, k]) * sx[m]) * sw[n] )
//
// qx: (M, K) int8 activations, quantized per row; qw: (N, K) int8 weight, the
// nn.Linear layout, quantized per row of that tensor (the JAX package's
// per-output-column scale of its (K, N) kernel); sx (M,) and sw (N,) fp32 scales.
// Both operands are K-major, which is the "row.col" operand layout of the int8
// tensor-core instruction, so the weight needs no transpose and no copy. The sum
// is exact in int32 (|acc| <= 127^2 * K, so K <= 133,144; the caller checks), the
// conversion to fp32 rounds to nearest even, and the two scale products are taken
// in that order, each rounded to fp32, then the result is rounded once to the
// output type (fp32 or bf16). So the kernel equals its plain version bit for bit.
//
// Bound on this card: operations and bytes nearly alike. ViT-H-14's MLP at batch
// 32 (M = 8224, K x N = 1280 x 5120) does 2*M*N*K = 107.8 GOP, 0.0545 ms at the
// int8 tensor-core peak (1,979 TOP/s), and moves M*K + N*K + 4*M*N + 4*(M+N) =
// 185 MB with an fp32 output, 0.0554 ms at 3.35 TB/s (101 MB, 0.030 ms, with a
// bf16 output). So the products run on the tensor cores, mma.sync m16n8k32
// s8.s8.s32, operands loaded from shared memory with ldmatrix, int32 accumulators
// in registers, and each output is written once. What the design does:
//   - one block of 8 warps per 128 x 128 output tile; each warp owns 64 x 32 of
//     it (4 x 4 fragments, 64 int32 accumulators a thread);
//   - K streams through shared memory in 64-byte steps, double-buffered with
//     cp.async, so the next step travels while the block computes on this one;
//     rows are padded by 16 bytes so that ldmatrix reads no bank twice;
//   - the ragged edges of M, N and K are predicated: a copy past an edge reads
//     nothing and fills zeros, which add nothing to the sums; nothing is padded in
//     device memory. Where K is no multiple of 16 (or a pointer is not 16-byte
//     aligned) the tiles are staged a byte at a time instead (only small shapes);
//   - the epilogue converts, scales and stores each accumulator once: no atomics,
//     no partial sums across blocks, the same bits every run.
// Not done yet (a later change): wgmma with TMA-fed shared memory rings, deeper
// pipelines, a persistent grid, and quantizing the activations inside the kernel.
//
// Shared memory per block: 2 stages x (128 + 128) rows x 80 bytes = 40,960 bytes.
//
// C interface, loaded with ctypes: the function returns the cudaError_t of its
// launch (0 on success), launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows per block
constexpr int BN = 128;          // output columns per block
constexpr int BK = 64;           // K bytes (int8 values) per pipeline step
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr int WM = BM / WARPS_M;  // 64 rows per warp
constexpr int WN = BN / WARPS_N;  // 32 columns per warp
constexpr int MT = WM / 16;       // m16 fragments per warp
constexpr int NT = WN / 8;        // n8 fragments per warp
constexpr int LDS = BK + 16;      // shared row stride in bytes
constexpr int CHUNKS = BK / 16;   // 16-byte copies per tile row
static_assert(BM == BN, "one staging routine serves both operands");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool inside) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = inside ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Rows [r0, r0 + 128) and bytes [k0, k0 + 64) of a (rows, K) int8 matrix into a
// shared tile; what lies past either edge becomes zeros. VEC: 16-byte cp.async
// copies (K a multiple of 16, 16-byte aligned base); else one byte at a time.
template <bool VEC>
__device__ __forceinline__ void stage(int8_t* dst, const int8_t* src, int rows, int K, int r0,
                                      int k0) {
  if (VEC) {
    for (int i = threadIdx.x; i < BM * CHUNKS; i += THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 16;
      const int row = r0 + r, col = k0 + c;
      const bool inside = row < rows && col < K;
      const int8_t* p = inside ? src + (long long)row * K + col : src;
      cp_async16(dst + r * LDS + c, p, inside);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int row = r0 + r, col = k0 + c;
      dst[r * LDS + c] = (row < rows && col < K) ? src[(long long)row * K + col] : int8_t(0);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16_rn(a),
                                                              __float2bfloat16_rn(b));
}

// One 128 x 128 output tile. Fragment layouts of mma.m16n8k32 (PTX ISA): with
// g = lane / 4 and t = lane % 4, A's four registers hold rows g, g + 8, g, g + 8
// at K bytes 4t..4t+3, 4t..4t+3, 16+4t.., 16+4t..; B's two hold column g at K
// bytes 4t.. and 16+4t..; the accumulator holds rows g and g + 8 at columns 2t and
// 2t + 1. ldmatrix.x4 on 8 x 16-byte matrices yields exactly these registers.
template <bool VEC, typename OutT>
__global__ void __launch_bounds__(THREADS)
    int8_matmul_dequant_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
                               const float* __restrict__ sx, const float* __restrict__ sw,
                               OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) int8_t sa[2][BM * LDS];
  __shared__ __align__(128) int8_t sb[2][BN * LDS];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int steps = (K + BK - 1) / BK;
  stage<VEC>(sa[0], qx, M, K, m0, 0);
  stage<VEC>(sb[0], qw, N, K, n0, 0);
  cp_async_commit();

  // ldmatrix addresses: A rows (lane % 16) at K byte 16 * (lane / 16); B columns
  // (lane % 8) + 8 * (lane / 16) at K byte 16 * ((lane / 8) % 2)
  const int a_row = lane % 16, a_col = (lane / 16) * 16;
  const int b_row = (lane % 8) + (lane / 16) * 8, b_col = ((lane / 8) % 2) * 16;

  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps) {
      stage<VEC>(sa[cur ^ 1], qx, M, K, m0, (s + 1) * BK);
      stage<VEC>(sb[cur ^ 1], qw, N, K, n0, (s + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step has landed; the next may still be in flight
    __syncthreads();

    const int8_t* ta = sa[cur];
    const int8_t* tb = sb[cur];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(af[i], ta + (wm + i * 16 + a_row) * LDS + ks + a_col);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, tb + (wn + j * 8 + b_row) * LDS + ks + b_col);
        bf[j][0] = r[0], bf[j][1] = r[1], bf[j + 1][0] = r[2], bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  const int g = lane / 4, t = lane % 4;
  const bool pairs = (N % 2) == 0;  // an even column and its neighbour: one aligned store
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + i * 16 + g + half * 8;
      if (row >= M) continue;
      const float s_row = sx[row];
      OutT* orow = out + (long long)row * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn + j * 8 + 2 * t;
        if (col >= N) continue;
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half]), s_row), sw[col]);
        if (pairs) {
          const float v1 =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]), s_row), sw[col + 1]);
          store2(orow + col, v0, v1);
        } else {
          store1(orow + col, v0);
          if (col + 1 < N)
            store1(orow + col + 1, __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * half + 1]),
                                                       s_row), sw[col + 1]));
        }
      }
    }
  }
}

template <typename OutT>
cudaError_t launch(const void* qx, const void* qw, const void* sx, const void* sw, void* out,
                   int M, int N, int K, int vec, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const auto* a = static_cast<const int8_t*>(qx);
  const auto* b = static_cast<const int8_t*>(qw);
  const auto* fx = static_cast<const float*>(sx);
  const auto* fw = static_cast<const float*>(sw);
  auto* o = static_cast<OutT*>(out);
  if (vec)
    int8_matmul_dequant_kernel<true, OutT><<<grid, THREADS, 0, stream>>>(a, b, fx, fw, o, M, N, K);
  else
    int8_matmul_dequant_kernel<false, OutT><<<grid, THREADS, 0, stream>>>(a, b, fx, fw, o, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// qx (M, K) int8, qw (N, K) int8, sx (M,) fp32, sw (N,) fp32, out (M, N): all
// contiguous. out_dtype: 0 = float32, 1 = bfloat16. vec: 1 when K is a multiple of
// 16 and qx, qw are 16-byte aligned (the 16-byte copy path), else 0. M, N, K >= 1.
extern "C" int oct_int8_matmul_dequant(const void* qx, const void* qw, const void* sx,
                                       const void* sw, void* out, int M, int N, int K,
                                       int out_dtype, int vec, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return (int)launch<float>(qx, qw, sx, sw, out, M, N, K, vec, s);
  if (out_dtype == 1) return (int)launch<__nv_bfloat16>(qx, qw, sx, sw, out, M, N, K, vec, s);
  return (int)cudaErrorInvalidValue;
}
