// SwitchBack int8 forward for Hopper (sm_90a): the int8 matmul with dequantization,
// and the row-wise quantization of its operands.
//
// THE PRODUCT replaces the TPU kernel open_clip_tpu/ops/switchback.py:_int8_matmul_kernel
// (launched by int8_matmul_dequant):
//
//     out[m, n] = out_dtype( (float(sum_k qx[m, k] * qw[n, k]) * sx[m]) * sw[n] )
//
// qx: (M, K) int8 activations, quantized per row; qw: (N, K) int8 weight, the
// nn.Linear layout, quantized per row of that tensor (the JAX package's
// per-output-column scale of its (K, N) kernel); sx (M,) and sw (N,) fp32 scales.
// Both operands are K-major, the one layout the 8-bit tensor-core instructions take,
// so the weight needs no transpose and no copy. The sum is exact in int32 (|acc| <=
// 127^2 * K, so K <= 133,144; the caller checks), the conversion to fp32 rounds to
// nearest even, and the two scale products are taken in that order, each rounded to
// fp32, then the result is rounded once to the output type (fp32 or bf16). So both
// bodies equal the plain version bit for bit.
//
// Bound on this card: operations. ViT-H-14's MLP at batch 32 (M = 8224, K x N =
// 1280 x 5120) does 2*M*N*K = 107.8 GOP, 0.0545 ms at the int8 tensor-core peak
// (1,979 TOP/s), and moves M*K + N*K + 2*M*N + 4*(M+N) = 101 MB with a bf16 output,
// 0.030 ms at 3.35 TB/s (185 MB, 0.0554 ms, with an fp32 output).
//
// Two bodies, picked by the caller (ops/switchback.py:matmul_body), never by a failure:
//   - "wgmma", where K % 16 == 0 and qx, qw are 16-byte aligned (TMA's rule for a
//     row stride and a base): wgmma.mma_async m64n128k32 s32.s8.s8 fed by TMA. A
//     persistent grid, one block on each SM, walks 128 x 128 output tiles, GROUP_M
//     tile rows at a time, so the blocks running together share their qx rows and qw
//     columns in L2. A block is a producer warpgroup (one thread issues every copy;
//     the warpgroup gives its registers to the others) and two consumer warpgroups of
//     64 rows each. K streams through a ring of STAGES stages of 128 bytes of K (both
//     operands' boxes of 128 int8 columns in the 128-byte swizzle, the layout of the
//     bf16 kernels' 64-column boxes), each completing on its "full" mbarrier and
//     refilled once every consumer thread released it on its "empty" one; a stage is
//     four k32 steps. TMA fills what lies past M, N or K with zeros, which add nothing
//     to the sums. The consumers keep one group of products in flight and release a
//     stage as soon as the products that read it are done, so the producer runs up to
//     STAGES stages ahead, into the next tile while this one's epilogue runs. A bf16
//     output whose rows TMA can write (N % 8 == 0) is staged in shared memory in the
//     128-byte swizzle and stored by TMA, which drains it while the warpgroup runs the
//     next tile's products; any other output is stored from the registers. The
//     staged store takes the epilogue's writes out of the products' way, which
//     matters most at ViT-H-14's c_fc (a 42M-value bf16 output, K only 1280). A
//     128 x 256 tile (fewer loads a product, but 3 stages beside its output tile) ran
//     slower at every MLP shape;
//   - "mma", for every other shape (K = 1, 24, 40, ...; a misaligned base):
//     mma.sync m16n8k32 s8.s8.s32 on 128 x 128 tiles, one block of 8 warps per tile,
//     each warp 64 x 32 of it; K in 64-byte steps double-buffered with cp.async (16-byte
//     copies where the wgmma rule holds, else a byte at a time), rows padded by 16
//     bytes so that ldmatrix reads no bank twice, ragged edges predicated.
// Both epilogues convert, scale and store each accumulator once, straight from the
// registers (a column pair in one store where N is even): no atomics, no partial sums
// across blocks, the same bits every run. Shared memory: wgmma 6 stages x (128 + 128)
// x 128 + the 32 KB bf16 output tile (7 stages without it) + 1,024 for the alignment =
// 230,400 bytes; mma 2 x (128 + 128) x 80 = 40,960 bytes.
//
// THE QUANTIZATION (quantize_rowwise; the JAX package leaves it to XLA, which fuses it
// into one reduce-and-map pass): for each row of a (M, K) bf16 or fp32 tensor,
//     scale = fmaxf(absmax, 1e-8) / 127,  q = clamp(rint(x / scale), -127, 127)
// with true IEEE divisions and rounding half to even, as the plain version computes
// them on the CPU (and jnp.round). absmax in fp32 (|x| of a bf16 or fp32 value is
// exact there). Bound: bytes, M*K*(size + 1) + 4*M, read once and written once:
// 0.038 ms for ViT-H-14's c_proj input (8224 x 5120 bf16) at 3.35 TB/s. A row is read
// once, in 16-byte vectors, and held in registers (TPR threads a row, up to 8 vectors
// a thread: a warp a row up to 4 KB, a block a row up to 32 KB), reduced across its
// threads, then quantized from the registers and written as 8- or 4-byte words. Rows
// that are longer, or not 16-byte vectors, take a warp a row that reads them twice.
//
// C interface, loaded with ctypes: each function returns the cudaError_t of its
// launch (0 on success), launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// the wgmma body
// ---------------------------------------------------------------------------

template <bool TMA_OUT_>
struct WgTile {
  static constexpr int BM = 128, BN = 128;  // output tile
  static constexpr bool TMA_OUT = TMA_OUT_;  // bf16 output staged in shared memory, TMA-stored
  static constexpr int BK = 128;            // K bytes (int8 values) a stage: 4 k32 steps
  static constexpr int NT = BN / 8;         // n8 column groups of a consumer's accumulator
  static constexpr int CONSUMERS = 256;     // two warpgroups, 64 rows each
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128*40 + 256*232 <= 65,536
  static constexpr int A_BYTES = BM * BK, STAGE_BYTES = (BM + BN) * BK;
  static constexpr int OUT_BYTES = TMA_OUT ? BM * BN * 2 : 0;  // both warpgroups' bf16 tiles
  // as many stages as fit beside the output tile: 6, or 7 without it
  static constexpr int STAGES = (230400 - 1024 - OUT_BYTES) / STAGE_BYTES;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + OUT_BYTES + 1024;  // + alignment
};
constexpr int GROUP_M = 8;  // tile rows walked together

// tile -> (tile row, tile column): GROUP_M tile rows at a time, the row fastest
__device__ __forceinline__ void tile_coords(int tile, int tiles_m, int tiles_n, int& tm, int& tn) {
  const int per_group = GROUP_M * tiles_n, group = tile / per_group;
  const int first = group * GROUP_M, rows = min(GROUP_M, tiles_m - first);
  const int r = tile - group * per_group;
  tm = first + r % rows;
  tn = r / rows;
}

// The accumulators of one consumer warpgroup, 64 rows from row0 by 8 * NT columns
// from col0 (the m64nNk32 fragment: d[j][c] at row (warp % 4) * 16 + lane / 4 + 8 *
// (c / 2), column 8 * j + 2 * (lane % 4) + c % 2), converted, scaled and stored.
template <int NT, typename OutT>
__device__ __forceinline__ void store_tile(const int (&acc)[NT][4], const float* __restrict__ sx,
                                           const float* __restrict__ sw, OutT* __restrict__ out,
                                           int row0, int col0, int M, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + (threadIdx.x >> 5 & 3) * 16 + g;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + half * 8;
    if (row >= M) continue;
    const float s_row = sx[row];
    OutT* orow = out + (long long)row * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + j * 8 + 2 * t;
      if (col >= N) continue;
      const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * half]), s_row), sw[col]);
      if (pairs) {
        const float v1 =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * half + 1]), s_row), sw[col + 1]);
        store2(orow + col, v0, v1);
      } else {
        store1(orow + col, v0);
        if (col + 1 < N)
          store1(orow + col + 1,
                 __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * half + 1]), s_row), sw[col + 1]));
      }
    }
  }
}

// The same values, bf16, into the warpgroup's 64 x 8 * NT output tile in shared memory
// at ost: boxes of 64 rows by 64 columns (8 KB), in the 128-byte swizzle that the
// output's tensor map reads (the 16-byte chunk c of row r at c ^ (r % 8)), so the 8
// rows of a warp's store land in 8 different bank groups. Values past M or N are
// staged with zero scales; TMA does not store them.
template <int NT>
__device__ __forceinline__ void stage_tile(const int (&acc)[NT][4], const float* __restrict__ sx,
                                           const float* __restrict__ sw, unsigned char* ost,
                                           int row0, int col0, int M, int N) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lr0 = (threadIdx.x >> 5 & 3) * 16 + g;
  float w[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    w[j][0] = col < N ? sw[col] : 0.f;
    w[j][1] = col + 1 < N ? sw[col + 1] : 0.f;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int lr = lr0 + half * 8, row = row0 + lr;
    const float s_row = row < M ? sx[row] : 0.f;
    unsigned char* orow = ost + lr * 128 + 4 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * half]), s_row), w[j][0]);
      const float v1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * half + 1]), s_row), w[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(orow + (j / 8) * 8192 + (((j % 8) ^ (lr % 8)) * 16)) =
          __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    }
  }
}

template <bool TMA_OUT, typename OutT>
__global__ void __launch_bounds__(WgTile<TMA_OUT>::THREADS, 1)
    int8_matmul_dequant_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                                     const __grid_constant__ CUtensorMap tw,
                                     const __grid_constant__ CUtensorMap to,  // out (TMA_OUT)
                                     const float* __restrict__ sx, const float* __restrict__ sw,
                                     OutT* __restrict__ out, int M, int N, int K) {
  using W = WgTile<TMA_OUT>;
  extern __shared__ unsigned char sb_smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[W::STAGES], empty_bar[W::STAGES];
  // [STAGES][A: 128 rows, B: 128 rows][128 bytes], then (TMA_OUT) [2 warpgroups][64 rows][128 bf16]
  unsigned char* smem = swizzle_aligned(sb_smem_raw);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_m = (M + W::BM - 1) / W::BM, tiles_n = (N + W::BN - 1) / W::BN;
  const int tiles = tiles_m * tiles_n, kblocks = (K + W::BK - 1) / W::BK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < W::STAGES; ++st) {
      mbar_init(&full_bar[st], 1);
      mbar_init(&empty_bar[st], W::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread issues every copy ----
    regs_dec<W::PRODUCER_REGS>();
    if (warp != 0 || lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int tm, tn;
      tile_coords(tile, tiles_m, tiles_n, tm, tn);
      for (int kb = 0; kb < kblocks; ++kb) {
        mbar_wait(&empty_bar[stage], phase ^ 1);  // every consumer released it
        mbar_arrive_expect_tx(&full_bar[stage], W::STAGE_BYTES);
        unsigned char* a = smem + stage * W::STAGE_BYTES;
        tma_load_3d(a, &tx, &full_bar[stage], kb * W::BK, tm * W::BM, 0);
        tma_load_3d(a + W::A_BYTES, &tw, &full_bar[stage], kb * W::BK, tn * W::BN, 0);
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile ----
  regs_inc<W::CONSUMER_REGS>();
  const int wg = (warp >> 2) - 1;
  int stage = 0;
  uint32_t phase = 0;
  int acc[W::NT][4];
#pragma unroll
  for (int j = 0; j < W::NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int tm, tn;
    tile_coords(tile, tiles_m, tiles_n, tm, tn);
    int prev = 0;
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(&full_bar[stage], phase);
      const uint32_t base = smem_u32(smem + stage * W::STAGE_BYTES);
      const uint64_t da = wgmma_desc(base + wg * 64 * 128, false);
      const uint64_t db = wgmma_desc(base + W::A_BYTES, false);
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < W::BK / 32; ++ks)  // a k32 step is 32 bytes: 2 in the descriptor
        wgmma_s8_m64n128k32_ss(acc, da + 2 * ks, db + 2 * ks, (kb | ks) != 0);
      wgmma_commit();
      if (kb > 0) {  // the previous stage's products are done: release it
        wgmma_wait<1>();
        pin(acc);
        mbar_arrive(&empty_bar[prev]);
      }
      prev = stage;
      if (++stage == W::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    pin(acc);
    mbar_arrive(&empty_bar[prev]);
    const int row0 = tm * W::BM + wg * 64, col0 = tn * W::BN;
    if constexpr (W::TMA_OUT) {
      // stage the tile in shared memory and let TMA store it while the next tile's
      // products run; the buffer is rewritten once the last store has read it
      unsigned char* ost = smem + W::STAGES * W::STAGE_BYTES + wg * (W::OUT_BYTES / 2);
      const bool issuer = threadIdx.x % 128 == 0;
      if (issuer) tma_store_wait_read<0>();
      named_barrier(1 + wg, 128);
      stage_tile<W::NT>(acc, sx, sw, ost, row0, col0, M, N);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (issuer) {
#pragma unroll
        for (int b = 0; b < W::BN / 64; ++b)
          tma_store_3d(&to, ost + b * 8192, col0 + 64 * b, row0, 0);
        tma_store_commit();
      }
    } else {
      store_tile<W::NT>(acc, sx, sw, out, row0, col0, M, N);
    }
  }
  if constexpr (W::TMA_OUT)
    if (threadIdx.x % 128 == 0) tma_store_wait<0>();  // the last stores are done
}

// ---------------------------------------------------------------------------
// the row-wise quantization
// ---------------------------------------------------------------------------

constexpr int Q_THREADS = 256;  // threads a block
constexpr int Q_NV = 8;         // 16-byte vectors a thread holds at most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quantize1(float v, float s) {
  return __float2int_rn(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

// the floats of a 16-byte vector: 8 bf16 or 4 fp32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[16 / sizeof(T)]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// TPR threads a row, 256 / TPR rows a block; a row of K values is K * sizeof(T) / 16
// vectors, at most TPR * Q_NV, each read once into registers.
template <typename T, int TPR>
__global__ void __launch_bounds__(Q_THREADS)
    quantize_rowwise_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                            float* __restrict__ scale, int M, int K) {
  constexpr int PER = 16 / sizeof(T);  // values a vector
  constexpr int ROWS = Q_THREADS / TPR, WPR = TPR / 32;
  __shared__ float red[Q_THREADS / 32];
  const int sub = threadIdx.x / TPR, i = threadIdx.x % TPR, warp = threadIdx.x / 32;
  const long long row = (long long)blockIdx.x * ROWS + sub;
  const bool live = row < M;
  const int nvec = K / PER;
  const uint4* src = reinterpret_cast<const uint4*>(x + (live ? row : 0) * K);
  uint4 v[Q_NV];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < Q_NV; ++j) {
    if (live && i + j * TPR < nvec) {
      v[j] = src[i + j * TPR];
      float f[PER];
      unpack<T>(v[j], f);
#pragma unroll
      for (int e = 0; e < PER; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if constexpr (WPR > 1) {
    if ((threadIdx.x & 31) == 0) red[warp] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WPR; ++w) amax = fmaxf(amax, red[sub * WPR + w]);
  }
  if (!live) return;
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  if (i == 0) scale[row] = s;
  int8_t* dst = q + row * K;
#pragma unroll
  for (int j = 0; j < Q_NV; ++j) {
    const int c = i + j * TPR;
    if (c < nvec) {
      float f[PER];
      unpack<T>(v[j], f);
      if constexpr (PER == 8) {
        const uint2 w = make_uint2(
            pack4(quantize1(f[0], s), quantize1(f[1], s), quantize1(f[2], s), quantize1(f[3], s)),
            pack4(quantize1(f[4], s), quantize1(f[5], s), quantize1(f[6], s), quantize1(f[7], s)));
        *reinterpret_cast<uint2*>(dst + c * PER) = w;
      } else {
        *reinterpret_cast<uint32_t*>(dst + c * PER) =
            pack4(quantize1(f[0], s), quantize1(f[1], s), quantize1(f[2], s), quantize1(f[3], s));
      }
    }
  }
}

// Any row: a warp a row, one value a lane at a time, read once for the absmax and
// again (from the caches) to quantize.
template <typename T>
__global__ void __launch_bounds__(Q_THREADS)
    quantize_rowwise_any_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                float* __restrict__ scale, int M, int K) {
  const long long row = (long long)blockIdx.x * (Q_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= M) return;  // the whole warp
  const T* src = x + row * K;
  float amax = 0.f;
  for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(to_float(src[c])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.f);
  if (lane == 0) scale[row] = s;
  for (int c = lane; c < K; c += 32) q[row * K + c] = (int8_t)quantize1(to_float(src[c]), s);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename OutT>
cudaError_t launch_mma(const void* qx, const void* qw, const void* sx, const void* sw, void* out,
                       int M, int N, int K, bool vec, cudaStream_t stream) {
  if ((M + BM - 1) / BM > 65535) return cudaErrorInvalidValue;
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

template <bool TMA_OUT, typename OutT>
cudaError_t launch_wgmma(const void* qx, const void* qw, const void* sx, const void* sw, void* out,
                         int M, int N, int K, cudaStream_t stream) {
  using W = WgTile<TMA_OUT>;
  CUtensorMap tx, tw, to{};  // (rows, K) int8, boxes of 128 K bytes by 128 rows
  if (!encode_rows_3d(&tx, qx, K, M, 1, K, (long long)K * M, W::BM,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !encode_rows_3d(&tw, qw, K, N, 1, K, (long long)K * N, W::BN, CU_TENSOR_MAP_DATA_TYPE_UINT8))
    return cudaErrorInvalidValue;
  // out (M, N) bf16 in boxes of 64 columns by a warpgroup's 64 rows
  if (TMA_OUT && !encode_rows_3d(&to, out, N, M, 1, 2LL * N, 2LL * N * M, 64))
    return cudaErrorInvalidValue;
  auto kern = int8_matmul_dequant_wgmma_kernel<TMA_OUT, OutT>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)W::SMEM);
  if (e != cudaSuccess) return e;
  int grid;
  const long long tiles = (long long)((M + W::BM - 1) / W::BM) * ((N + W::BN - 1) / W::BN);
  if ((e = persistent_grid(tiles, grid)) != cudaSuccess) return e;
  kern<<<grid, W::THREADS, W::SMEM, stream>>>(tx, tw, to, static_cast<const float*>(sx),
                                               static_cast<const float*>(sw),
                                               static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_product(const void* qx, const void* qw, const void* sx, const void* sw,
                           void* out, int M, int N, int K, int body, cudaStream_t stream) {
  const bool aligned = K % 16 == 0 && reinterpret_cast<uintptr_t>(qx) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(qw) % 16 == 0;
  if (body == 0) return launch_mma<OutT>(qx, qw, sx, sw, out, M, N, K, aligned, stream);
  if (body != 1 || !aligned) return cudaErrorInvalidValue;  // wgmma: TMA's rule
  // a bf16 output whose rows TMA can write (16-byte row strides, an aligned base) is
  // staged and TMA-stored; any other is stored from the registers
  if (std::is_same<OutT, __nv_bfloat16>::value && N % 8 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0)
    return launch_wgmma<true, OutT>(qx, qw, sx, sw, out, M, N, K, stream);
  return launch_wgmma<false, OutT>(qx, qw, sx, sw, out, M, N, K, stream);
}

// TPR threads a row, 256 / TPR rows a block
template <typename T, int TPR>
cudaError_t launch_rows(const T* x, int8_t* q, float* scale, int M, int K, cudaStream_t stream) {
  const long long rows = Q_THREADS / TPR, blocks = ((long long)M + rows - 1) / rows;
  quantize_rowwise_kernel<T, TPR><<<(unsigned)blocks, Q_THREADS, 0, stream>>>(x, q, scale, M, K);
  return cudaGetLastError();
}

// the fewest threads a row that hold it in registers, or the any-row kernel
template <typename T>
cudaError_t launch_quantize(const void* x, void* q, void* scale, int M, int K,
                            cudaStream_t stream) {
  const auto* src = static_cast<const T*>(x);
  auto* dq = static_cast<int8_t*>(q);
  auto* ds = static_cast<float*>(scale);
  const long long bytes = (long long)K * sizeof(T), nvec = bytes / 16;
  if (bytes % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    if (nvec <= 32 * Q_NV) return launch_rows<T, 32>(src, dq, ds, M, K, stream);
    if (nvec <= 64 * Q_NV) return launch_rows<T, 64>(src, dq, ds, M, K, stream);
    if (nvec <= 128 * Q_NV) return launch_rows<T, 128>(src, dq, ds, M, K, stream);
    if (nvec <= 256 * Q_NV) return launch_rows<T, 256>(src, dq, ds, M, K, stream);
  }
  const long long blocks = ((long long)M + Q_THREADS / 32 - 1) / (Q_THREADS / 32);
  quantize_rowwise_any_kernel<T><<<(unsigned)blocks, Q_THREADS, 0, stream>>>(src, dq, ds, M, K);
  return cudaGetLastError();
}

}  // namespace

// qx (M, K) int8, qw (N, K) int8, sx (M,) fp32, sw (N,) fp32, out (M, N): all
// contiguous. out_dtype: 0 = float32, 1 = bfloat16. body: 0 = mma (16-byte copies
// where K % 16 == 0 and qx, qw are 16-byte aligned, else byte-wise), 1 = wgmma, which
// takes only such shapes (else cudaErrorInvalidValue). M, N, K >= 1.
extern "C" int oct_int8_matmul_dequant(const void* qx, const void* qw, const void* sx,
                                       const void* sw, void* out, int M, int N, int K,
                                       int out_dtype, int body, void* stream) {
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return (int)launch_product<float>(qx, qw, sx, sw, out, M, N, K, body, s);
  if (out_dtype == 1)
    return (int)launch_product<__nv_bfloat16>(qx, qw, sx, sw, out, M, N, K, body, s);
  return (int)cudaErrorInvalidValue;
}

// x (M, K) contiguous, dtype 0 = float32, 1 = bfloat16; q (M, K) int8 and scale (M,)
// fp32 written. M, K >= 1.
extern "C" int oct_quantize_rowwise(const void* x, void* q, void* scale, int M, int K, int dtype,
                                    void* stream) {
  if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_quantize<float>(x, q, scale, M, K, s);
  if (dtype == 1) return (int)launch_quantize<__nv_bfloat16>(x, q, scale, M, K, s);
  return (int)cudaErrorInvalidValue;
}
