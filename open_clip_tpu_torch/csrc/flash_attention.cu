// Flash attention for Hopper (sm_90a): forward with logsumexp, backward dq, backward dk/dv.
//
// Replaces the three TPU kernels of open_clip_tpu/ops/flash_attention.py:
// _fa_fwd_kernel (launched by _flash_forward), _fa_bwd_dq_kernel (_bwd_dq) and
// _fa_bwd_dkv_kernel (_bwd_dkv). Self-attention over (B, L, H, hd) tensors with
// hd in {64, 128}, any L >= 1, bf16 or fp32, with three masks applied in the
// kernels: a (B, L) key-validity vector shared by the heads, the causal mask,
// and a bidirectional prefix of the causal mask (prefix-LM). Key j is visible to
// query i iff  valid[b, j]  and  (not causal  or  i >= j  or  j < prefix_len).
//
// FORWARD: tiled online softmax. logits = q.k * scale in fp32; a running max and
// sum per query row; the probabilities are rounded to the input dtype before the
// product with v; the accumulator is fp32; out = acc / sum, written in the input
// dtype, and lse = max + log(sum) as fp32 (B, H, L) for the backward. A masked
// entry has probability exactly 0. A query with no visible key at all gets a zero
// output row (sum is clamped at 1e-30), a finite lse, and zero gradients.
// Padded queries (valid[b, i] false) are computed like any other row.
//
// BACKWARD: from q, k, v, do, out and lse: di = rowsum(out * do) in fp32;
// p = exp(q.k * scale - lse) where visible, else 0; dp = do.v^T;
// ds = p * (dp - di) rounded to the input dtype; dq = scale * ds.k;
// dk = scale * ds^T.q;  dv = p^T.do with p rounded to the input dtype; fp32
// accumulators throughout. dq sums over keys and dk/dv over queries, so they are
// two kernels: one that walks the key tiles of a query tile (dq; it also takes di
// from the rows of out and do it holds and writes it, fp32 (B, H, L), for the
// other), and one that walks the query tiles of a key tile (dk, dv). Every output
// is written once, by one block, in a fixed order: no atomics, and two runs give
// the same bits.
//
// Bound on this card: operations. At L = 1024, hd = 64 a forward call does
// 4*B*H*L^2*hd operations on 4*B*L*H*hd*size bytes, L/size = 512 operations per
// byte in bf16, above the ~295 where the bf16 tensor cores become the limit. So
// the matrix products of the bf16 kernels run on the tensor cores, and what lies
// between two products never leaves the registers: the logits, the probabilities,
// ds and every accumulator; the accumulator fragment of q.k^T is, rounded to bf16,
// the A operand of p.v. At hd = 64 the forward's exponentials (one per logit, on
// the 16-a-clock special-function unit) cost as much time as its products. The fp32
// kernels keep full fp32 and run the same products on CUDA cores, with the score
// tile in shared memory. What else the design does:
//   - q, k, v are read in place from the tower's (B, L, H*hd) layout with a batch
//     and a row stride per tensor, so the three slices of a fused projection need
//     no transpose, no copy and no padding of L; the tail tile is staged as zeros
//     and masked in the kernel;
//   - the three bf16 kernels (the "wgmma" bodies, further down) are Hopper's:
//     warpgroup products (wgmma) on tiles that TMA copies into shared memory, a
//     producer warp and two or three consumer warpgroups on mbarriers, a persistent
//     grid; key tiles that hold no valid key are neither loaded nor multiplied (the
//     forward and dq skip them, dk/dv writes their zero gradients and loads nothing);
//   - the fp32 kernels: one block of 4 warps per (64-row tile, head, sample); each
//     warp owns 16 rows of the tile, so between the loads of two tiles no warp waits
//     for another; K/V (or Q/dO) stream through shared memory in 64-row tiles; key
//     validity is one byte per (sample, key), staged per key tile;
//   - the bf16 kernels take exponentials in base 2 on the special-function unit,
//     and a tile that every row of a warpgroup sees whole skips the mask arithmetic;
//   - under the causal mask the tiles no row of the block can see are skipped,
//     and the prefix tiles are kept.
//
// Shared memory per block (bytes), dynamic, opted in above 48 KB:
//   forward   bf16 hd=64 181,248 or 164,864 (192- or 128-row items)  hd=128 230,400
//             fp32 hd=64 106,752  hd=128 172,288
//   dq        bf16 hd=64 197,632   hd=128 197,632   fp32 hd=64 124,672  hd=128 190,208
//   dk/dv     bf16 hd=64 132,096   hd=128 164,864   fp32 hd=64 142,080  hd=128 207,616
//
// C interface, loaded with ctypes: each function returns the cudaError_t of its
// launch (0 on success), launches on the given stream, does not synchronise and
// allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 64;  // query rows per tile
constexpr int BN = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WR = 16;         // tile rows owned by one warp
constexpr int LDS = BN + 8;    // row stride of an fp32 score tile
constexpr float NEG = -1.7014117e38f;  // finfo(float32).min * 0.5, as the JAX kernel
static_assert(BM == BN && BM == WARPS * WR, "tiles are square, 16 rows per warp");

// row strides (elements) of the tiles held in the input dtype: 16 bytes of padding
template <typename T, int N>
struct Ld {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int value = N + V;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + 64) of one head's (L, HD) slice (row stride rs elements) into a
// shared-memory tile, 16 bytes at a time; rows at or past L become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long rs, int r0, int L) {
  constexpr int V = 16 / sizeof(T);
  constexpr int LD = Ld<T, HD>::value;
  constexpr int VPR = HD / V;
  for (int i = threadIdx.x; i < BM * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * V;
    const int row = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < L) x = *reinterpret_cast<const uint4*>(src + row * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

// One float per tile row from a (L,) vector; rows at or past L become zeros.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int L) {
  if (threadIdx.x < BM) {
    const int row = r0 + threadIdx.x;
    dst[threadIdx.x] = row < L ? src[row] : 0.f;
  }
}

// Does this thread's key of the tile at k0 exist, and is it valid? (1 for the
// threads that hold no key.) The global load starts here; its result is used later.
__device__ __forceinline__ int key_flag(const unsigned char* valid, int k0, int L) {
  int ok = 1;
  if (threadIdx.x < BN) {
    const int kj = k0 + threadIdx.x;
    ok = kj < L && (valid == nullptr || valid[kj] != 0);
  }
  return ok;
}

// The flags of the tile at k0 into shared memory; returns this thread's, for a
// block-wide "all valid" vote.
__device__ __forceinline__ int stage_valid(int* dst, const unsigned char* valid, int k0, int L) {
  const int ok = key_flag(valid, k0, L);
  if (threadIdx.x < BN) dst[threadIdx.x] = ok;
  return ok;
}

// ---------------------------------------------------------------------------
// fp32 kernels: the products on CUDA cores, tiles and scores in shared memory.
// One warp's 16 x N fp32 accumulator lives in registers.
// ---------------------------------------------------------------------------

template <typename T, int N>
struct Acc;

template <int N>
struct Acc<float, N> {
  static constexpr int C = N / 32;  // columns per lane
  float r[WR][C];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WR; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) r[i][c] = 0.f;
  }
  __device__ __forceinline__ void load(const float* m, int ldc) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < WR; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) r[i][c] = m[i * ldc + lane * C + c];
  }
  __device__ __forceinline__ void save(float* m, int ldc) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < WR; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) m[i * ldc + lane * C + c] = r[i][c];
  }
};

// c[16 x 64] = a[16 x KD] . b[64 x KD]^T, one warp; a, b and c in shared memory.
template <int KD>
__device__ __forceinline__ void mm_nt(float* c, int ldc, const float* a, int lda, const float* b,
                                      int ldb) {
  const int lane = threadIdx.x & 31;
  float acc[WR][2];  // the lane's two columns: lane and lane + 32
#pragma unroll
  for (int r = 0; r < WR; ++r) acc[r][0] = acc[r][1] = 0.f;
  const float* b0 = b + lane * ldb;
  const float* b1 = b + (lane + 32) * ldb;
#pragma unroll 2
  for (int d = 0; d < KD; d += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(b0 + d);
    const float4 x1 = *reinterpret_cast<const float4*>(b1 + d);
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const float4 y = *reinterpret_cast<const float4*>(a + r * lda + d);
      acc[r][0] = fmaf(y.x, x0.x, acc[r][0]);
      acc[r][0] = fmaf(y.y, x0.y, acc[r][0]);
      acc[r][0] = fmaf(y.z, x0.z, acc[r][0]);
      acc[r][0] = fmaf(y.w, x0.w, acc[r][0]);
      acc[r][1] = fmaf(y.x, x1.x, acc[r][1]);
      acc[r][1] = fmaf(y.y, x1.y, acc[r][1]);
      acc[r][1] = fmaf(y.z, x1.z, acc[r][1]);
      acc[r][1] = fmaf(y.w, x1.w, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < WR; ++r) {
    c[r * ldc + lane] = acc[r][0];
    c[r * ldc + lane + 32] = acc[r][1];
  }
}

// acc[16 x N] += a[16 x 64] . b[64 x N], one warp; a and b in shared memory.
template <int N>
__device__ __forceinline__ void mm_nn(Acc<float, N>& acc, const float* a, int lda, const float* b,
                                      int ldb) {
  constexpr int C = N / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int j = 0; j < BN; j += 4) {
    float bv[4][C];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < C; ++c) bv[jj][c] = b[(j + jj) * ldb + lane * C + c];
#pragma unroll
    for (int r = 0; r < WR; ++r) {
      const float4 y = *reinterpret_cast<const float4*>(a + r * lda + j);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc.r[r][c] = fmaf(y.x, bv[0][c], acc.r[r][c]);
        acc.r[r][c] = fmaf(y.y, bv[1][c], acc.r[r][c]);
        acc.r[r][c] = fmaf(y.z, bv[2][c], acc.r[r][c]);
        acc.r[r][c] = fmaf(y.w, bv[3][c], acc.r[r][c]);
      }
    }
  }
}

// Rows [row0 + 16*warp, +16) of an fp32 staging tile (stride ld) times `mul` into
// one head's (L, HD) slice of an output; 8 lanes share a row.
template <typename T, int HD>
__device__ __forceinline__ void write_rows(T* dst, long long rs, const float* tile, int ld,
                                           int row0, int L, float mul) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sub = lane >> 3, c8 = lane & 7;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = warp * WR + it * 4 + sub;
    const int row = row0 + r;
    if (row < L) {
      T* out = dst + row * rs;
      const float* in = tile + r * ld;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) store(out + c8 + 8 * i, in[c8 + 8 * i] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int HD>
constexpr size_t fwd_smem() {
  return (size_t)(3 * BM * Ld<T, HD>::value + BM * Ld<T, BN>::value) * sizeof(T) +
         (size_t)(BM * LDS + BM * (HD + 8)) * sizeof(float) + BN * sizeof(int);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const unsigned char* __restrict__ valid, T* __restrict__ o,
                      float* __restrict__ lse, int L, long long qbs, long long qrs, long long kbs,
                      long long krs, long long vbs, long long vrs, long long obs, long long ors,
                      float scale, int causal, int prefix) {
  constexpr int LDT = Ld<T, HD>::value;
  constexpr int LDP = Ld<T, BN>::value;
  constexpr int LDO = HD + 8;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  T* qs = reinterpret_cast<T*>(flash_smem);         // (BM, LDT)
  T* ks = qs + BM * LDT;                            // (BN, LDT)
  T* vs = ks + BN * LDT;                            // (BN, LDT)
  T* ps = vs + BN * LDT;                            // (BM, LDP): probabilities in T
  float* ss = reinterpret_cast<float*>(ps + BM * LDP);  // (BM, LDS): logits
  float* os = ss + BM * LDS;                        // (BM, LDO): accumulator
  int* kvs = reinterpret_cast<int*>(os + BM * LDO);  // (BN,)

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sub = lane >> 3, c8 = lane & 7;
  const T* kh = k + b * kbs + (long long)h * HD;
  const T* vh = v + b * vbs + (long long)h * HD;
  const unsigned char* valid_b = valid == nullptr ? nullptr : valid + (long long)b * L;

  int ntiles = (L + BN - 1) / BN;
  if (causal) {
    // only the tiles up to the diagonal contribute, and those of the prefix
    const int diag = min((q0 + BM + BN - 1) / BN, ntiles);
    const int pre = min((prefix + BN - 1) / BN, ntiles);
    ntiles = max(diag, pre);
  }

  stage_tile<T, HD>(qs, q + b * qbs + (long long)h * HD, qrs, q0, L);
  T* qw = qs + warp * WR * LDT;
  T* pw = ps + warp * WR * LDP;
  float* sw = ss + warp * WR * LDS;
  float* ow = os + warp * WR * LDO;
  for (int i = lane; i < WR * LDO; i += 32) ow[i] = 0.f;
  float m_run[4], l_run[4];
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    m_run[it] = NEG;
    l_run[it] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();
    stage_tile<T, HD>(ks, kh, krs, k0, L);
    stage_tile<T, HD>(vs, vh, vrs, k0, L);
    stage_valid(kvs, valid_b, k0, L);
    __syncthreads();

    mm_nt<HD>(sw, LDS, qw, LDT, ks, LDT);
    __syncwarp();

    // online softmax of the warp's 16 rows: 8 lanes a row, 4 rows at a time
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = it * 4 + sub;
      const int qi = q0 + warp * WR + r;
      const float* srow = sw + r * LDS;
      float s[BN / 8];
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = c8 + 8 * i;
        const int kj = k0 + col;
        const bool vis = kvs[col] && (!causal || kj <= qi || kj < prefix);
        s[i] = vis ? srow[col] * scale : NEG;
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m_run[it], group8_max(mx));
      const float alpha = expf(m_run[it] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const float p = s[i] > NEG ? expf(s[i] - m_new) : 0.f;  // masked: exactly 0
        sum += p;
        store(pw + r * LDP + c8 + 8 * i, p);
      }
      l_run[it] = l_run[it] * alpha + group8_sum(sum);
      m_run[it] = m_new;
      float* orow = ow + r * LDO;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) orow[c8 + 8 * i] *= alpha;
    }
    __syncwarp();

    Acc<T, HD> acc;
    acc.load(ow, LDO);
    mm_nn<HD>(acc, pw, LDP, vs, LDT);
    acc.save(ow, LDO);
    __syncwarp();
  }

  T* oh = o + b * obs + (long long)h * HD;
  float* lse_h = lse + ((long long)b * H + h) * L;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int r = it * 4 + sub;
    const int qi = q0 + warp * WR + r;
    const float l_safe = fmaxf(l_run[it], 1e-30f);
    if (qi < L) {
      T* out = oh + qi * ors;
      const float* orow = ow + r * LDO;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) store(out + c8 + 8 * i, orow[c8 + 8 * i] / l_safe);
      if (c8 == 0) lse_h[qi] = m_run[it] + logf(l_safe);
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dq (one block per query tile, loop over key tiles)
// ---------------------------------------------------------------------------

template <typename T, int HD>
constexpr size_t dq_smem() {
  return (size_t)(4 * BM * Ld<T, HD>::value + BM * Ld<T, BN>::value) * sizeof(T) +
         (size_t)(2 * BM * LDS + 2 * BM) * sizeof(float) + BN * sizeof(int);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         const unsigned char* __restrict__ valid, const T* __restrict__ dout,
                         const T* __restrict__ out, const float* __restrict__ lse,
                         float* __restrict__ di, T* __restrict__ dq, int L, long long qbs,
                         long long qrs, long long kbs, long long krs, long long vbs, long long vrs,
                         long long gbs, long long grs, long long obs, long long ors, long long dqbs,
                         long long dqrs, float scale, int causal, int prefix) {
  constexpr int LDT = Ld<T, HD>::value;
  constexpr int LDP = Ld<T, BN>::value;
  constexpr int LDO = HD + 8;
  static_assert(LDO <= 2 * LDS, "the output staging tile reuses the two score tiles");
  static_assert(THREADS == 2 * BM, "two threads a row for di");
  extern __shared__ __align__(128) unsigned char flash_smem[];
  T* qs = reinterpret_cast<T*>(flash_smem);         // (BM, LDT)
  T* gs = qs + BM * LDT;                            // (BM, LDT): the tile's rows of do
  T* ks = gs + BM * LDT;                            // (BN, LDT)
  T* vs = ks + BN * LDT;                            // (BN, LDT)
  T* ds = vs + BN * LDT;                            // (BM, LDP): ds in T
  float* ss = reinterpret_cast<float*>(ds + BM * LDP);  // (BM, LDS): q.k^T
  float* dd = ss + BM * LDS;                        // (BM, LDS): do.v^T
  float* lses = dd + BM * LDS;                      // (BM,)
  float* dis = lses + BM;                           // (BM,)
  int* kvs = reinterpret_cast<int*>(dis + BM);      // (BN,)

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sub = lane >> 3, c8 = lane & 7;
  const T* kh = k + b * kbs + (long long)h * HD;
  const T* vh = v + b * vbs + (long long)h * HD;
  const unsigned char* valid_b = valid == nullptr ? nullptr : valid + (long long)b * L;
  const long long row_base = ((long long)b * H + h) * L;

  int ntiles = (L + BN - 1) / BN;
  if (causal) {
    const int diag = min((q0 + BM + BN - 1) / BN, ntiles);
    const int pre = min((prefix + BN - 1) / BN, ntiles);
    ntiles = max(diag, pre);
  }

  stage_tile<T, HD>(qs, q + b * qbs + (long long)h * HD, qrs, q0, L);
  stage_tile<T, HD>(gs, dout + b * gbs + (long long)h * HD, grs, q0, L);
  stage_rows(lses, lse + row_base, q0, L);
  __syncthreads();
  {  // di = rowsum(out * do) in fp32, two threads a row; written for the dk/dv kernel
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1, row = q0 + r;
    float sum = 0.f;
    if (row < L) {
      const T* orow = out + b * obs + (long long)h * HD + row * ors;
      for (int c = part * (HD / 2); c < (part + 1) * (HD / 2); ++c)
        sum = fmaf(orow[c], gs[r * LDT + c], sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (part == 0) {
      dis[r] = sum;
      if (row < L) di[row_base + row] = sum;
    }
  }
  T* qw = qs + warp * WR * LDT;
  T* gw = gs + warp * WR * LDT;
  T* dsw = ds + warp * WR * LDP;
  float* sw = ss + warp * WR * LDS;
  float* dw = dd + warp * WR * LDS;
  Acc<T, HD> acc;
  acc.zero();

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();
    stage_tile<T, HD>(ks, kh, krs, k0, L);
    stage_tile<T, HD>(vs, vh, vrs, k0, L);
    stage_valid(kvs, valid_b, k0, L);
    __syncthreads();

    mm_nt<HD>(sw, LDS, qw, LDT, ks, LDT);
    mm_nt<HD>(dw, LDS, gw, LDT, vs, LDT);
    __syncwarp();

#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = it * 4 + sub;
      const int qi = q0 + warp * WR + r;
      const float lse_r = lses[warp * WR + r], di_r = dis[warp * WR + r];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = c8 + 8 * i;
        const int kj = k0 + col;
        const bool vis = kvs[col] && (!causal || kj <= qi || kj < prefix);
        const float p = vis ? expf(sw[r * LDS + col] * scale - lse_r) : 0.f;
        store(dsw + r * LDP + col, p * (dw[r * LDS + col] - di_r));
      }
    }
    __syncwarp();

    mm_nn<HD>(acc, dsw, LDP, ks, LDT);
  }

  __syncthreads();  // every warp is done with the score tiles: reuse them for the output
  float* stage = ss;
  acc.save(stage + warp * WR * LDO, LDO);
  __syncwarp();
  write_rows<T, HD>(dq + b * dqbs + (long long)h * HD, dqrs, stage, LDO, q0, L, scale);
}

// ---------------------------------------------------------------------------
// backward: dk and dv (one block per key tile, loop over query tiles)
// ---------------------------------------------------------------------------

template <typename T, int HD>
constexpr size_t dkv_smem() {
  return (size_t)(4 * BM * Ld<T, HD>::value + 2 * BN * Ld<T, BM>::value) * sizeof(T) +
         (size_t)(2 * BN * LDS + 2 * BM) * sizeof(float) + BN * sizeof(int);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const unsigned char* __restrict__ valid,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                          int L, long long qbs, long long qrs, long long kbs, long long krs,
                          long long vbs, long long vrs, long long gbs, long long grs,
                          long long dkbs, long long dkrs, long long dvbs, long long dvrs,
                          float scale, int causal, int prefix) {
  constexpr int LDT = Ld<T, HD>::value;
  constexpr int LDP = Ld<T, BM>::value;
  constexpr int LDO = HD + 8;
  static_assert(LDO <= 2 * LDS, "the output staging tile reuses the two score tiles");
  extern __shared__ __align__(128) unsigned char flash_smem[];
  T* ks = reinterpret_cast<T*>(flash_smem);         // (BN, LDT): the block's keys
  T* vs = ks + BN * LDT;                            // (BN, LDT): and their values
  T* qs = vs + BN * LDT;                            // (BM, LDT): a query tile
  T* gs = qs + BM * LDT;                            // (BM, LDT): its rows of do
  T* pt = gs + BM * LDT;                            // (BN, LDP): p in T, key-major
  T* dst = pt + BN * LDP;                           // (BN, LDP): ds in T, key-major
  float* st = reinterpret_cast<float*>(dst + BN * LDP);  // (BN, LDS): k.q^T
  float* dpt = st + BN * LDS;                       // (BN, LDS): v.do^T
  float* lses = dpt + BN * LDS;                     // (BM,)
  float* dis = lses + BM;                           // (BM,)
  int* kvk = reinterpret_cast<int*>(dis + BM);      // (BN,): the block's keys exist and are valid

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BN;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sub = lane >> 3, c8 = lane & 7;
  const T* qh = q + b * qbs + (long long)h * HD;
  const T* gh = dout + b * gbs + (long long)h * HD;
  const long long row_base = ((long long)b * H + h) * L;

  // under the causal mask the queries before j0 see none of these keys, unless
  // some of them lie in the prefix
  const int first = (causal && j0 >= prefix) ? j0 / BM : 0;
  const int ntiles = (L + BM - 1) / BM;

  stage_tile<T, HD>(ks, k + b * kbs + (long long)h * HD, krs, j0, L);
  stage_tile<T, HD>(vs, v + b * vbs + (long long)h * HD, vrs, j0, L);
  stage_valid(kvk, valid == nullptr ? nullptr : valid + (long long)b * L, j0, L);
  T* kw = ks + warp * WR * LDT;
  T* vw = vs + warp * WR * LDT;
  T* ptw = pt + warp * WR * LDP;
  T* dstw = dst + warp * WR * LDP;
  float* stw = st + warp * WR * LDS;
  float* dpw = dpt + warp * WR * LDS;
  Acc<T, HD> acc_k, acc_v;
  acc_k.zero();
  acc_v.zero();

  for (int t = first; t < ntiles; ++t) {
    const int i0 = t * BM;
    __syncthreads();
    stage_tile<T, HD>(qs, qh, qrs, i0, L);
    stage_tile<T, HD>(gs, gh, grs, i0, L);
    stage_rows(lses, lse + row_base, i0, L);
    stage_rows(dis, di + row_base, i0, L);
    __syncthreads();

    // transposed scores: the warp's 16 keys against the tile's 64 queries
    mm_nt<HD>(stw, LDS, kw, LDT, qs, LDT);
    mm_nt<HD>(dpw, LDS, vw, LDT, gs, LDT);
    __syncwarp();

#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int r = it * 4 + sub;
      const int kj = j0 + warp * WR + r;
      const bool kok = kvk[warp * WR + r] != 0;
#pragma unroll
      for (int i = 0; i < BM / 8; ++i) {
        const int col = c8 + 8 * i;
        const int qi = i0 + col;
        const bool vis = kok && qi < L && (!causal || kj <= qi || kj < prefix);
        const float p = vis ? expf(stw[r * LDS + col] * scale - lses[col]) : 0.f;
        store(ptw + r * LDP + col, p);
        store(dstw + r * LDP + col, p * (dpw[r * LDS + col] - dis[col]));
      }
    }
    __syncwarp();

    mm_nn<HD>(acc_v, ptw, LDP, gs, LDT);   // dv += p^T . do
    mm_nn<HD>(acc_k, dstw, LDP, qs, LDT);  // dk += ds^T . q
  }

  __syncthreads();  // every warp is done with the score tiles: reuse them for the outputs
  float* stage = st;
  float* mine = stage + warp * WR * LDO;
  acc_k.save(mine, LDO);
  __syncwarp();
  write_rows<T, HD>(dk + b * dkbs + (long long)h * HD, dkrs, stage, LDO, j0, L, scale);
  __syncwarp();
  acc_v.save(mine, LDO);
  __syncwarp();
  write_rows<T, HD>(dv + b * dvbs + (long long)h * HD, dvrs, stage, LDO, j0, L, 1.f);
}

// ---------------------------------------------------------------------------
// bf16 kernels: the products on the tensor cores (wgmma, bf16 operands, fp32
// accumulators). Only the Q/K/V/dO/O tiles live in shared memory; the scores, the
// probabilities, ds and every accumulator stay in registers: the accumulator fragment
// of one product is, two 8-column tiles at a time, the A fragment of the next.
// A warp owns 16 rows of its warpgroup's 64; in a fragment a lane holds, for rows
// g = lane / 4 and g + 8, the columns 2t and 2t + 1 (t = lane % 4) of every 8-column
// tile (the mma.sync m16n8k16 layout; its helpers are in mma_bf16.cuh).
// ---------------------------------------------------------------------------

constexpr float LN2 = 0.6931471805599453f;

// Probabilities of one tile from its base-2 logits (a MASKED entry, at NEG, gives
// exactly 0), packed as the A fragments of the product with v; adds each row's sum.
template <bool MASKED, int NT>
__device__ __forceinline__ void probabilities(const float (&s)[NT][4], float mn_lo, float mn_hi,
                                              uint32_t (&p)[NT / 2][4], float& sum_lo,
                                              float& sum_hi) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float e = fast_exp2(s[j][c] - (c < 2 ? mn_lo : mn_hi));
      x[c] = (MASKED && !(s[j][c] > NEG)) ? 0.f : e;
    }
    sum_lo += x[0] + x[1];
    sum_hi += x[2] + x[3];
    p[j / 2][(j % 2) * 2] = pack_bf16(x[0], x[1]);
    p[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
  }
}

// p and ds of one tile of the backward from the raw scores s and dp, packed as A
// fragments (p only if WANT_P). stat(j, c, lse2, di) gives an entry's base-2
// logsumexp and di (they belong to its row in the dq kernel, to its column in the
// dk/dv kernel); vis(j, c) says whether the entry is visible, asked only if MASKED.
template <bool MASKED, bool WANT_P, int NT, typename Vis, typename Stat>
__device__ __forceinline__ void backward_tile(const float (&s)[NT][4], const float (&dp)[NT][4],
                                              float scale2, Stat stat, Vis vis,
                                              uint32_t (&pa)[NT / 2][4], uint32_t (&dsa)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float pp[4], dd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float lse2, di;
      stat(j, c, lse2, di);
      const float e = fast_exp2(fmaf(s[j][c], scale2, -lse2));
      pp[c] = (MASKED && !vis(j, c)) ? 0.f : e;
      dd[c] = pp[c] * (dp[j][c] - di);
    }
    if (WANT_P) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(pp[0], pp[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pp[2], pp[3]);
    }
    dsa[j / 2][(j % 2) * 2] = pack_bf16(dd[0], dd[1]);
    dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(dd[2], dd[3]);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on wgmma fed by TMA (the "wgmma" body). A persistent grid, one block
// on each SM; a block walks work items (BM = 64 * CWG query rows of one head and
// sample), the query block fastest, so the blocks running at one time share their
// heads' K and V in L2. A block is a producer warpgroup and CWG consumer warpgroups:
//   - the producer warpgroup gives its registers to the others (setmaxnreg) and one
//     warp of it issues every copy. For each item: its Q rows into one of Q_BUFS Q
//     buffers (with two, the next item's Q lands while this one is computed), then its
//     key tiles of 128 keys into a ring of STAGES K/V stages, each completing on the
//     stage's "full" mbarrier, refilled once every consumer warp released it on its
//     "empty" one. Before a tile the warp reads the tile's 128 validity bytes (four per
//     lane, into four ballot words, a tile ahead): a tile with no valid key is neither
//     loaded nor multiplied. The stage's slot tells the consumers which key tile landed
//     and which of its keys are valid; a slot with tile -1 ends the item;
//   - a consumer warpgroup owns 64 query rows. S = Q.K^T by wgmma m64n128k16 from
//     shared memory (Q and K K-major); the online softmax on the S accumulators in
//     registers (base-2 logits; a tile whose keys all are valid and that every row of
//     the warpgroup sees whole skips the mask); the unnormalised exponentials rounded
//     to bf16 and packed, in registers, as the A operand of O += P.V by wgmma
//     m64n64k16 (V read in its (key, hd) layout through an MN-major descriptor). The
//     products of one tile overlap the softmax of the next: S of tile j+1 and P.V of
//     tile j are issued together, and the softmax of j+1 runs while P.V of j does.
//     The warpgroups take turns, in a ring, to issue (an mbarrier each), so one's
//     softmax runs while another's products do;
//   - q, k and v stay strided views of the fused projection: one 3-D tensor map each
//     (columns H*hd, rows L, batch B), boxes of 64 columns by BM (Q) or 128 (K, V)
//     rows in the 128-byte swizzle; rows past L come back as zeros.
// CWG is 3 (BM = 192) at hd = 64 where 192-row items pad L no more than 128-row ones
// (NaFlex serving's 576 tokens: a third less K/V read, a third more warps to hide the
// softmax's latency), else 2. The consumers' instruction latency bounds the kernel,
// not its copies: an experimental build without the loads ran as long. The warpgroups wait
// only on mbarriers, never on a block-wide barrier. Shared memory, bf16, 1024-byte
// aligned: Q_BUFS Q buffers BM x hd and STAGES x (K, V) 128 x hd: 181,248 bytes at
// hd = 64 and CWG = 3, 164,864 at CWG = 2 (2 Q buffers and 4 stages), 230,400 at hd =
// 128 (1 and 3: the next item's Q waits for this one's end there). A consumer
// warpgroup holds two stages at a time (K of tile j+1, V of tile j), so it takes
// three for the producer to run a tile ahead.
// ---------------------------------------------------------------------------

constexpr int WG_BN = 128;  // keys a tile

template <int HD, int CWG_>
struct WgTile {
  static constexpr int CWG = CWG_;                    // consumer warpgroups, 64 rows each
  static constexpr int BM = 64 * CWG;                 // query rows an item
  static constexpr int CONSUMERS = 128 * CWG;         // consumer threads
  static constexpr int THREADS = CONSUMERS + 128;     // and the producer warpgroup
  // registers a thread after setmaxnreg: 128 * (launch - producer) >= consumers * (consumer - launch)
  static constexpr int PRODUCER_REGS = CWG == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = CWG == 3 ? 160 : 232;
  static constexpr int HALVES = HD / 64;              // 64-column (128-byte) boxes a row
  static constexpr int Q_BUFS = HD == 64 ? 2 : 1;     // Q buffers
  static constexpr int STAGES = HD == 64 ? 4 : 3;     // K/V stages
  static constexpr int BOX = 64 * 128 * 2;            // bytes of one 64 x 128 box
  static constexpr int Q_BYTES = HALVES * BM * 128;   // BM rows
  static constexpr int KV_BYTES = 2 * HALVES * BOX;   // WG_BN keys of K and of V
  static constexpr size_t SMEM = (size_t)Q_BUFS * Q_BYTES + STAGES * KV_BYTES + 1024;  // + alignment
};

// what the producer tells the consumers about a stage: the key tile in it (-1: the
// item has no more tiles) and which of its keys exist and are valid (bit j of word w:
// key 32w + j)
struct KeyTile {
  int tile;
  uint32_t valid[4];
};

// work item -> (first query row, head, sample)
__device__ __forceinline__ void wg_item(int item, int nq, int bm, int H, int& q0, int& h,
                                        int& b) {
  const int qb = item % nq, rest = item / nq;
  q0 = qb * bm;
  h = rest % H;
  b = rest / H;
}

// the tiles of BN keys of an item of bm query rows from q0: up to the diagonal of its
// last row and the prefix's under the causal mask
template <int BN>
__device__ __forceinline__ int key_tiles(int q0, int bm, int L, int causal, int prefix) {
  int ntiles = (L + BN - 1) / BN;
  if (causal) {
    const int diag = min((q0 + bm + BN - 1) / BN, ntiles);
    const int pre = min((prefix + BN - 1) / BN, ntiles);
    ntiles = max(diag, pre);
  }
  return ntiles;
}

// The producer warp's key tiles of one item (the forward and dq): tiles 0 .. ntiles - 1
// of BN keys of head h and sample b, K and V boxes into the ring of STAGES stages at
// kvs ([STAGES][K, V][HD / 64][BN][64]), each completing on its stage's full barrier,
// refilled once every consumer released it on its empty one. Before a tile the warp
// reads its validity bytes (one a lane for each of the BN / 32 ballot words, a tile
// ahead); a tile with no valid key is neither loaded nor handed on. The stage's slot
// tells the consumers which tile landed and which of its keys are valid; a last slot
// with tile -1 ends the item.
template <int BN, int HD, int STAGES>
__device__ __forceinline__ void produce_key_tiles(const CUtensorMap* tk, const CUtensorMap* tv,
                                                  const unsigned char* valid_b, int L, int ntiles,
                                                  int h, int b, bf16* kvs, uint64_t* full_bar,
                                                  uint64_t* empty_bar, KeyTile* slots, int& stage,
                                                  uint32_t& phase) {
  constexpr int HALVES = HD / 64, WORDS = BN / 32, KV_BYTES = 2 * HALVES * BN * 128;
  const int lane = threadIdx.x & 31;
  // does key 32 w + lane of tile tt exist and is it valid?
  const auto key_ok = [&](int tt, int w) -> uint32_t {
    const int key = tt * BN + 32 * w + lane;
    if (tt >= ntiles || key >= L) return 0u;
    return valid_b == nullptr ? 1u : (uint32_t)valid_b[key];
  };
  uint32_t words[WORDS];
#pragma unroll
  for (int w = 0; w < WORDS; ++w) words[w] = __ballot_sync(0xffffffffu, key_ok(0, w) != 0u);
  for (int t = 0; t <= ntiles; ++t) {  // t == ntiles: the end of the item
    // the next tile's validity bytes, read now and used once this tile's copies are
    // issued: the loads travel while lane 0 waits for a free stage
    uint32_t next[WORDS], any = 0u;
#pragma unroll
    for (int w = 0; w < WORDS; ++w) {
      next[w] = key_ok(t + 1, w);
      any |= words[w];
    }
    if (t == ntiles || any != 0u) {  // else: no valid key
      if (lane == 0) {
        mbar_wait(&empty_bar[stage], phase ^ 1);  // every consumer released it
        slots[stage].tile = t < ntiles ? t : -1;
#pragma unroll
        for (int w = 0; w < 4; ++w) slots[stage].valid[w] = w < WORDS ? words[w] : 0u;
        if (t < ntiles) {
          mbar_arrive_expect_tx(&full_bar[stage], KV_BYTES);
          bf16* ks = kvs + (size_t)stage * KV_BYTES / 2;
          bf16* vs = ks + HALVES * BN * 64;
#pragma unroll
          for (int c = 0; c < HALVES; ++c) {
            tma_load_3d(ks + c * BN * 64, tk, &full_bar[stage], h * HD + 64 * c, t * BN, b);
            tma_load_3d(vs + c * BN * 64, tv, &full_bar[stage], h * HD + 64 * c, t * BN, b);
          }
        } else {
          mbar_arrive(&full_bar[stage]);
        }
      }
      __syncwarp();
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int w = 0; w < WORDS; ++w) words[w] = __ballot_sync(0xffffffffu, next[w] != 0u);
  }
}

// One tile's online softmax on the S accumulators of a warp's 16 rows (qi_lo, qi_hi):
// base-2 logits, masked entries at NEG; updates the running max and this lane's row
// sums, leaves the unnormalised exponentials in s (a masked entry's exactly 0) and
// gives the factors that rescale O.
template <int NT>
__device__ __forceinline__ void wg_softmax(float (&s)[NT][4], const uint32_t (&kv_ok)[4], int k0,
                                           int row0, int qi_lo, int qi_hi, int causal, int prefix,
                                           float scale2, float& m_lo, float& m_hi, float& l_lo,
                                           float& l_hi, float& alpha_lo, float& alpha_hi) {
  const int t = threadIdx.x & 3;
  const bool all_valid = (kv_ok[0] & kv_ok[1] & kv_ok[2] & kv_ok[3]) == 0xffffffffu;
  const bool full = all_valid && (!causal || k0 + WG_BN - 1 <= row0 || k0 + WG_BN <= prefix);
  float mx_lo = NEG, mx_hi = NEG;
  if (full) {  // the max of the raw products, scaled once (scale2 > 0)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo *= scale2;
    mx_hi *= scale2;
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const int kj = k0 + col;
        const bool ok = (kv_ok[j >> 2] >> (col & 31)) & 1u;
        const bool vis_lo = ok && (!causal || kj <= qi_lo || kj < prefix);
        const bool vis_hi = ok && (!causal || kj <= qi_hi || kj < prefix);
        s[j][e] = vis_lo ? s[j][e] * scale2 : NEG;
        s[j][2 + e] = vis_hi ? s[j][2 + e] * scale2 : NEG;
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  alpha_lo = fast_exp2(m_lo - mn_lo);
  alpha_hi = fast_exp2(m_hi - mn_hi);
  float sum_lo = 0.f, sum_hi = 0.f;
  if (full) {  // exp2(scale2 * s - max), one fused multiply-add an entry
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = fast_exp2(fmaf(s[j][c], scale2, -(c < 2 ? mn_lo : mn_hi)));
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = fast_exp2(s[j][c] - (c < 2 ? mn_lo : mn_hi));
        s[j][c] = s[j][c] > NEG ? e : 0.f;  // masked: exactly 0
      }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sum_lo += s[j][0] + s[j][1];
    sum_hi += s[j][2] + s[j][3];
  }
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
  m_lo = mn_lo;
  m_hi = mn_hi;
}

// wg_softmax, with the exponentials rounded to bf16 and packed into p as they are
// taken (two consumer warpgroups have the registers for it, and the next P is ready
// when the P.V that reads the current one is done)
template <int NT>
__device__ __forceinline__ void wg_softmax_packed(float (&s)[NT][4], const uint32_t (&kv_ok)[4], int k0,
                                           int row0, int qi_lo, int qi_hi, int causal, int prefix,
                                           float scale2, float& m_lo, float& m_hi, float& l_lo,
                                           float& l_hi, uint32_t (&p)[NT / 2][4], float& alpha_lo,
                                           float& alpha_hi) {
  const int t = threadIdx.x & 3;
  const bool all_valid = (kv_ok[0] & kv_ok[1] & kv_ok[2] & kv_ok[3]) == 0xffffffffu;
  const bool full = all_valid && (!causal || k0 + WG_BN - 1 <= row0 || k0 + WG_BN <= prefix);
  float mx_lo = NEG, mx_hi = NEG;
  if (full) {  // the max of the raw products, scaled once (scale2 > 0)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo *= scale2;
    mx_hi *= scale2;
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const int kj = k0 + col;
        const bool ok = (kv_ok[j >> 2] >> (col & 31)) & 1u;
        const bool vis_lo = ok && (!causal || kj <= qi_lo || kj < prefix);
        const bool vis_hi = ok && (!causal || kj <= qi_hi || kj < prefix);
        s[j][e] = vis_lo ? s[j][e] * scale2 : NEG;
        s[j][2 + e] = vis_hi ? s[j][2 + e] * scale2 : NEG;
        mx_lo = fmaxf(mx_lo, s[j][e]);
        mx_hi = fmaxf(mx_hi, s[j][2 + e]);
      }
    }
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo)), mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  alpha_lo = fast_exp2(m_lo - mn_lo);
  alpha_hi = fast_exp2(m_hi - mn_hi);
  float sum_lo = 0.f, sum_hi = 0.f;
  if (full) {  // exp2(scale2 * s - max), one fused multiply-add an entry
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float x[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) x[c] = fast_exp2(fmaf(s[j][c], scale2, -(c < 2 ? mn_lo : mn_hi)));
      sum_lo += x[0] + x[1];
      sum_hi += x[2] + x[3];
      p[j / 2][(j % 2) * 2] = pack_bf16(x[0], x[1]);
      p[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[2], x[3]);
    }
  } else {
    probabilities<true>(s, mn_lo, mn_hi, p, sum_lo, sum_hi);
  }
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
  m_lo = mn_lo;
  m_hi = mn_hi;
}

// The exponentials of wg_softmax, rounded to bf16 and packed as the A fragments of P.V.
template <int NT>
__device__ __forceinline__ void pack_p(const float (&s)[NT][4], uint32_t (&p)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    p[j / 2][(j % 2) * 2] = pack_bf16(s[j][0], s[j][1]);
    p[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
  }
}

template <int HD, int CWG>
__global__ void __launch_bounds__(WgTile<HD, CWG>::THREADS, 1)
flash_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const unsigned char* __restrict__ valid, bf16* __restrict__ o,
                            float* __restrict__ lse, int B, int L, int H, long long obs,
                            long long ors, float scale, int causal, int prefix) {
  using W = WgTile<HD, CWG>;
  constexpr int NT = WG_BN / 8, KS = HD / 16, ND = 64 / 8;
  extern __shared__ unsigned char wg_smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[W::STAGES], empty_bar[W::STAGES];
  __shared__ __align__(8) uint64_t q_full[W::Q_BUFS], q_empty[W::Q_BUFS];
  __shared__ __align__(8) uint64_t turn_bar[W::CWG];  // consumer warpgroup w may issue products
  __shared__ KeyTile slots[W::STAGES];
  unsigned char* smem = swizzle_aligned(wg_smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(smem);    // [Q_BUFS][HALVES][BM][64]
  bf16* kvs = qs + W::Q_BUFS * W::Q_BYTES / 2;  // [STAGES][K, V][HALVES][WG_BN][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (L + W::BM - 1) / W::BM, items = nq * H * B;

  if (threadIdx.x == 0) {
    for (int st = 0; st < W::STAGES; ++st) {
      mbar_init(&full_bar[st], 1);
      mbar_init(&empty_bar[st], W::CONSUMERS);
    }
    for (int i = 0; i < W::Q_BUFS; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], W::CONSUMERS);
    }
    for (int i = 0; i < W::CWG; ++i) mbar_init(&turn_bar[i], 128);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: warp 0 issues the copies ----
    regs_dec<W::PRODUCER_REGS>();
    if (warp != 0) return;
    int stage = 0, it = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      int q0, h, b;
      wg_item(item, nq, W::BM, H, q0, h, b);
      const int qbuf = it % W::Q_BUFS;
      if (lane == 0) {  // the Q buffer's previous item is done with it
        mbar_wait(&q_empty[qbuf], ((it / W::Q_BUFS) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qbuf], W::Q_BYTES);
#pragma unroll
        for (int c = 0; c < W::HALVES; ++c)
          tma_load_3d(qs + (qbuf * W::HALVES + c) * W::BM * 64, &tq, &q_full[qbuf], h * HD + 64 * c,
                      q0, b);
      }
      produce_key_tiles<WG_BN, HD, W::STAGES>(
          &tk, &tv, valid == nullptr ? nullptr : valid + (long long)b * L, L,
          key_tiles<WG_BN>(q0, W::BM, L, causal, prefix), h, b, kvs, full_bar, empty_bar, slots,
          stage, phase);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each item ----
  regs_inc<W::CONSUMER_REGS>();
  const int wg = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  const float scale2 = scale * LOG2E;
  int stage = 0, it = 0;
  uint32_t phase = 0;
  const auto advance = [&]() {
    if (++stage == W::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  };
  const auto kv_addr = [&](int st) { return smem_u32(kvs) + st * W::KV_BYTES; };
  // The warpgroups take turns, in a ring, to issue their products, so that one's
  // softmax runs while another's products do: a warpgroup waits for its turn, issues,
  // and hands the turn on. Each takes one turn a key tile and one for an item's last
  // P.V, its rows past L or not.
  uint32_t turn_phase = 0;
  const auto take_turn = [&]() {
    mbar_wait(&turn_bar[wg], turn_phase);
    turn_phase ^= 1;
  };
  const auto pass_turn = [&]() { mbar_arrive(&turn_bar[(wg + 1) % W::CWG]); };
  if (wg == W::CWG - 1) pass_turn();  // the first turn is warpgroup 0's
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    int q0, h, b;
    wg_item(item, nq, W::BM, H, q0, h, b);
    const int qbuf = it % W::Q_BUFS;
    const int row0 = q0 + 64 * wg;
    const int qi_lo = row0 + 16 * (warp & 3) + g, qi_hi = qi_lo + 8;
    const uint32_t q_addr = smem_u32(qs) + qbuf * W::Q_BYTES + wg * 64 * 128;
    const auto qk = [&](float (&s)[NT][4], int st) {  // issue S = Q.K^T of stage st
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {  // 16 columns of hd a step: box ks / 4, 32 bytes in
        const uint32_t qoff = (ks >> 2) * W::BM * 128 + (ks & 3) * 32;
        const uint32_t koff = (ks >> 2) * WG_BN * 128 + (ks & 3) * 32;
        wgmma_m64n128k16_ss(s, wgmma_desc(q_addr + qoff, false),
                            wgmma_desc(kv_addr(st) + koff, false), ks > 0);
      }
    };
    float o_acc[W::HALVES][ND][4];
    const auto pv = [&](const uint32_t (&p)[NT / 2][4], int st) {  // issue O += P.V of stage st
      const uint32_t v_addr = kv_addr(st) + W::KV_BYTES / 2;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)  // 16 keys a step: two 8-row swizzle groups
#pragma unroll
        for (int c = 0; c < W::HALVES; ++c)
          wgmma_m64n64k16_rs(o_acc[c], p[kk],
                             wgmma_desc(v_addr + c * WG_BN * 128 + kk * 16 * 128, true));
    };
    const auto rescale = [&](float a_lo, float a_hi) {
#pragma unroll
      for (int c = 0; c < W::HALVES; ++c)
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o_acc[c][n][0] *= a_lo;
          o_acc[c][n][1] *= a_lo;
          o_acc[c][n][2] *= a_hi;
          o_acc[c][n][3] *= a_hi;
        }
    };
#pragma unroll
    for (int c = 0; c < W::HALVES; ++c) zero_acc(o_acc[c]);
    // running max (of the base-2 logits) and this lane's share of the row sums
    float m_lo = NEG, m_hi = NEG, l_lo = 0.f, l_hi = 0.f, a_lo, a_hi;
    uint32_t kv_ok[4];
    mbar_wait(&q_full[qbuf], (it / W::Q_BUFS) & 1);
    mbar_wait(&full_bar[stage], phase);
    int tile = slots[stage].tile;
    if (row0 >= L) {  // a warpgroup of a head's last item whose rows all lie past L
      const bool any = tile >= 0;
      while (tile >= 0) {  // its turns, without products
        take_turn();
        pass_turn();
        mbar_arrive(&empty_bar[stage]);
        advance();
        mbar_wait(&full_bar[stage], phase);
        tile = slots[stage].tile;
      }
      if (any) {
        take_turn();
        pass_turn();
      }
    } else if (tile >= 0) {
      // the first tile: S, softmax
      float s[NT][4];
      uint32_t p[NT / 2][4];
#pragma unroll
      for (int w = 0; w < 4; ++w) kv_ok[w] = slots[stage].valid[w];
      take_turn();
      wgmma_fence();
      qk(s, stage);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      pin(s);
      // Three consumer warpgroups (a 512-thread block) have registers for one P at a
      // time: the exponentials stay fp32 in S and are packed once the P.V that reads
      // the current P is done. Two have room to pack the next P as they go, under it.
      if constexpr (CWG == 3) {
        wg_softmax(s, kv_ok, tile * WG_BN, row0, qi_lo, qi_hi, causal, prefix, scale2, m_lo,
                   m_hi, l_lo, l_hi, a_lo, a_hi);
        pack_p(s, p);
      } else {
        wg_softmax_packed(s, kv_ok, tile * WG_BN, row0, qi_lo, qi_hi, causal, prefix, scale2,
                          m_lo, m_hi, l_lo, l_hi, p, a_lo, a_hi);
      }
      int prev = stage;
      advance();
      for (;;) {
        mbar_wait(&full_bar[stage], phase);
        tile = slots[stage].tile;
        if (tile < 0) break;
#pragma unroll
        for (int w = 0; w < 4; ++w) kv_ok[w] = slots[stage].valid[w];
        // S of this tile and P.V of the previous one, then this tile's softmax while
        // the P.V runs
        float s2[NT][4];
        uint32_t p2[NT / 2][4];
        take_turn();
        wgmma_fence();
        qk(s2, stage);
        wgmma_commit();
        pv(p, prev);
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();
        pin(s2);
        if constexpr (CWG == 3) {
          wg_softmax(s2, kv_ok, tile * WG_BN, row0, qi_lo, qi_hi, causal, prefix, scale2, m_lo,
                     m_hi, l_lo, l_hi, a_lo, a_hi);
        } else {
          wg_softmax_packed(s2, kv_ok, tile * WG_BN, row0, qi_lo, qi_hi, causal, prefix, scale2,
                            m_lo, m_hi, l_lo, l_hi, p2, a_lo, a_hi);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < W::HALVES; ++c) pin(o_acc[c]);
        pin(p);
        mbar_arrive(&empty_bar[prev]);  // this thread is done with the previous stage
        rescale(a_lo, a_hi);
        if constexpr (CWG == 3) {
          pack_p(s2, p);  // the P.V that read p is done
        } else {
#pragma unroll
          for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
            for (int c = 0; c < 4; ++c) p[kk][c] = p2[kk][c];
        }
        prev = stage;
        advance();
      }
      take_turn();
      wgmma_fence();
      pv(p, prev);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < W::HALVES; ++c) pin(o_acc[c]);
      pin(p);
      mbar_arrive(&empty_bar[prev]);
    }
    mbar_arrive(&empty_bar[stage]);  // the end-of-item slot
    advance();
    mbar_arrive(&q_empty[qbuf]);     // no more products read this Q buffer

    const float ls_lo = fmaxf(quad_sum(l_lo), 1e-30f), ls_hi = fmaxf(quad_sum(l_hi), 1e-30f);
    bf16* oh = o + b * obs + (long long)h * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? qi_hi : qi_lo;
      const float inv = 1.f / (half ? ls_hi : ls_lo);
      if (row < L) {
        bf16* out = oh + row * ors + 2 * t;
#pragma unroll
        for (int c = 0; c < W::HALVES; ++c)
#pragma unroll
          for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(out + 64 * c + 8 * n) = __floats2bfloat162_rn(
                o_acc[c][n][2 * half] * inv, o_acc[c][n][2 * half + 1] * inv);
      }
    }
    if (t == 0) {
      float* lse_h = lse + ((long long)b * H + h) * L;
      if (qi_lo < L) lse_h[qi_lo] = m_lo * LN2 + logf(ls_lo);
      if (qi_hi < L) lse_h[qi_hi] = m_hi * LN2 + logf(ls_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward on wgmma fed by TMA (the "wgmma" bodies). Two kernels, each a
// persistent grid of one block an SM, a producer warpgroup and two consumer
// warpgroups on mbarriers, as the forward:
//   - dq: an item is 128 query rows of one head and sample (64 a consumer
//     warpgroup). Its Q, dO and O rows stay resident (RES_BUFS buffers, so the next
//     item's land while this one is computed); the producer streams its key tiles
//     (K and V, BN keys) into a ring of stages and skips the tiles with no valid key
//     (produce_key_tiles, the forward's loop). A consumer
//     warpgroup first takes di = rowsum(O * dO) of its rows in fp32 from the resident
//     tiles, keeps it in registers and writes it to the (B, H, L) di that the dk/dv
//     kernel reads; then for each key tile S = Q.K^T and dP = dO.V^T (SS wgmma, K and
//     V K-major), P and dS in registers, and dQ += dS.K (RS wgmma: the bf16-packed dS
//     fragment is the A operand, K read MN-major through the transpose bit).
//   - dk/dv: an item is 128 keys of one head and sample (64 a consumer warpgroup).
//     Its K and V rows stay resident (KV_BUFS buffers); an item whose keys hold no
//     valid key loads nothing and writes zero dk and dv (its probabilities are all
//     exactly 0). Otherwise the producer streams the query tiles (64 rows of Q and dO,
//     and their base-2 logsumexp and di, which its lanes copy into the stage) into a
//     ring of stages, from the first tile the causal mask lets see a key of the item.
//     Per query tile, transposed as the keys are the rows: S^T = K.Q^T and dP^T =
//     V.dO^T (SS), P^T and dS^T in registers, dV += P^T.dO and dK += dS^T.Q (RS, dO
//     and Q read MN-major). Neither P nor dS leaves the registers.
// The items' order puts the tile index fastest, so the blocks running at one time
// share their head's streamed tiles in L2. Every output row is written once, by the
// warpgroup that owns it: no atomics, and two runs give the same bits. Every wait
// is on an mbarrier (which traps after ~9 s).
// ---------------------------------------------------------------------------

template <int HD>
struct DqTile {
  static constexpr int BM = 128;                  // query rows an item, 64 a consumer warpgroup
  static constexpr int BN = HD == 64 ? 128 : 64;  // keys a stage (hd = 128: 64, for registers)
  static constexpr int NT = BN / 8;
  static constexpr int WORDS = BN / 32;           // validity words a key tile
  static constexpr int CONSUMERS = 256;
  static constexpr int THREADS = CONSUMERS + 128;
  // 128 * (168 - 40) = 256 * (232 - 168): the producer's registers go to the consumers
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int HALVES = HD / 64;
  static constexpr int ROWS_BYTES = HALVES * BM * 128;  // one of Q, dO, O
  static constexpr int RES_BYTES = 3 * ROWS_BYTES;
  static constexpr int RES_BUFS = HD == 64 ? 2 : 1;
  static constexpr int KV_BYTES = 2 * HALVES * BN * 128;  // BN keys of K and of V
  static constexpr int STAGES = 3;
  static constexpr size_t SMEM = (size_t)RES_BUFS * RES_BYTES + STAGES * KV_BYTES + 1024;
};

template <int HD>
struct DkvTile {
  static constexpr int BK = 128;  // keys an item, 64 a consumer warpgroup
  static constexpr int BQ = 64;   // queries a stage
  static constexpr int NT = BQ / 8;
  static constexpr int CONSUMERS = 256;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int HALVES = HD / 64;
  static constexpr int KV_BYTES = 2 * HALVES * BK * 128;     // the item's K and V
  static constexpr int KV_BUFS = HD == 64 ? 2 : 1;
  static constexpr int STAGE_BYTES = 2 * HALVES * BQ * 128;  // a tile's Q and dO
  static constexpr int STAGES = HD == 64 ? 4 : 3;
  static constexpr size_t SMEM = (size_t)KV_BUFS * KV_BYTES + STAGES * STAGE_BYTES + 1024;
};

// The accumulator of a warpgroup's 64 rows times mul into rows row_lo and row_lo + 8
// of this thread's fragment, in one head's (L, HD) slice of an output.
template <int HALVES>
__device__ __forceinline__ void store_rows(bf16* dst, long long rs, const float (&acc)[HALVES][8][4],
                                           int row_lo, int L, float mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row < L) {
      bf16* out = dst + row * rs + 2 * t;
#pragma unroll
      for (int c = 0; c < HALVES; ++c)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(out + 64 * c + 8 * n) =
              __floats2bfloat162_rn(acc[c][n][2 * half] * mul, acc[c][n][2 * half + 1] * mul);
    }
  }
}

// sum over 8 columns of a * b, two swizzled 16-byte chunks of bf16
__device__ __forceinline__ float dot8(const unsigned char* a, const unsigned char* b) {
  const uint4 x = *reinterpret_cast<const uint4*>(a), y = *reinterpret_cast<const uint4*>(b);
  const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(xs[i]), w = __bfloat1622float2(ys[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

template <int HD>
__global__ void __launch_bounds__(DqTile<HD>::THREADS, 1)
flash_attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tg,  // do
                               const __grid_constant__ CUtensorMap to,  // the forward's out
                               const unsigned char* __restrict__ valid,
                               const float* __restrict__ lse, float* __restrict__ di,
                               bf16* __restrict__ dq, int B, int L, int H, long long dqbs,
                               long long dqrs, float scale, int causal, int prefix) {
  using W = DqTile<HD>;
  constexpr int NT = W::NT, KS = HD / 16;
  extern __shared__ unsigned char wg_smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[W::STAGES], empty_bar[W::STAGES];
  __shared__ __align__(8) uint64_t res_full[W::RES_BUFS], res_empty[W::RES_BUFS];
  __shared__ KeyTile slots[W::STAGES];
  unsigned char* smem = swizzle_aligned(wg_smem_raw);
  bf16* res = reinterpret_cast<bf16*>(smem);     // [RES_BUFS][Q, dO, O][HALVES][BM][64]
  bf16* kvs = res + W::RES_BUFS * W::RES_BYTES / 2;  // [STAGES][K, V][HALVES][BN][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (L + W::BM - 1) / W::BM, items = nq * H * B;

  if (threadIdx.x == 0) {
    for (int st = 0; st < W::STAGES; ++st) {
      mbar_init(&full_bar[st], 1);
      mbar_init(&empty_bar[st], W::CONSUMERS);
    }
    for (int i = 0; i < W::RES_BUFS; ++i) {
      mbar_init(&res_full[i], 1);
      mbar_init(&res_empty[i], W::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: warp 0 issues the copies ----
    regs_dec<W::PRODUCER_REGS>();
    if (warp != 0) return;
    int stage = 0, it = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      int q0, h, b;
      wg_item(item, nq, W::BM, H, q0, h, b);
      const int rb = it % W::RES_BUFS;
      if (lane == 0) {  // the buffer's previous item is done with it
        mbar_wait(&res_empty[rb], ((it / W::RES_BUFS) & 1) ^ 1);
        mbar_arrive_expect_tx(&res_full[rb], W::RES_BYTES);
        bf16* base = res + (size_t)rb * W::RES_BYTES / 2;
        const CUtensorMap* maps[3] = {&tq, &tg, &to};
#pragma unroll
        for (int m = 0; m < 3; ++m)
#pragma unroll
          for (int c = 0; c < W::HALVES; ++c)
            tma_load_3d(base + (m * W::HALVES + c) * W::BM * 64, maps[m], &res_full[rb],
                        h * HD + 64 * c, q0, b);
      }
      produce_key_tiles<W::BN, HD, W::STAGES>(
          &tk, &tv, valid == nullptr ? nullptr : valid + (long long)b * L, L,
          key_tiles<W::BN>(q0, W::BM, L, causal, prefix), h, b, kvs, full_bar, empty_bar, slots,
          stage, phase);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each item ----
  regs_inc<W::CONSUMER_REGS>();
  const int wg = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  const int r_lo = 64 * wg + 16 * (warp & 3) + g;  // this thread's rows of the item: r_lo, r_lo + 8
  const float scale2 = scale * LOG2E;
  int stage = 0, it = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    int q0, h, b;
    wg_item(item, nq, W::BM, H, q0, h, b);
    const int rb = it % W::RES_BUFS;
    const int row0 = q0 + 64 * wg;
    const int qi_lo = q0 + r_lo, qi_hi = qi_lo + 8;
    const long long row_base = ((long long)b * H + h) * L;
    const float lse_lo = qi_lo < L ? lse[row_base + qi_lo] * LOG2E : 0.f;  // base 2
    const float lse_hi = qi_hi < L ? lse[row_base + qi_hi] * LOG2E : 0.f;
    const unsigned char* rbase = smem + (size_t)rb * W::RES_BYTES;
    const uint32_t q_addr = smem_u32(rbase) + wg * 64 * 128;  // box c at + c * BM * 128
    const uint32_t g_addr = q_addr + W::ROWS_BYTES;
    mbar_wait(&res_full[rb], (it / W::RES_BUFS) & 1);

    // di = rowsum(O * dO) in fp32 for rows r_lo and r_lo + 8: the four lanes of a
    // row take two 16-byte chunks of each 64-column box (chunk c of row r lies at
    // chunk c ^ (r % 8))
    float di_lo = 0.f, di_hi = 0.f;
#pragma unroll
    for (int c = 0; c < W::HALVES; ++c)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r_lo + 8 * half;
#pragma unroll
        for (int cc = t; cc < 8; cc += 4) {
          const int off = c * W::BM * 128 + r * 128 + ((cc ^ (r & 7)) << 4);
          const float x = dot8(rbase + W::ROWS_BYTES + off, rbase + 2 * W::ROWS_BYTES + off);
          if (half) di_hi += x; else di_lo += x;
        }
      }
    di_lo = quad_sum(di_lo);
    di_hi = quad_sum(di_hi);
    if (t == 0) {
      if (qi_lo < L) di[row_base + qi_lo] = di_lo;
      if (qi_hi < L) di[row_base + qi_hi] = di_hi;
    }

    float acc[W::HALVES][8][4];
#pragma unroll
    for (int c = 0; c < W::HALVES; ++c) zero_acc(acc[c]);
    for (;;) {
      mbar_wait(&full_bar[stage], phase);
      const int tile = slots[stage].tile;
      if (tile < 0) break;
      uint32_t kv_ok[W::WORDS];
#pragma unroll
      for (int w = 0; w < W::WORDS; ++w) kv_ok[w] = slots[stage].valid[w];
      const int k0 = tile * W::BN;
      const uint32_t k_addr = smem_u32(kvs) + stage * W::KV_BYTES;
      const uint32_t v_addr = k_addr + W::KV_BYTES / 2;
      float s[NT][4], dp[NT][4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {  // 16 columns of hd a step: box ks / 4, 32 bytes in
        const uint32_t roff = (ks >> 2) * W::BM * 128 + (ks & 3) * 32;
        const uint32_t koff = (ks >> 2) * W::BN * 128 + (ks & 3) * 32;
        wgmma_ss<NT>(s, wgmma_desc(q_addr + roff, false), wgmma_desc(k_addr + koff, false), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t roff = (ks >> 2) * W::BM * 128 + (ks & 3) * 32;
        const uint32_t koff = (ks >> 2) * W::BN * 128 + (ks & 3) * 32;
        wgmma_ss<NT>(dp, wgmma_desc(g_addr + roff, false), wgmma_desc(v_addr + koff, false), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(s);
      pin(dp);

      uint32_t all = 0xffffffffu;
#pragma unroll
      for (int w = 0; w < W::WORDS; ++w) all &= kv_ok[w];
      const bool full = all == 0xffffffffu &&
                        (!causal || k0 + W::BN - 1 <= row0 || k0 + W::BN <= prefix);
      const auto stat = [&](int, int c, float& l2, float& d) {
        l2 = c < 2 ? lse_lo : lse_hi;
        d = c < 2 ? di_lo : di_hi;
      };
      const auto vis = [&](int j, int c) {
        const int col = 8 * j + 2 * t + (c & 1);
        const int kj = k0 + col;
        return ((kv_ok[col >> 5] >> (col & 31)) & 1u) != 0u &&
               (!causal || kj <= (c < 2 ? qi_lo : qi_hi) || kj < prefix);
      };
      uint32_t ds[NT / 2][4];
      if (full) {
        backward_tile<false, false>(s, dp, scale2, stat, vis, ds, ds);
      } else {
        backward_tile<true, false>(s, dp, scale2, stat, vis, ds, ds);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)  // 16 keys a step: two 8-row swizzle groups
#pragma unroll
        for (int c = 0; c < W::HALVES; ++c)
          wgmma_m64n64k16_rs(acc[c], ds[kk], wgmma_desc(k_addr + c * W::BN * 128 + kk * 16 * 128, true));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < W::HALVES; ++c) pin(acc[c]);
      pin(ds);
      mbar_arrive(&empty_bar[stage]);  // this thread is done with the stage
      if (++stage == W::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    mbar_arrive(&empty_bar[stage]);  // the end-of-item slot
    if (++stage == W::STAGES) {
      stage = 0;
      phase ^= 1;
    }
    mbar_arrive(&res_empty[rb]);  // no more reads of the resident rows
    store_rows<W::HALVES>(dq + b * dqbs + (long long)h * HD, dqrs, acc, qi_lo, L, scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(DkvTile<HD>::THREADS, 1)
flash_attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tg,  // do
                                const unsigned char* __restrict__ valid,
                                const float* __restrict__ lse, const float* __restrict__ di,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int L, int H,
                                long long dkbs, long long dkrs, long long dvbs, long long dvrs,
                                float scale, int causal, int prefix) {
  using W = DkvTile<HD>;
  constexpr int NT = W::NT, KS = HD / 16;
  extern __shared__ unsigned char wg_smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[W::STAGES], empty_bar[W::STAGES];
  __shared__ __align__(8) uint64_t kv_full[W::KV_BUFS], kv_empty[W::KV_BUFS];
  __shared__ uint32_t item_valid[W::KV_BUFS][4];  // the item's keys that exist and are valid
  __shared__ float lse_s[W::STAGES][W::BQ], di_s[W::STAGES][W::BQ];  // lse in base 2
  unsigned char* smem = swizzle_aligned(wg_smem_raw);
  bf16* kvb = reinterpret_cast<bf16*>(smem);        // [KV_BUFS][K, V][HALVES][BK][64]
  bf16* qgs = kvb + W::KV_BUFS * W::KV_BYTES / 2;   // [STAGES][Q, dO][HALVES][BQ][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nk = (L + W::BK - 1) / W::BK, items = nk * H * B;
  const int nqt = (L + W::BQ - 1) / W::BQ;

  if (threadIdx.x == 0) {
    for (int st = 0; st < W::STAGES; ++st) {
      mbar_init(&full_bar[st], 32);  // the producer warp's lanes: each stored its stats
      mbar_init(&empty_bar[st], W::CONSUMERS);
    }
    for (int i = 0; i < W::KV_BUFS; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], W::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: warp 0 issues the copies and stores the statistics ----
    regs_dec<W::PRODUCER_REGS>();
    if (warp != 0) return;
    int stage = 0, it = 0;
    uint32_t phase = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
      int j0, h, b;
      wg_item(item, nk, W::BK, H, j0, h, b);
      const int kb = it % W::KV_BUFS;
      const unsigned char* valid_b = valid == nullptr ? nullptr : valid + (long long)b * L;
      uint32_t words[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int key = j0 + 32 * w + lane;
        const bool ok = key < L && (valid_b == nullptr || valid_b[key] != 0);
        words[w] = __ballot_sync(0xffffffffu, ok);
      }
      const bool any = (words[0] | words[1] | words[2] | words[3]) != 0u;
      if (lane == 0) {  // the buffer's previous item is done with it
        mbar_wait(&kv_empty[kb], ((it / W::KV_BUFS) & 1) ^ 1);
#pragma unroll
        for (int w = 0; w < 4; ++w) item_valid[kb][w] = words[w];
        if (any) {
          mbar_arrive_expect_tx(&kv_full[kb], W::KV_BYTES);
          bf16* ks = kvb + (size_t)kb * W::KV_BYTES / 2;
          bf16* vs = ks + W::HALVES * W::BK * 64;
#pragma unroll
          for (int c = 0; c < W::HALVES; ++c) {
            tma_load_3d(ks + c * W::BK * 64, &tk, &kv_full[kb], h * HD + 64 * c, j0, b);
            tma_load_3d(vs + c * W::BK * 64, &tv, &kv_full[kb], h * HD + 64 * c, j0, b);
          }
        } else {
          mbar_arrive(&kv_full[kb]);
        }
      }
      __syncwarp();
      if (!any) continue;  // no query tile: the consumers write zeros
      // under the causal mask the queries before j0 see none of these keys, unless
      // some of them lie in the prefix
      const int first = (causal && j0 >= prefix) ? j0 / W::BQ : 0;
      const long long row_base = ((long long)b * H + h) * L;
      // this lane's two rows (lane, lane + 32) of a tile's statistics, loaded a tile ahead
      const auto load_stats = [&](int tt, float (&l2)[2], float (&d)[2]) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = tt * W::BQ + lane + 32 * e;
          const bool in = tt < nqt && qi < L;
          l2[e] = in ? lse[row_base + qi] * LOG2E : 0.f;
          d[e] = in ? di[row_base + qi] : 0.f;
        }
      };
      float l2[2], d[2];
      load_stats(first, l2, d);
      for (int t = first; t < nqt; ++t) {
        float nl2[2], nd[2];
        load_stats(t + 1, nl2, nd);
        mbar_wait(&empty_bar[stage], phase ^ 1);  // every consumer released the stage
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lse_s[stage][lane + 32 * e] = l2[e];
          di_s[stage][lane + 32 * e] = d[e];
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full_bar[stage], W::STAGE_BYTES);
          bf16* qs = qgs + (size_t)stage * W::STAGE_BYTES / 2;
          bf16* gs = qs + W::HALVES * W::BQ * 64;
#pragma unroll
          for (int c = 0; c < W::HALVES; ++c) {
            tma_load_3d(qs + c * W::BQ * 64, &tq, &full_bar[stage], h * HD + 64 * c, t * W::BQ, b);
            tma_load_3d(gs + c * W::BQ * 64, &tg, &full_bar[stage], h * HD + 64 * c, t * W::BQ, b);
          }
        } else {
          mbar_arrive(&full_bar[stage]);
        }
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l2[e] = nl2[e];
          d[e] = nd[e];
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys 64 wg .. 64 wg + 63 of each item ----
  regs_inc<W::CONSUMER_REGS>();
  const int wg = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  const int r_lo = 64 * wg + 16 * (warp & 3) + g;  // this thread's keys of the item: r_lo, r_lo + 8
  const float scale2 = scale * LOG2E;
  int stage = 0, it = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    int j0, h, b;
    wg_item(item, nk, W::BK, H, j0, h, b);
    const int kb = it % W::KV_BUFS;
    const int kw0 = j0 + 64 * wg;
    const int kj_lo = j0 + r_lo, kj_hi = kj_lo + 8;
    mbar_wait(&kv_full[kb], (it / W::KV_BUFS) & 1);
    const uint32_t* iv = item_valid[kb];
    const bool any = (iv[0] | iv[1] | iv[2] | iv[3]) != 0u;
    const uint32_t w0 = iv[2 * wg], w1 = iv[2 * wg + 1];
    const bool kok_lo = (iv[r_lo >> 5] >> (r_lo & 31)) & 1u;
    const bool kok_hi = (iv[(r_lo + 8) >> 5] >> ((r_lo + 8) & 31)) & 1u;
    float acc_k[W::HALVES][8][4], acc_v[W::HALVES][8][4];
#pragma unroll
    for (int c = 0; c < W::HALVES; ++c) {
      zero_acc(acc_k[c]);
      zero_acc(acc_v[c]);
    }
    if (any) {
      const bool wg_any = (w0 | w1) != 0u, wg_all = (w0 & w1) == 0xffffffffu;
      const int first = (causal && j0 >= prefix) ? j0 / W::BQ : 0;
      const uint32_t k_addr = smem_u32(kvb) + kb * W::KV_BYTES + wg * 64 * 128;  // box c: + c * BK * 128
      const uint32_t v_addr = k_addr + W::KV_BYTES / 2;
      for (int tt = first; tt < nqt; ++tt) {
        mbar_wait(&full_bar[stage], phase);
        if (wg_any) {  // else this warpgroup's keys are all invalid: its rows stay 0
          const int i0 = tt * W::BQ;
          const uint32_t q_addr = smem_u32(qgs) + stage * W::STAGE_BYTES;  // box c: + c * BQ * 128
          const uint32_t g_addr = q_addr + W::STAGE_BYTES / 2;
          // transposed products: the warpgroup's 64 keys (rows) against the tile's 64 queries
          float st[NT][4], dpt[NT][4];
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const uint32_t koff = (ks >> 2) * W::BK * 128 + (ks & 3) * 32;
            const uint32_t qoff = (ks >> 2) * W::BQ * 128 + (ks & 3) * 32;
            wgmma_ss<NT>(st, wgmma_desc(k_addr + koff, false), wgmma_desc(q_addr + qoff, false), ks > 0);
          }
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            const uint32_t koff = (ks >> 2) * W::BK * 128 + (ks & 3) * 32;
            const uint32_t qoff = (ks >> 2) * W::BQ * 128 + (ks & 3) * 32;
            wgmma_ss<NT>(dpt, wgmma_desc(v_addr + koff, false), wgmma_desc(g_addr + qoff, false), ks > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          pin(st);
          pin(dpt);

          const float* ls = lse_s[stage];
          const float* dd = di_s[stage];
          const auto stat = [&](int j, int c, float& l2, float& d) {
            const int col = 8 * j + 2 * t + (c & 1);
            l2 = ls[col];
            d = dd[col];
          };
          const auto vis = [&](int j, int c) {
            const int qi = i0 + 8 * j + 2 * t + (c & 1);
            const int kj = c < 2 ? kj_lo : kj_hi;
            return (c < 2 ? kok_lo : kok_hi) && qi < L && (!causal || kj <= qi || kj < prefix);
          };
          // every query of the tile exists and sees every key of the warpgroup
          const bool full = wg_all && i0 + W::BQ <= L &&
                            (!causal || kw0 + 63 <= i0 || kw0 + 64 <= prefix);
          uint32_t pt[NT / 2][4], dst[NT / 2][4];
          if (full) {
            backward_tile<false, true>(st, dpt, scale2, stat, vis, pt, dst);
          } else {
            backward_tile<true, true>(st, dpt, scale2, stat, vis, pt, dst);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < NT / 2; ++kk)  // 16 queries a step: two 8-row swizzle groups
#pragma unroll
            for (int c = 0; c < W::HALVES; ++c)
              wgmma_m64n64k16_rs(acc_v[c], pt[kk],
                                 wgmma_desc(g_addr + c * W::BQ * 128 + kk * 16 * 128, true));
#pragma unroll
          for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
            for (int c = 0; c < W::HALVES; ++c)
              wgmma_m64n64k16_rs(acc_k[c], dst[kk],
                                 wgmma_desc(q_addr + c * W::BQ * 128 + kk * 16 * 128, true));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int c = 0; c < W::HALVES; ++c) {
            pin(acc_k[c]);
            pin(acc_v[c]);
          }
          pin(pt);
          pin(dst);
        }
        mbar_arrive(&empty_bar[stage]);  // this thread is done with the stage
        if (++stage == W::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    mbar_arrive(&kv_empty[kb]);  // no more reads of the item's K and V
    store_rows<W::HALVES>(dk + b * dkbs + (long long)h * HD, dkrs, acc_k, kj_lo, L, scale);
    store_rows<W::HALVES>(dv + b * dvbs + (long long)h * HD, dvrs, acc_v, kj_lo, L, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t opt_in_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void *q, *k, *v, *valid, *dout, *lse, *fwd_out;  // fwd_out: the forward's output (dq)
  void *o, *lse_out, *di, *dq, *dk, *dv;                 // di: written by dq, read by dk/dv
  int B, L, H;
  const long long* st;
  float scale;
  int causal, prefix;
  cudaStream_t stream;
};

template <typename T, typename K>
cudaError_t launch_fwd(K kern, size_t smem, const Args& a) {
  const cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + BM - 1) / BM, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const unsigned char*>(a.valid), static_cast<T*>(a.o),
      static_cast<float*>(a.lse_out), a.L, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5],
      a.st[6], a.st[7], a.scale, a.causal, a.prefix);
  return cudaGetLastError();
}

template <typename T, typename K>
cudaError_t launch_dq(K kern, size_t smem, const Args& a) {
  const cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + BM - 1) / BM, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const unsigned char*>(a.valid), static_cast<const T*>(a.dout),
      static_cast<const T*>(a.fwd_out), static_cast<const float*>(a.lse),
      static_cast<float*>(a.di), static_cast<T*>(a.dq), a.L, a.st[0], a.st[1], a.st[2], a.st[3],
      a.st[4], a.st[5], a.st[6], a.st[7], a.st[8], a.st[9], a.st[10], a.st[11], a.scale, a.causal,
      a.prefix);
  return cudaGetLastError();
}

template <typename T, typename K>
cudaError_t launch_dkv(K kern, size_t smem, const Args& a) {
  const cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.L + BN - 1) / BN, a.H, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const unsigned char*>(a.valid), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.L, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6],
      a.st[7], a.st[8], a.st[9], a.st[10], a.st[11], a.scale, a.causal, a.prefix);
  return cudaGetLastError();
}

// bf16 tensor maps over the strided (B, L, H*hd) views of n tensors, the [batch, row]
// strides (elements) of tensor i at a.st[2i]; boxes of 64 columns by box_rows[i] rows
template <int HD, int N>
bool encode_maps(CUtensorMap (&maps)[N], const void* const (&ptrs)[N], const int (&box_rows)[N],
                 const Args& a) {
  for (int i = 0; i < N; ++i)
    if (!encode_rows_3d(&maps[i], ptrs[i], (long long)a.H * HD, a.L, a.B,
                        a.st[2 * i + 1] * (long long)sizeof(bf16),
                        a.st[2 * i] * (long long)sizeof(bf16), box_rows[i]))
      return false;
  return true;
}

// q, k, v as tensor maps (strides a.st[0..5]), o's at a.st[6..7]
template <int HD, int CWG>
cudaError_t launch_fwd_wgmma_cwg(const Args& a) {
  using W = WgTile<HD, CWG>;
  CUtensorMap maps[3];
  if (!encode_maps<HD>(maps, {a.q, a.k, a.v}, {W::BM, WG_BN, WG_BN}, a)) return cudaErrorInvalidValue;
  auto kern = flash_attn_fwd_wgmma_kernel<HD, CWG>;
  cudaError_t e = opt_in_smem(kern, W::SMEM);
  if (e != cudaSuccess) return e;
  int grid;
  if ((e = persistent_grid((long long)((a.L + W::BM - 1) / W::BM) * a.H * a.B, grid)) != cudaSuccess)
    return e;
  kern<<<grid, W::THREADS, W::SMEM, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<const unsigned char*>(a.valid),
      static_cast<bf16*>(a.o), static_cast<float*>(a.lse_out), a.B, a.L, a.H, a.st[6], a.st[7],
      a.scale, a.causal, a.prefix);
  return cudaGetLastError();
}

// q, k, v, do and the forward's out as tensor maps (strides a.st[0..9]), dq's at a.st[10..11]
template <int HD>
cudaError_t launch_dq_wgmma(const Args& a) {
  using W = DqTile<HD>;
  CUtensorMap maps[5];
  if (!encode_maps<HD>(maps, {a.q, a.k, a.v, a.dout, a.fwd_out}, {W::BM, W::BN, W::BN, W::BM, W::BM}, a))
    return cudaErrorInvalidValue;
  auto kern = flash_attn_bwd_dq_wgmma_kernel<HD>;
  cudaError_t e = opt_in_smem(kern, W::SMEM);
  if (e != cudaSuccess) return e;
  int grid;
  if ((e = persistent_grid((long long)((a.L + W::BM - 1) / W::BM) * a.H * a.B, grid)) != cudaSuccess)
    return e;
  kern<<<grid, W::THREADS, W::SMEM, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const unsigned char*>(a.valid),
      static_cast<const float*>(a.lse), static_cast<float*>(a.di), static_cast<bf16*>(a.dq), a.B,
      a.L, a.H, a.st[10], a.st[11], a.scale, a.causal, a.prefix);
  return cudaGetLastError();
}

// q, k, v and do as tensor maps (strides a.st[0..7]), dk's and dv's at a.st[8..11]
template <int HD>
cudaError_t launch_dkv_wgmma(const Args& a) {
  using W = DkvTile<HD>;
  CUtensorMap maps[4];
  if (!encode_maps<HD>(maps, {a.q, a.k, a.v, a.dout}, {W::BQ, W::BK, W::BK, W::BQ}, a))
    return cudaErrorInvalidValue;
  auto kern = flash_attn_bwd_dkv_wgmma_kernel<HD>;
  cudaError_t e = opt_in_smem(kern, W::SMEM);
  if (e != cudaSuccess) return e;
  int grid;
  if ((e = persistent_grid((long long)((a.L + W::BK - 1) / W::BK) * a.H * a.B, grid)) != cudaSuccess)
    return e;
  kern<<<grid, W::THREADS, W::SMEM, a.stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const unsigned char*>(a.valid),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.B, a.L, a.H, a.st[8], a.st[9], a.st[10], a.st[11], a.scale,
      a.causal, a.prefix);
  return cudaGetLastError();
}

// hd = 64: items of 192 rows (three consumer warpgroups: more warps to hide latency and
// a third less K/V read a query row) where they pad L no more than 128-row items do
// (NaFlex's 576-token bucket), else 128 rows (its 1024: 192-row items would leave two
// warpgroups idle in a head's last item). hd = 128 takes 128 rows: its accumulators
// do not fit the registers of three consumer warpgroups.
template <int HD>
cudaError_t launch_fwd_wgmma(const Args& a) {
  const long long rows3 = (a.L + 191) / 192 * 192LL, rows2 = (a.L + 127) / 128 * 128LL;
  if constexpr (HD == 64)
    if (rows3 <= rows2) return launch_fwd_wgmma_cwg<HD, 3>(a);
  return launch_fwd_wgmma_cwg<HD, 2>(a);
}

enum Which { FWD, DQ, DKV };

// bf16 takes the tensor-core kernels, fp32 the CUDA-core ones
template <typename T, int HD>
cudaError_t launch_one(Which which, const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (which) {
      case FWD: return launch_fwd_wgmma<HD>(a);
      case DQ: return launch_dq_wgmma<HD>(a);
      default: return launch_dkv_wgmma<HD>(a);
    }
  } else {
    switch (which) {
      case FWD: return launch_fwd<T>(flash_attn_fwd_kernel<T, HD>, fwd_smem<T, HD>(), a);
      case DQ: return launch_dq<T>(flash_attn_bwd_dq_kernel<T, HD>, dq_smem<T, HD>(), a);
      default: return launch_dkv<T>(flash_attn_bwd_dkv_kernel<T, HD>, dkv_smem<T, HD>(), a);
    }
  }
}

cudaError_t dispatch(Which which, int hd, int dtype, const Args& a) {
  if (a.B < 1 || a.B > 65535 || a.H < 1 || a.H > 65535 || a.L < 1 || a.prefix < 0)
    return cudaErrorInvalidValue;
  if (a.prefix > 0 && !a.causal) return cudaErrorInvalidValue;
  if (dtype == 0 && hd == 64) return launch_one<float, 64>(which, a);
  if (dtype == 0 && hd == 128) return launch_one<float, 128>(which, a);
  if (dtype == 1 && hd == 64) return launch_one<__nv_bfloat16, 64>(which, a);
  if (dtype == 1 && hd == 128) return launch_one<__nv_bfloat16, 128>(which, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// All tensors are (B, L, H, hd) with the (H, hd) block dense and every row 16-byte
// aligned; strides (in elements) are [batch, row] pairs in the order the tensors
// are listed. valid: (B, L) bytes, contiguous, or null for "every key is valid".
// lse, di: (B, H, L) fp32, contiguous. dtype: 0 = float32, 1 = bfloat16.

// strides: q, k, v, o (8 values)
extern "C" int oct_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* valid, void* o, void* lse, int B, int L,
                                       int H, int hd, const long long* strides, float scale,
                                       int causal, int prefix_len, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.valid = valid, a.o = o, a.lse_out = lse;
  a.B = B, a.L = L, a.H = H, a.st = strides, a.scale = scale, a.causal = causal;
  a.prefix = prefix_len, a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(FWD, hd, dtype, a);
}

// strides: q, k, v, dout, out, dq (12 values); writes di = rowsum(out * dout), fp32
// (B, H, L), for the dk/dv kernel
extern "C" int oct_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* valid, const void* dout, const void* out,
                                          const void* lse, void* di, void* dq, int B, int L, int H,
                                          int hd, const long long* strides, float scale, int causal,
                                          int prefix_len, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.valid = valid, a.dout = dout, a.fwd_out = out, a.lse = lse;
  a.di = di, a.dq = dq;
  a.B = B, a.L = L, a.H = H, a.st = strides, a.scale = scale, a.causal = causal;
  a.prefix = prefix_len, a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(DQ, hd, dtype, a);
}

// strides: q, k, v, dout, dk, dv (12 values)
extern "C" int oct_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* valid, const void* dout, const void* lse,
                                           const void* di, void* dk, void* dv, int B, int L,
                                           int H, int hd, const long long* strides, float scale,
                                           int causal, int prefix_len, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.valid = valid, a.dout = dout, a.lse = lse;
  a.di = const_cast<void*>(di), a.dk = dk, a.dv = dv;
  a.B = B, a.L = L, a.H = H, a.st = strides, a.scale = scale, a.causal = causal;
  a.prefix = prefix_len, a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(DKV, hd, dtype, a);
}
