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
// BACKWARD: from q, k, v, do, lse and di = rowsum(out * do) (fp32 (B, H, L), made
// by the caller):  p = exp(q.k * scale - lse) where visible, else 0;
// dp = do.v^T;  ds = p * (dp - di) rounded to the input dtype;
// dq = scale * ds.k;  dk = scale * ds^T.q;  dv = p^T.do with p rounded to the
// input dtype; fp32 accumulators throughout. dq sums over keys and dk/dv over
// queries, so they are two kernels: one block per query tile looping over key
// tiles (dq), and one block per key tile looping over query tiles (dk, dv). Every
// output is written once, by one block, in a fixed order: no atomics, and two runs
// give the same bits.
//
// Bound on this card: operations. At L = 1024, hd = 64 a forward call does
// 4*B*H*L^2*hd operations on 4*B*L*H*hd*size bytes, L/size = 512 operations per
// byte in bf16, above the ~295 where the bf16 tensor cores become the limit. So
// the matrix products of the bf16 kernels run on the tensor cores (mma.sync
// m16n8k16 with fp32 accumulators, operands loaded with ldmatrix), and what lies
// between two products never leaves the registers: the logits, the probabilities,
// ds and every accumulator; the accumulator fragment of q.k^T is, rounded to bf16,
// the A operand of p.v. The fp32 kernels keep full fp32 and run the same products
// on CUDA cores, with the score tile in shared memory. What else the design does:
//   - q, k, v are read in place from the tower's (B, L, H*hd) layout with a batch
//     and a row stride per tensor, so the three slices of a fused projection need
//     no transpose, no copy and no padding of L; the tail tile is staged as zeros
//     and masked in the kernel;
//   - key validity is one byte per (sample, key), staged per key tile;
//   - one block of 4 warps per (64-row tile, head, sample); each warp owns 16 rows
//     of the tile, so between the loads of two tiles no warp waits for another;
//   - K/V (or Q/dO) stream through shared memory in 64-row tiles, rows padded by 16
//     bytes so that ldmatrix reads no bank twice; in the bf16 kernels the tiles are
//     double-buffered and copied with cp.async, so the next tile travels while the
//     block computes on this one; the running max and sum live in registers (the
//     sum as per-lane shares, added up once at the end);
//   - the bf16 kernels take exponentials in base 2 on the special-function unit,
//     and a tile that every row of the block sees whole skips the mask arithmetic;
//   - under the causal mask the tiles no row of the block can see are skipped,
//     and the prefix tiles are kept.
// Not done yet (a later change): wgmma and TMA, deeper pipelines, skipping key
// tiles that hold no valid key. Tried and dropped: 128 query rows and 8 warps a
// block (half the L2 traffic, but slower: more warps wait at each barrier).
//
// Shared memory per block (bytes), dynamic, opted in above 48 KB:
//   forward   bf16 hd=64  46,336   hd=128  87,296   fp32 hd=64 106,752  hd=128 172,288
//   dq        bf16 hd=64  55,552   hd=128 104,704   fp32 hd=64 124,672  hd=128 190,208
//   dk/dv     bf16 hd=64  56,576   hd=128 105,728   fp32 hd=64 142,080  hd=128 207,616
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
                         const float* __restrict__ lse, const float* __restrict__ di,
                         T* __restrict__ dq, int L, long long qbs, long long qrs, long long kbs,
                         long long krs, long long vbs, long long vrs, long long gbs, long long grs,
                         long long dqbs, long long dqrs, float scale, int causal, int prefix) {
  constexpr int LDT = Ld<T, HD>::value;
  constexpr int LDP = Ld<T, BN>::value;
  constexpr int LDO = HD + 8;
  static_assert(LDO <= 2 * LDS, "the output staging tile reuses the two score tiles");
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
  stage_rows(dis, di + row_base, q0, L);
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
// bf16 kernels: the products on the tensor cores (mma.sync m16n8k16, bf16 operands,
// fp32 accumulators). Only the Q/K/V/dO tiles live in shared memory; the scores, the
// probabilities and every accumulator stay in registers: the accumulator fragment
// of one product is, two 8-column tiles at a time, the A fragment of the next.
// A warp owns 16 rows; in a fragment a lane holds, for rows g = lane / 4 and g + 8,
// the columns 2t and 2t + 1 (t = lane % 4) of every 8-column tile. The warp-level
// helpers (cp.async, ldmatrix, mma.sync, the products) are in mma_bf16.cuh.
// ---------------------------------------------------------------------------

// cp_async16 for 4 bytes
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool inside) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = inside ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// stage_tile, asynchronously
template <int HD>
__device__ __forceinline__ void stage_tile_async(bf16* dst, const bf16* src, long long rs, int r0,
                                                 int L) {
  constexpr int LD = HD + 8;
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x; i < BM * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int row = r0 + r;
    cp_async16(dst + r * LD + c, src + min(row, L - 1) * rs + c, row < L);
  }
}

// stage_rows, asynchronously
__device__ __forceinline__ void stage_rows_async(float* dst, const float* src, int r0, int L) {
  if (threadIdx.x < BM) {
    const int row = r0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, src + min(row, L - 1), row < L);
  }
}

constexpr float LN2 = 0.6931471805599453f;

// The warp's accumulator times `mul` into rows row_lo and row_lo + 8 of one head's
// (L, HD) slice of an output.
template <int HD>
__device__ __forceinline__ void write_acc(bf16* dst, long long rs, const float (&acc)[HD / 8][4],
                                          int row_lo, int L, float mul_lo, float mul_hi) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row_lo + 8 * half;
    if (row < L) {
      bf16* out = dst + row * rs + 2 * t;
      const float mul = half ? mul_hi : mul_lo;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * half] * mul, acc[n][2 * half + 1] * mul);
    }
  }
}

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

template <int HD>
constexpr size_t fwd_mma_smem() {
  return (size_t)(5 * BM * (HD + 8)) * sizeof(bf16) + BN * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const unsigned char* __restrict__ valid,
                          bf16* __restrict__ o, float* __restrict__ lse, int L, long long qbs,
                          long long qrs, long long kbs, long long krs, long long vbs,
                          long long vrs, long long obs, long long ors, float scale, int causal,
                          int prefix) {
  constexpr int LDT = HD + 8;
  constexpr int KS = HD / 16, NT = BN / 8, ND = HD / 8;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16* qs = reinterpret_cast<bf16*>(flash_smem);  // (BM, LDT)
  bf16* kbuf = qs + BM * LDT;                      // 2 x (BN, LDT): K tiles, double-buffered
  bf16* vbuf = kbuf + 2 * BN * LDT;                // 2 x (BN, LDT): V tiles
  int* kvs = reinterpret_cast<int*>(vbuf + 2 * BN * LDT);  // (BN,)

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qi_lo = q0 + warp * WR + g, qi_hi = qi_lo + 8;
  const bf16* kh = k + b * kbs + (long long)h * HD;
  const bf16* vh = v + b * vbs + (long long)h * HD;
  const unsigned char* valid_b = valid == nullptr ? nullptr : valid + (long long)b * L;

  int ntiles = (L + BN - 1) / BN;
  if (causal) {
    const int diag = min((q0 + BM + BN - 1) / BN, ntiles);
    const int pre = min((prefix + BN - 1) / BN, ntiles);
    ntiles = max(diag, pre);
  }

  stage_tile<bf16, HD>(qs, q + b * qbs + (long long)h * HD, qrs, q0, L);
  const bf16* qw = qs + warp * WR * LDT;
  float o_acc[ND][4];
  zero_acc(o_acc);
  // running max (of the base-2 logits) and this lane's share of the row sum
  float m_lo = NEG, m_hi = NEG, l_lo = 0.f, l_hi = 0.f;
  const float scale2 = scale * LOG2E;

  stage_tile_async<HD>(kbuf, kh, krs, 0, L);
  stage_tile_async<HD>(vbuf, vh, vrs, 0, L);
  cp_async_commit();
  int ok_cur = key_flag(valid_b, 0, L);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BN;
    const bf16* ks = kbuf + (tile & 1) * BN * LDT;
    const bf16* vs = vbuf + (tile & 1) * BN * LDT;
    int ok_next = 1;
    if (tile + 1 < ntiles) {  // the next tile goes into the other buffer
      stage_tile_async<HD>(kbuf + ((tile + 1) & 1) * BN * LDT, kh, krs, k0 + BN, L);
      stage_tile_async<HD>(vbuf + ((tile + 1) & 1) * BN * LDT, vh, vrs, k0 + BN, L);
      ok_next = key_flag(valid_b, k0 + BN, L);
    }
    cp_async_commit();
    if (threadIdx.x < BN) kvs[threadIdx.x] = ok_cur;
    cp_async_wait<1>();  // this tile has landed; the next may still be in flight
    const int all_valid = __syncthreads_and(ok_cur);
    const bool full = all_valid && (!causal || k0 + BN - 1 <= q0 || k0 + BN <= prefix);

    float s[NT][4];
    zero_acc(s);
    gemm_nt<KS, NT>(s, qw, LDT, ks, LDT);

    // Base-2 logits, masked entries at NEG. A tile that every row of the block sees
    // whole (most tiles: no padding in it, not on the diagonal) skips the mask.
    float mx_lo = NEG, mx_hi = NEG;
    if (full) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] *= scale2;
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * t + e;
          const int kj = k0 + col;
          const bool ok = kvs[col] != 0;
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
    const float alpha_lo = fast_exp2(m_lo - mn_lo), alpha_hi = fast_exp2(m_hi - mn_hi);
    uint32_t p[NT / 2][4];
    float sum_lo = 0.f, sum_hi = 0.f;
    if (full) {
      probabilities<false>(s, mn_lo, mn_hi, p, sum_lo, sum_hi);
    } else {
      probabilities<true>(s, mn_lo, mn_hi, p, sum_lo, sum_hi);
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o_acc[n][0] *= alpha_lo;
      o_acc[n][1] *= alpha_lo;
      o_acc[n][2] *= alpha_hi;
      o_acc[n][3] *= alpha_hi;
    }
    gemm_nn<NT / 2, ND>(o_acc, p, vs, LDT);
    __syncthreads();  // every warp is done with this buffer before it is filled again
    ok_cur = ok_next;
  }

  const float ls_lo = fmaxf(quad_sum(l_lo), 1e-30f), ls_hi = fmaxf(quad_sum(l_hi), 1e-30f);
  write_acc<HD>(o + b * obs + (long long)h * HD, ors, o_acc, qi_lo, L, 1.f / ls_lo, 1.f / ls_hi);
  if (t == 0) {
    float* lse_h = lse + ((long long)b * H + h) * L;
    if (qi_lo < L) lse_h[qi_lo] = m_lo * LN2 + logf(ls_lo);
    if (qi_hi < L) lse_h[qi_hi] = m_hi * LN2 + logf(ls_hi);
  }
}

template <int HD>
constexpr size_t dq_mma_smem() {
  return (size_t)(6 * BM * (HD + 8)) * sizeof(bf16) + BN * sizeof(int);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const unsigned char* __restrict__ valid,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ di, bf16* __restrict__ dq, int L,
                             long long qbs, long long qrs, long long kbs, long long krs,
                             long long vbs, long long vrs, long long gbs, long long grs,
                             long long dqbs, long long dqrs, float scale, int causal, int prefix) {
  constexpr int LDT = HD + 8;
  constexpr int KS = HD / 16, NT = BN / 8, ND = HD / 8;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16* qs = reinterpret_cast<bf16*>(flash_smem);  // (BM, LDT)
  bf16* gs = qs + BM * LDT;                        // (BM, LDT): the tile's rows of do
  bf16* kbuf = gs + BM * LDT;                      // 2 x (BN, LDT): K tiles, double-buffered
  bf16* vbuf = kbuf + 2 * BN * LDT;                // 2 x (BN, LDT): V tiles
  int* kvs = reinterpret_cast<int*>(vbuf + 2 * BN * LDT);  // (BN,)

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int qi_lo = q0 + warp * WR + g, qi_hi = qi_lo + 8;
  const bf16* kh = k + b * kbs + (long long)h * HD;
  const bf16* vh = v + b * vbs + (long long)h * HD;
  const unsigned char* valid_b = valid == nullptr ? nullptr : valid + (long long)b * L;
  const long long row_base = ((long long)b * H + h) * L;
  const float scale2 = scale * LOG2E;
  const float lse_lo = qi_lo < L ? lse[row_base + qi_lo] * LOG2E : 0.f;  // base 2
  const float lse_hi = qi_hi < L ? lse[row_base + qi_hi] * LOG2E : 0.f;
  const float di_lo = qi_lo < L ? di[row_base + qi_lo] : 0.f;
  const float di_hi = qi_hi < L ? di[row_base + qi_hi] : 0.f;

  int ntiles = (L + BN - 1) / BN;
  if (causal) {
    const int diag = min((q0 + BM + BN - 1) / BN, ntiles);
    const int pre = min((prefix + BN - 1) / BN, ntiles);
    ntiles = max(diag, pre);
  }

  stage_tile<bf16, HD>(qs, q + b * qbs + (long long)h * HD, qrs, q0, L);
  stage_tile<bf16, HD>(gs, dout + b * gbs + (long long)h * HD, grs, q0, L);
  const bf16* qw = qs + warp * WR * LDT;
  const bf16* gw = gs + warp * WR * LDT;
  float acc[ND][4];
  zero_acc(acc);

  stage_tile_async<HD>(kbuf, kh, krs, 0, L);
  stage_tile_async<HD>(vbuf, vh, vrs, 0, L);
  cp_async_commit();
  int ok_cur = key_flag(valid_b, 0, L);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BN;
    const bf16* ks = kbuf + (tile & 1) * BN * LDT;
    const bf16* vs = vbuf + (tile & 1) * BN * LDT;
    int ok_next = 1;
    if (tile + 1 < ntiles) {  // the next tile goes into the other buffer
      stage_tile_async<HD>(kbuf + ((tile + 1) & 1) * BN * LDT, kh, krs, k0 + BN, L);
      stage_tile_async<HD>(vbuf + ((tile + 1) & 1) * BN * LDT, vh, vrs, k0 + BN, L);
      ok_next = key_flag(valid_b, k0 + BN, L);
    }
    cp_async_commit();
    if (threadIdx.x < BN) kvs[threadIdx.x] = ok_cur;
    cp_async_wait<1>();  // this tile has landed; the next may still be in flight
    const int all_valid = __syncthreads_and(ok_cur);
    const bool full = all_valid && (!causal || k0 + BN - 1 <= q0 || k0 + BN <= prefix);

    float s[NT][4], dp[NT][4];
    zero_acc(s);
    zero_acc(dp);
    gemm_nt<KS, NT>(s, qw, LDT, ks, LDT);
    gemm_nt<KS, NT>(dp, gw, LDT, vs, LDT);

    uint32_t ds[NT / 2][4];
    const auto stat = [&](int, int c, float& lse2, float& d) {
      lse2 = c < 2 ? lse_lo : lse_hi;
      d = c < 2 ? di_lo : di_hi;
    };
    const auto vis = [&](int j, int c) {
      const int col = 8 * j + 2 * t + (c & 1);
      const int kj = k0 + col;
      return kvs[col] != 0 && (!causal || kj <= (c < 2 ? qi_lo : qi_hi) || kj < prefix);
    };
    if (full) {
      backward_tile<false, false>(s, dp, scale2, stat, vis, ds, ds);
    } else {
      backward_tile<true, false>(s, dp, scale2, stat, vis, ds, ds);
    }
    gemm_nn<NT / 2, ND>(acc, ds, ks, LDT);
    __syncthreads();  // every warp is done with this buffer before it is filled again
    ok_cur = ok_next;
  }
  write_acc<HD>(dq + b * dqbs + (long long)h * HD, dqrs, acc, qi_lo, L, scale, scale);
}

template <int HD>
constexpr size_t dkv_mma_smem() {
  return (size_t)(6 * BM * (HD + 8)) * sizeof(bf16) + 4 * BM * sizeof(float) + BN * sizeof(int);
}

// hd = 64: at most 168 registers a thread, so that three blocks fit an SM
template <int HD>
__global__ void __launch_bounds__(THREADS, HD == 64 ? 3 : 1)
flash_attn_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const unsigned char* __restrict__ valid,
                              const bf16* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ di, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int L, long long qbs, long long qrs,
                              long long kbs, long long krs, long long vbs, long long vrs,
                              long long gbs, long long grs, long long dkbs, long long dkrs,
                              long long dvbs, long long dvrs, float scale, int causal,
                              int prefix) {
  constexpr int LDT = HD + 8;
  constexpr int KS = HD / 16, NT = BM / 8, ND = HD / 8;
  extern __shared__ __align__(128) unsigned char flash_smem[];
  bf16* ks = reinterpret_cast<bf16*>(flash_smem);  // (BN, LDT): the block's keys
  bf16* vs = ks + BN * LDT;                        // (BN, LDT): and their values
  bf16* qbuf = vs + BN * LDT;                      // 2 x (BM, LDT): query tiles, double-buffered
  bf16* gbuf = qbuf + 2 * BM * LDT;                // 2 x (BM, LDT): their rows of do
  float* lbuf = reinterpret_cast<float*>(gbuf + 2 * BM * LDT);  // 2 x (BM,): their lse
  float* dbuf = lbuf + 2 * BM;                     // 2 x (BM,): their di
  int* kvk = reinterpret_cast<int*>(dbuf + 2 * BM);  // (BN,): the block's keys exist and are valid

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * BN;
  const int H = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int kj_lo = j0 + warp * WR + g, kj_hi = kj_lo + 8;
  const bf16* qh = q + b * qbs + (long long)h * HD;
  const bf16* gh = dout + b * gbs + (long long)h * HD;
  const long long row_base = ((long long)b * H + h) * L;

  const int first = (causal && j0 >= prefix) ? j0 / BM : 0;
  const int ntiles = (L + BM - 1) / BM;
  const float scale2 = scale * LOG2E;

  stage_tile<bf16, HD>(ks, k + b * kbs + (long long)h * HD, krs, j0, L);
  stage_tile<bf16, HD>(vs, v + b * vbs + (long long)h * HD, vrs, j0, L);
  // (this barrier also publishes the staged keys, values and flags)
  const int keys_ok = __syncthreads_and(
      stage_valid(kvk, valid == nullptr ? nullptr : valid + (long long)b * L, j0, L));
  const bf16* kw = ks + warp * WR * LDT;
  const bf16* vw = vs + warp * WR * LDT;
  float acc_k[ND][4], acc_v[ND][4];
  zero_acc(acc_k);
  zero_acc(acc_v);

  const auto prefetch = [&](int tile) {  // query tile `tile` into buffer tile & 1
    const int buf = tile & 1, i0 = tile * BM;
    stage_tile_async<HD>(qbuf + buf * BM * LDT, qh, qrs, i0, L);
    stage_tile_async<HD>(gbuf + buf * BM * LDT, gh, grs, i0, L);
    stage_rows_async(lbuf + buf * BM, lse + row_base, i0, L);
    stage_rows_async(dbuf + buf * BM, di + row_base, i0, L);
  };
  prefetch(first);
  cp_async_commit();

  for (int tile = first; tile < ntiles; ++tile) {
    const int i0 = tile * BM;
    const bf16* qs = qbuf + (tile & 1) * BM * LDT;
    const bf16* gs = gbuf + (tile & 1) * BM * LDT;
    const float* lses = lbuf + (tile & 1) * BM;
    const float* dis = dbuf + (tile & 1) * BM;
    if (tile + 1 < ntiles) prefetch(tile + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next may still be in flight
    __syncthreads();
    const bool kok_lo = kvk[warp * WR + g] != 0, kok_hi = kvk[warp * WR + g + 8] != 0;

    // transposed scores: the warp's 16 keys (rows) against the tile's 64 queries
    float st[NT][4], dpt[NT][4];
    zero_acc(st);
    zero_acc(dpt);
    gemm_nt<KS, NT>(st, kw, LDT, qs, LDT);
    gemm_nt<KS, NT>(dpt, vw, LDT, gs, LDT);

    uint32_t pt[NT / 2][4], dst[NT / 2][4];
    const auto stat = [&](int j, int c, float& lse2, float& d) {
      const int col = 8 * j + 2 * t + (c & 1);
      lse2 = lses[col] * LOG2E;
      d = dis[col];
    };
    const auto vis = [&](int j, int c) {
      const int qi = i0 + 8 * j + 2 * t + (c & 1);
      const int kj = c < 2 ? kj_lo : kj_hi;
      return (c < 2 ? kok_lo : kok_hi) && qi < L && (!causal || kj <= qi || kj < prefix);
    };
    // every query of the tile exists and sees every key of the block
    const bool full = keys_ok && i0 + BM <= L &&
                      (!causal || j0 + BN - 1 <= i0 || j0 + BN <= prefix);
    if (full) {
      backward_tile<false, true>(st, dpt, scale2, stat, vis, pt, dst);
    } else {
      backward_tile<true, true>(st, dpt, scale2, stat, vis, pt, dst);
    }
    gemm_nn<NT / 2, ND>(acc_v, pt, gs, LDT);   // dv += p^T . do
    gemm_nn<NT / 2, ND>(acc_k, dst, qs, LDT);  // dk += ds^T . q
    __syncthreads();  // every warp is done with this buffer before it is filled again
  }
  write_acc<HD>(dk + b * dkbs + (long long)h * HD, dkrs, acc_k, kj_lo, L, scale, scale);
  write_acc<HD>(dv + b * dvbs + (long long)h * HD, dvrs, acc_v, kj_lo, L, 1.f, 1.f);
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
  const void *q, *k, *v, *valid, *dout, *lse, *di;
  void *o, *lse_out, *dq, *dk, *dv;
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
      static_cast<const float*>(a.lse), static_cast<const float*>(a.di), static_cast<T*>(a.dq),
      a.L, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.st[8],
      a.st[9], a.scale, a.causal, a.prefix);
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

enum Which { FWD, DQ, DKV };

// bf16 takes the tensor-core kernels, fp32 the CUDA-core ones
template <typename T, int HD>
cudaError_t launch_one(Which which, const Args& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    switch (which) {
      case FWD: return launch_fwd<T>(flash_attn_fwd_mma_kernel<HD>, fwd_mma_smem<HD>(), a);
      case DQ: return launch_dq<T>(flash_attn_bwd_dq_mma_kernel<HD>, dq_mma_smem<HD>(), a);
      default: return launch_dkv<T>(flash_attn_bwd_dkv_mma_kernel<HD>, dkv_mma_smem<HD>(), a);
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

// strides: q, k, v, dout, dq (10 values)
extern "C" int oct_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* valid, const void* dout, const void* lse,
                                          const void* di, void* dq, int B, int L, int H, int hd,
                                          const long long* strides, float scale, int causal,
                                          int prefix_len, int dtype, void* stream) {
  Args a{};
  a.q = q, a.k = k, a.v = v, a.valid = valid, a.dout = dout, a.lse = lse, a.di = di, a.dq = dq;
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
  a.q = q, a.k = k, a.v = v, a.valid = valid, a.dout = dout, a.lse = lse, a.di = di;
  a.dk = dk, a.dv = dv;
  a.B = B, a.L = L, a.H = H, a.st = strides, a.scale = scale, a.causal = causal;
  a.prefix = prefix_len, a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(DKV, hd, dtype, a);
}
