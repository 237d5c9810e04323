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
//   - the bf16 forward (the "wgmma" body, further down) is Hopper's: warpgroup
//     products (wgmma) on tiles that TMA copies into shared memory, a producer warp
//     and two consumer warpgroups on mbarriers, a persistent grid, and key tiles that
//     hold no valid key neither loaded nor multiplied;
//   - the backward kernels (bf16: mma.sync m16n8k16, operands loaded with ldmatrix)
//     and the fp32 forward: one block of 4 warps per (64-row tile, head, sample);
//     each warp owns 16 rows of the tile, so between the loads of two tiles no warp
//     waits for another; K/V (or Q/dO) stream through shared memory in 64-row tiles,
//     rows padded by 16 bytes so that ldmatrix reads no bank twice; in the bf16
//     kernels the tiles are double-buffered and copied with cp.async; key validity is
//     one byte per (sample, key), staged per key tile;
//   - the bf16 kernels take exponentials in base 2 on the special-function unit,
//     and a tile that every row of the block sees whole skips the mask arithmetic;
//   - under the causal mask the tiles no row of the block can see are skipped,
//     and the prefix tiles are kept.
// Not done yet (a later change): the backward kernels on wgmma and TMA.
//
// Shared memory per block (bytes), dynamic, opted in above 48 KB:
//   forward   bf16 hd=64 181,248 or 164,864 (192- or 128-row items)  hd=128 230,400
//             fp32 hd=64 106,752  hd=128 172,288
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

// the key tiles of an item: up to the diagonal of its last row and the prefix's
// under the causal mask
__device__ __forceinline__ int wg_key_tiles(int q0, int bm, int L, int causal, int prefix) {
  int ntiles = (L + WG_BN - 1) / WG_BN;
  if (causal) {
    const int diag = min((q0 + bm + WG_BN - 1) / WG_BN, ntiles);
    const int pre = min((prefix + WG_BN - 1) / WG_BN, ntiles);
    ntiles = max(diag, pre);
  }
  return ntiles;
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
  // the swizzle repeats every 1024 bytes: every box starts on such a boundary
  unsigned char* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
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
      const unsigned char* valid_b = valid == nullptr ? nullptr : valid + (long long)b * L;
      const int ntiles = wg_key_tiles(q0, W::BM, L, causal, prefix);
      // does key 32 w + lane of tile tt exist and is it valid?
      const auto key_ok = [&](int tt, int w) -> uint32_t {
        const int key = tt * WG_BN + 32 * w + lane;
        if (tt >= ntiles || key >= L) return 0u;
        return valid_b == nullptr ? 1u : (uint32_t)valid_b[key];
      };
      uint32_t words[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) words[w] = __ballot_sync(0xffffffffu, key_ok(0, w) != 0u);
      for (int t = 0; t <= ntiles; ++t) {  // t == ntiles: the end of the item
        // the next tile's validity bytes, read now and used once this tile's copies are
        // issued: the loads travel while lane 0 waits for a free stage
        uint32_t next[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) next[w] = key_ok(t + 1, w);
        if (t == ntiles || (words[0] | words[1] | words[2] | words[3]) != 0u) {  // else: no valid key
          if (lane == 0) {
            mbar_wait(&empty_bar[stage], phase ^ 1);  // both consumer warpgroups released it
            slots[stage].tile = t < ntiles ? t : -1;
#pragma unroll
            for (int w = 0; w < 4; ++w) slots[stage].valid[w] = words[w];
            if (t < ntiles) {
              mbar_arrive_expect_tx(&full_bar[stage], W::KV_BYTES);
              bf16* ks = kvs + (size_t)stage * W::KV_BYTES / 2;
              bf16* vs = ks + W::HALVES * WG_BN * 64;
#pragma unroll
              for (int c = 0; c < W::HALVES; ++c) {
                tma_load_3d(ks + c * WG_BN * 64, &tk, &full_bar[stage], h * HD + 64 * c,
                            t * WG_BN, b);
                tma_load_3d(vs + c * WG_BN * 64, &tv, &full_bar[stage], h * HD + 64 * c,
                            t * WG_BN, b);
              }
            } else {
              mbar_arrive(&full_bar[stage]);
            }
          }
          __syncwarp();
          if (++stage == W::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) words[w] = __ballot_sync(0xffffffffu, next[w] != 0u);
      }
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

// q, k, v as TMA tensor maps over their (B, L, H*hd) views, strides from a.st; one
// block a multiprocessor, or one an item where there are fewer items
template <int HD, int CWG>
cudaError_t launch_fwd_wgmma_cwg(const Args& a) {
  using W = WgTile<HD, CWG>;
  CUtensorMap maps[3];
  const void* ptrs[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i)
    if (!encode_rows_3d(&maps[i], ptrs[i], (long long)a.H * HD, a.L, a.B,
                        a.st[2 * i + 1] * (long long)sizeof(bf16),
                        a.st[2 * i] * (long long)sizeof(bf16), i == 0 ? W::BM : WG_BN))
      return cudaErrorInvalidValue;
  auto kern = flash_attn_fwd_wgmma_kernel<HD, CWG>;
  cudaError_t e = opt_in_smem(kern, W::SMEM);
  if (e != cudaSuccess) return e;
  int device, sms;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  const long long items = (long long)((a.L + W::BM - 1) / W::BM) * a.H * a.B;
  if (items > 2147483647LL) return cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  kern<<<grid, W::THREADS, W::SMEM, a.stream>>>(
      maps[0], maps[1], maps[2], static_cast<const unsigned char*>(a.valid),
      static_cast<bf16*>(a.o), static_cast<float*>(a.lse_out), a.B, a.L, a.H, a.st[6], a.st[7],
      a.scale, a.causal, a.prefix);
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
