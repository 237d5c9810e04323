// Short-sequence self-attention for Hopper (sm_90a): forward and backward.
//
// FORWARD. Replaces the TPU kernel open_clip_tpu/ops/short_attention.py:_fwd_kernel_v2
// (launched by _fwd_call). It computes what short_attention(q, k, v, causal,
// scale) computes: for each sample b and head h, exact softmax attention over
// L <= 288 keys, with the logits q.k * scale in fp32, an optional causal mask
// (key j > query i masked), an fp32 softmax whose probabilities are rounded to
// the input dtype before the product with v, an fp32 accumulator, and the
// output written in the input dtype.
//
// Bound on this card: memory. At CLIP's shapes (L = 50..77, hd = 64) the call
// does 4*B*L^2*W operations on 4*B*L*W*size bytes, about L operations per byte,
// far below the ~295 per byte where the H100's bf16 tensor cores become the
// limit. What the design does about it:
//   - q, k and v are read straight from the tower's (B, L, H*hd) layout, with a
//     row stride per tensor, so the q/k/v slices of one fused projection are
//     read in place: no (B, H, L, hd) transpose is ever written to memory;
//   - one block per (query tile of 16 rows, head, sample) stages K, then V, in
//     32-key tiles in shared memory; the logits and probabilities of the tile's
//     rows stay in shared memory (16 x round_up(L, 32) fp32), so nothing but
//     the output goes back to device memory;
//   - each warp owns 4 query rows and each lane one key of the tile (logits) or
//     hd/32 output columns (product with v); every K/V element staged once in
//     shared memory serves the block's 16 rows.
// Each row keeps its own max and sum: no max is shared across heads (the v2
// TPU body shares one across co-tiled heads and can return NaN when one head's
// logits sit ~100 below its neighbour's).
//
// Shared memory per block: (16*hd + 32*(hd+4) + 16*round_up(L, 32)) floats,
// at most 43.5 KB (L = 288, hd = 128), so no opt-in beyond 48 KB is needed;
// the launcher still opts in when a shape would exceed it. This CUDA-core body serves
// fp32; bf16 takes the tensor-core forward below.
//
// BF16 FORWARD ON THE TENSOR CORES (the "mma" body). The same function, with the TPU
// kernel's rounding points: e = exp(s - max) in fp32, e rounded to bf16 for the product
// with v, the row sum over the fp32 e, out = (e.v) / sum rounded once. (The plain
// PyTorch version rounds the normalised probabilities instead; both stay within 2e-2 of
// each other.) That order keeps e in registers: the accumulator tiles of q.k^T, two
// 8-key tiles at a time, are the A fragments of e.v (mma.sync m16n8k16, V read with
// ldmatrix.trans), so no probability goes through shared memory. At L <= 128 one block
// of LP/16 warps per (head, sample), the head fastest in the grid: it stages Q, K and V
// whole with 16-byte cp.async (rows at or past L zero-filled), V in a second group that
// lands while q.k^T runs; warp w owns queries 16w..16w+15 and holds its whole score row
// in registers (at most 64 floats), so K and V are read once per (sample, head). Past
// L = 128 the row would not fit with the accumulators. The block per (head, sample) then
// keeps K and V whole in shared memory; its warps (at most 6) take the 16-query units
// in turn, each staging its unit's rows of Q in an area of its own, and take q.k^T over
// 64-key chunks twice: first for each row's max, then for the exponentials and e.v (an
// online rescale would move the rounding points). Each row keeps its own max; under the
// causal mask the chunks and tiles above the diagonal are skipped, and a tile with no
// masked entry skips the mask arithmetic. Shared memory: 3*LP*(hd+8) bf16 at L <= 128
// (27 KB at L = 50, hd = 64), (2*LP + 16*warps)*(hd+8) past it (90 KB at L = 257,
// hd = 64, two blocks an SM; 179 KB at L = 288, hd = 128).
//
// BACKWARD. Replaces the TPU kernel _bwd_kernel_v2 (launched by _bwd_call) of the
// same file. From q, k, v and do it recomputes the softmax (the forward keeps
// nothing but q, k and v) and gives dq, dk and dv, with the TPU kernel's
// rounding points:
//   s   = q.k * scale in fp32, causal mask, p32 = softmax(s) in fp32;
//   dp  = do.v^T in fp32;  delta = rowsum(dp * p32);
//   ds  = p32 * (dp - delta) * scale, rounded to the input dtype;
//   dq  = ds.k,  dk = ds^T.q,  dv = p^T.do with p = p32 rounded to the input
//   dtype; all three accumulated in fp32 and written in the input dtype.
// dq sums over keys, but dk and dv sum over queries, so the forward's
// decomposition (one block per 16-query tile) would need a reduction across
// blocks, which bf16 outputs cannot take as atomics. The backward is therefore
// two kernels on one stream, each of which writes each of its outputs once, in a
// fixed order (the result does not change from run to run):
//   1. dq kernel, one block per (16-query tile, head, sample): stages K and V
//      tiles side by side, keeps the tile's logits and dp in shared memory,
//      takes each row's max, sum and delta, writes dq, and leaves the three row
//      statistics in a (B, H, 3, L) fp32 scratch tensor of the caller's;
//   2. dk/dv kernel, one block per (16-key tile, head, sample): stages Q and dO
//      tiles side by side, rebuilds p and ds for its keys from the row
//      statistics (the same expf(s - max) / sum as kernel 1, so the same bits)
//      and accumulates dk and dv in registers in a single pass over the queries.
//      Under the causal mask it starts at the first query tile that sees its keys.
// Bound on this card: memory, as the forward (7*B*L*W*size bytes for 10*B*H*hd*
// pairs operations). The scratch statistics add 12 bytes per (row, head), under
// 1 % of the traffic at hd = 64. Shared memory: the dq kernel takes
// (2*16*hd + 2*32*(hd+4) + 2*16*round_up(L, 32)) floats, 86.5 KB at L = 288,
// hd = 128, so the launcher opts in above 48 KB; the dk/dv kernel takes
// (2*16*hd + 2*32*(hd+4) + 2*16*32) floats, at most 53 KB.
//
// FUSED BACKWARD (bf16, L <= 128; the "mma" body). At these lengths a whole (sample,
// head) fits one block, so the backward is one kernel with the same rounding points and
// no scratch: one block of L/16 warps per (head, sample) stages Q, K, V and dO whole with
// 16-byte cp.async (L padded to a multiple of 16 with zero rows, rows padded by 16 bytes
// for ldmatrix); warp w owns queries 16w..16w+15 and computes S = q.k^T and dP = do.v^T
// on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate), the softmax with its
// own max per row and head, delta and ds in the accumulator registers; p and ds go to
// shared memory as bf16 tiles, dq = ds.k reads them back; then warp w owns keys
// 16w..16w+15 for dk = ds^T.q and dv = p^T.do (ldmatrix.trans). The causal mask is
// applied in registers and the tiles above the diagonal are skipped. Every output is
// written once: the same bits every run. Shared memory: (4*LP*(hd+8) + 2*LP*(LP+8))
// bf16, 74 KB at L = 77 (LP = 80), hd = 64, and 204 KB at L = 128, hd = 128 (opted in).
//
// LONG BACKWARD (bf16, 128 < L <= 288; the "mma" body too). The p and ds tiles of a
// whole (sample, head) no longer fit a block (305 KB at L = 272), so the two-kernel
// decomposition of the CUDA-core body stays, with its products on the tensor cores and p
// and ds in registers. Each kernel gives a (head, sample) one block that holds the operand
// its rows share whole in shared memory, read once; its warps (at most 6) take the
// 16-row units in turn, each staging its unit in an area of its own:
//   1. K and V whole; per unit of queries with its rows of dO: over 64-key chunks S and
//      dP, the row max, and the sums of exp(s - max) and of dp * exp(s - max) rescaled
//      with the running max (one pass); the max (base 2), 1 / sum and delta = the second
//      sum over the first go to the (B, H, 3, L) scratch; then S and dP again, and
//      ds = p32 * (dp - delta) * scale rounded to bf16 in registers as the A operand of
//      dq = ds.k;
//   2. Q, dO and the statistics whole; per unit of keys with their values: over the
//      64-query chunks that see them, S^T = k.q^T and dP^T = v.do^T, p32 and ds rebuilt
//      as kernel 1 builds them (the same expression on the same logits), p and ds rounded
//      in registers, dk += ds^T.q, dv += p^T.do.
// Nine products of 2*B*H*L^2*hd each (S and dP twice in kernel 1), all on the tensor
// cores; no atomics, every output written once. Shared memory: (2*LP + 32*warps)*(hd+8)
// bf16 (kernel 2 adds 3*LP floats), 107 KB at L = 257, hd = 64 (two blocks an SM), and
// 207 KB at L = 288, hd = 128.
//
// C interface, loaded with ctypes: oct_short_attention_fwd and oct_short_attention_bwd
// (the CUDA-core bodies, fp32), oct_short_attention_fwd_mma and
// oct_short_attention_bwd_mma (the tensor-core bodies, bf16; the backward picks its
// kernels by L) return the cudaError_t of the launch (0 on success). They launch on the
// given stream, do not synchronise and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int QT = 16;           // query rows per block
constexpr int KT = 32;           // keys per shared-memory tile: one per lane
constexpr int WARPS = 4;
constexpr int RPW = QT / WARPS;  // query rows per warp
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// x rounded to T and back: the probabilities enter the product with v in the
// input dtype, as in the reference (for fp32, the one dtype these kernels serve, a no-op).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + n) of one head's (L, HD) slice (row stride rs elements) into
// shared memory as fp32 with row stride ds; rows at or past L become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int ds, const T* src, long long rs,
                                      int r0, int n, int L) {
  constexpr int V = HD / 4;
  for (int i = threadIdx.x; i < n * V; i += THREADS) {
    const int r = i / V, c = (i % V) * 4;
    const int row = r0 + r;
    const float4 x = row < L ? load4(src + row * rs + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * ds + c) = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
short_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int L,
                      long long qbs, long long qrs, long long kbs, long long krs,
                      long long vbs, long long vrs, long long obs, long long ors,
                      float scale, int causal) {
  constexpr int KS = HD + 4;  // padded K/V row: conflict-free float4 reads per lane
  constexpr int C = HD / 32;  // output columns per lane
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // (QT, HD)
  float* kv = qs + QT * HD;                       // (KT, KS): a K tile, then a V tile
  float* ss = kv + KT * KS;                       // (QT, LS): logits, then probabilities
  const int LS = (L + KT - 1) / KT * KT;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kend = causal ? min(L, q0 + QT) : L;  // keys any row of the tile can see
  const int ntiles = (kend + KT - 1) / KT;

  const T* qh = q + b * qbs + (long long)h * HD;
  const T* kh = k + b * kbs + (long long)h * HD;
  const T* vh = v + b * vbs + (long long)h * HD;
  stage<T, HD>(qs, HD, qh, qrs, q0, QT, L);

  // logits: lane j of a warp scores key k0 + j against the warp's 4 rows
  const float* qw = qs + warp * RPW * HD;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * KT;
    __syncthreads();
    stage<T, HD>(kv, KS, kh, krs, k0, KT, L);
    __syncthreads();
    float acc[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
    const float* kr = kv + lane * KS;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(qw + r * HD + d);
        acc[r] = fmaf(qq.x, kk.x, acc[r]);
        acc[r] = fmaf(qq.y, kk.y, acc[r]);
        acc[r] = fmaf(qq.z, kk.z, acc[r]);
        acc[r] = fmaf(qq.w, kk.w, acc[r]);
      }
    }
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      const bool ok = kj < L && (!causal || kj <= q0 + row);
      ss[row * LS + kj] = ok ? acc[r] * scale : -INFINITY;
    }
  }
  __syncwarp();

  // softmax of each row, in place; key 0 is visible to every row, so the max
  // is finite and the sum is at least 1
  const int n = ntiles * KT;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    float* sr = ss + (warp * RPW + r) * LS;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) sr[j] = round_to(sr[j] / sum, q);
  }

  // context: lane owns output columns [lane*C, lane*C + C) of the warp's rows
  float out[RPW][C];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) out[r][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * KT;
    __syncthreads();
    stage<T, HD>(kv, KS, vh, vrs, k0, KT, L);
    __syncthreads();
    for (int j = 0; j < KT; ++j) {
      float vv[C];
      const float* vr = kv + j * KS + lane * C;
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = vr[c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = ss[(warp * RPW + r) * LS + k0 + j];
#pragma unroll
        for (int c = 0; c < C; ++c) out[r][c] = fmaf(p, vv[c], out[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + warp * RPW + r;
    if (qi < L) {
      T* orow = o + b * obs + qi * ors + (long long)h * HD + lane * C;
#pragma unroll
      for (int c = 0; c < C; ++c) store(orow + c, out[r][c]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int L,
                   int H, const long long* strides, float scale, int causal,
                   cudaStream_t stream) {
  const int LS = (L + KT - 1) / KT * KT;
  const size_t smem = (size_t)(QT * HD + KT * (HD + 4) + QT * LS) * sizeof(float);
  auto kern = short_attn_fwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((L + QT - 1) / QT, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), L, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], strides[6], strides[7], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
                      int L, int H, const long long* strides, float scale, int causal,
                      cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, L, H, strides, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, L, H, strides, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, L, H, strides, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// acc[r] = own[r] . tile[lane] for the warp's RPW own rows (row stride HD) and
// the lane's row of a staged tile (row stride HD + 4): the forward's logit loop.
template <int HD>
__device__ __forceinline__ void dot_rows(const float* own, const float* tile_row,
                                         float (&acc)[RPW]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 t = *reinterpret_cast<const float4*>(tile_row + d);
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(own + r * HD + d);
      acc[r] = fmaf(a.x, t.x, acc[r]);
      acc[r] = fmaf(a.y, t.y, acc[r]);
      acc[r] = fmaf(a.z, t.z, acc[r]);
      acc[r] = fmaf(a.w, t.w, acc[r]);
    }
  }
}

// out[r][c] += sum_j w[r * ws + j] * tile[j][lane * C + c] over the KT rows of a
// staged tile: the forward's product with v. w points at the warp's first row.
template <int HD>
__device__ __forceinline__ void axpy_rows(const float* w, int ws, const float* tile, int lane,
                                          float (&out)[RPW][HD / 32]) {
  constexpr int KS = HD + 4;
  constexpr int C = HD / 32;
  for (int j = 0; j < KT; ++j) {
    float t[C];
    const float* tr = tile + j * KS + lane * C;
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = tr[c];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float x = w[r * ws + j];
#pragma unroll
      for (int c = 0; c < C; ++c) out[r][c] = fmaf(x, t[c], out[r][c]);
    }
  }
}

template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* dst, long long rs, int row0, int L, int lane,
                                           const float (&out)[RPW][HD / 32]) {
  constexpr int C = HD / 32;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (row0 + r < L) {
      T* p = dst + (row0 + r) * rs + lane * C;
#pragma unroll
      for (int c = 0; c < C; ++c) store(p + c, out[r][c]);
    }
  }
}

// Kernel 1: dq and the row statistics (max, sum, delta) of one 16-query tile.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
short_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         T* __restrict__ dq, float* __restrict__ stats, int L,
                         long long qbs, long long qrs, long long kbs, long long krs,
                         long long vbs, long long vrs, long long gbs, long long grs,
                         long long dqbs, long long dqrs, float scale, int causal) {
  constexpr int KS = HD + 4;
  constexpr int C = HD / 32;
  extern __shared__ float4 smem_f4[];
  const int LS = (L + KT - 1) / KT * KT;
  float* qs = reinterpret_cast<float*>(smem_f4);  // (QT, HD)
  float* gs = qs + QT * HD;                       // (QT, HD): the tile's rows of do
  float* kt = gs + QT * HD;                       // (KT, KS): a K tile
  float* vt = kt + KT * KS;                       // (KT, KS): a V tile
  float* ss = vt + KT * KS;                       // (QT, LS): logits, then p32
  float* dd = ss + QT * LS;                       // (QT, LS): dp, then ds

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int H = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kend = causal ? min(L, q0 + QT) : L;
  const int ntiles = (kend + KT - 1) / KT;

  const T* kh = k + b * kbs + (long long)h * HD;
  const T* vh = v + b * vbs + (long long)h * HD;
  stage<T, HD>(qs, HD, q + b * qbs + (long long)h * HD, qrs, q0, QT, L);
  stage<T, HD>(gs, HD, dout + b * gbs + (long long)h * HD, grs, q0, QT, L);

  // logits and dp of the tile's rows against every visible key
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * KT;
    __syncthreads();
    stage<T, HD>(kt, KS, kh, krs, k0, KT, L);
    stage<T, HD>(vt, KS, vh, vrs, k0, KT, L);
    __syncthreads();
    float s[RPW], dp[RPW];
    dot_rows<HD>(qs + warp * RPW * HD, kt + lane * KS, s);
    dot_rows<HD>(gs + warp * RPW * HD, vt + lane * KS, dp);
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      const bool ok = kj < L && (!causal || kj <= q0 + row);
      ss[row * LS + kj] = ok ? __fmul_rn(s[r], scale) : -INFINITY;
      dd[row * LS + kj] = dp[r];
    }
  }
  __syncwarp();

  // per row: p32 = softmax, delta = sum(dp * p32), ds = p32 * (dp - delta) * scale
  const int n = ntiles * KT;
  float* st = stats + ((long long)b * H + h) * 3 * L;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp * RPW + r;
    float* sr = ss + row * LS;
    float* dr = dd + row * LS;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = sr[j] / sum;
      sr[j] = p;
      delta = fmaf(dr[j], p, delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < n; j += 32) dr[j] = round_to(sr[j] * (dr[j] - delta) * scale, q);
    if (lane == 0 && q0 + row < L) {
      st[q0 + row] = m;
      st[L + q0 + row] = sum;
      st[2 * L + q0 + row] = delta;
    }
  }

  // dq = ds . k
  float out[RPW][C];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) out[r][c] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    __syncthreads();
    stage<T, HD>(kt, KS, kh, krs, t * KT, KT, L);
    __syncthreads();
    axpy_rows<HD>(dd + warp * RPW * LS + t * KT, LS, kt, lane, out);
  }
  store_rows<T, HD>(dq + b * dqbs + (long long)h * HD, dqrs, q0 + warp * RPW, L, lane, out);
}

// Kernel 2: dk and dv of one 16-key tile, from the row statistics of kernel 1.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
short_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          T* __restrict__ dk, T* __restrict__ dv,
                          const float* __restrict__ stats, int L,
                          long long qbs, long long qrs, long long kbs, long long krs,
                          long long vbs, long long vrs, long long gbs, long long grs,
                          long long dkbs, long long dkrs, long long dvbs, long long dvrs,
                          float scale, int causal) {
  constexpr int KS = HD + 4;
  constexpr int C = HD / 32;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);  // (QT, HD): the tile's keys
  float* vs = ks + QT * HD;                       // (QT, HD): and their values
  float* qt = vs + QT * HD;                       // (KT, KS): a Q tile
  float* gt = qt + KT * KS;                       // (KT, KS): a dO tile
  float* pw = gt + KT * KS;                       // (QT, KT): p, rounded, key-major
  float* dw = pw + QT * KT;                       // (QT, KT): ds, key-major

  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * QT;
  const int H = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // under the causal mask the queries before j0 see none of this tile's keys
  const int first = causal ? j0 / KT : 0;
  const int ntiles = (L + KT - 1) / KT;

  const T* qh = q + b * qbs + (long long)h * HD;
  const T* gh = dout + b * gbs + (long long)h * HD;
  const float* st = stats + ((long long)b * H + h) * 3 * L;
  stage<T, HD>(ks, HD, k + b * kbs + (long long)h * HD, krs, j0, QT, L);
  stage<T, HD>(vs, HD, v + b * vbs + (long long)h * HD, vrs, j0, QT, L);

  float acc_k[RPW][C], acc_v[RPW][C];  // dk and dv accumulators
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  for (int t = first; t < ntiles; ++t) {
    const int i0 = t * KT;
    __syncthreads();
    stage<T, HD>(qt, KS, qh, qrs, i0, KT, L);
    stage<T, HD>(gt, KS, gh, grs, i0, KT, L);
    __syncthreads();
    // lane i of a warp takes query i0 + i against the warp's 4 keys
    float s[RPW], dp[RPW];
    dot_rows<HD>(ks + warp * RPW * HD, qt + lane * KS, s);
    dot_rows<HD>(vs + warp * RPW * HD, gt + lane * KS, dp);
    const int qi = i0 + lane;
    const bool qok = qi < L;
    const float m = qok ? st[qi] : 0.f;
    const float sum = qok ? st[L + qi] : 1.f;
    const float delta = qok ? st[2 * L + qi] : 0.f;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp * RPW + r;
      const int kj = j0 + row;
      const bool ok = qok && kj < L && (!causal || kj <= qi);
      // __fmul_rn: no fused multiply-add, so s * scale rounds as it did in kernel 1
      const float p = ok ? expf(__fmul_rn(s[r], scale) - m) / sum : 0.f;
      pw[row * KT + lane] = round_to(p, q);
      dw[row * KT + lane] = round_to(p * (dp[r] - delta) * scale, q);
    }
    __syncwarp();
    axpy_rows<HD>(dw + warp * RPW * KT, KT, qt, lane, acc_k);  // dk += ds^T . q
    axpy_rows<HD>(pw + warp * RPW * KT, KT, gt, lane, acc_v);  // dv += p^T . do
  }
  store_rows<T, HD>(dk + b * dkbs + (long long)h * HD, dkrs, j0 + warp * RPW, L, lane, acc_k);
  store_rows<T, HD>(dv + b * dvbs + (long long)h * HD, dvrs, j0 + warp * RPW, L, lane, acc_v);
}

template <typename K>
cudaError_t opt_in_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                       void* dk, void* dv, float* stats, int B, int L, int H,
                       const long long* st, float scale, int causal, cudaStream_t stream) {
  const int LS = (L + KT - 1) / KT * KT;
  const size_t tiles = (size_t)(2 * QT * HD + 2 * KT * (HD + 4));
  const size_t smem_dq = (tiles + 2 * QT * LS) * sizeof(float);
  const size_t smem_dkv = (tiles + 2 * QT * KT) * sizeof(float);
  auto kern_dq = short_attn_bwd_dq_kernel<T, HD>;
  auto kern_dkv = short_attn_bwd_dkv_kernel<T, HD>;
  cudaError_t e = opt_in_smem(kern_dq, smem_dq);
  if (e != cudaSuccess) return e;
  e = opt_in_smem(kern_dkv, smem_dkv);
  if (e != cudaSuccess) return e;
  const dim3 grid((L + QT - 1) / QT, H, B);
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *gp = static_cast<const T*>(dout);
  kern_dq<<<grid, THREADS, smem_dq, stream>>>(
      qp, kp, vp, gp, static_cast<T*>(dq), stats, L, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kern_dkv<<<grid, THREADS, smem_dkv, stream>>>(
      qp, kp, vp, gp, static_cast<T*>(dk), static_cast<T*>(dv), stats, L, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[10], st[11], st[12], st[13], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_hd(int hd, const void* q, const void* k, const void* v, const void* dout,
                          void* dq, void* dk, void* dv, float* stats, int B, int L, int H,
                          const long long* st, float scale, int causal, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_bwd<T, 32>(q, k, v, dout, dq, dk, dv, stats, B, L, H, st, scale, causal, stream);
    case 64:
      return launch_bwd<T, 64>(q, k, v, dout, dq, dk, dv, stats, B, L, H, st, scale, causal, stream);
    case 128:
      return launch_bwd<T, 128>(q, k, v, dout, dq, dk, dv, stats, B, L, H, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 backward, fused, on the tensor cores (the "mma" body): L <= 128
// ---------------------------------------------------------------------------

constexpr int FUSED_MAX_L = 128;

// offset (elements) of row r from the first row: r times a row stride
struct RowStride {
  long long rs;
  __device__ __forceinline__ long long operator()(int r) const { return r * rs; }
};

// Shared memory of the fused kernel: Q, K, V and dO whole, (LP, HD + 8) bf16 each, and
// the (LP, LP + 8) bf16 p and ds tiles; LP = L rounded up to 16.
template <int HD>
size_t fused_smem(int L) {
  const int LP = (L + 15) / 16 * 16;
  return (size_t)(4 * LP * (HD + 8) + 2 * LP * (LP + 8)) * sizeof(bf16);
}

// One block per (head, sample), LP / 16 warps; NT >= LP / 8 sizes the score fragments.
template <int HD, int NT>
__global__ void __launch_bounds__(2 * FUSED_MAX_L)
short_attn_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int L, long long qbs, long long qrs, long long kbs, long long krs,
                          long long vbs, long long vrs, long long gbs, long long grs,
                          long long dqbs, long long dqrs, long long dkbs, long long dkrs,
                          long long dvbs, long long dvrs, float scale, int causal) {
  constexpr int LDT = HD + 8, KS = HD / 16, ND = HD / 8, VPR = HD / 8;
  extern __shared__ __align__(128) unsigned char short_smem[];
  const int LP = (L + 15) / 16 * 16, LDP = LP + 8, nw = LP / 16, nt = LP / 8;
  bf16* qs = reinterpret_cast<bf16*>(short_smem);  // (LP, LDT)
  bf16* ks = qs + LP * LDT;                        // (LP, LDT)
  bf16* vs = ks + LP * LDT;                        // (LP, LDT)
  bf16* gs = vs + LP * LDT;                        // (LP, LDT): dO
  bf16* ps = gs + LP * LDT;                        // (LP, LDP): p, rounded
  bf16* dss = ps + LP * LDP;                       // (LP, LDP): ds, rounded

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = 16 * warp, row_lo = r0 + (lane >> 2);
  // key tiles of 8 that the warp's rows see: under the causal mask the tiles above
  // the diagonal are skipped
  const int ntw = causal ? min(nt, 2 * warp + 2) : nt;

  const auto stage = [&](bf16* dst, const bf16* src, long long bs, long long rs) {
    const bf16* base = src + b * bs + (long long)h * HD;
    for (int i = threadIdx.x; i < LP * VPR; i += blockDim.x) {
      const int r = i / VPR, c = (i % VPR) * 8;
      cp_async16(dst + r * LDT + c, base + min(r, L - 1) * rs + c, r < L);  // rows >= L: zeros
    }
  };
  stage(qs, q, qbs, qrs);
  stage(ks, k, kbs, krs);
  cp_async_commit();
  stage(gs, dout, gbs, grs);
  stage(vs, v, vbs, vrs);
  cp_async_commit();

  // S = q.k^T while dO and V are still on their way, then dP = do.v^T
  float sa[NT][4], dp[NT][4];
  zero_acc(sa);
  zero_acc(dp);
  cp_async_wait<1>();
  __syncthreads();
  gemm_nt<KS, NT>(sa, qs + r0 * LDT, LDT, ks, LDT, ntw);
  cp_async_wait<0>();
  __syncthreads();
  gemm_nt<KS, NT>(dp, gs + r0 * LDT, LDT, vs, LDT, ntw);

  // softmax of rows row_lo (entries 0, 1) and row_lo + 8 (entries 2, 3), base 2, a max
  // per row and head; entries of keys or rows past L, or above the diagonal, are 0
  const float scale2 = scale * LOG2E;
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < ntw)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1), row = row_lo + 8 * (c >> 1);
        const bool vis = row < L && col < L && (!causal || col <= row);
        sa[j][c] = vis ? sa[j][c] * scale2 : -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], sa[j][c]);
      }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < ntw)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[j][c] = sa[j][c] == -INFINITY ? 0.f : fast_exp2(sa[j][c] - mx[c >> 1]);
        sum[c >> 1] += sa[j][c];
      }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
  const float inv[2] = {sum[0] > 0.f ? 1.f / sum[0] : 0.f, sum[1] > 0.f ? 1.f / sum[1] : 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < ntw)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[j][c] *= inv[c >> 1];  // p, fp32
        delta[c >> 1] = fmaf(dp[j][c], sa[j][c], delta[c >> 1]);
      }
  delta[0] = quad_sum(delta[0]);
  delta[1] = quad_sum(delta[1]);

  // ds = p * (dp - delta) * scale; p and ds, rounded, to shared memory
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < ntw) {
      float d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) d[c] = sa[j][c] * (dp[j][c] - delta[c >> 1]) * scale;
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(ps + row_lo * LDP + col) = pack_bf16(sa[j][0], sa[j][1]);
      *reinterpret_cast<uint32_t*>(ps + (row_lo + 8) * LDP + col) = pack_bf16(sa[j][2], sa[j][3]);
      *reinterpret_cast<uint32_t*>(dss + row_lo * LDP + col) = pack_bf16(d[0], d[1]);
      *reinterpret_cast<uint32_t*>(dss + (row_lo + 8) * LDP + col) = pack_bf16(d[2], d[3]);
    }
  __syncwarp();

  // dq = ds . k over the keys the warp's rows see
  float acc[ND][4];
  zero_acc(acc);
  gemm_smem<ND, false>(acc, dss + r0 * LDP, LDP, ks, LDT, 0, ntw / 2);
  store_acc<ND>(dq + b * dqbs + (long long)h * HD, RowStride{dqrs}, acc, row_lo, L, 1.f);
  __syncthreads();  // every warp's rows of p and ds are in

  // the warp owns keys r0..r0 + 15: dk = ds^T . q, dv = p^T . do over the queries that
  // see them (under the causal mask, from the warp's own tile on)
  const int first = causal ? warp : 0;
  zero_acc(acc);
  gemm_smem<ND, true>(acc, dss + r0, LDP, qs, LDT, first, nw);
  store_acc<ND>(dk + b * dkbs + (long long)h * HD, RowStride{dkrs}, acc, row_lo, L, 1.f);
  zero_acc(acc);
  gemm_smem<ND, true>(acc, ps + r0, LDP, gs, LDT, first, nw);
  store_acc<ND>(dv + b * dvbs + (long long)h * HD, RowStride{dvrs}, acc, row_lo, L, 1.f);
}

template <int HD, int NT>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* dout,
                           void* dq, void* dk, void* dv, int B, int L, int H,
                           const long long* st, float scale, int causal, cudaStream_t stream) {
  const size_t smem = fused_smem<HD>(L);
  auto kern = short_attn_bwd_mma_kernel<HD, NT>;
  const cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const int LP = (L + 15) / 16 * 16;
  const dim3 grid(H, B);  // the head fastest: the heads of a sample share its rows in L2
  kern<<<grid, 2 * LP, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], st[12], st[13], scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_mma_l(const void* q, const void* k, const void* v, const void* dout,
                             void* dq, void* dk, void* dv, int B, int L, int H,
                             const long long* st, float scale, int causal, cudaStream_t stream) {
  if (L <= 64)
    return launch_bwd_mma<HD, 8>(q, k, v, dout, dq, dk, dv, B, L, H, st, scale, causal, stream);
  return launch_bwd_mma<HD, 16>(q, k, v, dout, dq, dk, dv, B, L, H, st, scale, causal, stream);
}

// ---------------------------------------------------------------------------
// bf16 forward, and bf16 backward at 128 < L <= 288, on the tensor cores
// ---------------------------------------------------------------------------


// Rows 0 .. LP - 1 of one head's (L, HD) slice (row stride rs elements) into dst (row
// stride HD + 8) by the whole block, 16 bytes per cp.async; rows at or past L become zeros
// (cp.async's source size 0).
template <int HD>
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* src, long long rs,
                                                 int LP, int L) {
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x; i < LP * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * 8;
    cp_async16(dst + r * (HD + 8) + c, src + min(r, L - 1) * rs + c, r < L);
  }
}

// s = q.k^T in fp32, unscaled, of a warp's 16 rows r0 .. r0 + 15 (a, row-major in shared
// memory) against the keys c0 .. c0 + 8 * NT (ktile: the rows of key c0 on). Entries of
// keys at or past kend or L, or above the diagonal, are -inf; a tile that has none (most
// tiles) skips the mask arithmetic, which costs as much as the product at hd = 64.
// Returns the number of 8-key tiles computed (even).
template <int KS, int NT>
__device__ __forceinline__ int scores(float (&s)[NT][4], const bf16* a, const bf16* ktile, int ld,
                                      int c0, int kend, int L, int r0, int causal) {
  const int lane = threadIdx.x & 31, t = lane & 3, row_lo = r0 + (lane >> 2);
  const int nt = min(NT, (kend - c0) / 8);
  zero_acc(s);
  gemm_nt<KS, NT>(s, a, ld, ktile, ld, nt);
  const int c1 = c0 + 8 * NT;  // past the tile's last key
  if (c1 > L || c1 > kend || (causal && c1 - 1 > r0)) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = c0 + 8 * j + 2 * t + (c & 1), row = row_lo + 8 * (c >> 1);
        if (!(j < nt && col < L && (!causal || col <= row))) s[j][c] = -INFINITY;
      }
  }
  return nt;
}

// the largest entry of each of a warp's two rows (lane-local: reduce with quad_max)
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], float& mx_lo, float& mx_hi) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
  }
}

// exp2(s * scale2 - m2): the exponential of a logit in base 2 against its row's max m2
// (base 2), 0 for a masked (-inf) entry. One rounding (the fused multiply-add), the same
// expression in every kernel, so that each one rebuilds the same bits from the same s.
__device__ __forceinline__ float exp_logit(float s, float scale2, float m2) {
  return fast_exp2(fmaf(s, scale2, -m2));
}

// bf16 A fragments (k-steps of 16 columns) from fp32 accumulator tiles: tiles 2kk and
// 2kk + 1 of x are k-step kk.
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NT / 2][4], const float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(x[j][0], x[j][1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[j][2], x[j][3]);
  }
}

// e = exp(s * scale - max) of a warp's scores in place (0 where masked), each row's sum
// added; m2_lo, m2_hi: the rows' max logits in base 2
template <int NT>
__device__ __forceinline__ void exponentials(float (&s)[NT][4], float scale2, float m2_lo,
                                             float m2_hi, float& sum_lo, float& sum_hi) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = exp_logit(s[j][c], scale2, c < 2 ? m2_lo : m2_hi);
    sum_lo += s[j][0] + s[j][1];
    sum_hi += s[j][2] + s[j][3];
  }
}

// acc / sum, rows row_lo and row_lo + 8, as bf16 into one head's slice of o
template <int ND>
__device__ __forceinline__ void store_normalised(bf16* o, long long ors, float (&acc)[ND][4],
                                                 float sum_lo, float sum_hi, int row_lo, int L) {
  sum_lo = quad_sum(sum_lo);
  sum_hi = quad_sum(sum_hi);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] /= sum_lo;
    acc[n][1] /= sum_lo;
    acc[n][2] /= sum_hi;
    acc[n][3] /= sum_hi;
  }
  store_acc<ND>(o, RowStride{ors}, acc, row_lo, L, 1.f);
}

// Forward, L <= 128: one block of LP / 16 warps per (head, sample); warp w owns queries
// 16w .. 16w + 15 and holds its whole score row (8 * NT >= LP keys) in registers from
// the max to the exponentials. Q and K land in a first cp.async group, V in a second
// while the block takes q.k^T. K and V are read once per (head, sample).
template <int HD, int NT>
__global__ void __launch_bounds__(2 * FUSED_MAX_L)
short_attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o, int L,
                          long long qbs, long long qrs, long long kbs, long long krs,
                          long long vbs, long long vrs, long long obs, long long ors,
                          float scale, int causal) {
  constexpr int LDT = HD + 8, KS = HD / 16, ND = HD / 8;
  extern __shared__ __align__(128) unsigned char short_smem[];
  const int LP = (L + 15) / 16 * 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * warp, row_lo = r0 + (lane >> 2);
  const int kend = causal ? r0 + 16 : LP;  // the keys the warp's rows see (a multiple of 16)
  bf16* qs = reinterpret_cast<bf16*>(short_smem);  // (LP, LDT)
  bf16* ks = qs + LP * LDT;                        // (LP, LDT)
  bf16* vs = ks + LP * LDT;                        // (LP, LDT)
  stage_rows_async<HD>(qs, q + b * qbs + (long long)h * HD, qrs, LP, L);
  stage_rows_async<HD>(ks, k + b * kbs + (long long)h * HD, krs, LP, L);
  cp_async_commit();
  stage_rows_async<HD>(vs, v + b * vbs + (long long)h * HD, vrs, LP, L);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // the max of each row (a row sees key 0, so it is finite), then e = exp(s - max) in
  // fp32, summed per row; e rounded to bf16 is the A operand of e.v, out = (e.v) / sum
  // (the max of s * scale is the max of s, times scale: scale > 0)
  float s[NT][4];
  const float scale2 = scale * LOG2E;
  const int nt = scores<KS, NT>(s, qs + r0 * LDT, ks, LDT, 0, kend, L, r0, causal);
  float mx_lo = -INFINITY, mx_hi = -INFINITY, sum_lo = 0.f, sum_hi = 0.f;
  row_max<NT>(s, mx_lo, mx_hi);
  exponentials<NT>(s, scale2, quad_max(mx_lo) * scale2, quad_max(mx_hi) * scale2, sum_lo,
                   sum_hi);
  uint32_t e[NT / 2][4];
  pack_a<NT>(e, s);
  float acc[ND][4];
  zero_acc(acc);
  cp_async_wait<0>();
  __syncthreads();  // V is in
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk)
    if (2 * kk < nt) mma_b_rows<ND>(acc, e[kk], vs, LDT, kk);
  store_normalised<ND>(o + b * obs + (long long)h * HD, ors, acc, sum_lo, sum_hi, row_lo, L);
}

// The long bodies (128 < L <= 288) give each (head, sample) one block that holds the operand
// its rows share (K and V for the forward and dq, Q and dO for dk/dv) whole in shared
// memory, read once; its warps loop over the 16-row units of their own rows, each staging
// its unit in an area of its own, with no barrier after the first. LP / 16 units are dealt
// round-robin to at most 6 warps, as many as keep the rounds fewest (L = 257: 17 units,
// 6 warps, 3 rounds).
constexpr int RES_MAX_WARPS = 6;

inline int resident_warps(int L) {
  const int units = (L + 15) / 16;
  const int rounds = (units + RES_MAX_WARPS - 1) / RES_MAX_WARPS;
  return (units + rounds - 1) / rounds;
}

// The warp's 16 rows r0 .. r0 + 15 of one head's (L, HD) slice (row stride rs) into dst
// (row stride HD + 8), 16 bytes per cp.async by the warp's lanes; rows at or past L zeros.
template <int HD>
__device__ __forceinline__ void stage_unit(bf16* dst, const bf16* src, long long rs, int r0,
                                           int L) {
  constexpr int VPR = HD / 8;
  for (int i = threadIdx.x & 31; i < 16 * VPR; i += 32) {
    const int r = r0 + i / VPR, c = (i % VPR) * 8;
    cp_async16(dst + (i / VPR) * (HD + 8) + c, src + min(r, L - 1) * rs + c, r < L);
  }
}

// Wait for this thread's copies; then, on a warp's first unit, for the whole block's
// (the resident operand), else for the warp's lanes.
__device__ __forceinline__ void unit_landed(bool first) {
  cp_async_wait<0>();
  if (first) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// Forward, 128 < L <= 288: K and V resident; per unit, a warp takes q.k^T over 64-key
// chunks twice: first for each row's max, then for the exponentials and e.v (no online
// rescale: the exponentials round to bf16 where the TPU kernel's do).
template <int HD>
__global__ void __launch_bounds__(32 * RES_MAX_WARPS, HD <= 64 ? 2 : 1)
short_attn_fwd_long_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, bf16* __restrict__ o, int L,
                               long long qbs, long long qrs, long long kbs, long long krs,
                               long long vbs, long long vrs, long long obs, long long ors,
                               float scale, int causal) {
  constexpr int LDT = HD + 8, KS = HD / 16, ND = HD / 8, NT = 8, CK = 8 * NT;
  extern __shared__ __align__(128) unsigned char short_smem[];
  const int LP = (L + 15) / 16 * 16, warps = blockDim.x / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* ks = reinterpret_cast<bf16*>(short_smem);  // (LP, LDT)
  bf16* vs = ks + LP * LDT;                        // (LP, LDT)
  bf16* qw = vs + LP * LDT + warp * 16 * LDT;      // (16, LDT): the warp's unit of Q
  const bf16* qh = q + b * qbs + (long long)h * HD;
  stage_rows_async<HD>(ks, k + b * kbs + (long long)h * HD, krs, LP, L);
  stage_rows_async<HD>(vs, v + b * vbs + (long long)h * HD, vrs, LP, L);
  const float scale2 = scale * LOG2E;
  float s[NT][4], acc[ND][4];
  for (int r0 = 16 * warp; r0 < LP; r0 += 16 * warps) {
    stage_unit<HD>(qw, qh, qrs, r0, L);
    cp_async_commit();
    unit_landed(r0 == 16 * warp);
    const int kend = causal ? r0 + 16 : LP;  // the keys the unit's rows see
    // pass 1: each row's max (a row sees key 0, so it is finite)
    float mx_lo = -INFINITY, mx_hi = -INFINITY, sum_lo = 0.f, sum_hi = 0.f;
    for (int c0 = 0; c0 < kend; c0 += CK) {
      scores<KS, NT>(s, qw, ks + c0 * LDT, LDT, c0, kend, L, r0, causal);
      row_max<NT>(s, mx_lo, mx_hi);
    }
    mx_lo = quad_max(mx_lo) * scale2;  // the max logits in base 2
    mx_hi = quad_max(mx_hi) * scale2;
    // pass 2: e = exp(s - max), summed per row; e rounded to bf16 is the A operand of e.v
    zero_acc(acc);
    for (int c0 = 0; c0 < kend; c0 += CK) {
      const int nt = scores<KS, NT>(s, qw, ks + c0 * LDT, LDT, c0, kend, L, r0, causal);
      exponentials<NT>(s, scale2, mx_lo, mx_hi, sum_lo, sum_hi);
      uint32_t e[NT / 2][4];
      pack_a<NT>(e, s);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        if (2 * kk < nt) mma_b_rows<ND>(acc, e[kk], vs + c0 * LDT, LDT, kk);
    }
    store_normalised<ND>(o + b * obs + (long long)h * HD, ors, acc, sum_lo, sum_hi,
                         r0 + (lane >> 2), L);
    __syncwarp();  // every lane is done with the unit before the next one is staged
  }
}

template <int HD, int NT>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, void* o, int B, int L,
                           int H, const long long* st, float scale, int causal,
                           cudaStream_t stream) {
  const int LP = (L + 15) / 16 * 16;
  const size_t smem = (size_t)3 * LP * (HD + 8) * sizeof(bf16);
  auto kern = short_attn_fwd_mma_kernel<HD, NT>;
  const cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B);  // the head fastest: the heads of a sample share its rows in L2
  kern<<<grid, 2 * LP, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), L, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale,
      causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fwd_long_mma(const void* q, const void* k, const void* v, void* o, int B,
                                int L, int H, const long long* st, float scale, int causal,
                                cudaStream_t stream) {
  const int LP = (L + 15) / 16 * 16, warps = resident_warps(L);
  // K and V whole, and each warp's unit of Q
  const size_t smem = (size_t)(2 * LP + 16 * warps) * (HD + 8) * sizeof(bf16);
  auto kern = short_attn_fwd_long_mma_kernel<HD>;
  const cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B);  // the head fastest: the heads of a sample share its rows in L2
  kern<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), L, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale,
      causal);
  return cudaGetLastError();
}

// the row in registers, sized to it (fewer registers, more blocks an SM: L = 77 takes 80
// keys), up to L = 128; past that, streamed tiles
template <int HD>
cudaError_t launch_fwd_mma_l(const void* q, const void* k, const void* v, void* o, int B, int L,
                             int H, const long long* st, float scale, int causal,
                             cudaStream_t stream) {
  if (L <= 64) return launch_fwd_mma<HD, 8>(q, k, v, o, B, L, H, st, scale, causal, stream);
  if (L <= 80) return launch_fwd_mma<HD, 10>(q, k, v, o, B, L, H, st, scale, causal, stream);
  if (L <= 96) return launch_fwd_mma<HD, 12>(q, k, v, o, B, L, H, st, scale, causal, stream);
  if (L <= FUSED_MAX_L)
    return launch_fwd_mma<HD, 16>(q, k, v, o, B, L, H, st, scale, causal, stream);
  return launch_fwd_long_mma<HD>(q, k, v, o, B, L, H, st, scale, causal, stream);
}

// Backward at 128 < L <= 288, kernel 1: dq and the row statistics. K and V resident; per
// unit of queries (with its rows of dO), pass 1 takes S = q.k^T and dP = do.v^T over
// 64-key chunks, each row's max, its sum of exp(s - max) and its sum of dp * exp(s - max),
// the sums rescaled when the running max moves; delta = the second sum over the first.
// The statistics (the max in base 2, 1 / sum, delta) go to the (B, H, 3, L) scratch.
// Pass 2 takes S and dP again, gives ds = p32 * (dp - delta) * scale rounded to bf16 in
// registers, and dq = ds.k.
template <int HD>
__global__ void __launch_bounds__(32 * RES_MAX_WARPS, HD <= 64 ? 2 : 1)
short_attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                             bf16* __restrict__ dq, float* __restrict__ stats, int L,
                             long long qbs, long long qrs, long long kbs, long long krs,
                             long long vbs, long long vrs, long long gbs, long long grs,
                             long long dqbs, long long dqrs, float scale, int causal) {
  constexpr int LDT = HD + 8, KS = HD / 16, ND = HD / 8, NT = 8, CK = 8 * NT;
  extern __shared__ __align__(128) unsigned char short_smem[];
  const int LP = (L + 15) / 16 * 16, warps = blockDim.x / 32;
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  bf16* ks = reinterpret_cast<bf16*>(short_smem);  // (LP, LDT)
  bf16* vs = ks + LP * LDT;                        // (LP, LDT)
  bf16* qw = vs + LP * LDT + warp * 32 * LDT;      // (16, LDT): the warp's unit of Q
  bf16* gw = qw + 16 * LDT;                        // (16, LDT): and of dO
  const bf16* qh = q + b * qbs + (long long)h * HD;
  const bf16* gh = dout + b * gbs + (long long)h * HD;
  float* st = stats + ((long long)b * H + h) * 3 * L;
  stage_rows_async<HD>(ks, k + b * kbs + (long long)h * HD, krs, LP, L);
  stage_rows_async<HD>(vs, v + b * vbs + (long long)h * HD, vrs, LP, L);
  const float scale2 = scale * LOG2E;
  float s[NT][4], dp[NT][4], acc[ND][4];
  for (int r0 = 16 * warp; r0 < LP; r0 += 16 * warps) {
    stage_unit<HD>(qw, qh, qrs, r0, L);
    stage_unit<HD>(gw, gh, grs, r0, L);
    cp_async_commit();
    unit_landed(r0 == 16 * warp);
    const int kend = causal ? r0 + 16 : LP, row_lo = r0 + (lane >> 2), row_hi = row_lo + 8;
    // S (masked) and dP of the keys c0 .. c0 + 64; returns the tiles computed
    const auto chunk = [&](int c0) {
      const int nt = scores<KS, NT>(s, qw, ks + c0 * LDT, LDT, c0, kend, L, r0, causal);
      zero_acc(dp);
      gemm_nt<KS, NT>(dp, gw, LDT, vs + c0 * LDT, LDT, nt);
      return nt;
    };
    // pass 1: lanes keep their shares of the two sums, rescaled by exp(old max - new max)
    // when a chunk raises the max; key 0 lies in the first chunk and every row sees it, so
    // the max is finite from there on
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f, d_lo = 0.f, d_hi = 0.f;
    for (int c0 = 0; c0 < kend; c0 += CK) {
      chunk(c0);
      float cm_lo = -INFINITY, cm_hi = -INFINITY;
      row_max<NT>(s, cm_lo, cm_hi);
      // the running max logits in base 2 (the max of s * scale2 is the max of s, times it)
      const float mn_lo = fmaxf(m_lo, quad_max(cm_lo) * scale2);
      const float mn_hi = fmaxf(m_hi, quad_max(cm_hi) * scale2);
      const float a_lo = fast_exp2(m_lo - mn_lo), a_hi = fast_exp2(m_hi - mn_hi);  // 0 at first
      l_lo *= a_lo;
      d_lo *= a_lo;
      l_hi *= a_hi;
      d_hi *= a_hi;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = exp_logit(s[j][c], scale2, c < 2 ? mn_lo : mn_hi);
          if (c < 2) {
            l_lo += e;
            d_lo = fmaf(dp[j][c], e, d_lo);
          } else {
            l_hi += e;
            d_hi = fmaf(dp[j][c], e, d_hi);
          }
        }
      m_lo = mn_lo;
      m_hi = mn_hi;
    }
    l_lo = quad_sum(l_lo);
    l_hi = quad_sum(l_hi);
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    const float delta_lo = quad_sum(d_lo) / l_lo, delta_hi = quad_sum(d_hi) / l_hi;
    if (t == 0) {  // the statistics, written once per row
      if (row_lo < L) {
        st[row_lo] = m_lo;
        st[L + row_lo] = inv_lo;
        st[2 * L + row_lo] = delta_lo;
      }
      if (row_hi < L) {
        st[row_hi] = m_hi;
        st[L + row_hi] = inv_hi;
        st[2 * L + row_hi] = delta_hi;
      }
    }
    // pass 2: ds in registers, dq = ds.k
    zero_acc(acc);
    for (int c0 = 0; c0 < kend; c0 += CK) {
      const int nt = chunk(c0);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool lo = c < 2;
          const float p = exp_logit(s[j][c], scale2, lo ? m_lo : m_hi) * (lo ? inv_lo : inv_hi);
          dp[j][c] = p * (dp[j][c] - (lo ? delta_lo : delta_hi)) * scale;
        }
      uint32_t ds[NT / 2][4];
      pack_a<NT>(ds, dp);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        if (2 * kk < nt) mma_b_rows<ND>(acc, ds[kk], ks + c0 * LDT, LDT, kk);
    }
    store_acc<ND>(dq + b * dqbs + (long long)h * HD, RowStride{dqrs}, acc, row_lo, L, 1.f);
    __syncwarp();  // every lane is done with the unit before the next one is staged
  }
}

// Backward at 128 < L <= 288, kernel 2: dk and dv. Q and dO resident, with the statistics
// of kernel 1 (the max, 1 / sum and delta of every query); per unit of keys (with their
// values), over the 64-query chunks that see them: S^T = k.q^T and dP^T = v.do^T,
// p32 = exp2(s - max) / sum and ds rebuilt as kernel 1 builds them, p and ds rounded to
// bf16 in registers, then dk += ds^T.q and dv += p^T.do.
template <int HD>
__global__ void __launch_bounds__(32 * RES_MAX_WARPS, HD <= 64 ? 2 : 1)
short_attn_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              const float* __restrict__ stats, int L,
                              long long qbs, long long qrs, long long kbs, long long krs,
                              long long vbs, long long vrs, long long gbs, long long grs,
                              long long dkbs, long long dkrs, long long dvbs, long long dvrs,
                              float scale, int causal) {
  constexpr int LDT = HD + 8, KS = HD / 16, ND = HD / 8, NT = 8, CK = 8 * NT;
  extern __shared__ __align__(128) unsigned char short_smem[];
  const int LP = (L + 15) / 16 * 16, warps = blockDim.x / 32;
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  bf16* qs = reinterpret_cast<bf16*>(short_smem);  // (LP, LDT)
  bf16* gs = qs + LP * LDT;                        // (LP, LDT): dO
  bf16* kw = gs + LP * LDT + warp * 32 * LDT;      // (16, LDT): the warp's unit of K
  bf16* vw = kw + 16 * LDT;                        // (16, LDT): and of V
  float* sm = reinterpret_cast<float*>(gs + LP * LDT + warps * 32 * LDT);  // (3, LP)
  const bf16* kh = k + b * kbs + (long long)h * HD;
  const bf16* vh = v + b * vbs + (long long)h * HD;
  stage_rows_async<HD>(qs, q + b * qbs + (long long)h * HD, qrs, LP, L);
  stage_rows_async<HD>(gs, dout + b * gbs + (long long)h * HD, grs, LP, L);
  const float* st = stats + ((long long)b * H + h) * 3 * L;
  for (int i = threadIdx.x; i < LP; i += blockDim.x) {
    const bool in = i < L;  // queries past L: zero statistics, so p = 0 and ds = 0 unmasked
    sm[i] = in ? st[i] : 0.f;
    sm[LP + i] = in ? st[L + i] : 0.f;
    sm[2 * LP + i] = in ? st[2 * L + i] : 0.f;
  }
  const float scale2 = scale * LOG2E;
  float acc_k[ND][4], acc_v[ND][4];
  for (int kr0 = 16 * warp; kr0 < LP; kr0 += 16 * warps) {
    stage_unit<HD>(kw, kh, krs, kr0, L);
    stage_unit<HD>(vw, vh, vrs, kr0, L);
    cp_async_commit();
    unit_landed(kr0 == 16 * warp);
    const int kj_lo = kr0 + (lane >> 2), kj_hi = kj_lo + 8;
    zero_acc(acc_k);
    zero_acc(acc_v);
    // under the causal mask the queries before kr0 see none of the unit's keys; keys past
    // L are never written, so only the diagonal chunks take the mask arithmetic
    for (int c0 = causal ? kr0 / CK * CK : 0; c0 < LP; c0 += CK) {
      const int nt = min(NT, (LP - c0) / 8);
      float s[NT][4], dp[NT][4];
      zero_acc(s);
      zero_acc(dp);
      gemm_nt<KS, NT>(s, kw, LDT, qs + c0 * LDT, LDT, nt);
      gemm_nt<KS, NT>(dp, vw, LDT, gs + c0 * LDT, LDT, nt);
      const bool diagonal = causal && c0 < kr0 + 16;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = min(c0 + 8 * j + 2 * t + (c & 1), LP - 1);
          float p = exp_logit(s[j][c], scale2, sm[qi]) * sm[LP + qi];
          if (diagonal && (c < 2 ? kj_lo : kj_hi) > qi) p = 0.f;
          dp[j][c] = p * (dp[j][c] - sm[2 * LP + qi]) * scale;
          s[j][c] = p;
        }
      uint32_t pa[NT / 2][4], da[NT / 2][4];
      pack_a<NT>(pa, s);
      pack_a<NT>(da, dp);
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        if (2 * kk < nt) {
          mma_b_rows<ND>(acc_v, pa[kk], gs + c0 * LDT, LDT, kk);  // dv += p^T . do
          mma_b_rows<ND>(acc_k, da[kk], qs + c0 * LDT, LDT, kk);  // dk += ds^T . q
        }
    }
    store_acc<ND>(dk + b * dkbs + (long long)h * HD, RowStride{dkrs}, acc_k, kj_lo, L, 1.f);
    store_acc<ND>(dv + b * dvbs + (long long)h * HD, RowStride{dvrs}, acc_v, kj_lo, L, 1.f);
    __syncwarp();  // every lane is done with the unit before the next one is staged
  }
}

template <int HD>
cudaError_t launch_bwd_long_mma(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, float* stats, int B, int L, int H,
                                const long long* st, float scale, int causal,
                                cudaStream_t stream) {
  const int LP = (L + 15) / 16 * 16, warps = resident_warps(L);
  // two resident operands and each warp's units of two (kernel 2 adds the statistics)
  const size_t smem_dq = (size_t)(2 * LP + 32 * warps) * (HD + 8) * sizeof(bf16);
  const size_t smem_dkv = smem_dq + 3 * LP * sizeof(float);
  auto kern_dq = short_attn_bwd_dq_mma_kernel<HD>;
  auto kern_dkv = short_attn_bwd_dkv_mma_kernel<HD>;
  cudaError_t e = opt_in_smem(kern_dq, smem_dq);
  if (e != cudaSuccess) return e;
  e = opt_in_smem(kern_dkv, smem_dkv);
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B);
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k),
             *vp = static_cast<const bf16*>(v), *gp = static_cast<const bf16*>(dout);
  kern_dq<<<grid, 32 * warps, smem_dq, stream>>>(
      qp, kp, vp, gp, static_cast<bf16*>(dq), stats, L, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kern_dkv<<<grid, 32 * warps, smem_dkv, stream>>>(
      qp, kp, vp, gp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), stats, L, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[10], st[11], st[12], st[13], scale, causal);
  return cudaGetLastError();
}

// Every pointer 16-byte aligned and every stride (elements) a multiple of 8: what the
// mma bodies' 16-byte copies read.
bool aligned16(const void* const* ptrs, int n, const long long* strides) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || strides[2 * i] % 8 || strides[2 * i + 1] % 8)
      return false;
  return true;
}

}  // namespace

// q, k, v, o: fp32 (B, L, H, hd) with the (H, hd) block dense; strides (in
// elements) are [q batch, q row, k batch, k row, v batch, v row, o batch,
// o row].
extern "C" int oct_short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int B, int L, int H, int hd,
                                       const long long* strides, float scale, int causal,
                                       void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || L > 288) return cudaErrorInvalidValue;
  return launch_hd<float>(hd, q, k, v, o, B, L, H, strides, scale, causal,
                          static_cast<cudaStream_t>(stream));
}

// q, k, v, dout (read) and dq, dk, dv (written): fp32 (B, L, H, hd) with the (H, hd)
// block dense; strides (in elements) are [batch, row] of q, k, v, dout, dq, dk,
// dv in that order (14 values). stats: (B, H, 3, L) fp32 scratch, written by the
// first kernel and read by the second.
extern "C" int oct_short_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, int B, int L, int H, int hd,
                                       const long long* strides, float scale, int causal,
                                       void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || L > 288) return cudaErrorInvalidValue;
  return launch_bwd_hd<float>(hd, q, k, v, dout, dq, dk, dv, static_cast<float*>(stats), B, L,
                              H, strides, scale, causal, static_cast<cudaStream_t>(stream));
}

// The bf16 forward on the tensor cores: the same tensors and strides as
// oct_short_attention_fwd. Every pointer 16-byte aligned and every stride (in elements) a
// multiple of 8, or the call is refused.
extern "C" int oct_short_attention_fwd_mma(const void* q, const void* k, const void* v, void* o,
                                           int B, int L, int H, int hd,
                                           const long long* strides, float scale, int causal,
                                           void* stream) {
  if (B < 1 || B > 65535 || H < 1 || L < 1 || L > 288) return cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  if (!aligned16(ptrs, 4, strides)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_fwd_mma_l<32>(q, k, v, o, B, L, H, strides, scale, causal, s);
    case 64: return launch_fwd_mma_l<64>(q, k, v, o, B, L, H, strides, scale, causal, s);
    case 128: return launch_fwd_mma_l<128>(q, k, v, o, B, L, H, strides, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 backward on the tensor cores: the same tensors, strides and scratch as
// oct_short_attention_bwd. L <= 128 takes the fused kernel (the scratch is not touched),
// 128 < L <= 288 the two kernels. Every pointer 16-byte aligned and every stride (in
// elements) a multiple of 8, or the call is refused.
extern "C" int oct_short_attention_bwd_mma(const void* q, const void* k, const void* v,
                                           const void* dout, void* dq, void* dk, void* dv,
                                           void* stats, int B, int L, int H, int hd,
                                           const long long* strides, float scale, int causal,
                                           void* stream) {
  if (B < 1 || B > 65535 || H < 1 || L < 1 || L > 288) return cudaErrorInvalidValue;
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (!aligned16(ptrs, 7, strides)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (L <= FUSED_MAX_L) {
    switch (hd) {
      case 32:
        return launch_bwd_mma_l<32>(q, k, v, dout, dq, dk, dv, B, L, H, strides, scale, causal, s);
      case 64:
        return launch_bwd_mma_l<64>(q, k, v, dout, dq, dk, dv, B, L, H, strides, scale, causal, s);
      case 128:
        return launch_bwd_mma_l<128>(q, k, v, dout, dq, dk, dv, B, L, H, strides, scale, causal, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32:
      return launch_bwd_long_mma<32>(q, k, v, dout, dq, dk, dv, st, B, L, H, strides, scale,
                                     causal, s);
    case 64:
      return launch_bwd_long_mma<64>(q, k, v, dout, dq, dk, dv, st, B, L, H, strides, scale,
                                     causal, s);
    case 128:
      return launch_bwd_long_mma<128>(q, k, v, dout, dq, dk, dv, st, B, L, H, strides, scale,
                                      causal, s);
    default: return cudaErrorInvalidValue;
  }
}
