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
// the launcher still opts in when a shape would exceed it.
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
// C interface, loaded with ctypes: oct_short_attention_fwd and
// oct_short_attention_bwd return the cudaError_t of the launch (0 on success).
// They launch on the given stream, do not synchronise and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 16;           // query rows per block
constexpr int KT = 32;           // keys per shared-memory tile: one per lane
constexpr int WARPS = 4;
constexpr int RPW = QT / WARPS;  // query rows per warp
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded to T and back: the probabilities enter the product with v in the
// input dtype, as in the reference.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

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

}  // namespace

// q, k, v, o: (B, L, H, hd) with the (H, hd) block dense; strides (in
// elements) are [q batch, q row, k batch, k row, v batch, v row, o batch,
// o row]. dtype: 0 = float32, 1 = bfloat16.
extern "C" int oct_short_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int B, int L, int H, int hd,
                                       const long long* strides, float scale, int causal,
                                       int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || L > 288) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(hd, q, k, v, o, B, L, H, strides, scale, causal, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, L, H, strides, scale, causal, s);
  return cudaErrorInvalidValue;
}

// q, k, v, dout (read) and dq, dk, dv (written): (B, L, H, hd) with the (H, hd)
// block dense; strides (in elements) are [batch, row] of q, k, v, dout, dq, dk,
// dv in that order (14 values). stats: (B, H, 3, L) fp32 scratch, written by the
// first kernel and read by the second. dtype: 0 = float32, 1 = bfloat16.
extern "C" int oct_short_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, int B, int L, int H, int hd,
                                       const long long* strides, float scale, int causal,
                                       int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || L < 1 || L > 288) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (dtype == 0)
    return launch_bwd_hd<float>(hd, q, k, v, dout, dq, dk, dv, st, B, L, H, strides, scale,
                                causal, s);
  if (dtype == 1)
    return launch_bwd_hd<__nv_bfloat16>(hd, q, k, v, dout, dq, dk, dv, st, B, L, H, strides,
                                        scale, causal, s);
  return cudaErrorInvalidValue;
}
