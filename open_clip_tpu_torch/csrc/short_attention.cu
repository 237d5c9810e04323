// Short-sequence self-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel open_clip_tpu/ops/short_attention.py:_fwd_kernel_v2
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
// C interface, loaded with ctypes: oct_short_attention_fwd returns the
// cudaError_t of the launch (0 on success). It launches on the given stream,
// does not synchronise and allocates nothing.

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
