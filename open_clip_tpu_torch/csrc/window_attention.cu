// Swin window attention for Hopper (sm_90a): forward and backward, for windows
// that are either pre-partitioned or gathered from the token map.
//
// Replaces four TPU kernels, one launch site each:
//   open_clip_tpu/ops/window_attention.py:_fwd_kernel and _bwd_kernel
//     (PARTITIONED: q, k, v are (B*nW, N, C) rows, window i uses bias i % nW);
//   open_clip_tpu/ops/swin_attention.py:_fwd_kernel and _bwd_kernel
//     (PANEL: q, k, v are the (B, H*W, C) token map; window (wy, wx) of a sample is
//     rows (wy*ws + r)*W + wx*ws + c for r, c < ws, and uses bias wy*nWx + wx).
// Both compute, for every window and head h (hd = C / heads columns):
//   s   = scale * q.k^T + bias[w, h]          fp32 (bias: rel-pos table + shift mask)
//   p   = softmax(s) over the window's N keys, fp32;  o = round(p) . v, fp32 sum
//   backward, with p recomputed from q, k and the bias (nothing else is saved):
//   dv  = round(p)^T . do;  dp = do . v^T;  ds = p * (dp - rowsum(dp * p))   fp32
//   dbias[w, h] += ds over every window that shares bias window w        fp32
//   dq  = scale * round(ds) . k;  dk = scale * round(ds)^T . q
// where round() is a rounding to the input dtype, as the TPU kernels do.
//
// Bound on this card: at Swin's shapes (N = 49 or 64, hd = 24 or 32) a window does
// ~4*N^2*hd operations on ~4*N*hd*size bytes, N/2 = 25..32 operations per byte in
// fp32 terms, so fp32 CUDA cores and memory are both near their limit; tensor cores
// (mma.sync/wgmma) are the next step and are not used yet. What the design does:
//   - q, k, v are read in place through a (window, row) -> address map: strided
//     views of the fused qkv projection (row stride 3C) and, in PANEL mode, the
//     token map itself, so neither a partition copy nor a head transpose is made;
//   - one block owns one (window, head) tile whole: N <= 128 queries and keys are
//     padded to NP in {32, 64, 128} in shared memory, padded keys get probability
//     exactly 0 and padded queries are never stored. Each of the (NP/4)^2 threads
//     keeps a 4x4 tile of the logits (and in the backward of dp) in registers,
//     rows ti + a*NP/4 and columns tj + b*NP/4, so a row's softmax is a reduction
//     over the NP/4 lanes of one warp that share ti;
//   - the head's columns are staged 32 at a time, so any hd (up to C = 1024) fits.
// The backward has no atomics. Every output row of dq, dk and dv belongs to one
// window, and one block computes the whole window, so each is written once. dbias
// sums over windows: a block walks a fixed group of G windows that share one bias
// window, keeps the running sum of its ds tile in registers and writes one fp32
// partial; a fold kernel then adds the groups' partials in group order. The result
// does not change from run to run. G is chosen by the caller so that there are
// enough blocks (an unshifted stage has only one bias window).
//
// Shared memory, fp32: forward 2 staged (NP, 33) tiles and the (NP, NP+1)
// probabilities, 33 KB at NP = 64; backward 4 tiles and 2 (NP, NP+1) buffers, 67 KB
// at NP = 64 and 200 KB at NP = 128 (the launcher opts in above 48 KB).
//
// C interface, loaded with ctypes: the functions return the cudaError_t of the
// launches (0 on success). They launch on the given stream, do not synchronise
// and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DC = 32;      // head columns staged at a time
constexpr int TS = DC + 1;  // staged tile row stride (floats): conflict-free columns
constexpr int PARTITIONED = 0;
constexpr int PANEL = 1;

struct Geom {
  int S;     // samples (PANEL) or windows / P (PARTITIONED)
  int P;     // windows per sample
  int N;     // tokens per window
  int H;     // heads
  int hd;    // head width
  int nWb;   // bias windows: 1 (shared) or P
  int ws;    // PANEL: window side
  int W;     // PANEL: token-map width
  int nWx;   // PANEL: windows per map row
  float scale;
};

// batch and row strides (elements) of one tensor
struct Strides {
  long long bs, rs;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// offset (elements) of row r of window (s, p) from the tensor's base
template <int MODE>
__device__ __forceinline__ long long row_offset(const Geom& g, Strides t, int s, int p, int r) {
  if (MODE == PARTITIONED) return (long long)(s * g.P + p) * t.bs + (long long)r * t.rs;
  const int wy = p / g.nWx, wx = p - wy * g.nWx;
  const int ry = r / g.ws, rx = r - ry * g.ws;
  const long long tok = (long long)(wy * g.ws + ry) * g.W + wx * g.ws + rx;
  return (long long)s * t.bs + tok * t.rs;
}

// reductions over the TJ lanes that share a row (TJ divides 32, lanes consecutive)
template <int TJ>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = TJ / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TJ>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = TJ / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Columns [d0, d0 + DC) of head h, rows [0, NP) of window (s, p), into a (NP, TS)
// fp32 tile; rows >= N and columns >= hd become zeros.
template <typename T, int NP, int MODE>
__device__ __forceinline__ void stage(float* dst, const T* src, Strides t, const Geom& g,
                                      int s, int p, int h, int d0) {
  constexpr int THREADS = (NP / 4) * (NP / 4);
  const T* base = src + (long long)h * g.hd + d0;
  for (int i = threadIdx.x; i < NP * DC; i += THREADS) {
    const int r = i / DC, c = i - r * DC;
    float x = 0.f;
    if (r < g.N && d0 + c < g.hd) x = ld(base + row_offset<MODE>(g, t, s, p, r) + c);
    dst[r * TS + c] = x;
  }
}

// The probabilities of the (window, head) tile from the logit accumulators: fp32
// softmax of each valid row, 0 for padded keys and padded rows.
template <int NP>
__device__ __forceinline__ void softmax_tile(float (&s)[4][4], const float* bw, int N,
                                             float scale, int ti, int tj) {
  constexpr int TJ = NP / 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti + a * TJ;
    float m = -INFINITY;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tj + b * TJ;
      const bool ok = i < N && j < N;
      s[a][b] = ok ? s[a][b] * scale + bw[i * N + j] : -INFINITY;
      m = fmaxf(m, s[a][b]);
    }
    m = group_max<TJ>(m);
    float sum = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float e = s[a][b] == -INFINITY ? 0.f : expf(s[a][b] - m);
      s[a][b] = e;
      sum += e;
    }
    sum = group_sum<TJ>(sum);
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = sum > 0.f ? s[a][b] / sum : 0.f;
  }
}

template <typename T, int NP, int MODE>
__global__ void __launch_bounds__((NP / 4) * (NP / 4))
win_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, T* __restrict__ o, Geom g, Strides sq,
                    Strides sk, Strides sv, Strides so) {
  constexpr int TJ = NP / 4;
  constexpr int PS = NP + 1;
  constexpr int CPT = DC / TJ;  // output columns per thread and chunk
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // (NP, TS): a q chunk
  float* kv = qs + NP * TS;                       // (NP, TS): a k chunk, then a v chunk
  float* ps = kv + NP * TS;                       // (NP, PS): probabilities, rounded

  const int win = blockIdx.x, h = blockIdx.y;
  const int s = win / g.P, p = win - (win / g.P) * g.P;
  const int ti = threadIdx.x / TJ, tj = threadIdx.x % TJ;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  for (int d0 = 0; d0 < g.hd; d0 += DC) {
    __syncthreads();
    stage<T, NP, MODE>(qs, q, sq, g, s, p, h, d0);
    stage<T, NP, MODE>(kv, k, sk, g, s, p, h, d0);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < DC; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(ti + a * TJ) * TS + c];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = kv[(tj + b * TJ) * TS + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(qa[a], kb[b], acc[a][b]);
    }
  }
  const int wb = g.nWb == 1 ? 0 : p;
  softmax_tile<NP>(acc, bias + ((long long)wb * g.H + h) * g.N * g.N, g.N, g.scale, ti, tj);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) ps[(ti + a * TJ) * PS + tj + b * TJ] = round_to(acc[a][b], q);

  T* oh = o + (long long)h * g.hd;
  for (int d0 = 0; d0 < g.hd; d0 += DC) {
    __syncthreads();
    stage<T, NP, MODE>(kv, v, sv, g, s, p, h, d0);
    __syncthreads();
    float out[4][CPT];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < CPT; ++c) out[a][c] = 0.f;
    for (int j = 0; j < NP; ++j) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = kv[j * TS + tj + c * TJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float pw = ps[(ti + a * TJ) * PS + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) out[a][c] = fmaf(pw, vv[c], out[a][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti + a * TJ;
      if (i >= g.N) continue;
      T* orow = oh + row_offset<MODE>(g, so, s, p, i) + d0;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tj + c * TJ;
        if (d0 + col < g.hd) st(orow + col, out[a][c]);
      }
    }
  }
}

template <typename T, int NP, int MODE>
__global__ void __launch_bounds__((NP / 4) * (NP / 4))
win_attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const T* __restrict__ dout,
                    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ partials, Geom g, int G, Strides sq, Strides sk,
                    Strides sv, Strides sg, Strides sdq, Strides sdk, Strides sdv) {
  constexpr int TJ = NP / 4;
  constexpr int PS = NP + 1;
  constexpr int CPT = DC / TJ;
  extern __shared__ float4 smem_f4[];
  float* t0 = reinterpret_cast<float*>(smem_f4);  // (NP, TS): q chunk
  float* t1 = t0 + NP * TS;                       // k chunk
  float* t2 = t1 + NP * TS;                       // do chunk
  float* t3 = t2 + NP * TS;                       // v chunk
  float* pb = t3 + NP * TS;                       // (NP, PS): p, rounded
  float* db = pb + NP * PS;                       // (NP, PS): ds, rounded

  const int grp = blockIdx.x, wb = blockIdx.y, h = blockIdx.z;
  const int count = g.nWb == 1 ? g.S * g.P : g.S;  // windows that share bias window wb
  const int j0 = grp * G, j1 = min(count, j0 + G);
  const int ti = threadIdx.x / TJ, tj = threadIdx.x % TJ;
  const float* bw = bias + ((long long)wb * g.H + h) * g.N * g.N;

  float dbacc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dbacc[a][b] = 0.f;

  for (int jw = j0; jw < j1; ++jw) {
    const int s = g.nWb == 1 ? jw / g.P : jw;
    const int p = g.nWb == 1 ? jw - (jw / g.P) * g.P : wb;

    // logits and dp, 4x4 of each per thread
    float sa[4][4], dpa[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sa[a][b] = dpa[a][b] = 0.f;
    for (int d0 = 0; d0 < g.hd; d0 += DC) {
      __syncthreads();
      stage<T, NP, MODE>(t0, q, sq, g, s, p, h, d0);
      stage<T, NP, MODE>(t1, k, sk, g, s, p, h, d0);
      stage<T, NP, MODE>(t2, dout, sg, g, s, p, h, d0);
      stage<T, NP, MODE>(t3, v, sv, g, s, p, h, d0);
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < DC; ++c) {
        float qa[4], ga[4], kb[4], vb[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          qa[a] = t0[(ti + a * TJ) * TS + c];
          ga[a] = t2[(ti + a * TJ) * TS + c];
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          kb[b] = t1[(tj + b * TJ) * TS + c];
          vb[b] = t3[(tj + b * TJ) * TS + c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            sa[a][b] = fmaf(qa[a], kb[b], sa[a][b]);
            dpa[a][b] = fmaf(ga[a], vb[b], dpa[a][b]);
          }
      }
    }
    softmax_tile<NP>(sa, bw, g.N, g.scale, ti, tj);
    // ds = p * (dp - rowsum(dp * p)); p is 0 off the valid tile, so ds is too
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float delta = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) delta = fmaf(dpa[a][b], sa[a][b], delta);
      delta = group_sum<TJ>(delta);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float ds = sa[a][b] * (dpa[a][b] - delta);
        dbacc[a][b] += ds;
        const int idx = (ti + a * TJ) * PS + tj + b * TJ;
        pb[idx] = round_to(sa[a][b], q);
        db[idx] = round_to(ds, q);
      }
    }

    // dq = scale * ds . k, dk = scale * ds^T . q, dv = p^T . do, chunk by chunk
    for (int d0 = 0; d0 < g.hd; d0 += DC) {
      __syncthreads();
      stage<T, NP, MODE>(t0, q, sq, g, s, p, h, d0);
      stage<T, NP, MODE>(t1, k, sk, g, s, p, h, d0);
      stage<T, NP, MODE>(t2, dout, sg, g, s, p, h, d0);
      __syncthreads();
      float aq[4][CPT], ak[4][CPT], av[4][CPT];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < CPT; ++c) aq[a][c] = ak[a][c] = av[a][c] = 0.f;
      for (int j = 0; j < NP; ++j) {
        float kk[CPT], qq[CPT], gg[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = tj + c * TJ;
          kk[c] = t1[j * TS + col];
          qq[c] = t0[j * TS + col];
          gg[c] = t2[j * TS + col];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = ti + a * TJ;
          const float dsij = db[i * PS + j];  // ds[i][j]
          const float dsji = db[j * PS + i];  // ds[j][i]
          const float pji = pb[j * PS + i];   // p[j][i]
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            aq[a][c] = fmaf(dsij, kk[c], aq[a][c]);
            ak[a][c] = fmaf(dsji, qq[c], ak[a][c]);
            av[a][c] = fmaf(pji, gg[c], av[a][c]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ti + a * TJ;
        if (i >= g.N) continue;
        T* rq = dq + (long long)h * g.hd + row_offset<MODE>(g, sdq, s, p, i) + d0;
        T* rk = dk + (long long)h * g.hd + row_offset<MODE>(g, sdk, s, p, i) + d0;
        T* rv = dv + (long long)h * g.hd + row_offset<MODE>(g, sdv, s, p, i) + d0;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = tj + c * TJ;
          if (d0 + col < g.hd) {
            st(rq + col, aq[a][c] * g.scale);
            st(rk + col, ak[a][c] * g.scale);
            st(rv + col, av[a][c]);
          }
        }
      }
    }
  }

  // this group's dbias partial: partials is (nG, nWb, H, N, N)
  float* out = partials + (((long long)grp * g.nWb + wb) * g.H + h) * g.N * g.N;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ti + a * TJ;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = tj + b * TJ;
      if (i < g.N && j < g.N) out[i * g.N + j] = dbacc[a][b];
    }
  }
}

// out[e] = sum over groups, in order, of partials[grp][e]; E = nWb * H * N * N
__global__ void __launch_bounds__(256)
dbias_fold_kernel(const float* __restrict__ partials, float* __restrict__ out, int nG,
                  long long E) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int grp = 0; grp < nG; ++grp) acc += partials[(long long)grp * E + e];
  out[e] = acc;
}

template <typename K>
cudaError_t opt_in_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NP, int MODE>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias, void* o,
                       const Geom& g, const long long* st, cudaStream_t stream) {
  constexpr int THREADS = (NP / 4) * (NP / 4);
  const size_t smem = (size_t)(2 * NP * TS + NP * (NP + 1)) * sizeof(float);
  auto kern = win_attn_fwd_kernel<T, NP, MODE>;
  const cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.S * g.P, g.H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(o), g, Strides{st[0], st[1]}, Strides{st[2], st[3]},
      Strides{st[4], st[5]}, Strides{st[6], st[7]});
  return cudaGetLastError();
}

template <typename T, int NP, int MODE>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* bias,
                       const void* dout, void* dq, void* dk, void* dv, float* partials,
                       float* dbias, const Geom& g, int G, int nG, const long long* st,
                       cudaStream_t stream) {
  constexpr int THREADS = (NP / 4) * (NP / 4);
  const size_t smem = (size_t)(4 * NP * TS + 2 * NP * (NP + 1)) * sizeof(float);
  auto kern = win_attn_bwd_kernel<T, NP, MODE>;
  cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  // with one group the partial is the sum itself
  float* part = nG == 1 ? dbias : partials;
  const dim3 grid(nG, g.nWb, g.H);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), part, g, G, Strides{st[0], st[1]}, Strides{st[2], st[3]},
      Strides{st[4], st[5]}, Strides{st[6], st[7]}, Strides{st[8], st[9]},
      Strides{st[10], st[11]}, Strides{st[12], st[13]});
  e = cudaGetLastError();
  if (e != cudaSuccess || nG == 1) return e;
  const long long E = (long long)g.nWb * g.H * g.N * g.N;
  dbias_fold_kernel<<<(unsigned)((E + 255) / 256), 256, 0, stream>>>(partials, dbias, nG, E);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t fwd_np(int np, const void* q, const void* k, const void* v, const float* bias,
                   void* o, const Geom& g, const long long* st, cudaStream_t s) {
  switch (np) {
    case 32: return launch_fwd<T, 32, MODE>(q, k, v, bias, o, g, st, s);
    case 64: return launch_fwd<T, 64, MODE>(q, k, v, bias, o, g, st, s);
    case 128: return launch_fwd<T, 128, MODE>(q, k, v, bias, o, g, st, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int MODE>
cudaError_t bwd_np(int np, const void* q, const void* k, const void* v, const float* bias,
                   const void* dout, void* dq, void* dk, void* dv, float* partials,
                   float* dbias, const Geom& g, int G, int nG, const long long* st,
                   cudaStream_t s) {
  switch (np) {
    case 32:
      return launch_bwd<T, 32, MODE>(q, k, v, bias, dout, dq, dk, dv, partials, dbias, g, G,
                                     nG, st, s);
    case 64:
      return launch_bwd<T, 64, MODE>(q, k, v, bias, dout, dq, dk, dv, partials, dbias, g, G,
                                     nG, st, s);
    case 128:
      return launch_bwd<T, 128, MODE>(q, k, v, bias, dout, dq, dk, dv, partials, dbias, g, G,
                                      nG, st, s);
    default: return cudaErrorInvalidValue;
  }
}

int padded(int n) { return n <= 32 ? 32 : (n <= 64 ? 64 : (n <= 128 ? 128 : 0)); }

// geom: [mode, S, P, N, H, hd, nWb, ws, W, nWx]
bool make_geom(const long long* gv, float scale, Geom* g, int* mode) {
  *mode = (int)gv[0];
  g->S = (int)gv[1]; g->P = (int)gv[2]; g->N = (int)gv[3]; g->H = (int)gv[4];
  g->hd = (int)gv[5]; g->nWb = (int)gv[6]; g->ws = (int)gv[7]; g->W = (int)gv[8];
  g->nWx = (int)gv[9]; g->scale = scale;
  if (*mode != PARTITIONED && *mode != PANEL) return false;
  if (g->S < 1 || g->P < 1 || g->N < 1 || g->N > 128 || g->H < 1 || g->H > 65535) return false;
  if (g->hd < 1 || g->hd > 1024 || (g->nWb != 1 && g->nWb != g->P)) return false;
  if ((long long)g->S * g->P > 2147483647LL) return false;
  if (*mode == PANEL && (g->ws * g->ws != g->N || g->nWx < 1 || g->P % g->nWx)) return false;
  return true;
}

}  // namespace

// q, k, v (read) and o (written): rows of hd*H dense columns; strides (elements)
// [batch, row] of q, k, v, o (8 values): a batch is a window (PARTITIONED) or a
// sample (PANEL). bias: (nWb, H, N, N) fp32, dense. dtype: 0 = float32, 1 = bfloat16.
extern "C" int oct_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, void* o, const long long* geom,
                                        const long long* strides, float scale, int dtype,
                                        void* stream) {
  Geom g;
  int mode;
  if (!make_geom(geom, scale, &g, &mode)) return cudaErrorInvalidValue;
  const int np = padded(g.N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return mode == PANEL ? fwd_np<float, PANEL>(np, q, k, v, b, o, g, strides, s)
                         : fwd_np<float, PARTITIONED>(np, q, k, v, b, o, g, strides, s);
  if (dtype == 1)
    return mode == PANEL ? fwd_np<__nv_bfloat16, PANEL>(np, q, k, v, b, o, g, strides, s)
                         : fwd_np<__nv_bfloat16, PARTITIONED>(np, q, k, v, b, o, g, strides, s);
  return cudaErrorInvalidValue;
}

// q, k, v, dout (read), dq, dk, dv (written): as the forward's tensors; strides
// [batch, row] of q, k, v, dout, dq, dk, dv (14 values). G: windows per group,
// nG: groups per bias window (nG * G >= the windows that share one). partials:
// (nG, nWb, H, N, N) fp32 scratch (unused when nG == 1); dbias: (nWb, H, N, N)
// fp32, written.
extern "C" int oct_window_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* dout, void* dq, void* dk,
                                        void* dv, void* partials, void* dbias,
                                        const long long* geom, const long long* strides,
                                        int G, int nG, float scale, int dtype, void* stream) {
  Geom g;
  int mode;
  if (!make_geom(geom, scale, &g, &mode) || G < 1 || nG < 1) return cudaErrorInvalidValue;
  const long long count = g.nWb == 1 ? (long long)g.S * g.P : g.S;
  if ((long long)G * nG < count || (long long)G * (nG - 1) >= count) return cudaErrorInvalidValue;
  const int np = padded(g.N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(partials);
  float* db = static_cast<float*>(dbias);
  if (dtype == 0)
    return mode == PANEL
               ? bwd_np<float, PANEL>(np, q, k, v, b, dout, dq, dk, dv, pp, db, g, G, nG, strides, s)
               : bwd_np<float, PARTITIONED>(np, q, k, v, b, dout, dq, dk, dv, pp, db, g, G, nG,
                                            strides, s);
  if (dtype == 1)
    return mode == PANEL ? bwd_np<__nv_bfloat16, PANEL>(np, q, k, v, b, dout, dq, dk, dv, pp, db,
                                                        g, G, nG, strides, s)
                         : bwd_np<__nv_bfloat16, PARTITIONED>(np, q, k, v, b, dout, dq, dk, dv,
                                                              pp, db, g, G, nG, strides, s);
  return cudaErrorInvalidValue;
}
