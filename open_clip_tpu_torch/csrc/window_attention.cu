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
// fp32 terms, so fp32 CUDA cores and memory are both near their limit. The bf16
// forward and backward of windows of at most 64 tokens (PANEL, and PARTITIONED with
// N <= 64) therefore have a second body each on the tensor cores (mma.sync; "the mma
// bodies", further down), under which a window is ~100 bf16 operations per byte and
// the bytes bound it; fp32 and the other shapes run the CUDA-core kernels described
// here. What their design does:
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
// The mma bodies keep the same math and rounding points (p normalised in fp32, then
// p and ds rounded to bf16 before their products, fp32 accumulators, dbias from the
// unrounded fp32 ds) and the same dbias partials and fold, so they are deterministic
// too.
//
// C interface, loaded with ctypes: the functions return the cudaError_t of the
// launches (0 on success). They launch on the given stream, do not synchronise
// and allocate nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bf16 backward on the tensor cores (the "mma" body). One block of 4 warps per
// (head, bias window, group of G windows), the head the fastest grid index, so the
// blocks of one window's heads run together and share its token rows in L2. Per
// window of the group:
//   - q, k, v and do (64 rows of hd) are staged once, with 16-byte cp.async, the next
//     window's while this one computes (two buffers). A window row's address is
//     worked out once per thread and kernel (PANEL: 8 consecutive tokens of the map
//     per window row), not once per element;
//   - warp w owns queries 16w..16w+15: S = q.k^T and dP = do.v^T on the tensor cores
//     (hd padded with zero columns to a multiple of 16 for these two), then softmax,
//     delta and ds in the accumulator registers, and dq = scale * round(ds).k with
//     ds's fragments as the A operand;
//   - p and ds go to shared memory as bf16 tiles; warp w then owns keys
//     16w..16w+15: dk = scale * round(ds)^T.q and dv = round(p)^T.do, the transposes
//     read with ldmatrix.trans. The outputs go in 8-column tiles (hd = 24 is 3 tiles);
//   - the bias tile (times log2 e) and the running dbias sum stay in the S-fragment
//     registers across the group's windows, which share one bias window.
// Takes bf16 windows of N <= 64 tokens (PANEL: ws = 8; PARTITIONED: Swin's 7x7 = 49,
// or HTSAT's 64 when it falls back to partitioned windows), hd % 8 == 0 and hd <= 64,
// 16-byte aligned rows. The tile is padded to MN = 64 rows and keys:
//   - rows past N of q, k, v and do are staged as zeros (cp.async reads nothing for
//     them), so a padded query's dp and delta are 0, its ds is 0, and it adds nothing
//     to dk or dv (its do row is 0); it still sees the N valid keys, so its softmax
//     stays finite;
//   - a padded key gets bias -inf: probability exactly 0, ds exactly 0;
//   - the bias and dbias rows are N floats long: only entries inside N x N are read
//     or written (N = 49 puts a row at an odd float, so scalar loads and stores).
// Shared memory: 2 x 4 staged (64, HDP + 8) tiles and the (64, 72) p and ds tiles,
// 59,392 bytes at hd = 24 or 32 (HDP = 32).
// ---------------------------------------------------------------------------

constexpr int MN = 64;  // the padded window: rows and keys of the tile
constexpr int MMA_THREADS = 128;
constexpr int LDP = MN + 8;  // row stride of the p and ds tiles

template <int HD>
struct MmaTile {
  static constexpr int HDP = (HD + 15) / 16 * 16;  // depth of q.k^T and do.v^T
  static constexpr int LDT = HDP + 8;              // row stride of a staged tile
  static constexpr int ELEMS = MN * LDT;
  static constexpr int VPR = HD / 8;  // 16-byte chunks in a row
  static constexpr int SLOTS = (MN * VPR + MMA_THREADS - 1) / MMA_THREADS;  // chunks a thread
};

template <int HD>
constexpr size_t bwd_mma_smem() {
  return (size_t)(8 * MmaTile<HD>::ELEMS + 2 * MN * LDP) * sizeof(bf16);
}

// First row of window (s, p), in elements from the tensor's base
template <int MODE>
__device__ __forceinline__ long long window_base(const Geom& g, Strides t, int s, int p) {
  if (MODE == PARTITIONED) return (long long)(s * g.P + p) * t.bs;
  const int wy = p / g.nWx, wx = p - wy * g.nWx;
  return (long long)s * t.bs + (long long)(wy * 8 * g.W + wx * 8) * t.rs;
}

// Row r of a window, in rows of the tensor from the window's first row
template <int MODE>
__device__ __forceinline__ int window_row(const Geom& g, int r) {
  return MODE == PANEL ? (r >> 3) * g.W + (r & 7) : r;
}

// offset (elements) of a window's row r from the window's first row
template <int MODE>
struct WindowRows {
  const Geom* g;
  long long rs;
  __device__ __forceinline__ long long operator()(int r) const {
    return (long long)window_row<MODE>(*g, r) * rs;
  }
};

// What the mma kernels share. A block stages head h's rows of the windows that share
// bias window wb; each thread copies the same 16-byte chunks of every staged (MN, LDT)
// tile: row (-1: none), column, and the row's offset from its window's first row in
// rows of the tensor, worked out once per kernel (PANEL: 8 consecutive tokens of the
// map per window row), not once per element.
template <int HD, int MODE>
struct WindowTiles {
  using D = MmaTile<HD>;
  const Geom* g;
  int h, wb;
  int crow[D::SLOTS], ccol[D::SLOTS], ctok[D::SLOTS];

  __device__ __forceinline__ WindowTiles(const Geom* g_, int h_, int wb_) : g(g_), h(h_), wb(wb_) {
#pragma unroll
    for (int m = 0; m < D::SLOTS; ++m) {
      const int i = threadIdx.x + m * MMA_THREADS;
      crow[m] = i < MN * D::VPR ? i / D::VPR : -1;
      ccol[m] = (i % D::VPR) * 8;
      ctok[m] = window_row<MODE>(*g, min(max(crow[m], 0), g->N - 1));
    }
  }

  // window jw of those that share bias window wb: sample s, window p of the sample
  __device__ __forceinline__ void window_of(int jw, int& s, int& p) const {
    s = g->nWb == 1 ? jw / g->P : jw;
    p = g->nWb == 1 ? jw - s * g->P : wb;
  }

  // window jw of the NX tensors src into NX consecutive tiles from dst, by cp.async;
  // rows past N become zeros (nothing is read for them)
  template <int NX>
  __device__ __forceinline__ void stage(bf16* dst, const bf16* const (&src)[NX],
                                        const Strides (&st)[NX], int jw) const {
    int s, p;
    window_of(jw, s, p);
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      const bf16* base = src[x] + window_base<MODE>(*g, st[x], s, p) + h * HD;
#pragma unroll
      for (int m = 0; m < D::SLOTS; ++m)
        if (crow[m] >= 0)
          cp_async16(dst + x * D::ELEMS + crow[m] * D::LDT + ccol[m],
                     base + (long long)ctok[m] * st[x].rs + ccol[m], crow[m] < g->N);
    }
  }
};

// the pad columns [HD, HDP) of n staged tiles: zeros for the whole kernel
template <int HD>
__device__ __forceinline__ void zero_pad_columns(bf16* tiles, int n) {
  using D = MmaTile<HD>;
  if (D::HDP > HD)
    for (int r = threadIdx.x; r < n * MN; r += MMA_THREADS)
      *reinterpret_cast<uint4*>(tiles + r * D::LDT + HD) = make_uint4(0u, 0u, 0u, 0u);
}

// the bias bw (N x N, fp32) of the lane's S-fragment entries, rows row_lo and
// row_lo + 8, in base 2: -inf for a padded key, 0 for a padded query, whose row the
// bias does not have (N = 49 puts a row at an odd float, so scalar loads)
template <int NT>
__device__ __forceinline__ void load_bias2(float (&b2)[NT][4], const float* bw, int N, int row_lo) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = row_lo + 8 * (c >> 1), col = 8 * j + 2 * t + (c & 1);
      b2[j][c] = col >= N ? -INFINITY : (row < N ? bw[row * N + col] * LOG2E : 0.f);
    }
}

template <int HD, int MODE>
__global__ void __launch_bounds__(MMA_THREADS)
win_attn_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        const bf16* __restrict__ dout, bf16* __restrict__ dq,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        float* __restrict__ partials, Geom g, int G, Strides sq, Strides sk,
                        Strides sv, Strides sg, Strides sdq, Strides sdk, Strides sdv) {
  using D = MmaTile<HD>;
  constexpr int KS = D::HDP / 16, ND = HD / 8, NT = MN / 8, LDT = D::LDT;
  extern __shared__ __align__(128) unsigned char win_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(win_smem);  // 2 buffers x (q, k, v, do)
  bf16* ps = tiles + 8 * D::ELEMS;                  // (MN, LDP): p, rounded
  bf16* dss = ps + MN * LDP;                        // (MN, LDP): ds, rounded

  const int h = blockIdx.x, wb = blockIdx.y, grp = blockIdx.z;
  const int count = g.nWb == 1 ? g.S * g.P : g.S;  // windows that share bias window wb
  const int j0 = grp * G, j1 = min(count, j0 + G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = warp * 16, row_lo = r0 + (lane >> 2);
  const float scale2 = g.scale * LOG2E;

  zero_pad_columns<HD>(tiles, 8);
  const WindowTiles<HD, MODE> win(&g, h, wb);
  const bf16* const src[4] = {q, k, v, dout};
  const Strides st[4] = {sq, sk, sv, sg};
  // the bias in base 2 and the running dbias sums, in the S-fragment layout
  float b2[NT][4], db[NT][4];
  load_bias2(b2, bias + ((long long)wb * g.H + h) * g.N * g.N, g.N, row_lo);
  zero_acc(db);

  win.stage(tiles, src, st, j0);
  cp_async_commit();
  for (int jw = j0; jw < j1; ++jw) {
    const int buf = (jw - j0) & 1;
    if (jw + 1 < j1)  // the next window into the other buffer
      win.stage(tiles + (buf ^ 1) * 4 * D::ELEMS, src, st, jw + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this window has landed; the next may still be in flight
    __syncthreads();
    const bf16* qs = tiles + buf * 4 * D::ELEMS;
    const bf16* ks = qs + D::ELEMS;
    const bf16* vs = ks + D::ELEMS;
    const bf16* gs = vs + D::ELEMS;

    float sa[NT][4], dp[NT][4];
    zero_acc(sa);
    zero_acc(dp);
    gemm_nt<KS, NT>(sa, qs + r0 * LDT, LDT, ks, LDT);
    gemm_nt<KS, NT>(dp, gs + r0 * LDT, LDT, vs, LDT);

    // softmax of rows row_lo (entries 0, 1) and row_lo + 8 (entries 2, 3), base 2
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[j][c] = fmaf(sa[j][c], scale2, b2[j][c]);
        mx[c >> 1] = fmaxf(mx[c >> 1], sa[j][c]);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[j][c] = fast_exp2(sa[j][c] - mx[c >> 1]);
        sum[c >> 1] += sa[j][c];
      }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[j][c] *= inv[c >> 1];  // p, fp32
        delta[c >> 1] = fmaf(dp[j][c], sa[j][c], delta[c >> 1]);
      }
    delta[0] = quad_sum(delta[0]);
    delta[1] = quad_sum(delta[1]);

    // ds = p * (dp - delta) into dbias (fp32) and, rounded, into the A fragments of dq;
    // p and ds to shared memory for dk and dv
    uint32_t dsa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float d[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        d[c] = sa[j][c] * (dp[j][c] - delta[c >> 1]);
        db[j][c] += d[c];
      }
      dsa[j / 2][(j % 2) * 2] = pack_bf16(d[0], d[1]);
      dsa[j / 2][(j % 2) * 2 + 1] = pack_bf16(d[2], d[3]);
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(ps + row_lo * LDP + col) = pack_bf16(sa[j][0], sa[j][1]);
      *reinterpret_cast<uint32_t*>(ps + (row_lo + 8) * LDP + col) = pack_bf16(sa[j][2], sa[j][3]);
      *reinterpret_cast<uint32_t*>(dss + row_lo * LDP + col) = dsa[j / 2][(j % 2) * 2];
      *reinterpret_cast<uint32_t*>(dss + (row_lo + 8) * LDP + col) = dsa[j / 2][(j % 2) * 2 + 1];
    }

    int s, p;
    win.window_of(jw, s, p);
    float acc[ND][4];
    zero_acc(acc);
    gemm_nn<NT / 2, ND>(acc, dsa, ks, LDT);  // dq = scale * ds . k
    store_acc<ND>(dq + window_base<MODE>(g, sdq, s, p) + h * HD,
                  WindowRows<MODE>{&g, sdq.rs}, acc, row_lo, g.N, g.scale);
    __syncthreads();  // every warp's rows of p and ds are in

    zero_acc(acc);
    gemm_smem<ND, true>(acc, dss + r0, LDP, qs, LDT, 0, MN / 16);  // dk = scale * ds^T . q
    store_acc<ND>(dk + window_base<MODE>(g, sdk, s, p) + h * HD,
                  WindowRows<MODE>{&g, sdk.rs}, acc, row_lo, g.N, g.scale);
    zero_acc(acc);
    gemm_smem<ND, true>(acc, ps + r0, LDP, gs, LDT, 0, MN / 16);  // dv = p^T . do
    store_acc<ND>(dv + window_base<MODE>(g, sdv, s, p) + h * HD,
                  WindowRows<MODE>{&g, sdv.rs}, acc, row_lo, g.N, 1.f);
    __syncthreads();  // every warp is done with this buffer and with p and ds
  }

  // this group's dbias partial: partials is (nG, nWb, H, N, N)
  float* out = partials + (((long long)grp * g.nWb + wb) * g.H + h) * g.N * g.N;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = row_lo + 8 * (c >> 1), col = 8 * j + 2 * t + (c & 1);
      if (row < g.N && col < g.N) out[row * g.N + col] = db[j][c];
    }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores (the "mma" forward): the backward's grid, staging
// and fragments with one product and the softmax fewer. One block of 4 warps per
// (head, bias window, group of G windows that share the bias window), the head the
// fastest grid index. Per window of the group:
//   - q, k and v (64 rows of hd) are staged with 16-byte cp.async, the next window's
//     while this one computes (two buffers of three tiles; PANEL gathers a window row
//     as 8 consecutive tokens of the map, rows past N are zeros);
//   - warp w owns queries 16w..16w+15: S = q.k^T on the tensor cores (hd padded with
//     zero columns to a multiple of 16), then the softmax in the accumulators (base
//     2, quad reductions) and normalised in fp32, as the TPU kernel does before its
//     rounding: p = e / sum(e), then round(p) to bf16;
//   - the rounded p fragments are the A operand of o = round(p).v (v read with
//     ldmatrix.trans), so p never goes to shared memory; o leaves in 8-column tiles
//     (hd = 24 is 3 tiles) straight to the window's token rows;
//   - the bias tile (times log2 e; -inf for a padded key, 0 for a padded query row)
//     is loaded once into the S-fragment registers and serves the whole group, so a
//     window does not re-read it.
// Takes what the mma backward takes (mma_fits). Every output row is written once, so
// two launches give the same bits. Shared memory: 2 x 3 staged (64, HDP + 8) tiles,
// 30,720 bytes at hd = 24 or 32 (HDP = 32), so several blocks share an SM.
// ---------------------------------------------------------------------------

template <int HD>
constexpr size_t fwd_mma_smem() {
  return (size_t)(6 * MmaTile<HD>::ELEMS) * sizeof(bf16);
}

template <int HD, int MODE>
__global__ void __launch_bounds__(MMA_THREADS)
win_attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const float* __restrict__ bias,
                        bf16* __restrict__ o, Geom g, int G, Strides sq, Strides sk, Strides sv,
                        Strides so) {
  using D = MmaTile<HD>;
  constexpr int KS = D::HDP / 16, ND = HD / 8, NT = MN / 8, LDT = D::LDT;
  extern __shared__ __align__(128) unsigned char win_smem[];
  bf16* tiles = reinterpret_cast<bf16*>(win_smem);  // 2 buffers x (q, k, v)

  const int h = blockIdx.x, wb = blockIdx.y, grp = blockIdx.z;
  const int count = g.nWb == 1 ? g.S * g.P : g.S;  // windows that share bias window wb
  const int j0 = grp * G, j1 = min(count, j0 + G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16, row_lo = r0 + (lane >> 2);
  const float scale2 = g.scale * LOG2E;

  zero_pad_columns<HD>(tiles, 6);
  const WindowTiles<HD, MODE> win(&g, h, wb);
  const bf16* const src[3] = {q, k, v};
  const Strides st[3] = {sq, sk, sv};
  float b2[NT][4];  // the bias in base 2, in the S-fragment layout
  load_bias2(b2, bias + ((long long)wb * g.H + h) * g.N * g.N, g.N, row_lo);

  win.stage(tiles, src, st, j0);
  cp_async_commit();
  for (int jw = j0; jw < j1; ++jw) {
    const int buf = (jw - j0) & 1;
    if (jw + 1 < j1)  // the next window into the other buffer
      win.stage(tiles + (buf ^ 1) * 3 * D::ELEMS, src, st, jw + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this window has landed; the next may still be in flight
    __syncthreads();
    const bf16* qs = tiles + buf * 3 * D::ELEMS;
    const bf16* ks = qs + D::ELEMS;
    const bf16* vs = ks + D::ELEMS;

    float sa[NT][4];
    zero_acc(sa);
    gemm_nt<KS, NT>(sa, qs + r0 * LDT, LDT, ks, LDT);

    // softmax of rows row_lo (entries 0, 1) and row_lo + 8 (entries 2, 3), base 2
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[j][c] = fmaf(sa[j][c], scale2, b2[j][c]);
        mx[c >> 1] = fmaxf(mx[c >> 1], sa[j][c]);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sa[j][c] = fast_exp2(sa[j][c] - mx[c >> 1]);
        sum[c >> 1] += sa[j][c];
      }
    const float inv[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};

    // p = e / sum(e) in fp32, rounded to bf16 into the A fragments of o = p.v
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(sa[j][0] * inv[0], sa[j][1] * inv[0]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sa[j][2] * inv[1], sa[j][3] * inv[1]);
    }
    float acc[ND][4];
    zero_acc(acc);
    gemm_nn<NT / 2, ND>(acc, pa, vs, LDT);
    int s, p;
    win.window_of(jw, s, p);
    store_acc<ND>(o + window_base<MODE>(g, so, s, p) + h * HD, WindowRows<MODE>{&g, so.rs}, acc,
                  row_lo, g.N, 1.f);
    __syncthreads();  // every warp is done with this buffer
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

template <int HD, int MODE>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const float* bias,
                           const void* dout, void* dq, void* dk, void* dv, float* partials,
                           float* dbias, const Geom& g, int G, int nG, const long long* st,
                           cudaStream_t stream) {
  const size_t smem = bwd_mma_smem<HD>();
  auto kern = win_attn_bwd_mma_kernel<HD, MODE>;
  cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  float* part = nG == 1 ? dbias : partials;
  const dim3 grid(g.H, g.nWb, nG);  // the head fastest
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, g, G, Strides{st[0], st[1]}, Strides{st[2], st[3]},
      Strides{st[4], st[5]}, Strides{st[6], st[7]}, Strides{st[8], st[9]},
      Strides{st[10], st[11]}, Strides{st[12], st[13]});
  e = cudaGetLastError();
  if (e != cudaSuccess || nG == 1) return e;
  const long long E = (long long)g.nWb * g.H * g.N * g.N;
  dbias_fold_kernel<<<(unsigned)((E + 255) / 256), 256, 0, stream>>>(partials, dbias, nG, E);
  return cudaGetLastError();
}

template <int HD, int MODE>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const float* bias, void* o,
                           const Geom& g, int G, int nG, const long long* st,
                           cudaStream_t stream) {
  const size_t smem = fwd_mma_smem<HD>();
  auto kern = win_attn_fwd_mma_kernel<HD, MODE>;
  const cudaError_t e = opt_in_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(g.H, g.nWb, nG);  // the head fastest
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<bf16*>(o), g, G, Strides{st[0], st[1]}, Strides{st[2], st[3]},
      Strides{st[4], st[5]}, Strides{st[6], st[7]});
  return cudaGetLastError();
}

// the mma bodies' shapes: bf16 windows of PANEL's 64 tokens or of PARTITIONED's
// N <= 64, hd % 8 == 0 and hd <= 64, every row of the n tensors 16-byte aligned
// (pointers, and strides in elements, multiples of 8)
bool mma_fits(int mode, const Geom& g, const void* const* ptrs, const long long* st, int n) {
  if (mode == PANEL ? g.N != MN : g.N > MN) return false;
  if (g.hd % 8 || g.hd > 64) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 || st[2 * i] % 8 || st[2 * i + 1] % 8)
      return false;
  return true;
}

template <int MODE>
cudaError_t fwd_mma(const void* q, const void* k, const void* v, const float* bias, void* o,
                    const Geom& g, int G, int nG, const long long* st, cudaStream_t s) {
#define OCT_FWD_MMA(HD) \
  case HD: return launch_fwd_mma<HD, MODE>(q, k, v, bias, o, g, G, nG, st, s);
  switch (g.hd) {
    OCT_FWD_MMA(8)
    OCT_FWD_MMA(16)
    OCT_FWD_MMA(24)
    OCT_FWD_MMA(32)
    OCT_FWD_MMA(40)
    OCT_FWD_MMA(48)
    OCT_FWD_MMA(56)
    OCT_FWD_MMA(64)
    default: return cudaErrorInvalidValue;
  }
#undef OCT_FWD_MMA
}

template <int MODE>
cudaError_t bwd_mma(const void* q, const void* k, const void* v, const float* bias,
                    const void* dout, void* dq, void* dk, void* dv, float* partials, float* dbias,
                    const Geom& g, int G, int nG, const long long* st, cudaStream_t s) {
#define OCT_BWD_MMA(HD)                                                                      \
  case HD:                                                                                   \
    return launch_bwd_mma<HD, MODE>(q, k, v, bias, dout, dq, dk, dv, partials, dbias, g, G, \
                                    nG, st, s);
  switch (g.hd) {
    OCT_BWD_MMA(8)
    OCT_BWD_MMA(16)
    OCT_BWD_MMA(24)
    OCT_BWD_MMA(32)
    OCT_BWD_MMA(40)
    OCT_BWD_MMA(48)
    OCT_BWD_MMA(56)
    OCT_BWD_MMA(64)
    default: return cudaErrorInvalidValue;
  }
#undef OCT_BWD_MMA
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

// the group split is a valid one: G windows a group, nG groups a bias window, every
// window that shares one in exactly one group and no group empty
bool groups_fit(const Geom& g, int G, int nG) {
  if (G < 1 || nG < 1 || nG > 65535 || g.nWb > 65535) return false;
  const long long count = g.nWb == 1 ? (long long)g.S * g.P : g.S;
  return (long long)G * nG >= count && (long long)G * (nG - 1) < count;
}

}  // namespace

// q, k, v (read) and o (written): rows of hd*H dense columns; strides (elements)
// [batch, row] of q, k, v, o (8 values): a batch is a window (PARTITIONED) or a
// sample (PANEL). bias: (nWb, H, N, N) fp32, dense. dtype: 0 = float32, 1 = bfloat16.
// body: 0 = the CUDA-core kernel (any shape, fp32 or bf16; G and nG unused), 1 = the
// tensor-core kernel (bf16 only, the shapes of mma_fits; anything else is refused),
// over groups of G windows, nG groups a bias window, as the backward's.
extern "C" int oct_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, void* o, const long long* geom,
                                        const long long* strides, int G, int nG, float scale,
                                        int dtype, int body, void* stream) {
  Geom g;
  int mode;
  if (!make_geom(geom, scale, &g, &mode)) return cudaErrorInvalidValue;
  const int np = padded(g.N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (body == 1) {
    const void* ptrs[4] = {q, k, v, o};
    if (dtype != 1 || !groups_fit(g, G, nG) || !mma_fits(mode, g, ptrs, strides, 4))
      return cudaErrorInvalidValue;
    return mode == PANEL ? fwd_mma<PANEL>(q, k, v, b, o, g, G, nG, strides, s)
                         : fwd_mma<PARTITIONED>(q, k, v, b, o, g, G, nG, strides, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
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
// fp32, written. body: 0 = the CUDA-core kernel (any shape, fp32 or bf16), 1 = the
// tensor-core kernel (bf16 only, the shapes of mma_fits; anything else is refused).
extern "C" int oct_window_attention_bwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* dout, void* dq, void* dk,
                                        void* dv, void* partials, void* dbias,
                                        const long long* geom, const long long* strides,
                                        int G, int nG, float scale, int dtype, int body,
                                        void* stream) {
  Geom g;
  int mode;
  if (!make_geom(geom, scale, &g, &mode) || !groups_fit(g, G, nG)) return cudaErrorInvalidValue;
  const int np = padded(g.N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* pp = static_cast<float*>(partials);
  float* db = static_cast<float*>(dbias);
  if (body == 1) {
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    if (dtype != 1 || !mma_fits(mode, g, ptrs, strides, 7)) return cudaErrorInvalidValue;
    return mode == PANEL
               ? bwd_mma<PANEL>(q, k, v, b, dout, dq, dk, dv, pp, db, g, G, nG, strides, s)
               : bwd_mma<PARTITIONED>(q, k, v, b, dout, dq, dk, dv, pp, db, g, G, nG, strides, s);
  }
  if (body != 0) return cudaErrorInvalidValue;
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
