// Fused LayerNorm backward for Hopper (sm_90a).
//
// Replaces the TPU kernel open_clip_tpu/ops/fused_ln.py:_bwd_kernel (launched by
// _ln_bwd_pallas). From x, dy (R, W) and scale (W,) it gives, with every
// statistic recomputed from x in fp32 (the forward keeps x and scale only):
//   mu = mean(x); inv = rsqrt(mean((x - mu)^2) + eps); xhat = (x - mu) * inv
//   g = dy * scale
//   dx = inv * (g - mean(g) - xhat * mean(g * xhat))          per row, in x's dtype
//   dscale = sum over rows of dy * xhat;  dbias = sum over rows of dy   (fp32)
//
// Bound on this card: memory (x and dy read once, dx written once, 3*R*W*size
// bytes for about 12*R*W operations). What the design does about it: one pass.
// A block takes rows blockIdx.x, blockIdx.x + gridDim.x, ...; its 128 threads
// hold the row's x and dy in registers (4 neighbouring elements a thread per
// 512-column chunk, 8- or 16-byte loads), so each element is read from device
// memory once; the row sums go through warp shuffles and 4 floats of shared
// memory. Each thread owns the same columns in every row, so it carries its
// columns' dscale and dbias sums in registers across the block's rows.
//
// The sums across rows cross blocks, and blocks run in no order. The TPU kernel
// writes one partial per row block and sums them outside; so does this one: the
// block writes its (W,) partials to a (2, G, W) fp32 scratch tensor of the
// caller's, and a second small kernel folds the G partials of each column in a
// fixed order. No atomics: the result does not change from run to run.
//
// C interface, loaded with ctypes: oct_layer_norm_bwd returns the cudaError_t
// of the launch (0 on success). It launches on the given stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = THREADS * 4;  // columns the block covers with one 4-element load a thread
constexpr int FOLD_COLS = 32;       // fold kernel: columns per block
constexpr int FOLD_ROWS = 16;       // fold kernel: partial rows summed side by side

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of x over the block's threads, the same value in every thread. red holds
// WARPS floats; two barriers, so red can be used again right after the call.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += red[w];
  __syncthreads();
  return total;
}

// NV: 512-column chunks a row is cut into, W <= NV * 512.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ scale, T* __restrict__ dx,
                      float* __restrict__ partials, int R, int W, float eps) {
  __shared__ float red[3 * WARPS];
  const int G = gridDim.x;
  const float inv_w = 1.f / (float)W;

  float sc[NV][4], ds[NV][4], db[NV][4];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * CHUNK + threadIdx.x * 4;
    const float4 s4 = c < W ? load4(scale + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    sc[i][0] = s4.x; sc[i][1] = s4.y; sc[i][2] = s4.z; sc[i][3] = s4.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) ds[i][j] = db[i][j] = 0.f;
  }

  for (int row = blockIdx.x; row < R; row += G) {
    const T* xr = x + (long long)row * W;
    const T* gr = dy + (long long)row * W;
    float xv[NV][4], gv[NV][4];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * CHUNK + threadIdx.x * 4;
      const bool in = c < W;
      const float4 a = in ? load4(xr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 g = in ? load4(gr + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      xv[i][0] = a.x; xv[i][1] = a.y; xv[i][2] = a.z; xv[i][3] = a.w;
      gv[i][0] = g.x; gv[i][1] = g.y; gv[i][2] = g.z; gv[i][3] = g.w;
      sum += (a.x + a.y) + (a.z + a.w);
    }
    const float mu = block_sum(sum, red) * inv_w;

    // with xc = x - mu: var = mean(xc^2), mean(g), and mean(g * xhat) = inv * mean(g * xc)
    float sq = 0.f, sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const bool in = i * CHUNK + threadIdx.x * 4 < W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xc = in ? xv[i][j] - mu : 0.f;
        const float g = gv[i][j] * sc[i][j];
        xv[i][j] = xc;
        sq = fmaf(xc, xc, sq);
        sg += g;
        sgx = fmaf(g, xc, sgx);
      }
    }
    // three sums through one pair of barriers
    sq = warp_sum(sq);
    sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    if (threadIdx.x % 32 == 0) {
      const int w = threadIdx.x / 32;
      red[w] = sq;
      red[WARPS + w] = sg;
      red[2 * WARPS + w] = sgx;
    }
    __syncthreads();
    sq = sg = sgx = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      sq += red[w];
      sg += red[WARPS + w];
      sgx += red[2 * WARPS + w];
    }
    __syncthreads();
    const float inv = rsqrtf(sq * inv_w + eps);
    const float mg = sg * inv_w;
    const float mgx = sgx * inv_w * inv;

    T* dr = dx + (long long)row * W;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = i * CHUNK + threadIdx.x * 4;
      if (c < W) {
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float xhat = xv[i][j] * inv;
          const float g = gv[i][j] * sc[i][j];
          o[j] = inv * (g - mg - xhat * mgx);
          ds[i][j] = fmaf(gv[i][j], xhat, ds[i][j]);
          db[i][j] += gv[i][j];
        }
        store4(dr + c, make_float4(o[0], o[1], o[2], o[3]));
      }
    }
  }

  // this block's partial sums: partials is (2, G, W), dscale first
  float* ps = partials + (long long)blockIdx.x * W;
  float* pb = ps + (long long)G * W;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = i * CHUNK + threadIdx.x * 4;
    if (c < W) {
      store4(ps + c, make_float4(ds[i][0], ds[i][1], ds[i][2], ds[i][3]));
      store4(pb + c, make_float4(db[i][0], db[i][1], db[i][2], db[i][3]));
    }
  }
}

// out[z][c] = sum over g of partials[z][g][c]; grid (ceil(W / 32), 2), block (32, 16).
// Thread (tx, ty) sums rows ty, ty + 16, ... of its column, then the 16 sums are
// added in order.
__global__ void __launch_bounds__(FOLD_COLS * FOLD_ROWS)
layer_norm_bwd_fold_kernel(const float* __restrict__ partials, float* __restrict__ out,
                           int G, int W) {
  __shared__ float red[FOLD_ROWS][FOLD_COLS + 1];
  const int c = blockIdx.x * FOLD_COLS + threadIdx.x;
  const float* p = partials + (long long)blockIdx.y * G * W;
  float acc = 0.f;
  if (c < W)
    for (int g = threadIdx.y; g < G; g += FOLD_ROWS) acc += p[(long long)g * W + c];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < W) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < FOLD_ROWS; ++r) total += red[r][threadIdx.x];
    out[(long long)blockIdx.y * W + c] = total;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, const float* scale, void* dx, float* partials,
                   float* out, int R, int W, int G, float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
  const int nv = (W + CHUNK - 1) / CHUNK;
  if (nv <= 1)
    layer_norm_bwd_kernel<T, 1><<<G, THREADS, 0, stream>>>(xp, gp, scale, dp, partials, R, W, eps);
  else if (nv <= 2)
    layer_norm_bwd_kernel<T, 2><<<G, THREADS, 0, stream>>>(xp, gp, scale, dp, partials, R, W, eps);
  else if (nv <= 4)
    layer_norm_bwd_kernel<T, 4><<<G, THREADS, 0, stream>>>(xp, gp, scale, dp, partials, R, W, eps);
  else
    layer_norm_bwd_kernel<T, 8><<<G, THREADS, 0, stream>>>(xp, gp, scale, dp, partials, R, W, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((W + FOLD_COLS - 1) / FOLD_COLS, 2);
  layer_norm_bwd_fold_kernel<<<grid, dim3(FOLD_COLS, FOLD_ROWS), 0, stream>>>(partials, out, G, W);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (R, W) dense, 16-byte aligned, W % 4 == 0 and W <= 4096. scale: (W,)
// fp32. partials: (2, G, W) fp32 scratch with 1 <= G <= R, G the number of blocks.
// out: (2, W) fp32, dscale then dbias. dtype (of x, dy, dx): 0 = float32, 1 = bfloat16.
extern "C" int oct_layer_norm_bwd(const void* x, const void* dy, const void* scale, void* dx,
                                  void* partials, void* out, int R, int W, int G, float eps,
                                  int dtype, void* stream) {
  if (R < 1 || W < 4 || W % 4 || W > 8 * CHUNK || G < 1 || G > R) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  float* pp = static_cast<float*>(partials);
  float* op = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(x, dy, sc, dx, pp, op, R, W, G, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, dy, sc, dx, pp, op, R, W, G, eps, s);
  return cudaErrorInvalidValue;
}
