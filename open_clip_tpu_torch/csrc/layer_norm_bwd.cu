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
// Bound on this card: memory. x and dy are read once and dx written once,
// 3*R*W*size + 12*W bytes, for about 12*R*W operations. To keep 3.35 TB/s busy an
// SM needs some 25 KB of loads in flight, at every width; so the design:
//
// - One persistent launch: a block an SM (the caller's `blocks`) walks over tiles
//   of `rows_per_tile` rows, tile t of the full rounds going to block t % blocks;
//   what the last round leaves is cut into even shares, one a block, so that the
//   blocks' rows differ by one pair at most.
// - Rows go to warps, not blocks. Up to 1024 columns a group of 16 or 32 lanes of
//   one warp owns a row (two rows a warp at 16 lanes) and takes U rows side by
//   side; its four row sums go through shuffles only. Past 1024 columns, and for a
//   launch of fewer rows than the card has consumer warps (where a row's latency
//   sets the time), a warpgroup owns a row, the sums crossing its four warps
//   through shared memory under a named barrier of those 128 threads. No barrier
//   of the whole block stands in the row loop. A row is read from its stage in
//   three passes (the mean; the variance and the two sums of g; dx), so a thread
//   keeps in registers only its columns' dscale and dbias sums.
// - A ring of `stages` tiles in shared memory, filled by one producer thread with
//   one bulk copy (TMA, cp.async.bulk) of x's tile and one of dy's, each
//   completing on the stage's full mbarrier; the 8 consumer warps release a stage
//   on its empty mbarrier once they are done with its rows. A stage holds 32-64 KB
//   of x and dy, so ~100 KB are in flight an SM. dx leaves from the registers as
//   8- or 16-byte stores. scale sits in shared memory beside the ring.
// - A bulk copy moves a multiple of 16 bytes from a 16-byte aligned address. The
//   tiles hold an even number of rows, so every tile starts aligned; where a
//   bf16 row is not a multiple of 16 bytes (W % 8 == 4) and the last tile has an
//   odd count of rows, the producer warp copies its last row by plain loads.
// - dscale and dbias: each lane carries its columns' sums in registers over all
//   its rows; at the end the block's rows are summed through shared memory in a
//   fixed order into one (2, W) partial a block. The last `fold_slices` blocks to
//   arrive (an arrival counter) each sum one slice of the columns over the blocks
//   in block order, once the counter shows every block arrived. No atomic touches a
//   value: the result does not change from run to run, whichever blocks fold.
//   Launches take the two arrival counters in turn (by the parity of a launch
//   count), and each zeroes the one it does not take, for the launch after it.
//
// C interface, loaded with ctypes: oct_layer_norm_bwd returns the cudaError_t of
// the launch (0 on success). It launches on the given stream, does not synchronise
// and allocates nothing. Launches that share the counters must not overlap.

#include "sm90.cuh"

namespace {

constexpr int MAX_STAGES = 4;
constexpr int MAX_FOLD_SLICES = 16;
constexpr int FOLD_SPLIT = 8;            // a fold slice's blocks cut into at most 8 runs
constexpr int SMEM_LIMIT = 232448;       // a block's shared memory on sm_90
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* x;
  const void* dy;
  const float* scale;
  void* dx;
  float* partials;      // (blocks, 2, W) block partials, then the (2, W) result
  unsigned* counters;   // two arrival counters, taken in turn, and the launch count
  long long rows;
  int width, rows_per_tile, stages, fold_slices, stage_bytes;
  float eps;
};

// one bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends 16-byte
// aligned) from device memory to shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// rows of a tile that its bulk copy moves: all, or all but the last where the
// tile's bytes are not a multiple of 16 (bf16, W % 8 == 4, an odd row count)
__device__ __forceinline__ int bulk_rows(int rows, int width, int size) {
  return ((long long)rows * width * size) % 16 ? rows - 1 : rows;
}

// VEC neighbouring elements, converted to or from fp32
template <typename E, int VEC>
struct Io;

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

__device__ __forceinline__ void unpack2(uint32_t u, float& a, float& b) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  a = f.x;
  b = f.y;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <>
struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    unpack2(u.x, v[0], v[1]); unpack2(u.y, v[2], v[3]);
    unpack2(u.z, v[4], v[5]); unpack2(u.w, v[6], v[7]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
};

template <>
struct Io<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    unpack2(u.x, v[0], v[1]); unpack2(u.y, v[2], v[3]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
};

template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + j);
    v[j] = a.x; v[j + 1] = a.y; v[j + 2] = a.z; v[j + 3] = a.w;
  }
}

// rows a group of lanes takes side by side, for the latency of its two reductions:
// 4, 2 or 1, the most whose pass over every consumer warp (x and dy, at most
// lanes * nv * vec columns) stays within UNROLL_BYTES; one where a warpgroup owns the row
constexpr int UNROLL_BYTES = 64 * 1024;
__host__ __device__ constexpr int unroll(int lanes, int nv, int vec, int size) {
  return lanes > 32 ? 1
         : CONSUMER_WARPS * (32 / lanes) * 4 * 2 * lanes * nv * vec * size <= UNROLL_BYTES ? 4
         : CONSUMER_WARPS * (32 / lanes) * 2 * 2 * lanes * nv * vec * size <= UNROLL_BYTES ? 2
                                                                                            : 1;
}

// Sums of K values over the LANES threads that own a row, for each of U rows, the
// same in every thread. A warpgroup (LANES 128, U 1) exchanges its warps' sums in
// red[wg][buf] under its named barrier; the two buffers alternate, so a buffer is
// written again only after every warp has passed the barrier that follows its read.
template <int LANES, int U, int K>
__device__ __forceinline__ void group_sum(float (&v)[U][K], float* red, int& buf) {
  if constexpr (LANES <= 32) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) v[u][k] += __shfl_xor_sync(FULL, v[u][k], o);
  } else {
    static_assert(U == 1 && K <= 4, "a warpgroup holds one row");
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int k = 0; k < K; ++k) v[0][k] += __shfl_xor_sync(FULL, v[0][k], o);
    const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
    float* r = red + (wg * 2 + buf) * 16;
    if (threadIdx.x % 32 == 0)
#pragma unroll
      for (int k = 0; k < K; ++k) r[w * 4 + k] = v[0][k];
    named_barrier(1 + wg, 128);
#pragma unroll
    for (int k = 0; k < K; ++k) v[0][k] = ((r[k] + r[4 + k]) + r[8 + k]) + r[12 + k];
    buf ^= 1;
  }
}

// the sum of v[0 .. N) as a tree
template <int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (N == 1) {
    return v[0];
  } else {
    float h[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) h[j] = v[2 * j] + v[2 * j + 1];
    return tree_sum<N / 2>(h);
  }
}

__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* c, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n" : "=r"(old) : "l"(c), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void atom_add_relaxed(unsigned* c, unsigned v) {
  asm volatile("red.relaxed.gpu.global.add.u32 [%0], %1;\n" ::"l"(c), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* c) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(c) : "memory");
  return v;
}

// wait until *c >= n (the other blocks' releases are seen); trap after ~2**34 cycles
__device__ __forceinline__ void wait_count(const unsigned* c, unsigned n) {
  const long long t0 = clock64();
  while (true) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(c) : "memory");
    if (v >= n) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// The block's tiles. The full rounds go round the blocks a tile each, so that
// neighbouring blocks read neighbouring rows; the rows the last round leaves are cut
// into even shares of row pairs, one more tile a block, so that no block takes a
// whole tile more than another.
struct Tile {
  long long first;
  int count;  // 0 past the block's last tile
};

struct Walk {
  long long rounds, share_first;
  int share_count;

  __device__ __forceinline__ explicit Walk(const Params& p) {
    const long long G = gridDim.x, T = p.rows_per_tile;
    rounds = p.rows / (G * T);
    const long long start = rounds * G * T, pairs = (p.rows - start + 1) / 2;
    share_first = start + 2 * (blockIdx.x * pairs / G);
    const long long end = start + 2 * ((blockIdx.x + 1) * pairs / G);
    share_count = (int)((end < p.rows ? end : p.rows) - share_first);
  }

  __device__ __forceinline__ Tile operator()(const Params& p, int i) const {
    if (i < rounds) return {((long long)i * gridDim.x + blockIdx.x) * p.rows_per_tile, p.rows_per_tile};
    if (i == rounds) return {share_first, share_count};
    return {0, 0};
  }
};

// The producer warp: fills stages for the block's tiles i0 .. i1 - 1, one bulk copy
// of x's rows and one of dy's a tile, waiting for a stage's release from its second
// use on. A last row no bulk copy can move is copied by the warp's lanes before the
// stage's arrival.
template <typename E>
__device__ __forceinline__ void produce(const Params& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int i0, int i1) {
  const int lane = threadIdx.x % 32, W = p.width, T = p.rows_per_tile, S = p.stages;
  const E* x = static_cast<const E*>(p.x);
  const E* dy = static_cast<const E*>(p.dy);
  const Walk tiles(p);
  for (int i = i0; i < i1; ++i) {
    const Tile tl = tiles(p, i);
    if (tl.count <= 0) return;
    const long long r0 = tl.first;
    const int rows = tl.count, s = i % S;
    if (i >= S) mbar_wait(&empty[s], ((i / S) - 1) & 1);
    const int bulk = bulk_rows(rows, W, sizeof(E));
    E* xs = reinterpret_cast<E*>(smem + (size_t)s * p.stage_bytes);
    E* gs = xs + (size_t)T * W;
    if (bulk < rows) {  // 8-byte pieces: a bf16 row of W % 8 == 4 is 8-byte aligned
      constexpr int PIECE = 8 / sizeof(E);
      for (int c = lane * PIECE; c < W; c += 32 * PIECE) {
        const size_t at = (size_t)bulk * W + c;
        *reinterpret_cast<uint2*>(xs + at) = *reinterpret_cast<const uint2*>(x + r0 * W + at);
        *reinterpret_cast<uint2*>(gs + at) = *reinterpret_cast<const uint2*>(dy + r0 * W + at);
      }
      fence_proxy_async();  // before a later bulk copy into the same stage
      __syncwarp();
    }
    if (lane == 0) {
      const uint32_t bytes = (uint32_t)bulk * W * sizeof(E);
      if (bytes) {
        mbar_arrive_expect_tx(&full[s], 2 * bytes);
        bulk_load(xs, x + r0 * W, bytes, &full[s]);
        bulk_load(gs, dy + r0 * W, bytes, &full[s]);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    __syncwarp();
  }
}

// E: element type; VEC: elements a lane moves at once; LANES: threads that own a
// row (16, 32 or 128); NV: VEC-wide chunks of the row a thread owns, chunk i at
// column (i * LANES + lane in group) * VEC. A row is read from its stage three
// times (the mean; the three sums; dx), so that a thread holds only its columns'
// dscale and dbias sums across rows.
template <typename E, int VEC, int LANES, int NV>
__global__ void __launch_bounds__(THREADS, 1) layer_norm_bwd_kernel(const Params p) {
  constexpr int U = unroll(LANES, NV, VEC, sizeof(E));
  constexpr int GPW = LANES <= 32 ? 32 / LANES : 1;   // rows side by side in a warp
  constexpr int RS = CONSUMERS / LANES * U;            // rows the consumers take at once
  constexpr int PARTS = LANES <= 32 ? CONSUMER_WARPS : CONSUMERS / 128;
  using V = Io<E, VEC>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ float red[CONSUMERS / 128 * 2 * 16];  // (warpgroup, buffer, warp, sum)
  __shared__ unsigned ticket;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int W = p.width, T = p.rows_per_tile, S = p.stages;
  E* __restrict__ dx = static_cast<E*>(p.dx);
  // this launch's arrival counter, by the parity of the launch count (which only
  // the launch's last arrival moves on); block 0 zeroes the other one, which the
  // launch before this used, for the launch after it
  unsigned* const arrived = p.counters + (tid == 0 ? ld_relaxed(p.counters + 2) & 1 : 0);
  if (blockIdx.x == 0 && tid == 0) p.counters[(arrived - p.counters) ^ 1] = 0;
  float* scale = reinterpret_cast<float*>(smem + (size_t)S * p.stage_bytes);  // (W,)

  // the producer sets the barriers up and starts the first copies while the
  // consumers bring scale into shared memory
  if (warp == CONSUMER_WARPS) {
    if (lane == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], CONSUMER_WARPS);
      }
      mbar_fence_init();
    }
    __syncwarp();
    produce<E>(p, smem, full, empty, 0, S);
  } else {
    for (int c = tid * 4; c < W; c += CONSUMERS * 4)
      *reinterpret_cast<float4*>(scale + c) = *reinterpret_cast<const float4*>(p.scale + c);
  }
  __syncthreads();

  // each consumer thread's columns and its dscale / dbias sums over its rows
  const int gl = LANES <= 32 ? lane % LANES : tid % 128;
  float ds[NV][VEC], db[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) ds[i][j] = db[i][j] = 0.f;

  if (warp == CONSUMER_WARPS) {
    produce<E>(p, smem, full, empty, S, 1 << 30);
  } else {
    const int base = LANES <= 32 ? warp * U * GPW + lane / LANES : tid / 128;
    const float inv_w = 1.f / (float)W;
    int buf = 0;
    const Walk tiles(p);
    for (int n = 0;; ++n) {  // the block's n-th tile
      const Tile tl = tiles(p, n);
      if (tl.count <= 0) break;
      const long long r0 = tl.first;
      const int rows = tl.count, s = n % S;
      mbar_wait(&full[s], (n / S) & 1);
      const E* xs = reinterpret_cast<const E*>(smem + (size_t)s * p.stage_bytes);
      const E* gs = xs + (size_t)T * W;
      for (int r1 = 0; r1 < rows; r1 += RS) {
        int rr[U];
#pragma unroll
        for (int u = 0; u < U; ++u) rr[u] = r1 + base + u * GPW;
        // the mean; a row past the tile's end sums to 0 and writes nothing
        float m[U][1];
#pragma unroll
        for (int u = 0; u < U; ++u) m[u][0] = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = (i * LANES + gl) * VEC;
          if (c < W)
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (rr[u] < rows) {
                float v[VEC];
                V::load(xs + (size_t)rr[u] * W + c, v);
                m[u][0] += tree_sum<VEC>(v);
              }
        }
        group_sum<LANES, U, 1>(m, red, buf);
        // with xc = x - mu: var = mean(xc^2), mean(g), and mean(g * xhat) = inv * mean(g * xc)
        float a[U][3];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          m[u][0] *= inv_w;
          a[u][0] = a[u][1] = a[u][2] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = (i * LANES + gl) * VEC;
          if (c < W) {
            float sc[VEC];
            load_scale<VEC>(scale + c, sc);
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (rr[u] < rows) {
                float xv[VEC], gv[VEC], q0[VEC], q1[VEC], q2[VEC];
                V::load(xs + (size_t)rr[u] * W + c, xv);
                V::load(gs + (size_t)rr[u] * W + c, gv);
#pragma unroll
                for (int j = 0; j < VEC; ++j) {
                  const float xc = xv[j] - m[u][0], g = gv[j] * sc[j];
                  q0[j] = xc * xc;
                  q1[j] = g;
                  q2[j] = g * xc;
                }
                a[u][0] += tree_sum<VEC>(q0);
                a[u][1] += tree_sum<VEC>(q1);
                a[u][2] += tree_sum<VEC>(q2);
              }
          }
        }
        group_sum<LANES, U, 3>(a, red, buf);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float inv = rsqrtf(a[u][0] * inv_w + p.eps);
          a[u][0] = inv;
          a[u][1] *= inv_w;               // mean(g)
          a[u][2] *= inv_w * inv;         // mean(g * xhat)
        }
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int c = (i * LANES + gl) * VEC;
          if (c < W) {
            float sc[VEC];
            load_scale<VEC>(scale + c, sc);
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (rr[u] < rows) {
                float xv[VEC], gv[VEC], o[VEC];
                V::load(xs + (size_t)rr[u] * W + c, xv);
                V::load(gs + (size_t)rr[u] * W + c, gv);
#pragma unroll
                for (int j = 0; j < VEC; ++j) {
                  const float xhat = (xv[j] - m[u][0]) * a[u][0];
                  o[j] = a[u][0] * (gv[j] * sc[j] - a[u][1] - xhat * a[u][2]);
                  ds[i][j] = fmaf(gv[j], xhat, ds[i][j]);
                  db[i][j] += gv[j];
                }
                V::store(dx + (r0 + rr[u]) * W + c, o);
              }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // the block's partial: the ring is free (every stage was consumed, every copy landed)
  __syncthreads();
  float* cols = reinterpret_cast<float*>(smem);  // (PARTS, 2, W)
  if (warp < CONSUMER_WARPS) {
    if constexpr (LANES < 32) {  // the rows a warp held side by side
#pragma unroll
      for (int o = 16; o >= LANES; o >>= 1)
#pragma unroll
        for (int i = 0; i < NV; ++i)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            ds[i][j] += __shfl_xor_sync(FULL, ds[i][j], o);
            db[i][j] += __shfl_xor_sync(FULL, db[i][j], o);
          }
    }
    const int part = LANES <= 32 ? warp : tid / 128;
    if (LANES > 32 || lane < LANES) {
      float* cp = cols + (size_t)part * 2 * W;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (i * LANES + gl) * VEC;
        if (c < W)
#pragma unroll
          for (int j = 0; j < VEC; j += 4) {
            *reinterpret_cast<float4*>(cp + c + j) =
                make_float4(ds[i][j], ds[i][j + 1], ds[i][j + 2], ds[i][j + 3]);
            *reinterpret_cast<float4*>(cp + W + c + j) =
                make_float4(db[i][j], db[i][j + 1], db[i][j + 2], db[i][j + 3]);
          }
      }
    }
  }
  __syncthreads();
  float* mine = p.partials + (size_t)blockIdx.x * 2 * W;
  for (int j = tid; j < 2 * W; j += THREADS) {
    float acc = cols[j];
#pragma unroll
    for (int q = 1; q < PARTS; ++q) acc += cols[(size_t)q * 2 * W + j];
    mine[j] = acc;
  }
  __syncthreads();
  if (tid == 0) {  // the arrival releases the partial, written by all the block's threads
    ticket = atom_add_acq_rel(arrived, 1u);
    if (ticket == gridDim.x - 1) atom_add_relaxed(p.counters + 2, 1u);  // the launch count
  }
  __syncthreads();
  const int k = (int)ticket - ((int)gridDim.x - p.fold_slices);
  if (k < 0) return;

  // a folder: once every block has arrived, slice k of the 2 * W columns, summed
  // over the blocks in block order
  if (tid == 0) wait_count(arrived, gridDim.x);
  __syncthreads();
  const int n4 = W / 2;  // float4s of a partial
  const int per = (n4 + p.fold_slices - 1) / p.fold_slices;
  const int j0 = k * per, cols4 = (n4 - j0 < per ? n4 - j0 : per);
  if (cols4 > 0) {
    const int G = gridDim.x;
    const int split = THREADS / cols4 < 1 ? 1 : (THREADS / cols4 > FOLD_SPLIT ? FOLD_SPLIT : THREADS / cols4);
    const float4* part4 = reinterpret_cast<const float4*>(p.partials);
    float4* tmp = reinterpret_cast<float4*>(smem);  // (split, cols4)
    for (int e = tid; e < split * cols4; e += THREADS) {
      const int q = e / cols4, j = j0 + e % cols4;
      const int g1 = (int)((long long)(q + 1) * G / split);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int g = (int)((long long)q * G / split); g < g1; ++g) {
        const float4 v = __ldcg(part4 + (size_t)g * n4 + j);  // past L1: other SMs wrote it
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      tmp[e] = acc;
    }
    __syncthreads();
    float4* out4 = reinterpret_cast<float4*>(p.partials + (size_t)G * 2 * W);
    for (int j = tid; j < cols4; j += THREADS) {
      float4 acc = tmp[j];
      for (int q = 1; q < split; ++q) {
        const float4 v = tmp[q * cols4 + j];
        acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      }
      out4[j0 + j] = acc;
    }
  }
}

template <typename E, int VEC, int LANES, int NV>
cudaError_t launch(const Params& p, int blocks, int smem, cudaStream_t stream) {
  auto kernel = layer_norm_bwd_kernel<E, VEC, LANES, NV>;
  static int allowed[64] = {};  // dynamic shared memory already allowed, by device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed[dev] = smem;
  }
  kernel<<<blocks, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

#define OCT_LN_CASE(E, V, L, N) \
  if (vec == V && lanes == L && nv == N) return launch<E, V, L, N>(p, blocks, smem, stream);

template <typename E>
cudaError_t dispatch(const Params& p, int vec, int lanes, int nv, int blocks, int smem,
                     cudaStream_t stream);

template <>
cudaError_t dispatch<float>(const Params& p, int vec, int lanes, int nv, int blocks, int smem,
                            cudaStream_t stream) {
  OCT_LN_CASE(float, 4, 16, 1)
  OCT_LN_CASE(float, 4, 32, 1) OCT_LN_CASE(float, 4, 32, 2) OCT_LN_CASE(float, 4, 32, 3)
  OCT_LN_CASE(float, 4, 32, 4) OCT_LN_CASE(float, 4, 32, 6) OCT_LN_CASE(float, 4, 32, 8)
  OCT_LN_CASE(float, 4, 128, 1) OCT_LN_CASE(float, 4, 128, 2) OCT_LN_CASE(float, 4, 128, 3)
  OCT_LN_CASE(float, 4, 128, 4) OCT_LN_CASE(float, 4, 128, 6) OCT_LN_CASE(float, 4, 128, 8)
  return cudaErrorInvalidValue;
}

template <>
cudaError_t dispatch<__nv_bfloat16>(const Params& p, int vec, int lanes, int nv, int blocks,
                                    int smem, cudaStream_t stream) {
  OCT_LN_CASE(__nv_bfloat16, 8, 16, 1)
  OCT_LN_CASE(__nv_bfloat16, 8, 32, 1) OCT_LN_CASE(__nv_bfloat16, 8, 32, 2)
  OCT_LN_CASE(__nv_bfloat16, 8, 32, 3) OCT_LN_CASE(__nv_bfloat16, 8, 32, 4)
  OCT_LN_CASE(__nv_bfloat16, 8, 128, 1) OCT_LN_CASE(__nv_bfloat16, 8, 128, 2)
  OCT_LN_CASE(__nv_bfloat16, 8, 128, 3) OCT_LN_CASE(__nv_bfloat16, 8, 128, 4)
  OCT_LN_CASE(__nv_bfloat16, 4, 16, 1)
  OCT_LN_CASE(__nv_bfloat16, 4, 32, 1) OCT_LN_CASE(__nv_bfloat16, 4, 32, 2)
  OCT_LN_CASE(__nv_bfloat16, 4, 32, 3) OCT_LN_CASE(__nv_bfloat16, 4, 32, 4)
  OCT_LN_CASE(__nv_bfloat16, 4, 32, 6) OCT_LN_CASE(__nv_bfloat16, 4, 32, 8)
  OCT_LN_CASE(__nv_bfloat16, 4, 128, 1) OCT_LN_CASE(__nv_bfloat16, 4, 128, 2)
  OCT_LN_CASE(__nv_bfloat16, 4, 128, 3) OCT_LN_CASE(__nv_bfloat16, 4, 128, 4)
  OCT_LN_CASE(__nv_bfloat16, 4, 128, 6) OCT_LN_CASE(__nv_bfloat16, 4, 128, 8)
  return cudaErrorInvalidValue;
}

#undef OCT_LN_CASE

}  // namespace

// x, dy, dx: (rows, width) dense, 16-byte aligned, width % 4 == 0, 4 <= width <= 4096.
// scale: (width,) fp32, 16-byte aligned. partials: blocks * 2 * width + 2 * width fp32
// scratch, 16-byte aligned; the result (dscale, then dbias) is its last 2 * width.
// counters: 3 unsigned, zeroed once for all launches on the card (two arrival
// counters taken in turn, then the launch count). dtype: 0 = float32,
// 1 = bfloat16. The launch plan (ops/fused_ln.py launch_plan): vec elements a lane
// moves, lanes owning a row, nv chunks a lane, rows_per_tile (even), stages (2..4),
// blocks (<= row pairs), fold_slices (1..16, <= blocks). device: the card of the tensors
// and the stream, made current for the launch.
extern "C" int oct_layer_norm_bwd(const void* x, const void* dy, const void* scale, void* dx,
                                  void* partials, void* counters, long long rows, int width,
                                  int dtype, int vec, int lanes, int nv, int rows_per_tile,
                                  int stages, int blocks, int fold_slices, int device,
                                  float eps, void* stream) {
  const int size = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || rows < 1 || width < 4 || width % 4 || width > 4096 ||
      rows_per_tile < 2 || rows_per_tile % 2 || stages < 2 || stages > MAX_STAGES ||
      fold_slices < 1 || fold_slices > MAX_FOLD_SLICES || fold_slices > blocks ||
      (width * size) % (vec * size) || (long long)lanes * nv * vec < width)
    return cudaErrorInvalidValue;
  if (blocks < 1 || blocks > (rows + 1) / 2) return cudaErrorInvalidValue;
  const long long tile_bytes = 2LL * rows_per_tile * width * size;
  const int stage_bytes = (int)((tile_bytes + 127) / 128 * 128);
  const int parts = lanes <= 32 ? CONSUMER_WARPS : CONSUMERS / 128;
  long long smem = (long long)stages * stage_bytes + 4LL * width;  // the ring, then scale
  if ((long long)parts * 8 * width > smem) smem = (long long)parts * 8 * width;
  const long long per = (width / 2 + fold_slices - 1) / fold_slices;  // float4s a fold slice
  if (16 * (per > THREADS ? per : THREADS) > smem) smem = 16 * (per > THREADS ? per : THREADS);
  if (smem > SMEM_LIMIT - 1024) return cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dy = dy;
  p.scale = static_cast<const float*>(scale);
  p.dx = dx;
  p.partials = static_cast<float*>(partials);
  p.counters = static_cast<unsigned*>(counters);
  p.rows = rows;
  p.width = width;
  p.rows_per_tile = rows_per_tile;
  p.stages = stages;
  p.fold_slices = fold_slices;
  p.stage_bytes = stage_bytes;
  p.eps = eps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = dtype == 0 ? dispatch<float>(p, vec, lanes, nv, blocks, (int)smem, s)
                 : dispatch<__nv_bfloat16>(p, vec, lanes, nv, blocks, (int)smem, s);
  if (current != device) cudaSetDevice(current);
  return e;
}
