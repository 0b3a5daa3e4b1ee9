// Codebook nearest-neighbour search (distance argmin) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel in esc_tpu/ops/pallas/vq_kernels.py
// (_argmin_kernel, launched by _pallas_argmin behind codebook_argmin).
// For every query row z_n of z (N, d) and codebook C (K, d):
//
//     code[n] = argmin_k ( (|z_n|^2 - 2 z_n . c_k) + |c_k|^2 )
//
// in fp32, the first index winning exact ties, and code 0 for a row whose
// distances hold a NaN (the TPU kernel's two-pass min finds no d <= min
// there, vq_kernels.py:45-53). |z|^2, z.c and |c|^2 are sequential fmaf
// over c = 0..d-1. The TPU kernel's 256-row tiles and the padding of d to
// 128 lanes are TPU layout only and are not carried over.
//
// What bounds it on an H100: at the codec's shapes (K = 1024, d = 6..32,
// N = a few hundred to a few thousand rows per call) the work is 2 N K d
// flops (10-80 MFLOP) and the bytes are (N d + K d + N) * 4 (0.1 MB): both
// bounds are well under a microsecond, so what a call costs is its launch,
// the copy of the codebook into each block's shared memory, and how many
// SMs take part.
//
// Design:
// - The grid fills the card in one wave at the codec's shapes: a block
//   takes R consecutive query rows (the launch plan's rows per block, about
//   N / 132 and at most 64 / d), so N = 600 runs as 120 blocks of 5 rows.
// - Each block copies the (K, d) codebook, as it lies in global memory,
//   into shared memory with one bulk asynchronous copy (cp.async.bulk)
//   completing on an mbarrier; bytes past the last multiple of 16, or all
//   of them when the codebook is not 16-byte aligned, are copied with plain
//   loads by the block's threads. The block loads its R query rows into
//   registers and computes |z|^2 while the copy is in flight.
// - Thread t scans the codewords k = t, t + T, ...: it reads codeword k
//   from shared memory once, with 16-byte (or 8-byte) loads, computes
//   |c_k|^2 and the distance to all R rows from registers, so every
//   shared-memory read feeds R FMAs. Lanes of a warp read consecutive
//   codewords; each lane starts the row's 16-byte chunks at a rotation that
//   puts the lanes of one shared-memory phase on distinct banks for every
//   d of the codec. A thread keeps its first minimum per row; two hardware
//   warp reductions (__reduce_min_sync: the least distance, as an ordered
//   key, then the least index holding it) per warp and a pass over the
//   warps (one warp per row) keep the lexicographically least (distance,
//   index) pair, so exact ties go to the first index.
// - fp32 FMA on the CUDA cores: no tensor cores and no TF32, which would
//   move codes. d is a template parameter for 6, 8, 12, 16, 24 and 32;
//   other widths take a generic instance that reads the rows from shared
//   memory.
// - A codebook too large for shared memory (K 1024 x d >= 57) goes to a
//   kernel of its own, codebook_argmin_tiled_kernel, which streams it
//   through shared memory in K-tiles of the launch plan's k_tile
//   codewords, one tile at a time in one buffer: the block scans a tile,
//   waits at a barrier, and the next tile replaces it. A thread visits its
//   codewords in increasing index across tiles and keeps its running
//   (distance, index) minimum in registers, so the result is the untiled
//   scan's: the same fmaf order, the first index on ties, NaN -> 0. It has
//   one instance for every d, the query rows in shared memory, each
//   codeword value read once for all of the block's rows. These sizes are
//   off the codec's path: the design is simple and right first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxRows = 8;  // rows per block
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Rows per block a width allows: R * d query values live in registers.
__host__ __device__ constexpr int max_rows(int d) {
  return d <= 0 ? kMaxRows : (64 / d < 1 ? 1 : (64 / d > kMaxRows ? kMaxRows
                                                                   : 64 / d));
}

// Shared memory of one block: the codebook (or one tile of k_tile of its
// codewords), the query rows (generic and tiled kernels), the per-warp
// partial minima and the mbarrier.
size_t smem_bytes(int k_tile, int d, int rows) {
  const size_t cb = ((size_t)k_tile * d * sizeof(float) + 15) / 16 * 16;
  const size_t zs = ((size_t)rows * d * sizeof(float) + 15) / 16 * 16;
  const size_t red = (size_t)kMaxWarps * kMaxRows * 16;
  return cb + zs + red + sizeof(uint64_t);
}

struct Best {
  float dist;
  int idx;  // k = no candidate yet
  int nan;
};

// A distance as an unsigned key in the same order (no distance is -0: a
// sum (x + |c|^2) with |c|^2 >= +0 is not). "No candidate" is the largest.
__device__ __forceinline__ uint32_t order_key(const Best& b, int k) {
  if (b.idx == k) return 0xffffffffu;
  const uint32_t u = __float_as_uint(b.dist);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's lexicographically least (key, index) pair, by two hardware
// reductions: the least key, then the least index among the lanes that
// hold it. Returns the index (k for none); `nan` becomes the warp's OR.
__device__ __forceinline__ int warp_min(uint32_t& key, int idx, int& nan,
                                        int k) {
  const uint32_t least = __reduce_min_sync(0xffffffffu, key);
  const int first = (int)__reduce_min_sync(
      0xffffffffu, key == least ? (uint32_t)idx : (uint32_t)k);
  key = least;
  nan = __any_sync(0xffffffffu, nan);
  return first;
}

// Codeword k's d values from shared memory into registers. With V-float
// vector loads, a shared-memory phase serves 32 / V lanes; lane L starts at
// chunk (L mod P) / (P / g), g the power of two shared by the row's chunk
// count and P, which puts the phase's lanes on distinct banks.
template <int D>
__device__ __forceinline__ void load_codeword(const float* cb, int k, int lane,
                                              float (&c)[D]) {
  constexpr int V = D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1);
  constexpr int chunks = D / V;
  constexpr int P = 32 / V;
  constexpr int g = (chunks & -chunks) < P ? (chunks & -chunks) : P;
  const int rot = (lane % P) / (P / g);
  const float* row = cb + (size_t)k * D;
#pragma unroll
  for (int p = 0; p < chunks; ++p) {
    int q = p + rot;
    if (q >= chunks) q -= chunks;
    if constexpr (V == 4) {
      const float4 v = reinterpret_cast<const float4*>(row)[q];
#pragma unroll
      for (int u = 0; u < chunks; ++u)
        if (u == q) {
          c[4 * u] = v.x;
          c[4 * u + 1] = v.y;
          c[4 * u + 2] = v.z;
          c[4 * u + 3] = v.w;
        }
    } else if constexpr (V == 2) {
      const float2 v = reinterpret_cast<const float2*>(row)[q];
#pragma unroll
      for (int u = 0; u < chunks; ++u)
        if (u == q) {
          c[2 * u] = v.x;
          c[2 * u + 1] = v.y;
        }
    } else {
      c[p] = row[p];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
codebook_argmin_kernel(const float* __restrict__ z,
                       const float* __restrict__ cb_g,
                       int32_t* __restrict__ out, int n, int k, int d_rt,
                       int rows_per_block) {
  constexpr int R = max_rows(D);
  const int d = D > 0 ? D : d_rt;
  extern __shared__ __align__(128) unsigned char smem[];
  float* cb = reinterpret_cast<float*>(smem);
  const size_t cb_bytes = ((size_t)k * d * sizeof(float) + 15) / 16 * 16;
  float* zs = reinterpret_cast<float*>(smem + cb_bytes);
  const size_t zs_bytes =
      ((size_t)rows_per_block * d * sizeof(float) + 15) / 16 * 16;
  uint32_t* red_k = reinterpret_cast<uint32_t*>(smem + cb_bytes + zs_bytes);
  int* red_i = reinterpret_cast<int*>(red_k + kMaxWarps * kMaxRows);
  int* red_n = red_i + kMaxWarps * kMaxRows;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + cb_bytes + zs_bytes + (size_t)kMaxWarps * kMaxRows * 16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);

  // the codebook: a bulk copy of its 16-byte-aligned whole, plain loads
  // for the rest
  const size_t total = (size_t)k * d;
  const bool aligned = reinterpret_cast<uintptr_t>(cb_g) % 16 == 0;
  const size_t bulk = aligned ? (total * sizeof(float)) / 16 * 16 : 0;
  if (tid == 0 && bulk) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"((uint32_t)bulk)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(cb)),
        "l"(cb_g), "r"((uint32_t)bulk), "r"(smem_u32(bar))
        : "memory");
  }
  for (size_t e = bulk / sizeof(float) + tid; e < total; e += blockDim.x)
    cb[e] = cb_g[e];

  // the block's query rows and their |z|^2, while the copy is in flight
  float zr[D > 0 ? R * D : 1];
  float zsq[R];
  if constexpr (D > 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        zr[r * D + c] = r < rows ? __ldg(z + (size_t)(row0 + r) * D + c) : 0.f;
        s = fmaf(zr[r * D + c], zr[r * D + c], s);
      }
      zsq[r] = s;
    }
  } else {
    for (int e = tid; e < rows * d; e += blockDim.x)
      zs[e] = z[(size_t)row0 * d + e];
  }
  __syncthreads();  // plain-loaded codebook tail and query rows
  if constexpr (D <= 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
      if (r < rows)
        for (int c = 0; c < d; ++c) s = fmaf(zs[r * d + c], zs[r * d + c], s);
      zsq[r] = s;
    }
  }
  if (bulk) {
    uint32_t done = 0;
    const long long t0 = clock64();
    while (!done) {
      if (clock64() - t0 > 20000000000LL) __trap();  // a copy never landed
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(smem_u32(bar))
          : "memory");
    }
  }

  Best best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) best[r] = Best{INFINITY, k, 0};

  for (int j = tid; j < k; j += blockDim.x) {
    if constexpr (D > 0) {
      float c[D];
      load_codeword<D>(cb, j, lane, c);
      float csq = 0.f;
#pragma unroll
      for (int u = 0; u < D; ++u) csq = fmaf(c[u], c[u], csq);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < D; ++u) dot = fmaf(zr[r * D + u], c[u], dot);
        const float dist = (zsq[r] - 2.f * dot) + csq;
        if (isnan(dist)) {
          best[r].nan = 1;
        } else if (best[r].idx == k || dist < best[r].dist) {
          best[r].dist = dist;
          best[r].idx = j;
        }
      }
    } else {
      const float* c = cb + (size_t)j * d;
      float csq = 0.f;
      for (int u = 0; u < d; ++u) csq = fmaf(c[u], c[u], csq);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) {
          float dot = 0.f;
          for (int u = 0; u < d; ++u) dot = fmaf(zs[r * d + u], c[u], dot);
          const float dist = (zsq[r] - 2.f * dot) + csq;
          if (isnan(dist)) {
            best[r].nan = 1;
          } else if (best[r].idx == k || dist < best[r].dist) {
            best[r].dist = dist;
            best[r].idx = j;
          }
        }
      }
    }
  }

  // warp minima, then the minimum over the block's warps
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t key = order_key(best[r], k);
    int nan = best[r].nan;
    const int idx = warp_min(key, best[r].idx, nan, k);
    if (lane == 0) {
      red_k[warp * kMaxRows + r] = key;
      red_i[warp * kMaxRows + r] = idx;
      red_n[warp * kMaxRows + r] = nan;
    }
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {  // warp r takes row r
    const bool on = lane < nwarps;
    uint32_t key = on ? red_k[lane * kMaxRows + r] : 0xffffffffu;
    int nan = on ? red_n[lane * kMaxRows + r] : 0;
    const int idx = warp_min(key, on ? red_i[lane * kMaxRows + r] : k, nan, k);
    if (lane == 0) out[row0 + r] = (nan || idx == k) ? 0 : idx;
  }
}

// Wait until the bulk copies armed on `bar` for phase `parity` have landed.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > 20000000000LL) __trap();  // a copy never landed
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// The codebook in K-tiles (see the design notes at the top).
__global__ void __launch_bounds__(kMaxThreads)
codebook_argmin_tiled_kernel(const float* __restrict__ z,
                             const float* __restrict__ cb_g,
                             int32_t* __restrict__ out, int n, int k, int d,
                             int rows_per_block, int k_tile) {
  constexpr int R = kMaxRows;
  extern __shared__ __align__(128) unsigned char smem[];
  float* cb = reinterpret_cast<float*>(smem);
  const size_t cb_bytes =
      ((size_t)k_tile * d * sizeof(float) + 15) / 16 * 16;
  float* zs = reinterpret_cast<float*>(smem + cb_bytes);
  const size_t zs_bytes =
      ((size_t)rows_per_block * d * sizeof(float) + 15) / 16 * 16;
  uint32_t* red_k = reinterpret_cast<uint32_t*>(smem + cb_bytes + zs_bytes);
  int* red_i = reinterpret_cast<int*>(red_k + kMaxWarps * kMaxRows);
  int* red_n = red_i + kMaxWarps * kMaxRows;
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + cb_bytes + zs_bytes + (size_t)kMaxWarps * kMaxRows * 16);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, n - row0);
  const bool aligned = reinterpret_cast<uintptr_t>(cb_g) % 16 == 0;
  if (tid == 0 && aligned) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < rows * d; e += blockDim.x)
    zs[e] = z[(size_t)row0 * d + e];
  __syncthreads();  // the query rows and the mbarrier
  float zsq[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = 0.f;
    if (r < rows)
      for (int c = 0; c < d; ++c) s = fmaf(zs[r * d + c], zs[r * d + c], s);
    zsq[r] = s;
  }

  Best best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) best[r] = Best{INFINITY, k, 0};

  uint32_t phase = 0;
  for (int t0 = 0; t0 < k; t0 += k_tile) {
    // codewords t0 .. t0 + nk - 1: a bulk copy of their 16-byte-aligned
    // whole (tiles start on 16 bytes: k_tile * d is a multiple of 4),
    // plain loads for the rest
    const int nk = min(k_tile, k - t0);
    const size_t total = (size_t)nk * d;
    const float* src = cb_g + (size_t)t0 * d;
    const size_t bulk = aligned ? (total * sizeof(float)) / 16 * 16 : 0;
    if (t0 > 0) {
      // every thread has read the last tile (from both proxies' side)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    if (tid == 0 && bulk) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_u32(bar)),
          "r"((uint32_t)bulk)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(cb)),
          "l"(src), "r"((uint32_t)bulk), "r"(smem_u32(bar))
          : "memory");
    }
    for (size_t e = bulk / sizeof(float) + tid; e < total; e += blockDim.x)
      cb[e] = src[e];
    __syncthreads();  // the plain-loaded tail
    if (bulk) wait_parity(bar, phase++ & 1);  // tiles under 16 B arm none

    for (int jl = tid; jl < nk; jl += blockDim.x) {
      // each codeword value is read once for all rows; every row's sum
      // still runs over u = 0 .. d-1 in order
      const float* c = cb + (size_t)jl * d;
      float csq = 0.f, dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.f;
      for (int u = 0; u < d; ++u) {
        const float cu = c[u];
        csq = fmaf(cu, cu, csq);
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (r < rows) dot[r] = fmaf(zs[r * d + u], cu, dot[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) continue;
        const float dist = (zsq[r] - 2.f * dot[r]) + csq;
        if (isnan(dist)) {
          best[r].nan = 1;
        } else if (best[r].idx == k || dist < best[r].dist) {
          best[r].dist = dist;
          best[r].idx = t0 + jl;
        }
      }
    }
  }

  // warp minima, then the minimum over the block's warps
#pragma unroll
  for (int r = 0; r < R; ++r) {
    uint32_t key = order_key(best[r], k);
    int nan = best[r].nan;
    const int idx = warp_min(key, best[r].idx, nan, k);
    if (lane == 0) {
      red_k[warp * kMaxRows + r] = key;
      red_i[warp * kMaxRows + r] = idx;
      red_n[warp * kMaxRows + r] = nan;
    }
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {  // warp r takes row r
    const bool on = lane < nwarps;
    uint32_t key = on ? red_k[lane * kMaxRows + r] : 0xffffffffu;
    int nan = on ? red_n[lane * kMaxRows + r] : 0;
    const int idx = warp_min(key, on ? red_i[lane * kMaxRows + r] : k, nan, k);
    if (lane == 0) out[row0 + r] = (nan || idx == k) ? 0 : idx;
  }
}

template <int D>
int launch(const float* z, const float* cb, int32_t* out, int n, int k, int d,
           int rows, int threads, int grid, int smem, cudaStream_t stream) {
  if (rows > max_rows(D)) return cudaErrorInvalidValue;
  auto kernel = codebook_argmin_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(z, cb, out, n, k, d, rows);
  return cudaGetLastError();
}

int launch_tiled(const float* z, const float* cb, int32_t* out, int n, int k,
                 int d, int rows, int threads, int grid, int smem, int k_tile,
                 cudaStream_t stream) {
  auto kernel = codebook_argmin_tiled_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(z, cb, out, n, k, d, rows, k_tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// z (n, d) f32, cb (k, d) f32, out (n,) int32, all contiguous on the
// current device. The launch plan (rows per block, threads, grid,
// shared-memory bytes) comes from the wrapper
// (esc_tpu_torch/ops/kernels/codebook_argmin.py::launch_plan) and is
// checked here; k_tile codewords (k, or a multiple of 4 below it: the
// tiled kernel) pass through shared memory at a time. Returns the CUDA
// error of the launch (0 = none); a plan that does not fit is refused as
// an invalid value.
int esc_codebook_argmin(const float* z, const float* cb, int32_t* out, int n,
                        int k, int d, int rows, int threads, int grid,
                        int smem, int k_tile, void* stream) {
  if (n <= 0) return cudaSuccess;
  const bool ok = k >= 1 && d >= 1 && rows >= 1 && rows <= kMaxRows &&
                  k_tile >= 1 && k_tile <= k &&
                  (k_tile == k || k_tile % 4 == 0) &&
                  threads >= 32 && threads % 32 == 0 &&
                  threads <= kMaxThreads && grid >= 1 &&
                  (long long)grid * rows >= n &&
                  (long long)(grid - 1) * rows < n && smem <= kMaxSmem &&
                  (size_t)smem == smem_bytes(k_tile, d, rows);
  if (!ok) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (k_tile < k)
    return launch_tiled(z, cb, out, n, k, d, rows, threads, grid, smem,
                        k_tile, s);
  switch (d) {
    case 6:
      return launch<6>(z, cb, out, n, k, d, rows, threads, grid, smem, s);
    case 8:
      return launch<8>(z, cb, out, n, k, d, rows, threads, grid, smem, s);
    case 12:
      return launch<12>(z, cb, out, n, k, d, rows, threads, grid, smem, s);
    case 16:
      return launch<16>(z, cb, out, n, k, d, rows, threads, grid, smem, s);
    case 24:
      return launch<24>(z, cb, out, n, k, d, rows, threads, grid, smem, s);
    case 32:
      return launch<32>(z, cb, out, n, k, d, rows, threads, grid, smem, s);
    default:
      return launch<0>(z, cb, out, n, k, d, rows, threads, grid, smem, s);
  }
}

const char* esc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
