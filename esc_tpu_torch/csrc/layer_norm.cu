// LayerNorm over the rows of a contiguous (rows, C) fp32 array, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: esc_tpu normalises with flax's nn.LayerNorm, which
// XLA fuses into its neighbours on the TPU. The port's nn.LayerNorm went to
// ATen, whose kernels give one block to each row: at ESC's widths (45 to 384
// floats a row, up to 307,200 rows a call) a block of 128-512 threads then
// reduces a few dozen values, and at widths that are not a multiple of 4 (45,
// 90) ATen takes two kernels (the row moments, then the normalisation). This
// kernel is the codec's inference LayerNorm; training keeps ATen's, with its
// backward. For every row r:
//
//     mean_r = sum_c x[r, c] / C
//     var_r  = sum_c (x[r, c] - mean_r)^2 / C        (biased, from the mean)
//     y[r, c] = (x[r, c] - mean_r) * rsqrt(var_r + eps) * gamma[c] + beta[c]
//
// all in fp32.
//
// What bounds it on an H100: each element is read once and written once (8
// bytes) for about 8 operations, 1 operation a byte against the card's 20
// fp32 operations a byte of memory: bytes bound it, 4 (2 rows C + 2 C) / 3.35
// TB/s a call. So the design keeps every byte of HBM traffic a full, aligned
// transaction and enough bytes in flight on every SM, and keeps the reduction
// cheap enough to hide behind the copies:
//
// - A tile is `rows_per_tile` consecutive rows: one contiguous span of the
//   array whatever C is. Each warp owns two tile buffers in shared memory and
//   walks the tiles warp_id, warp_id + all warps, ...; the copy of its next
//   tile is in flight (cp.async) while it normalises the current one. The
//   span is copied in 16-byte pieces (cp.async.cg, past L1) where the global
//   and shared addresses agree modulo 16: the tile's element e sits at
//   buf[pre + e], pre its global address's float offset modulo 4, so that
//   both sides are aligned from the first whole 16 bytes on. The head and
//   the tail of a span that is no multiple of 16 bytes go 4 bytes at a time.
//   The output leaves the same way, as 16-byte stores from the buffer.
// - Rows are reduced within a warp, never across warps: no block-wide
//   barrier after the block has read gamma and beta into shared memory once.
//   A row belongs to a group of `lanes` lanes (1, 2, ..., 32; 32 / lanes
//   rows at a time); lane k of a group takes columns k, k + lanes, ... from
//   the buffer, keeps its partial sums in registers, and the group adds them
//   with xor shuffles: the sum, then the mean, then the squared deviations.
//   The launch plan picks the group size from C alone, so that a row's
//   columns fill the lanes and the lanes of one read fall on distinct banks:
//   at C 45 each lane takes a whole row (45 is odd, so 32 rows 45 floats
//   apart hit 32 banks), at 384 the warp takes one row.
// - The normalised row is written back into the buffer, then the tile
//   leaves for global memory; the buffer is refilled two tiles on.
// - Blocks of up to 4 warps, as many per SM as shared memory allows; the
//   grid covers the tiles once, up to a full load of the card, and each
//   warp then takes every (all warps)-th tile.
//
// The launch plan (esc_tpu_torch/ops/kernels/layer_norm.py::launch_plan) is
// computed by the wrapper and checked here. C may be 1..kMaxC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kStages = 2;  // tile buffers of a warp
constexpr int kMaxC = 4096;
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread's copies but the newest has landed
__device__ __forceinline__ void wait_all_but_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// gamma and beta (each padded to 16 bytes), then kStages buffers of `pitch`
// floats per warp
size_t smem_bytes(int C, int warps, int pitch) {
  return (2 * (size_t)round4(C) + (size_t)warps * kStages * pitch) *
         sizeof(float);
}

// The float offset of p modulo 4: where a span starting at p sits in a
// buffer so that its 16-byte pieces line up on both sides.
__device__ __forceinline__ int quad_offset(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The span src[0, n) into buf[pre, pre + n), pre = quad_offset(src): whole
// 16-byte pieces as such, the head and tail 4 bytes at a time. Asynchronous:
// the caller commits and waits.
__device__ __forceinline__ void load_span(float* buf, const float* src, int n,
                                          int lane) {
  float* dst = buf + quad_offset(src);
  const int head = min(n, (4 - quad_offset(src)) & 3);
  const int body = (n - head) >> 2;
  const int tail = head + 4 * body;
  if (lane < head) copy4(dst + lane, src + lane);
  for (int i = lane; i < body; i += 32)
    copy16(dst + head + 4 * i, src + head + 4 * i);
  if (tail + lane < n) copy4(dst + tail + lane, src + tail + lane);
}

// buf[pre, pre + n) out to dst[0, n): 16-byte stores where dst lines up with
// the buffer, 4-byte stores otherwise.
__device__ __forceinline__ void store_span(float* dst, const float* buf,
                                           int pre, int n, int lane) {
  const float* src = buf + pre;
  if (quad_offset(dst) != pre) {
    for (int i = lane; i < n; i += 32) dst[i] = src[i];
    return;
  }
  const int head = min(n, (4 - pre) & 3);
  const int body = (n - head) >> 2;
  const int tail = head + 4 * body;
  if (lane < head) dst[lane] = src[lane];
  for (int i = lane; i < body; i += 32)
    *reinterpret_cast<float4*>(dst + head + 4 * i) =
        *reinterpret_cast<const float4*>(src + head + 4 * i);
  if (tail + lane < n) dst[tail + lane] = src[tail + lane];
}

// the sum over a group of `lanes` neighbouring lanes (a power of two)
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
layer_norm_kernel(const float* __restrict__ x,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, float* __restrict__ y,
                  int rows, int C, float eps, int lanes, int rows_per_tile,
                  int pitch, int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int C4 = round4(C);
  float* g_s = smem;
  float* b_s = smem + C4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float* bufs = smem + 2 * C4 + (size_t)warp * kStages * pitch;

  const int stride = gridDim.x * warps;
  const int group = lane / lanes, k = lane % lanes;
  const int rows_at_once = 32 / lanes;

  int t = blockIdx.x * warps + warp;
  if (t < tiles) {
    const long long r0 = (long long)t * rows_per_tile;
    load_span(bufs, x + r0 * C,
              (int)(min((long long)rows_per_tile, rows - r0) * C), lane);
  }
  commit();

  // gamma and beta, once per block, while the first tiles are in flight:
  // 16-byte reads (both are 16-byte aligned)
  for (int i = threadIdx.x; i < C / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(g_s)[i] =
        reinterpret_cast<const float4*>(gamma)[i];
    reinterpret_cast<float4*>(b_s)[i] =
        reinterpret_cast<const float4*>(beta)[i];
  }
  for (int c = C / 4 * 4 + threadIdx.x; c < C; c += blockDim.x) {
    g_s[c] = gamma[c];
    b_s[c] = beta[c];
  }
  __syncthreads();

  for (int it = 0; t < tiles; ++it, t += stride) {
    // the next tile's copy goes out before this one is normalised
    const int next = t + stride;
    if (next < tiles) {
      const long long r0 = (long long)next * rows_per_tile;
      load_span(bufs + ((it + 1) % kStages) * pitch, x + r0 * C,
                (int)(min((long long)rows_per_tile, rows - r0) * C), lane);
    }
    commit();
    wait_all_but_newest();
    __syncwarp();

    const long long r0 = (long long)t * rows_per_tile;
    const int nrows = (int)min((long long)rows_per_tile, rows - r0);
    const int pre = quad_offset(x + r0 * C);
    float* buf = bufs + (it % kStages) * pitch;
    for (int rb = 0; rb < nrows; rb += rows_at_once) {
      const int r = rb + group;
      const bool valid = r < nrows;
      float* xr = buf + pre + r * C;
      float s = 0.f;
      if (valid)
        for (int c = k; c < C; c += lanes) s += xr[c];
      const float mean = group_sum(s, lanes) / (float)C;
      float q = 0.f;
      if (valid)
        for (int c = k; c < C; c += lanes) {
          const float d = xr[c] - mean;
          q = fmaf(d, d, q);
        }
      const float rstd = rsqrtf(group_sum(q, lanes) / (float)C + eps);
      if (valid)
        for (int c = k; c < C; c += lanes)
          xr[c] = fmaf((xr[c] - mean) * rstd, g_s[c], b_s[c]);
    }
    __syncwarp();
    store_span(y + r0 * C, buf, pre, nrows * C, lane);
    __syncwarp();  // the buffer is read out before it is refilled
  }
  wait_all();
}

}  // namespace

extern "C" {

// x, y (rows, C) f32, contiguous, on the current device; gamma, beta (C,)
// f32, 16-byte aligned. plan holds rows, C and the launch plan (lanes a
// row, rows a tile, warps a block, blocks, floats a tile buffer,
// shared-memory bytes), computed by the wrapper
// (esc_tpu_torch/ops/kernels/layer_norm.py::launch_plan; one array keeps
// the host's call short) and checked here. Returns the CUDA error of the
// launch (0 = none); a plan that does not fit is refused as an invalid
// value.
int esc_layer_norm(const float* x, const float* gamma, const float* beta,
                   float* y, float eps, const int* plan, void* stream) {
  const int rows = plan[0], C = plan[1], lanes = plan[2],
            rows_per_tile = plan[3], warps = plan[4], grid = plan[5],
            pitch = plan[6], smem = plan[7];
  if (rows <= 0) return cudaSuccess;
  const long long tiles =
      rows_per_tile > 0 ? ((long long)rows + rows_per_tile - 1) / rows_per_tile
                        : 0;
  const bool ok =
      C >= 1 && C <= kMaxC && lanes >= 1 && lanes <= 32 &&
      (lanes & (lanes - 1)) == 0 && rows_per_tile >= 32 / lanes &&
      rows_per_tile % (32 / lanes) == 0 && warps >= 1 && warps <= kMaxWarps &&
      pitch % 4 == 0 && (long long)pitch >= (long long)rows_per_tile * C + 3 &&
      (long long)rows_per_tile * C < (1LL << 30) && tiles < (1LL << 31) &&
      grid >= 1 && (long long)(grid - 1) * warps < tiles && smem <= kMaxSmem &&
      (size_t)smem == smem_bytes(C, warps, pitch) &&
      reinterpret_cast<uintptr_t>(gamma) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(beta) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 4 == 0;
  if (!ok) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // per device: the attribute is set once for the largest size asked
    static int set_to[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || smem > set_to[dev]) {
      err = cudaFuncSetAttribute(layer_norm_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) set_to[dev] = smem;
    }
  }
  layer_norm_kernel<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      x, gamma, beta, y, rows, C, eps, lanes, rows_per_tile, pitch,
      (int)tiles);
  return cudaGetLastError();
}

}  // extern "C"
