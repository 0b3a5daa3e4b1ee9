// Fused Swin window attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel esc_tpu/ops/pallas/attention_kernels.py
// (fused_window_attention, with its bodies _kernel and _kernel4d). For
// every window g and head h of the qkv projection (G, N, 3C), N = 16:
//
//     out[g, :, h] = softmax((q * scale) k^T + bias[h] + mask[g % nW]) v
//
// Scores, bias, mask and softmax are fp32. bf16 q/k/v are read as bf16,
// multiplied in fp32 and accumulated in fp32; as in the TPU kernel the
// scaled q and the probabilities are rounded to bf16 before their
// products. The probabilities are exp(s - max) times 1 / sum: one division
// per row, since a subnormal quotient (a masked score) takes the division's
// slow path. The output is fp32 (G, N, C). The TPU kernel's head tiling and
// its window-count thresholds are v5e tunings and are not carried over.
//
// What bounds it on an H100: a window moves 192 C bytes in (f32 q/k/v) and
// 64 C out for about 1,024 C flops, 4 flops per byte - far below the
// card's ratio of fp32 rate to memory rate (about 20), so the floor is the
// memory: every input byte read once, every output byte written once. The
// calls of ESC-Base serving move 4-55 MB each, so the time a window's bytes
// spend in flight has to be hidden behind other windows' arithmetic. On
// the SM the arithmetic is fp32 FMA on the CUDA cores (no tensor cores:
// TF32 would break the parity contract) fed from shared memory; the rate of
// shared-memory reads (one 128-byte wavefront per clock and SM) is the next
// limit.
//
// Design:
// - A tile is W consecutive windows (the launch plan's windows per stage).
//   All heads of a window sit in one contiguous (16, 3C) slab of qkv and a
//   tile in W of them, so a tile arrives with one bulk asynchronous copy
//   (cp.async.bulk, the Tensor Memory Accelerator's 1-D form) completing on
//   an mbarrier. Where a row of 3C elements spans a multiple of 128 bytes,
//   every row would start on the same bank; then the tile comes as one
//   bulk copy per row into rows padded by 16 bytes.
// - Blocks are persistent: the grid is sized to the card and each block
//   walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ... through a ring
//   of `stages` input buffers. The copy of a later tile is issued before
//   the current one is computed, so copies overlap the arithmetic.
// - One warp per (window, head) pair of the tile, W * nh warps in all, so
//   no lane idles at any head count. Lane 2i + s owns query row i and the
//   score columns j = 2 jj + s (jj = 0..7): q row in registers, k and v
//   rows read as broadcasts of two rows, the row max and sum one shuffle
//   away. hd is a template parameter for the main path's widths (6, 8, 12,
//   15, 16, 24), so the loops over a head's channels unroll; a generic
//   instance serves any other width up to 32. At hd 15, whose slices allow
//   no vector reads, a lane takes two rows and four columns instead
//   (attend_blocked), so that each read feeds two FMAs.
// - bias (nh, 16, 16) is copied into shared memory once per block, rows
//   padded to 17 floats. The mask of window g (index g % nW) comes with the
//   tile, one bulk copy per 64-byte row into rows of 20 floats.
// - q, k and v are read from shared memory as 16-, 8- or 4-byte vectors
//   (the widest whose element count divides hd), so one read feeds up to
//   four FMAs per lane.
// - Each warp writes its (16, hd) output into a per-tile output buffer in
//   shared memory; the tile's (W * 16, C) output, contiguous in global
//   memory, then leaves by bulk asynchronous stores (cp.async.bulk, shared
//   to global): one store for the tile, or, where C is a multiple of 8 and
//   rows C floats apart would put the 16 rows on few banks, one per row
//   from rows padded to C + 4 floats. Two output buffers alternate, so one
//   barrier per tile suffices.
//
// Wider layers (head groups). Where one window of all heads does not fit
// a block's shared memory, or a head is wider than 32, a second kernel
// (window_attention_grouped_kernel) takes the call, as the TPU kernel
// splits heads into channel groups (attention_kernels.py:47-58,
// _heads_per_tile). Its unit of work is a tile of windows times a group
// of heads; persistent blocks walk the units. A block copies only its
// group's q, k and v columns, three strided segments per token row, with
// plain vector loads (the segments of a head group need not start on 16
// bytes, so no bulk copies), into rows [q_g | k_g | v_g] padded to 16
// bytes; the tile's mask comes the same way. Heads up to 32 wide go
// through the same per-warp code as above; wider heads (up to
// kMaxWideHeadDim) through attend_wide, which keeps no per-channel
// registers: a lane scores its row's columns reading q and k from shared
// memory, the warp's probabilities go to a 16 x 17 scratch tile, and lane
// c then sums output channels c, c + 32, ... over the 16 keys. The
// output is written straight to global memory. These widths are off the
// codec's serving path: the design is simple and right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;  // tokens per window (4 x 4)
constexpr int kMaxHeadDim = 32;       // per-channel registers (attend)
constexpr int kMaxWideHeadDim = 256;  // attend_wide
constexpr int kMaxThreads = 768;
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;  // 227 KB, an H100 block's limit
constexpr int kBiasPitch = kN + 1;
constexpr int kMaskPitch = 20;  // floats: 16-byte rows, 2-way conflicts
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Rounds a value to the input type, as the TPU kernel's astype(q.dtype).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the mbarrier completes the phase of `parity`. A copy that
// never lands (a fault) traps after about ten seconds instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > 20000000000LL) __trap();
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

// Shared -> global bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned), in the issuing thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// Global -> shared bulk copy of `bytes` (a multiple of 16, both addresses
// 16-byte aligned), counted against the mbarrier's transaction bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Plan {
  int windows;     // windows per tile
  int stages;      // input buffers in the ring
  int threads;
  int grid;
  int in_pitch;    // bytes between rows of an input buffer
  int out_pitch;   // floats between rows of an output buffer
};

__host__ __device__ size_t in_stage_bytes(const Plan& p) {
  return (size_t)p.windows * kN * p.in_pitch;
}
__host__ __device__ size_t mask_stage_bytes(const Plan& p, bool masked) {
  return masked ? (size_t)p.windows * kN * kMaskPitch * sizeof(float) : 0;
}
__host__ __device__ size_t out_buffer_bytes(const Plan& p) {
  return (size_t)p.windows * kN * p.out_pitch * sizeof(float);
}
// Shared memory of one block: the input ring, the mask ring (masked calls
// only), two output buffers, the padded bias and one mbarrier per stage, in
// that order.
size_t smem_bytes(const Plan& p, int nh, bool masked) {
  return p.stages * (in_stage_bytes(p) + mask_stage_bytes(p, masked)) +
         2 * out_buffer_bytes(p) +
         (size_t)nh * kN * kBiasPitch * sizeof(float) +
         (size_t)p.stages * sizeof(uint64_t);
}

// Elements of T read as one vector: the widest of 16, 8, 4 bytes (or one
// element) whose element count divides hd, so that every head's slice of a
// row, which starts at a multiple of hd, starts on the vector's alignment.
template <typename T, int HD>
__host__ __device__ constexpr int vec_width() {
  constexpr int most = 16 / (int)sizeof(T);
  if (HD <= 0) return 1;
  for (int v = most; v > 1; v /= 2)
    if (HD % v == 0) return v;
  return 1;
}

// V consecutive elements at p (aligned to V elements) as floats.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

__device__ __forceinline__ void bf16x2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    bf16x2(t.x, v), bf16x2(t.y, v + 2), bf16x2(t.z, v + 4),
        bf16x2(t.w, v + 6);
  } else if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    bf16x2(t.x, v), bf16x2(t.y, v + 2);
  } else if constexpr (V == 2) {
    bf16x2(*reinterpret_cast<const uint32_t*>(p), v);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// One (window, head) pair: `in` is the window's first row in the input
// buffer (row pitch `pitch` elements), `ob` its first row in the output
// buffer, `bs` the head's padded bias, `mk` the window's padded mask in
// shared memory or null.
template <typename T, int HD>
__device__ __forceinline__ void attend(const T* __restrict__ in, int pitch,
                                       int C, int h, int hd_rt,
                                       const float* __restrict__ bs,
                                       const float* __restrict__ mk,
                                       float* __restrict__ ob, int out_pitch,
                                       float scale, int lane) {
  constexpr int kMax = HD > 0 ? HD : kMaxHeadDim;
  constexpr int V = vec_width<T, HD>();
  const int hd = HD > 0 ? HD : hd_rt;
  const int i = lane >> 1, half = lane & 1;

  const T* qr = in + i * pitch + h * hd;
  float q[kMax];
#pragma unroll
  for (int c0 = 0; c0 < kMax; c0 += V) {
    if (c0 < hd) {
      float v[V];
      load_vec<V>(qr + c0, v);
#pragma unroll
      for (int u = 0; u < V; ++u) q[c0 + u] = round_to(v[u] * scale, qr);
    }
  }

  // rows j = 2 jj + half of k and v; each vector read is a broadcast of
  // two rows
  const T* kr = in + half * pitch + C + h * hd;
  const T* vr = kr + C;
  float s[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) s[jj] = 0.f;
#pragma unroll
  for (int c0 = 0; c0 < kMax; c0 += V) {
    if (c0 < hd) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float v[V];
        load_vec<V>(kr + 2 * jj * pitch + c0, v);
#pragma unroll
        for (int u = 0; u < V; ++u) s[jj] = fmaf(q[c0 + u], v[u], s[jj]);
      }
    }
  }
  float m = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = 2 * jj + half;
    s[jj] += bs[i * kBiasPitch + j];  // (q.k + bias) + mask, as the plain
    if (mk) s[jj] += mk[i * kMaskPitch + j];  // version adds them
    m = fmaxf(m, s[jj]);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    s[jj] = expf(s[jj] - m);
    sum += s[jj];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float inv = 1.f / sum;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) s[jj] = round_to(s[jj] * inv, qr);

  float o[kMax];
#pragma unroll
  for (int c = 0; c < kMax; ++c) o[c] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
    for (int c0 = 0; c0 < kMax; c0 += V) {
      if (c0 < hd) {
        float v[V];
        load_vec<V>(vr + 2 * jj * pitch + c0, v);
#pragma unroll
        for (int u = 0; u < V; ++u) o[c0 + u] = fmaf(s[jj], v[u], o[c0 + u]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kMax; ++c)
    if (c < hd) o[c] += __shfl_xor_sync(0xffffffffu, o[c], 1);

  // lane 2i + half stores channels 2 m + half of row i
  float* orow = ob + i * out_pitch + h * hd;
#pragma unroll
  for (int c0 = 0; c0 < kMax; c0 += 2) {
    const float val = (half && c0 + 1 < kMax) ? o[c0 + 1] : o[c0];
    if (c0 + half < hd) orow[c0 + half] = val;
  }
}

// The same pair for a head width read one element at a time (hd 15): each
// shared-memory read then feeds one FMA in attend, so here a lane takes two
// query rows and four key columns, and every k or v element read feeds two
// FMAs. Lane 4 r + q owns rows r and r + 8 and columns j = q + 4 jj; the
// row max and sum are two shuffles away, and the four lanes' partial
// outputs are summed by a reduce-scatter (hd + hd / 2 shuffles) that leaves
// each lane half of one row's channels.
template <typename T, int HD>
__device__ __forceinline__ void attend_blocked(
    const T* __restrict__ in, int pitch, int C, int h,
    const float* __restrict__ bs, const float* __restrict__ mk,
    float* __restrict__ ob, int out_pitch, float scale, int lane) {
  constexpr int kHalf = (HD + 1) / 2;
  const int r = lane >> 2, q = lane & 3;

  const T* qa = in + r * pitch + h * HD;
  const T* qb = qa + 8 * pitch;
  float xa[HD], xb[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    xa[c] = round_to(load(qa + c) * scale, qa);
    xb[c] = round_to(load(qb + c) * scale, qa);
  }
  const T* kr = in + q * pitch + C + h * HD;  // row j = q + 4 jj
  const T* vr = kr + C;
  float sa[4], sb[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) sa[jj] = sb[jj] = 0.f;
#pragma unroll
  for (int c = 0; c < HD; ++c) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float kv = load(kr + 4 * jj * pitch + c);
      sa[jj] = fmaf(xa[c], kv, sa[jj]);
      sb[jj] = fmaf(xb[c], kv, sb[jj]);
    }
  }
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = q + 4 * jj;
    sa[jj] += bs[r * kBiasPitch + j];
    sb[jj] += bs[(r + 8) * kBiasPitch + j];
    if (mk) {
      sa[jj] += mk[r * kMaskPitch + j];
      sb[jj] += mk[(r + 8) * kMaskPitch + j];
    }
    ma = fmaxf(ma, sa[jj]);
    mb = fmaxf(mb, sb[jj]);
  }
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
  }
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    sa[jj] = expf(sa[jj] - ma);
    sb[jj] = expf(sb[jj] - mb);
    suma += sa[jj];
    sumb += sb[jj];
  }
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    suma += __shfl_xor_sync(0xffffffffu, suma, off);
    sumb += __shfl_xor_sync(0xffffffffu, sumb, off);
  }
  const float inva = 1.f / suma, invb = 1.f / sumb;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    sa[jj] = round_to(sa[jj] * inva, qa);
    sb[jj] = round_to(sb[jj] * invb, qa);
  }

  float oa[HD], obr[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) oa[c] = obr[c] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      const float vv = load(vr + 4 * jj * pitch + c);
      oa[c] = fmaf(sa[jj], vv, oa[c]);
      obr[c] = fmaf(sb[jj], vv, obr[c]);
    }
  }
  // lanes with q & 2 keep row r + 8, the others row r ...
  const bool upper = q & 2, odd = q & 1;
  float acc[HD];
#pragma unroll
  for (int c = 0; c < HD; ++c) {
    const float keep = upper ? obr[c] : oa[c];
    acc[c] = keep + __shfl_xor_sync(0xffffffffu, upper ? oa[c] : obr[c], 2);
  }
  // ... and odd lanes channels kHalf.., the others ..kHalf
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
    const float give = odd ? acc[m] : (m + kHalf < HD ? acc[m + kHalf] : 0.f);
    const float got = __shfl_xor_sync(0xffffffffu, give, 1);
    if (!odd) acc[m] += got;
    else if (m + kHalf < HD) acc[m + kHalf] += got;
  }
  float* orow = ob + (r + (upper ? 8 : 0)) * out_pitch + h * HD;
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
    if (!odd) orow[m] = acc[m];
    else if (m + kHalf < HD) orow[m + kHalf] = acc[m + kHalf];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads)
window_attention_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, int n_mask,
                        float* __restrict__ out, int G, int nh, int hd,
                        float scale, Plan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = nh * hd;
  const size_t row_bytes = (size_t)3 * C * sizeof(T);
  const size_t in_bytes = in_stage_bytes(plan);
  const size_t mask_bytes = mask_stage_bytes(plan, mask != nullptr);
  const size_t out_bytes = out_buffer_bytes(plan);
  unsigned char* in_ring = smem;
  unsigned char* mask_ring = smem + plan.stages * in_bytes;
  float* out_buf = reinterpret_cast<float*>(
      mask_ring + plan.stages * mask_bytes);
  float* bias_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(out_buf) + 2 * out_bytes);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(bias_s + (size_t)nh * kN * kBiasPitch);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int W = plan.windows;
  const int n_tiles = (G + W - 1) / W;
  const int pitch = plan.in_pitch / (int)sizeof(T);
  const unsigned char* src = reinterpret_cast<const unsigned char*>(qkv);

  // Issued by warp 0: lane 0 announces the bytes, then the lanes issue the
  // copies, the mask's one per 64-byte row into rows of kMaskPitch floats.
  auto issue = [&](int tile, int stage) {
    const int g0 = tile * W;
    const int nwin = min(W, G - g0);
    const int rows = nwin * kN;
    unsigned char* dst = in_ring + stage * in_bytes;
    const unsigned char* from = src + (size_t)g0 * kN * row_bytes;
    const uint32_t qkv_total = (uint32_t)(rows * row_bytes);
    if (lane == 0)
      mbar_expect_tx(&bars[stage],
                     qkv_total + (mask ? rows * kN * sizeof(float) : 0));
    __syncwarp();
    if ((size_t)plan.in_pitch == row_bytes) {
      if (lane == 0) bulk_copy(dst, from, qkv_total, &bars[stage]);
    } else {
      for (int r = lane; r < rows; r += 32)
        bulk_copy(dst + (size_t)r * plan.in_pitch, from + r * row_bytes,
                  (uint32_t)row_bytes, &bars[stage]);
    }
    if (mask) {
      float* mdst = reinterpret_cast<float*>(mask_ring + stage * mask_bytes);
      for (int r = lane; r < rows; r += 32) {
        const int w = r / kN, i = r - w * kN;
        bulk_copy(mdst + r * kMaskPitch,
                  mask + ((size_t)((g0 + w) % n_mask) * kN + i) * kN,
                  kN * sizeof(float), &bars[stage]);
      }
    }
  };

  if (tid == 0) {
    for (int s = 0; s < plan.stages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < nh * kN * kN; e += blockDim.x)
    bias_s[(e / kN) * kBiasPitch + e % kN] = bias[e];
  __syncthreads();
  if (warp == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      const int tile = blockIdx.x + s * gridDim.x;
      if (tile < n_tiles) issue(tile, s);
    }
  }

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int stage = it % plan.stages;
    const int g0 = tile * W;
    const int nwin = min(W, G - g0);
    mbar_wait(&bars[stage], (uint32_t)((it / plan.stages) & 1));
    const T* in = reinterpret_cast<const T*>(in_ring + stage * in_bytes);
    const float* ms =
        reinterpret_cast<const float*>(mask_ring + stage * mask_bytes);
    float* ob = out_buf + (size_t)(it & 1) * (out_bytes / sizeof(float));

    for (int p = warp; p < nwin * nh; p += nwarps) {
      const int w = p / nh, h = p - w * nh;
      const T* win = in + (size_t)w * kN * pitch;
      const float* bh = bias_s + (size_t)h * kN * kBiasPitch;
      const float* mw = mask ? ms + w * kN * kMaskPitch : nullptr;
      float* ow = ob + (size_t)w * kN * plan.out_pitch;
      if constexpr (HD > 0 && vec_width<T, HD>() == 1)
        attend_blocked<T, HD>(win, pitch, C, h, bh, mw, ow, plan.out_pitch,
                              scale, lane);
      else
        attend<T, HD>(win, pitch, C, h, hd, bh, mw, ow, plan.out_pitch, scale,
                      lane);
    }
    // order this thread's shared-memory accesses before the async proxy's
    // (the refill of the input buffers, the stores of the output buffer)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // the other output buffer's stores (from the previous tile) have read
    // it before anyone writes it again
    if (warp == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();  // the input buffers are read, the output buffer full

    if (warp == 0) {
      const int next = tile + plan.stages * gridDim.x;
      if (next < n_tiles) issue(next, stage);
      // the tile's output: nwin * 16 rows of C floats, contiguous in out
      float* dst = out + (size_t)g0 * kN * C;
      if (plan.out_pitch == C) {
        if (lane == 0)
          bulk_store(dst, ob, (uint32_t)(nwin * kN * C * sizeof(float)));
      } else {
        for (int r = lane; r < nwin * kN; r += 32)
          bulk_store(dst + (size_t)r * C, ob + (size_t)r * plan.out_pitch,
                     (uint32_t)(C * sizeof(float)));
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (warp == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// One (window, head) pair of any head width (hd up to kMaxWideHeadDim),
// with no per-channel registers. Lane 2i + half scores row i against the
// columns j = 2 jj + half, reading q and k from shared memory; the
// probabilities go to the warp's scratch tile `ps` (16 x kBiasPitch);
// then lane c sums output channels c, c + 32, ... over the 16 keys, in
// key order, and writes them to `ob` (row pitch `out_pitch`).
template <typename T>
__device__ __forceinline__ void attend_wide(const T* __restrict__ in,
                                            int pitch, int C, int h, int hd,
                                            const float* __restrict__ bs,
                                            const float* __restrict__ mk,
                                            float* __restrict__ ob,
                                            int out_pitch, float scale,
                                            float* __restrict__ ps, int lane) {
  const int i = lane >> 1, half = lane & 1;
  const T* qr = in + i * pitch + h * hd;
  const T* kr = in + half * pitch + C + h * hd;
  float s[8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) s[jj] = 0.f;
  for (int c = 0; c < hd; ++c) {
    const float q = round_to(load(qr + c) * scale, qr);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      s[jj] = fmaf(q, load(kr + 2 * jj * pitch + c), s[jj]);
  }
  float m = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = 2 * jj + half;
    s[jj] += bs[i * kBiasPitch + j];
    if (mk) s[jj] += mk[i * kMaskPitch + j];
    m = fmaxf(m, s[jj]);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    s[jj] = expf(s[jj] - m);
    sum += s[jj];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float inv = 1.f / sum;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    ps[i * kBiasPitch + 2 * jj + half] = round_to(s[jj] * inv, qr);
  __syncwarp();
  const T* vr = in + 2 * C + h * hd;
  for (int c = lane; c < hd; c += 32) {
    // reload the probabilities in every pass: hoisted out of the loop
    // they would take 256 registers
    asm volatile("" ::: "memory");
    float o[kN];
#pragma unroll
    for (int r = 0; r < kN; ++r) o[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float v = load(vr + j * pitch + c);
#pragma unroll
      for (int r = 0; r < kN; ++r) o[r] = fmaf(ps[r * kBiasPitch + j], v, o[r]);
    }
#pragma unroll
    for (int r = 0; r < kN; ++r) ob[r * out_pitch + h * hd + c] = o[r];
  }
  __syncwarp();  // ps is read before the warp's next pair writes it
}

struct GroupPlan {
  int windows;   // windows per unit
  int heads;     // heads per group
  int threads;
  int grid;
  int in_pitch;  // bytes between rows of the input buffer
};

// Shared memory of one block of the grouped kernel: the input buffer, the
// mask buffer (masked calls only), the padded bias of every head and, for
// heads wider than kMaxHeadDim, one probability tile per warp.
size_t grouped_smem_bytes(const GroupPlan& p, int nh, int hd, bool masked) {
  const size_t tile = (size_t)kN * kBiasPitch * sizeof(float);
  return (size_t)p.windows * kN * p.in_pitch +
         (masked ? (size_t)p.windows * kN * kMaskPitch * sizeof(float) : 0) +
         (size_t)nh * tile + (hd > kMaxHeadDim ? (p.threads / 32) * tile : 0);
}

// Copies `rows` rows of the three segments (q, k, v) of one head group:
// `n` bytes each, from row stride `src_row` and segment stride `src_seg`
// in global memory to row stride `dst_row` and segment stride `dst_seg`
// in shared memory, in units of U (every offset and `n` are multiples of
// sizeof(U)).
template <typename U>
__device__ __forceinline__ void copy_segments(
    unsigned char* __restrict__ dst, const unsigned char* __restrict__ src,
    int rows, int n, size_t src_row, size_t src_seg, int dst_row,
    int dst_seg) {
  const int units = n / (int)sizeof(U);
  const int per_row = 3 * units;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, rem = e - r * per_row;
    const int sg = rem / units, c = rem - sg * units;
    *reinterpret_cast<U*>(dst + (size_t)r * dst_row + sg * dst_seg +
                          c * sizeof(U)) =
        *reinterpret_cast<const U*>(src + r * src_row + sg * src_seg +
                                    c * sizeof(U));
  }
}

// Heads split into groups across blocks; heads up to kMaxHeadDim wide
// keep their channels in registers (attend), wider ones take attend_wide.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads)
window_attention_grouped_kernel(const T* __restrict__ qkv,
                                const float* __restrict__ bias,
                                const float* __restrict__ mask, int n_mask,
                                float* __restrict__ out, int G, int nh,
                                int hd, float scale, GroupPlan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = nh * hd;
  const int W = plan.windows, hg = plan.heads;
  const int Cg = hg * hd;  // elements between segments of a buffer row
  unsigned char* in_buf = smem;
  float* mask_buf =
      reinterpret_cast<float*>(smem + (size_t)W * kN * plan.in_pitch);
  float* bias_s = mask_buf + (mask ? (size_t)W * kN * kMaskPitch : 0);
  float* scratch = bias_s + (size_t)nh * kN * kBiasPitch;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int n_tiles = (G + W - 1) / W;
  const int n_groups = (nh + hg - 1) / hg;
  const int pitch = plan.in_pitch / (int)sizeof(T);
  // the widest unit that every segment's offset and length divide
  const int seg_bytes = hd * (int)sizeof(T);
  const int unit = seg_bytes % 16 == 0 ? 16
                   : seg_bytes % 8 == 0 ? 8
                   : seg_bytes % 4 == 0 ? 4
                                        : 2;

  for (int e = tid; e < nh * kN * kN; e += blockDim.x)
    bias_s[(e / kN) * kBiasPitch + e % kN] = bias[e];

  for (int u = blockIdx.x; u < n_tiles * n_groups; u += gridDim.x) {
    const int tile = u / n_groups, grp = u - tile * n_groups;
    const int g0 = tile * W, nwin = min(W, G - g0);
    const int h0 = grp * hg, hgl = min(hg, nh - h0);
    const int rows = nwin * kN;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        qkv + (size_t)g0 * kN * 3 * C + (size_t)h0 * hd);
    const int n = hgl * hd * (int)sizeof(T);
    const size_t src_row = (size_t)3 * C * sizeof(T);
    const size_t src_seg = (size_t)C * sizeof(T);
    const int dst_seg = Cg * (int)sizeof(T);
    __syncthreads();  // the previous unit's buffers are read
    if (unit == 16)
      copy_segments<uint4>(in_buf, src, rows, n, src_row, src_seg,
                           plan.in_pitch, dst_seg);
    else if (unit == 8)
      copy_segments<uint2>(in_buf, src, rows, n, src_row, src_seg,
                           plan.in_pitch, dst_seg);
    else if (unit == 4)
      copy_segments<uint32_t>(in_buf, src, rows, n, src_row, src_seg,
                              plan.in_pitch, dst_seg);
    else
      copy_segments<uint16_t>(in_buf, src, rows, n, src_row, src_seg,
                              plan.in_pitch, dst_seg);
    if (mask) {
      for (int e = tid; e < rows * kN; e += blockDim.x) {
        const int r = e / kN, j = e - r * kN;
        const int w = r / kN, i = r - w * kN;
        mask_buf[r * kMaskPitch + j] =
            mask[((size_t)((g0 + w) % n_mask) * kN + i) * kN + j];
      }
    }
    __syncthreads();

    const T* in = reinterpret_cast<const T*>(in_buf);
    for (int p = warp; p < nwin * hgl; p += nwarps) {
      const int w = p / hgl, hl = p - w * hgl;
      const T* win = in + (size_t)w * kN * pitch;
      const float* bh = bias_s + (size_t)(h0 + hl) * kN * kBiasPitch;
      const float* mw = mask ? mask_buf + w * kN * kMaskPitch : nullptr;
      float* ow = out + (size_t)(g0 + w) * kN * C + (size_t)h0 * hd;
      if constexpr (WIDE)
        attend_wide<T>(win, pitch, Cg, hl, hd, bh, mw, ow, C, scale,
                       scratch + (size_t)warp * kN * kBiasPitch, lane);
      else
        attend<T, 0>(win, pitch, Cg, hl, hd, bh, mw, ow, C, scale, lane);
    }
  }
}

template <typename T, bool WIDE>
int launch_grouped(const T* qkv, const float* bias, const float* mask,
                   int n_mask, float* out, int G, int nh, int hd, float scale,
                   const GroupPlan& plan, int smem, cudaStream_t stream) {
  auto kernel = window_attention_grouped_kernel<T, WIDE>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<plan.grid, plan.threads, smem, stream>>>(qkv, bias, mask, n_mask,
                                                    out, G, nh, hd, scale,
                                                    plan);
  return cudaGetLastError();
}

template <typename T>
int dispatch_grouped(const void* qkv, const float* bias, const float* mask,
                     int n_mask, float* out, int G, int nh, int hd,
                     float scale, const GroupPlan& plan, int smem,
                     cudaStream_t s) {
  const T* x = static_cast<const T*>(qkv);
  if (hd > kMaxHeadDim)
    return launch_grouped<T, true>(x, bias, mask, n_mask, out, G, nh, hd,
                                   scale, plan, smem, s);
  return launch_grouped<T, false>(x, bias, mask, n_mask, out, G, nh, hd,
                                  scale, plan, smem, s);
}

template <typename T, int HD>
int launch(const T* qkv, const float* bias, const float* mask, int n_mask,
           float* out, int G, int nh, int hd, float scale, const Plan& plan,
           int smem, cudaStream_t stream) {
  auto kernel = window_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    // per device: the attribute is set once for the largest size asked
    static int set_to[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || smem > set_to[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) set_to[dev] = smem;
    }
  }
  kernel<<<plan.grid, plan.threads, smem, stream>>>(
      qkv, bias, mask, n_mask, out, G, nh, hd, scale, plan);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* qkv, const float* bias, const float* mask,
             int n_mask, float* out, int G, int nh, int hd, float scale,
             const Plan& plan, int smem, cudaStream_t s) {
  const T* x = static_cast<const T*>(qkv);
  switch (hd) {
    case 6:
      return launch<T, 6>(x, bias, mask, n_mask, out, G, nh, hd, scale, plan,
                          smem, s);
    case 8:
      return launch<T, 8>(x, bias, mask, n_mask, out, G, nh, hd, scale, plan,
                          smem, s);
    case 12:
      return launch<T, 12>(x, bias, mask, n_mask, out, G, nh, hd, scale,
                           plan, smem, s);
    case 15:
      return launch<T, 15>(x, bias, mask, n_mask, out, G, nh, hd, scale,
                           plan, smem, s);
    case 16:
      return launch<T, 16>(x, bias, mask, n_mask, out, G, nh, hd, scale,
                           plan, smem, s);
    case 24:
      return launch<T, 24>(x, bias, mask, n_mask, out, G, nh, hd, scale,
                           plan, smem, s);
    default:
      return launch<T, 0>(x, bias, mask, n_mask, out, G, nh, hd, scale, plan,
                          smem, s);
  }
}

}  // namespace

extern "C" {

// qkv (G, 16, 3C) f32 or bf16, 16-byte aligned; bias (nh, 16, 16) f32;
// mask (n_mask, 16, 16) f32 or null; out (G, 16, C) f32, 16-byte aligned;
// all contiguous on the current device. The launch plan (windows per tile,
// stages, threads, grid, input row pitch in bytes, output row pitch in
// floats, shared-memory bytes, heads per group) comes from the wrapper
// (esc_tpu_torch/ops/kernels/window_attention.py::launch_plan) and is
// checked here. heads_per_group 0 takes the all-heads kernel (stages and
// out_pitch apply); > 0 the grouped kernel (stages 1, out_pitch 0).
// Returns the CUDA error of the launch (0 = none).
int esc_window_attention(const void* qkv, int qkv_is_bf16, const float* bias,
                         const float* mask, int n_mask, float* out, int G,
                         int nh, int hd, float scale, int windows, int stages,
                         int threads, int grid, int in_pitch, int out_pitch,
                         int smem, int heads_per_group, void* stream) {
  if (G <= 0) return cudaSuccess;
  const int C = nh * hd;
  const int es = qkv_is_bf16 ? 2 : 4;
  const int row_bytes = 3 * C * es;
  const bool common =
      hd >= 1 && nh >= 1 && (!mask || n_mask >= 1) && windows >= 1 &&
      threads >= 32 && threads % 32 == 0 && threads <= kMaxThreads &&
      grid >= 1 && smem <= kMaxSmem &&
      reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (heads_per_group > 0) {
    const GroupPlan plan{windows, heads_per_group, threads, grid, in_pitch};
    const bool ok =
        common && hd <= kMaxWideHeadDim && heads_per_group <= nh &&
        stages == 1 && out_pitch == 0 && in_pitch % 16 == 0 &&
        in_pitch >= 3 * heads_per_group * hd * es &&
        threads / 32 <= windows * heads_per_group &&
        (size_t)smem == grouped_smem_bytes(plan, nh, hd, mask != nullptr);
    if (!ok) return cudaErrorInvalidValue;
    return qkv_is_bf16
               ? dispatch_grouped<__nv_bfloat16>(qkv, bias, mask, n_mask, out,
                                                 G, nh, hd, scale, plan, smem,
                                                 s)
               : dispatch_grouped<float>(qkv, bias, mask, n_mask, out, G, nh,
                                         hd, scale, plan, smem, s);
  }
  const Plan plan{windows, stages, threads, grid, in_pitch, out_pitch};
  const bool ok =
      common && hd <= kMaxHeadDim && stages >= 1 && stages <= kMaxStages &&
      (in_pitch == row_bytes ||
       (in_pitch > row_bytes && in_pitch % 16 == 0 && row_bytes % 16 == 0)) &&
      (out_pitch == C || (out_pitch % 4 == 0 && C % 4 == 0 &&
                          out_pitch > C)) &&
      (size_t)smem == smem_bytes(plan, nh, mask != nullptr) &&
      (size_t)windows * kN * (row_bytes + kN * sizeof(float)) < (1u << 20);
  if (!ok) return cudaErrorInvalidValue;
  return qkv_is_bf16
             ? dispatch<__nv_bfloat16>(qkv, bias, mask, n_mask, out, G, nh,
                                       hd, scale, plan, smem, s)
             : dispatch<float>(qkv, bias, mask, n_mask, out, G, nh, hd,
                               scale, plan, smem, s);
}

}  // extern "C"
