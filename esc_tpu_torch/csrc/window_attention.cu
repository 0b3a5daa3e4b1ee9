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
// products. The output is fp32 (G, N, C). The TPU kernel's head tiling and
// its window-count thresholds are v5e tunings and are not carried over.
//
// What bounds it on an H100: per window and head the kernel does
// 4 * N^2 * hd flops against 3 * N * hd input and N * hd output elements,
// about 21 flops per byte in fp32 - far below the card's ratio of peak
// fp32 rate to memory rate, so it is bound by memory: reading q/k/v once
// and writing the output once.
//
// Design: one warp per (window, head) pair, four warps per block. The warp
// reads its q/k/v slices straight from the (G, N, 3C) projection through
// strides (no split copies), keeps them in shared memory with a padded row
// (hd + 1) against bank conflicts, and each lane owns half a row of the
// 16 x 16 score tile: row i = lane / 2, columns 8 * (lane % 2) .. + 8. The
// row max and sum are one shuffle away (lanes 2i and 2i + 1). The
// probabilities go to shared memory and each lane then writes every other
// channel of its row of the output. The scores never leave the SM. Any
// head width hd <= 32 works, odd ones included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kN = 16;  // tokens per window (4 x 4)
constexpr int kWarps = 4;
constexpr int kMaxHeadDim = 32;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Rounds a value to the input type, as the TPU kernel's astype(q.dtype).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

size_t smem_floats_per_warp(int hd) {
  return (size_t)3 * kN * (hd + 1) + kN * (kN + 1);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_kernel(const T* __restrict__ qkv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, int n_mask,
                        float* __restrict__ out, int G, int nh, int hd,
                        float scale) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = hd + 1;
  float* qs = smem + (size_t)warp * (3 * kN * ld + kN * (kN + 1));
  float* ks = qs + kN * ld;
  float* vs = ks + kN * ld;
  float* ps = vs + kN * ld;  // (kN, kN + 1) probabilities

  const long long pair = (long long)blockIdx.x * kWarps + warp;
  if (pair >= (long long)G * nh) return;  // no block-wide barrier below
  const int g = (int)(pair / nh), h = (int)(pair - (long long)g * nh);
  const int C = nh * hd;
  const T* base = qkv + (size_t)g * kN * 3 * C + (size_t)h * hd;

  for (int t = lane; t < kN * hd; t += 32) {
    const int i = t / hd, c = t - i * hd;
    const T* p = base + (size_t)i * 3 * C + c;
    qs[i * ld + c] = round_to(load(p) * scale, p);
    ks[i * ld + c] = load(p + C);
    vs[i * ld + c] = load(p + 2 * C);
  }
  __syncwarp();

  const int i = lane >> 1, j0 = (lane & 1) * 8;
  const float* brow = bias + ((size_t)h * kN + i) * kN + j0;
  const float* mrow =
      mask ? mask + ((size_t)(g % n_mask) * kN + i) * kN + j0 : nullptr;
  float s[8];
  float m = -INFINITY;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float* kr = ks + (j0 + jj) * ld;
    const float* qr = qs + i * ld;
    float acc = 0.f;
    for (int c = 0; c < hd; ++c) acc = fmaf(qr[c], kr[c], acc);
    acc += brow[jj];
    if (mrow) acc += mrow[jj];
    s[jj] = acc;
    m = fmaxf(m, acc);
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  float sum = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    s[jj] = expf(s[jj] - m);
    sum += s[jj];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
    ps[i * (kN + 1) + j0 + jj] = round_to(s[jj] / sum, base);
  __syncwarp();

  float* orow = out + ((size_t)g * kN + i) * C + (size_t)h * hd;
  const float* pr = ps + i * (kN + 1);
  for (int c = lane & 1; c < hd; c += 2) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) acc = fmaf(pr[j], vs[j * ld + c], acc);
    orow[c] = acc;
  }
}

template <typename T>
int launch(const void* qkv, const float* bias, const float* mask, int n_mask,
           float* out, int G, int nh, int hd, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats_per_warp(hd) * kWarps * sizeof(float);
  const long long pairs = (long long)G * nh;
  const long long blocks = (pairs + kWarps - 1) / kWarps;
  window_attention_kernel<T><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), bias, mask, n_mask, out, G, nh, hd, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv (G, 16, 3C) f32 or bf16, bias (nh, 16, 16) f32, mask (n_mask, 16, 16)
// f32 or null, out (G, 16, C) f32; all contiguous on the current device.
// Returns the CUDA error of the launch (0 = none).
int esc_window_attention(const void* qkv, int qkv_is_bf16, const float* bias,
                         const float* mask, int n_mask, float* out, int G,
                         int nh, int hd, float scale, void* stream) {
  if (G <= 0) return cudaSuccess;
  if (hd < 1 || hd > kMaxHeadDim || nh < 1 || (mask && n_mask < 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return qkv_is_bf16
      ? launch<__nv_bfloat16>(qkv, bias, mask, n_mask, out, G, nh, hd, scale, s)
      : launch<float>(qkv, bias, mask, n_mask, out, G, nh, hd, scale, s);
}

}  // extern "C"
