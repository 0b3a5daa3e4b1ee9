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
// there, vq_kernels.py:45-53). The TPU kernel's 256-row tiles and the
// padding of d to 128 lanes are TPU layout only and are not carried over.
//
// What bounds it on an H100: at the codec's shapes (K = 1024, d = 6..32,
// N = a few hundred to a few thousand rows per call) the work is
// 2*N*K*d flops (10-80 MFLOP) and the bytes are (N*d + K*d + N)*4
// (0.1 MB): both bounds are about a microsecond, so launch latency and the
// copy of the codebook into shared memory in every block bound the kernel.
//
// Design: each block stages the codebook transposed (d rows of K, so the
// 32 lanes of a warp read 32 consecutive codewords with no bank conflict)
// and |c_k|^2 in shared memory once. Each warp then takes one query row at
// a time: a lane scans the codewords k = lane, lane + 32, ... with fp32 FMA
// on the CUDA cores (no tensor cores and no TF32, which would move codes)
// and keeps its first minimum; a shuffle reduction over the warp keeps the
// lexicographically least (distance, index) pair. The grid is capped so
// that few blocks re-stage the codebook when N is large.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBlocks = 264;  // two blocks per SM of an H100

__global__ void __launch_bounds__(kThreads)
codebook_argmin_kernel(const float* __restrict__ z,
                       const float* __restrict__ cb,
                       int32_t* __restrict__ out, int n, int k, int d) {
  extern __shared__ float smem[];
  float* cbt = smem;                        // (d, k) transposed codebook
  float* csq = cbt + (size_t)d * k;         // (k,)   |c_k|^2
  float* zs = csq + k;                      // (kWarps, d) query rows

  for (int i = threadIdx.x; i < k * d; i += blockDim.x) {
    const int row = i / d, col = i - row * d;
    cbt[(size_t)col * k + row] = cb[i];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < d; ++c) {
      const float v = cbt[(size_t)c * k + r];
      s = fmaf(v, v, s);
    }
    csq[r] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* zw = zs + warp * d;
  for (int row = blockIdx.x * kWarps + warp; row < n;
       row += gridDim.x * kWarps) {
    for (int c = lane; c < d; c += 32) zw[c] = z[(size_t)row * d + c];
    __syncwarp();
    float zsq = 0.f;
    for (int c = 0; c < d; ++c) zsq = fmaf(zw[c], zw[c], zsq);

    float best = INFINITY;
    int best_idx = k;  // k = "no candidate yet"
    bool saw_nan = false;
    for (int j = lane; j < k; j += 32) {
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot = fmaf(zw[c], cbt[(size_t)c * k + j], dot);
      const float dist = (zsq - 2.f * dot) + csq[j];
      if (isnan(dist)) {
        saw_nan = true;
      } else if (best_idx == k || dist < best) {
        best = dist;
        best_idx = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_idx, off);
      const bool take = oi != k &&
          (best_idx == k || ob < best || (ob == best && oi < best_idx));
      if (take) {
        best = ob;
        best_idx = oi;
      }
    }
    saw_nan = __any_sync(0xffffffffu, saw_nan);
    if (lane == 0) out[row] = (saw_nan || best_idx == k) ? 0 : best_idx;
    __syncwarp();  // zw is rewritten for the next row
  }
}

// Shared memory one block needs for a (K, d) codebook.
size_t smem_bytes(int k, int d) {
  return ((size_t)d * k + k + (size_t)kWarps * d) * sizeof(float);
}

}  // namespace

extern "C" {

// z (n, d) f32, cb (k, d) f32, out (n,) int32, all contiguous on the
// current device. Returns the CUDA error of the launch (0 = none); a
// codebook too large for shared memory is refused as an invalid value.
int esc_codebook_argmin(const float* z, const float* cb, int32_t* out, int n,
                        int k, int d, void* stream) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = smem_bytes(k, d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        codebook_argmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = (n + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  codebook_argmin_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      z, cb, out, n, k, d);
  return cudaGetLastError();
}

const char* esc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
