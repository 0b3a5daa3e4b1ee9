// The snake activation of the DAC, y = x + sin^2(alpha x) / (alpha + 1e-9),
// over a contiguous (B, C, T) fp32 array with one alpha a channel, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: esc_tpu/baselines/dac/layers.py:20 writes snake as
// jnp expressions and leaves them to XLA, which fuses them into one pass on
// the TPU. The port's expression went to ATen, which runs it as five
// elementwise kernels (a product, sin, a square, a quotient and a sum), each
// reading and writing whole (B, C, T) arrays: about 44 bytes an element
// where one pass needs 8. The DAC's 58 snakes a roundtrip of 16 clips of 3 s
// touch 2.33 G elements, so ATen took about a quarter of its device time.
// This kernel is the DAC's inference snake; training and plain_ops keep the
// expression, with its backward.
//
// For every element, in fp32 and in ATen's order of operations:
//
//     s = sinf(alpha[c] * x)
//     y = x + (s * s) / (alpha[c] + 1e-9f)
//
// each product, quotient and sum rounded once (__fmul_rn, __fdiv_rn,
// __fadd_rn: IEEE, never contracted into an FMA), and sinf the CUDA math
// library's, as ATen's sin kernel calls it: the output is ATen's, bit for
// bit. 1e-9f is the float nearest to the double 1e-9, which ATen rounds the
// Python scalar to.
//
// What bounds it on an H100: each element is read once and written once (8
// bytes) for a few dozen instructions (sinf's range reduction and
// polynomial, the IEEE quotient's reciprocal and corrections, the channel's
// index), under the card's instruction rate per byte of memory: bytes bound
// it, 4 (2 B C T + C) / 3.35 TB/s a call. So the design keeps every byte of
// HBM traffic a full 16-byte access and enough bytes in flight on every SM:
//
// - The array is one flat stream of n = B C T floats, whatever T is: the
//   cell's rows (T = 47,992, 23,996, 5,999, 150, ...) are no multiple of 4
//   floats, so a row-by-row walk would split into unaligned heads and tails;
//   the flat stream splits once. Its first `head` floats (up to the first
//   16-byte boundary) and its last < 4 go one at a time; the body goes as
//   float4s, cut into `per_block` consecutive float4s a block (a multiple of
//   8 float4s: 128-byte lines), so that every block streams the same amount.
// - A thread loads kUnroll float4s, kThreads apart, before it computes any:
//   1024 threads an SM keep 64 KB of loads in flight, where about 20 KB an
//   SM sustain 3.35 TB/s at a microsecond's latency. (On an H100, 700 W,
//   the DAC cell's 58 calls took 7.28-8.35 ms by events with 128-512
//   threads a block, 2-8 float4s a thread and 2-8 blocks an SM, 9.52 ms
//   where 8 blocks of 256 forced spills; this plan 7.39 ms.)
// - The channel of element i is (i / T) mod C, by two multiply-high
//   divisions with precomputed magic numbers (valid below 2^31); a float4
//   takes its first element's alpha (a read-only load, the C alphas stay in
//   L1) and looks again only for the elements past its row's end.
// - The grid is at most as many blocks as the card holds at once
//   (__launch_bounds__ keeps kMinBlocks blocks of kThreads an SM); each
//   block streams its own span.
// - x and y must agree modulo 16 bytes for the float4 body; where they do
//   not (x a view 4 bytes past an allocation), every element goes alone.
//
// The launch plan (esc_tpu_torch/ops/kernels/snake.py::launch_plan) is
// computed by the wrapper and checked here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMinBlocks = 4;  // blocks an SM, by __launch_bounds__
constexpr uint32_t kLine = 8;  // float4s of a 128-byte line

// n / d = (umulhi(n, mul) + n) >> shift for 0 <= n < 2^31 and 1 <= d < 2^31
// (Granlund and Montgomery; the magic numbers of PyTorch's IntDivider)
struct Divider {
  uint32_t mul, shift;
};

Divider make_divider(uint32_t d) {
  uint32_t shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const uint64_t mul = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return {(uint32_t)mul, shift};
}

__device__ __forceinline__ uint32_t quotient(uint32_t n, Divider d) {
  return (__umulhi(n, d.mul) + n) >> d.shift;
}

// alpha of flat element i: channel (i / T) mod C
__device__ __forceinline__ float alpha_of(const float* __restrict__ alpha,
                                          uint32_t i, Divider by_t,
                                          uint32_t C, Divider by_c) {
  const uint32_t r = quotient(i, by_t);
  return __ldg(alpha + (r - quotient(r, by_c) * C));
}

__device__ __forceinline__ float snake1(float v, float a) {
  const float s = sinf(__fmul_rn(a, v));
  return __fadd_rn(v, __fdiv_rn(__fmul_rn(s, s), __fadd_rn(a, 1e-9f)));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
             float* __restrict__ y, uint32_t n, uint32_t T, uint32_t C,
             Divider by_t, Divider by_c, uint32_t per_block) {
  const uint32_t mis = (uint32_t)(reinterpret_cast<uintptr_t>(x) >> 2) & 3;
  if (mis != ((uint32_t)(reinterpret_cast<uintptr_t>(y) >> 2) & 3)) {
    // x and y disagree modulo 16 bytes: one element at a time
    for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += gridDim.x * kThreads)
      y[i] = snake1(x[i], alpha_of(alpha, i, by_t, C, by_c));
    return;
  }
  const uint32_t head = min(n, (4 - mis) & 3);
  const uint32_t n4 = (n - head) >> 2;
  const uint32_t tail = head + 4 * n4;
  if (blockIdx.x == 0) {
    const uint32_t t = threadIdx.x;
    if (t < head) y[t] = snake1(x[t], alpha_of(alpha, t, by_t, C, by_c));
    if (t >= 32 && t - 32 < n - tail) {
      const uint32_t i = tail + t - 32;
      y[i] = snake1(x[i], alpha_of(alpha, i, by_t, C, by_c));
    }
  }

  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x + head);
  float4* __restrict__ y4 = reinterpret_cast<float4*>(y + head);
  const uint32_t start = blockIdx.x * per_block;
  const uint32_t end = min(start + per_block, n4);
  for (uint32_t q0 = start + threadIdx.x; q0 < end;
       q0 += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t q = q0 + u * kThreads;
      if (q < end) v[u] = __ldcs(x4 + q);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t q = q0 + u * kThreads;
      if (q >= end) continue;
      const uint32_t i = head + 4 * q;
      const uint32_t r = quotient(i, by_t);
      const uint32_t e = i - r * T;  // i's place in its row
      const float a = __ldg(alpha + (r - quotient(r, by_c) * C));
      float a1 = a, a2 = a, a3 = a;
      if (e + 3 >= T) {  // the float4 runs past its row's end
        if (e + 1 >= T) a1 = alpha_of(alpha, i + 1, by_t, C, by_c);
        if (e + 2 >= T) a2 = alpha_of(alpha, i + 2, by_t, C, by_c);
        a3 = alpha_of(alpha, i + 3, by_t, C, by_c);
      }
      float4 o;
      o.x = snake1(v[u].x, a);
      o.y = snake1(v[u].y, a1);
      o.z = snake1(v[u].z, a2);
      o.w = snake1(v[u].w, a3);
      y4[q] = o;
    }
  }
}

}  // namespace

extern "C" {

// x, y (B, C, T) f32, contiguous, on the current device; alpha (C,) f32.
// plan holds n = B C T, T, C, the launch plan (threads a block, float4s a
// thread a round, blocks, float4s a block) and the magic numbers of the
// divisions by T and by C, computed by the wrapper
// (esc_tpu_torch/ops/kernels/snake.py::launch_plan and ::divider) and
// checked here. Returns the CUDA error of the launch (0 = none); a plan
// that does not fit is refused as an invalid value.
int esc_snake(const float* x, const float* alpha, float* y,
              const uint32_t* plan, void* stream) {
  const uint32_t n = plan[0], T = plan[1], C = plan[2], threads = plan[3],
                 unroll = plan[4], grid = plan[5], per_block = plan[6];
  const Divider by_t{plan[7], plan[8]}, by_c{plan[9], plan[10]};
  if (n == 0) return cudaSuccess;
  const uint64_t work = n / 4 > 0 ? n / 4 : 1;
  bool ok = n < (1u << 31) && T >= 1 && C >= 1 && n % T == 0 &&
            (n / T) % C == 0 && threads == (uint32_t)kThreads &&
            unroll == (uint32_t)kUnroll && grid >= 1 && grid < (1u << 31) &&
            per_block >= kLine && per_block % kLine == 0 &&
            (uint64_t)(grid - 1) * per_block < work &&
            (uint64_t)grid * per_block >= work &&
            reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(y) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(alpha) % 4 == 0;
  if (ok) {
    const Divider t = make_divider(T), c = make_divider(C);
    ok = t.mul == by_t.mul && t.shift == by_t.shift && c.mul == by_c.mul &&
         c.shift == by_c.shift;
  }
  if (!ok) return cudaErrorInvalidValue;
  snake_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, alpha, y, n, T, C, by_t, by_c, per_block);
  return cudaGetLastError();
}

}  // extern "C"
