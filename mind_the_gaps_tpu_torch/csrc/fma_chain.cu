// Latency probe: chains of dependent multiply-adds, one chain a thread.
//
// Replaces the Pallas probe `make` of benchmarks/experiments/sublane_probe.py
// (line 29), which ran the same recurrence on a TPU to ask how Mosaic laid
// out 1-D vectors.  On Hopper the question it answers is another: how long
// one dependent float32 or float64 multiply-add takes.  That latency, not
// the card's throughput, bounds the celerite kernels, whose chains of 5000
// dependent steps run one per likelihood (celerite_loglike.cuh,
// celerite_grad.cuh).
//
// Each thread runs, on its element x,
//     a = x;  b = a * 1.000001 + 0.5;
//     iters times:  a = a * 0.999999 + b;  b = b * 1.000001 - a * 1e-7;
// and writes a + b.  Both updates are fused multiply-adds (the second takes
// b * 1.000001, which does not wait for the new a, as its addend), so the
// dependent chain is two FMAs an iteration: with one warp on each of an
// SM's schedulers, the time of an iteration is twice the FMA's latency.
// `iters` is a runtime argument, so the compiler cannot fold the loop.
// What bounds it: neither bytes (8 or 16 a thread) nor operations, but the
// latency of the chain; more warps an SM hide it until the FMA pipe is full.

#include <cuda_runtime.h>

namespace fma_chain {

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__global__ void chain_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T a = x[i];
  T b = fma_rn(a, T(1.000001), T(0.5));
  for (int k = 0; k < iters; ++k) {
    a = fma_rn(a, T(0.999999), b);
    b = fma_rn(a, T(-1e-7), b * T(1.000001));
  }
  out[i] = a + b;
}

template <typename T>
int launch(const void* x, void* out, long long n, int iters, int threads, void* stream) {
  if (n <= 0 || iters < 0 || threads < 32 || threads > 1024 || threads % 32 != 0) return -2;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 2147483647LL) return -2;
  chain_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>((const T*)x, (T*)out, n, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fma_chain

// C entry points.  x and out are device pointers to n contiguous elements;
// `threads` a block (a multiple of 32, at most 1024).  Returns 0, -2 for a
// bad size, or the cudaError_t of the launch.
extern "C" int fma_chain_f32(const void* x, void* out, long long n, int iters, int threads, void* stream) {
  return fma_chain::launch<float>(x, out, n, iters, threads, stream);
}

extern "C" int fma_chain_f64(const void* x, void* out, long long n, int iters, int threads, void* stream) {
  return fma_chain::launch<double>(x, out, n, iters, threads, stream);
}
