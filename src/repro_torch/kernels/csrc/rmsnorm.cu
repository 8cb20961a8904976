// RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, per row, in f32.
//
// Replaces: repro/kernels/rmsnorm.py, rmsnorm_pallas (_rmsnorm_kernel).
//
// Bound on the H100: bytes.  The work is one read and one write of the
// activation (plus the (d,) weight, which stays in L2): 2 * rows * d *
// sizeof(T) bytes against ~3 flops per element.  At decode (8 rows of
// d = 2048) that is 64 KB, under a microsecond at 3.35 TB/s, so the kernel
// is pure launch latency there; at prefill (hundreds of rows) it is a
// bandwidth kernel.
//
// Design: one CTA of 256 threads per row.  The sum of squares is reduced
// in f32 (warp shuffles, then one shared-memory pass across the 8 warps);
// the second pass re-reads the row (from L1/L2, it was just read) and
// writes x * inv * w cast to T.  No block-level carry exists, so rows run
// fully in parallel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* outr = out + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::to_float(xr[i]);
    ss += v * v;
  }
  ss = repro::warp_sum(ss);
  __shared__ float partial[kThreads / 32];
  __shared__ float inv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? partial[lane] : 0.f;
    v = repro::warp_sum(v);
    if (lane == 0) inv = rsqrtf(v / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::to_float(xr[i]);
    outr[i] = repro::from_float<T>(v * r * w[i]);
  }
}

template <typename T>
void launch(const void* x, const void* w, void* out, int rows, int d,
            float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), d, eps);
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             int rows, int d, float eps, int dtype,
                             void* stream) {
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) {
    launch<float>(x, w, out, rows, d, eps, s);
  } else if (dtype == repro::kBFloat16) {
    launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
