// f32 matmul (out = A @ B) and the fused LU trailing update (out = C - A @
// B), both in 3xTF32 on the tensor cores: the shared body of tf32_gemm.cuh
// (TMA ring, A split in registers, B split and transposed in shared
// memory, m64n128k8 wgmma, each K step promoted into an f32 sum on the
// CUDA cores), walking one leg A @ B.
//
// Replaces: repro/kernels/matmul.py, matmul_pallas (_matmul_kernel) and
// schur_update_pallas (_schur_kernel).
//
// Bound on the H100: operations for the matmul.  A 2048^3 product is 17.2
// GFLOP against 50 MB of operands: 0.035 ms at the 495 TFLOP/s dense TF32
// peak (0.104 ms for the three passes), 15 us at 3.35 TB/s.  The Schur
// update at the LU's K = nb = 128 is bound by bytes: C, A and B read once
// and the result written once, 2 * 128 flops per 8 bytes of C moved, far
// below the TF32 ridge (~150 flops a byte).  Its epilogue reads C with
// guarded loads in the accumulator's fragment layout and writes C - A @ B,
// so C crosses HBM once each way, the round trip the fused TPU kernel saves
// over matmul-then-subtract; the CTA starts its C tile toward L2 as it
// begins, so that read overlaps the K walk.
#include "tf32_gemm.cuh"

namespace {

using namespace repro::tf32_gemm;

__global__ void __launch_bounds__(kThreads, 1)
matmul_kernel(const __grid_constant__ CUtensorMap a_map,
              const __grid_constant__ CUtensorMap b_map,
              float* __restrict__ out, int M, int N, int K) {
  const Leg legs[1] = {{&a_map, &b_map, 1.f}};
  gemm_tile(legs, M, N, K, [=](int row, int col, float x, float y) {
    *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) = make_float2(x, y);
  });
}

__global__ void __launch_bounds__(kThreads, 1)
schur_kernel(const __grid_constant__ CUtensorMap a_map,
             const __grid_constant__ CUtensorMap b_map,
             const float* __restrict__ c, float* __restrict__ out, int M, int N,
             int K) {
  // C is read by the epilogue alone: its tile is started toward L2 now, so
  // that read overlaps the K walk (4 lines of 128 bytes per row)
  for (int l = threadIdx.x; l < kBM * 4; l += kThreads) {
    const int row = blockIdx.y * kBM + l / 4, col = blockIdx.x * kBN + 32 * (l % 4);
    if (row < M && col < N) prefetch_l2(c + static_cast<size_t>(row) * N + col);
  }
  const Leg legs[1] = {{&a_map, &b_map, 1.f}};
  gemm_tile(legs, M, N, K, [=](int row, int col, float x, float y) {
    const size_t o = static_cast<size_t>(row) * N + col;
    const float2 cv = __ldg(reinterpret_cast<const float2*>(c + o));
    *reinterpret_cast<float2*>(out + o) = make_float2(cv.x - x, cv.y - y);
  });
}

}  // namespace

extern "C" int repro_matmul(const void* a, const void* b, void* out, int M,
                            int N, int K, void* stream) {
  if (!valid(M, N, K, {a, b, out})) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0) {
    cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(M) * N, s);
    return cudaGetLastError();
  }
  CUtensorMap a_map, b_map;
  cudaError_t err = make_a_map(&a_map, a, M, K);
  if (err == cudaSuccess) err = make_b_map(&b_map, b, K, N);
  if (err != cudaSuccess) return err;
  static const cudaError_t smem_err = allow_smem(matmul_kernel, kSmem);
  if (smem_err != cudaSuccess) return smem_err;
  matmul_kernel<<<grid(M, N), kThreads, kSmem, s>>>(
      a_map, b_map, static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}

extern "C" int repro_schur_update(const void* c, const void* a, const void* b,
                                  void* out, int M, int N, int K,
                                  void* stream) {
  if (!valid(M, N, K, {c, a, b, out})) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0) {
    cudaMemcpyAsync(out, c, sizeof(float) * static_cast<size_t>(M) * N,
                    cudaMemcpyDeviceToDevice, s);
    return cudaGetLastError();
  }
  CUtensorMap a_map, b_map;
  cudaError_t err = make_a_map(&a_map, a, M, K);
  if (err == cudaSuccess) err = make_b_map(&b_map, b, K, N);
  if (err != cudaSuccess) return err;
  static const cudaError_t smem_err = allow_smem(schur_kernel, kSmem);
  if (smem_err != cudaSuccess) return smem_err;
  schur_kernel<<<grid(M, N), kThreads, kSmem, s>>>(
      a_map, b_map, static_cast<const float*>(c), static_cast<float*>(out), M, N, K);
  return cudaGetLastError();
}
