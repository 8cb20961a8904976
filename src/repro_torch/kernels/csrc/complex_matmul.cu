// Complex matmul (Ar + i Ai) @ (Br + i Bi) as four real products into two
// f32 output planes: out_r = Ar Br - Ai Bi, out_i = Ar Bi + Ai Br.  One
// stage of the matmul-DFT 2-D FFT (kernels/fft.py chains two).
//
// Replaces: repro/kernels/fft.py, complex_matmul_pallas (_cmm_kernel),
// reached through fft2d_pallas.
//
// Bound on the H100: operations.  One 2048^3 stage is 4 * 2 * 2048^3 =
// 68.7 GFLOP (0.139 ms at the 495 TFLOP/s dense TF32 peak, 0.416 ms for
// three passes) against 4 input and 2 output planes of 16 MB (29 us at
// 3.35 TB/s).  It runs in 3xTF32 on the tensor cores, on the body of
// tf32_gemm.cuh, in the block form [Or | Oi] = [Ar | Ai] @ [[Br, Bi],
// [-Bi, Br]]: two accumulators of a 128 x 128 tile do not fit in one CTA
// beside their per-step partials, so each CTA owns one tile of one plane
// (blockIdx.z) and walks two legs, (Ar, Br) then (Ai, -Bi) for the real
// plane and (Ar, Bi) then (Ai, Br) for the imaginary one.  The sign is
// applied as B is split; the planes never meet a complex type, as on the
// TPU.
#include "tf32_gemm.cuh"

namespace {

using namespace repro::tf32_gemm;

__global__ void __launch_bounds__(kThreads, 1)
complex_matmul_kernel(const __grid_constant__ CUtensorMap ar_map,
                      const __grid_constant__ CUtensorMap ai_map,
                      const __grid_constant__ CUtensorMap br_map,
                      const __grid_constant__ CUtensorMap bi_map,
                      float* __restrict__ out_r, float* __restrict__ out_i,
                      int M, int N, int K) {
  const bool imag = blockIdx.z;
  const Leg legs[2] = {{&ar_map, imag ? &bi_map : &br_map, 1.f},
                       {&ai_map, imag ? &br_map : &bi_map, imag ? 1.f : -1.f}};
  float* out = imag ? out_i : out_r;
  gemm_tile(legs, M, N, K, [=](int row, int col, float x, float y) {
    *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * N + col) = make_float2(x, y);
  });
}

}  // namespace

extern "C" int repro_complex_matmul(const void* ar, const void* ai,
                                    const void* br, const void* bi,
                                    void* out_r, void* out_i, int M, int N,
                                    int K, void* stream) {
  if (!valid(M, N, K, {ar, ai, br, bi, out_r, out_i})) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 0) {
    const size_t bytes = sizeof(float) * static_cast<size_t>(M) * N;
    cudaMemsetAsync(out_r, 0, bytes, s);
    cudaMemsetAsync(out_i, 0, bytes, s);
    return cudaGetLastError();
  }
  CUtensorMap ar_map, ai_map, br_map, bi_map;
  cudaError_t err = make_a_map(&ar_map, ar, M, K);
  if (err == cudaSuccess) err = make_a_map(&ai_map, ai, M, K);
  if (err == cudaSuccess) err = make_b_map(&br_map, br, K, N);
  if (err == cudaSuccess) err = make_b_map(&bi_map, bi, K, N);
  if (err != cudaSuccess) return err;
  static const cudaError_t smem_err = allow_smem(complex_matmul_kernel, kSmem);
  if (smem_err != cudaSuccess) return smem_err;
  complex_matmul_kernel<<<grid(M, N, 2), kThreads, kSmem, s>>>(
      ar_map, ai_map, br_map, bi_map, static_cast<float*>(out_r),
      static_cast<float*>(out_i), M, N, K);
  return cudaGetLastError();
}
