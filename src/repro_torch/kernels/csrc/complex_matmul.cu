// Complex matmul (Ar + i Ai) @ (Br + i Bi) as four real products into two
// f32 accumulators: out_r = Ar Br - Ai Bi, out_i = Ar Bi + Ai Br.  One stage
// of the matmul-DFT 2-D FFT (kernels/fft.py chains two).
//
// Replaces: repro/kernels/fft.py, complex_matmul_pallas (_cmm_kernel),
// reached through fft2d_pallas.
//
// Bound on the H100: operations.  One 2048^3 stage is 4 * 2 * 2048^3 =
// 68.7 GFLOP (1.03 ms at the 67 TFLOP/s f32 peak) against 4 input and 2
// output planes of 16 MB (29 us at 3.35 TB/s).  The GEMM body (gemm.cuh)
// stages the real and imaginary planes of A and B side by side in shared
// memory, so each loaded value feeds 16 FMAs of the two 8 x 8 accumulator
// micro-tiles; the planes never meet a complex type, as on the TPU.
#include "gemm.cuh"

namespace {

using namespace repro::gemm;

__global__ void __launch_bounds__(kThreads)
complex_matmul_kernel(Operands<2> op, float* __restrict__ out_r,
                      float* __restrict__ out_i) {
  __shared__ __align__(16) Stage<2> st[2];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc_r[8][8], acc_i[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;
  k_loop<2>(op, st, m0, n0, [&](Stage<2>& s, int k, int ty_, int tx_) {
    float ar[8], ai[8], br[8], bi[8];
    frag(s.a[0][k], ty_, ar);
    frag(s.a[1][k], ty_, ai);
    frag(s.b[0][k], tx_, br);
    frag(s.b[1][k], tx_, bi);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc_r[i][j] = fmaf(ar[i], br[j], acc_r[i][j]);
        acc_r[i][j] = fmaf(-ai[i], bi[j], acc_r[i][j]);
        acc_i[i][j] = fmaf(ar[i], bi[j], acc_i[i][j]);
        acc_i[i][j] = fmaf(ai[i], br[j], acc_i[i][j]);
      }
  });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_index(ty, i);
    if (gm >= op.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tile_index(tx, j);
      if (gn < op.N) {
        const size_t o = static_cast<size_t>(gm) * op.N + gn;
        out_r[o] = acc_r[i][j];
        out_i[o] = acc_i[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int repro_complex_matmul(const void* ar, const void* ai,
                                    const void* br, const void* bi,
                                    void* out_r, void* out_i, int M, int N,
                                    int K, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  Operands<2> op;
  op.a[0] = static_cast<const float*>(ar);
  op.a[1] = static_cast<const float*>(ai);
  op.b[0] = static_cast<const float*>(br);
  op.b[1] = static_cast<const float*>(bi);
  op.M = M;
  op.N = N;
  op.K = K;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  complex_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<float*>(out_r), static_cast<float*>(out_i));
  return cudaGetLastError();
}
