// Blocked f32 matmul (out = A @ B) and the fused LU trailing update
// (out = C - A @ B), one GEMM body (gemm.cuh) whose accumulators start at 0
// or at C.
//
// Replaces: repro/kernels/matmul.py, matmul_pallas (_matmul_kernel) and
// schur_update_pallas (_schur_kernel).
//
// Bound on the H100: operations.  A 2048^3 product is 17.2 GFLOP against
// 50 MB of operands (0.26 ms at the 67 TFLOP/s f32 peak vs 15 us at
// 3.35 TB/s); the LU's trailing updates (c (n-kb-nb)^2, K = nb = 128) do
// 2*128 flops per 12 bytes of C moved, also above the f32 ridge.  So the
// design keeps every loaded value in registers for 8 FMAs (8 x 8 micro-
// tiles) and double-buffers the tiles in shared memory; the Schur form
// reads C once into the accumulators and writes the result once, which is
// the HBM round trip of C the fused TPU kernel saves too.
#include "gemm.cuh"

namespace {

using namespace repro::gemm;

template <bool kSubtract>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(Operands<1> op, const float* __restrict__ c, float* __restrict__ out) {
  __shared__ __align__(16) Stage<1> st[2];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_index(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tile_index(tx, j);
      acc[i][j] = (kSubtract && gm < op.M && gn < op.N)
                      ? c[static_cast<size_t>(gm) * op.N + gn] : 0.f;
    }
  }
  k_loop<1>(op, st, m0, n0, [&](Stage<1>& s, int k, int ty_, int tx_) {
    float a[8], b[8];
    frag(s.a[0][k], ty_, a);
    frag(s.b[0][k], tx_, b);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = kSubtract ? fmaf(-a[i], b[j], acc[i][j])
                              : fmaf(a[i], b[j], acc[i][j]);
  });
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + tile_index(ty, i);
    if (gm >= op.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tile_index(tx, j);
      if (gn < op.N) out[static_cast<size_t>(gm) * op.N + gn] = acc[i][j];
    }
  }
}

template <bool kSubtract>
int launch(const void* c, const void* a, const void* b, void* out, int M,
           int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return cudaErrorInvalidValue;
  Operands<1> op;
  op.a[0] = static_cast<const float*>(a);
  op.b[0] = static_cast<const float*>(b);
  op.M = M;
  op.N = N;
  op.K = K;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<kSubtract><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const float*>(c), static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_matmul(const void* a, const void* b, void* out, int M,
                            int N, int K, void* stream) {
  return launch<false>(nullptr, a, b, out, M, N, K, stream);
}

extern "C" int repro_schur_update(const void* c, const void* a, const void* b,
                                  void* out, int M, int N, int K,
                                  void* stream) {
  return launch<true>(c, a, b, out, M, N, K, stream);
}
