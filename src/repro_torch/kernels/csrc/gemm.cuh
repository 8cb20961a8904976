// One tiled f32 GEMM body on CUDA cores, shared by the Schur-update and
// complex-matmul kernels (csrc/matmul.cu, csrc/complex_matmul.cu).
//
// The TPU kernels these replace (repro/kernels/matmul.py, fft.py) walk a
// sequential (M/bm, N/bn, K/bk) grid and keep an f32 accumulator tile in
// VMEM across the K steps.  Here one CTA owns one 128 x 128 output tile and
// loops over K itself, in steps of 8, with the accumulators in registers:
// 256 threads, each an 8 x 8 micro-tile (rows {4ty..4ty+3, 64+4ty..},
// columns {4tx..4tx+3, 64+4tx..}), so every shared-memory read is a float4
// and every value read feeds 8 FMAs.  A and B tiles are staged through two
// shared-memory buffers: the next K step's global loads are issued into
// registers before the current step's FMAs, and stored to the other buffer
// after them, so one __syncthreads per step suffices.  Loads are bounds-
// checked (zero outside the matrix), so any M, N, K works; the wrappers
// enforce the reference's tiling contract on top.
//
// Products are f32 FMAs on CUDA cores: no tensor cores, so no TF32
// rounding.  The H100's f32 peak outside the tensor cores is 67 TFLOP/s.
#pragma once

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kThreads = 256;
constexpr int kLoads = kBM * kBK / kThreads;  // A (and B) elements per thread

// P planes (1 real, 2 complex) of one K step's A and B tiles
template <int P>
struct Stage {
  float a[P][kBK][kBM];  // A tile, transposed: a[p][k][m]
  float b[P][kBK][kBN];  // B tile: b[p][k][n]
};

template <int P>
struct Operands {
  const float* a[P];  // (M, K) row-major planes
  const float* b[P];  // (K, N) row-major planes
  int M, N, K;
};

// one K step's global loads, held in registers until stored to smem
template <int P>
struct Fetch {
  float a[P][kLoads];
  float b[P][kLoads];

  __device__ __forceinline__ void load(const Operands<P>& op, int m0, int n0,
                                       int k0, int tid) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
      // A: 8 consecutive k of one row per 8 threads (one 32-byte sector)
      const int ar = idx / kBK, ac = idx % kBK;
      const int gm = m0 + ar, gk = k0 + ac;
      const bool a_in = gm < op.M && gk < op.K;
      // B: 128 consecutive n of one row per 128 threads
      const int br = idx / kBN, bc = idx % kBN;
      const int bk = k0 + br, bn = n0 + bc;
      const bool b_in = bk < op.K && bn < op.N;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        a[p][i] = a_in ? op.a[p][static_cast<size_t>(gm) * op.K + gk] : 0.f;
        b[p][i] = b_in ? op.b[p][static_cast<size_t>(bk) * op.N + bn] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(Stage<P>& s, int tid) const {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * kThreads;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        s.a[p][idx % kBK][idx / kBK] = a[p][i];
        s.b[p][idx / kBN][idx % kBN] = b[p][i];
      }
    }
  }
};

// the 8 rows (or columns) of a thread's micro-tile, from one smem row
__device__ __forceinline__ void frag(const float* row, int t, float (&out)[8]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 hi = *reinterpret_cast<const float4*>(row + 64 + 4 * t);
  out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
  out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
}

// global row/column of micro-tile index i (0..7) for thread coordinate t
__device__ __forceinline__ int tile_index(int t, int i) {
  return (i < 4 ? 4 * t : 64 + 4 * t - 4) + i;
}

// Walk K for one CTA's tile.  Body(stage, k, ty, tx) does the FMAs of one
// k of the staged tile into the caller's accumulators.
template <int P, typename Body>
__device__ __forceinline__ void k_loop(const Operands<P>& op, Stage<P> (&st)[2],
                                       int m0, int n0, Body body) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int steps = (op.K + kBK - 1) / kBK;
  Fetch<P> f;
  if (steps > 0) {
    f.load(op, m0, n0, 0, tid);
    f.store(st[0], tid);
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) f.load(op, m0, n0, (s + 1) * kBK, tid);
#pragma unroll
    for (int k = 0; k < kBK; ++k) body(st[s & 1], k, ty, tx);
    if (more) f.store(st[(s + 1) & 1], tid);
    __syncthreads();
  }
}

}  // namespace gemm
}  // namespace repro
