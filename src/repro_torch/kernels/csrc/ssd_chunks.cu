// Mamba-2 SSD chunk terms: the intra-chunk output, the chunk's final state,
// the cumulative decay and the chunk total, per (batch, chunk, head).
//
// Replaces: repro/kernels/ssd.py, ssd_chunks_pallas (_ssd_chunk_kernel).
//
// Semantics, for batch b, chunk c of L steps (positions s0 = c * L ..) and
// head h, with a_cum = cumsum(a[h] * dt) over the chunk and a_tot its last
// entry:
//   y[i, p]      = sum_{j <= i} (C_i . B_j) * exp(a_cum[i] - a_cum[j])
//                                * dt[j] * x[j, p]
//   state[n, p]  = sum_j (B[j, n] * dt[j] * exp(a_tot - a_cum[j])) * x[j, p]
//   cumdecay[i]  = exp(a_cum[i]),   total = exp(a_tot)
// B and C (B, S, N) are one group shared by every head.  x, B and C are
// f32 or bf16; dt and a f32; every sum and every output is f32.  The exp
// is taken only where i >= j (above the diagonal the difference is
// positive and may overflow), of the difference of the cumulative sums,
// as the TPU kernel does.  Zero-padded steps (dt = 0) need no special
// case: their decay is 1 and their update 0.
//
// Bound on the H100: bytes, counting the TPU kernel's work.  At mamba2's
// prefill (B = 1, S = 512, H = 80, P = 64, N = 128, L = 128) the call
// moves ~27 MB (x in, y and the states out), 0.008 ms at 3.35 TB/s,
// against 2.7 GFLOP of products as the TPU kernel counts them (C B^T per
// head): 0.0027 ms on the bf16 tensor cores.  This first kernel does its
// products on the CUDA cores in f32 (67 TFLOP/s peak), so it sits far
// above either bound; wgmma tiles are later work.
//
// Design: one CTA of 256 threads (a 16 x 16 grid) per (b, chunk, tile of
// heads).  B and C are the same for every head, so the CTA stages them
// once (transposed, f32, rows padded by one float so the transposed
// writes do not collide on a bank) and forms G = C B^T (L x L) once in
// shared memory, where the TPU grid (B, H, NC) recomputes it per head.
// The tile size is chosen by the wrapper so that the grid is one wave of
// CTAs (one fits on an SM: ~227 KB of shared memory at L = N = 128,
// P = 64).  Per head, warp 0 scans a * dt with shuffles (4 steps a lane);
// the CTA stages the x tile, writes the decay-weighted W^T = (G o Lambda o
// dt_j)^T, then every thread accumulates register micro-tiles of
// y = W x (8 rows x 4 columns) and of the state (8 x 4).  L <= 128 is
// taken at run time and need not be a power of two (a 97-token prompt
// runs L = 97); rows past L are masked.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kGrid = 16;  // threads form a kGrid x kGrid grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kMaxL = 128;
constexpr int kMaxN = 128;
constexpr int kMaxP = 64;
constexpr int kRows = kMaxL / kGrid;   // G / y rows per thread
constexpr int kSRows = kMaxN / kGrid;  // state rows per thread
constexpr int kPCols = kMaxP / kGrid;  // y / state columns per thread

size_t smem_floats(int L, int N, int P) {
  const int Lp = L + 1;
  return static_cast<size_t>(L) * L + std::max(L * L, N * Lp) + N * Lp +
         L * P + 3 * L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunks_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, float* __restrict__ y,
                  float* __restrict__ states, float* __restrict__ cumdecay,
                  float* __restrict__ totals, long long x_bs, long long x_ss,
                  long long b_bs, long long b_ss, long long c_bs,
                  long long c_ss, int S, int H, int P, int N, int L, int HT) {
  extern __shared__ float smem[];
  const int Lp = L + 1;
  float* gt = smem;                     // G^T: gt[j * L + i] = C_i . B_j
  float* wt = gt + L * L;               // W^T: wt[j * L + i]
  float* ct = wt;                       // C^T: ct[n * Lp + i] (before W)
  float* bt = wt + max(L * L, N * Lp);  // B^T: bt[n * Lp + j]
  float* xs = bt + N * Lp;              // x tile: xs[j * P + p]
  float* acum = xs + L * P;
  float* dts = acum + L;
  float* sw = dts + L;

  const int c = blockIdx.y;
  const int b = blockIdx.z;
  const int NC = S / L;
  const int s0 = c * L;
  const int tid = threadIdx.x;
  const int ti = tid % kGrid;
  const int tj = tid / kGrid;

  // stage B^T and C^T (n fastest across threads: coalesced global reads)
  const T* bb = bm + b * b_bs + s0 * b_ss;
  const T* cb = cm + b * c_bs + s0 * c_ss;
  for (int idx = tid; idx < L * N; idx += kThreads) {
    const int j = idx / N;
    const int n = idx % N;
    bt[n * Lp + j] = repro::to_float(bb[j * b_ss + n]);
    ct[n * Lp + j] = repro::to_float(cb[j * c_ss + n]);
  }
  __syncthreads();

  // G^T[j][i] = sum_n C[i][n] B[j][n]; thread (ti, tj) owns rows
  // i = ti + 16 r and columns j = tj + 16 q
  {
    float acc[kRows][kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[r][q] = 0.f;
    }
    for (int n = 0; n < N; ++n) {
      float cv[kRows];
      float bv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = ti + kGrid * r;
        cv[r] = i < L ? ct[n * Lp + i] : 0.f;
        const int j = tj + kGrid * r;
        bv[r] = j < L ? bt[n * Lp + j] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < kRows; ++q) acc[r][q] += cv[r] * bv[q];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = ti + kGrid * r;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int j = tj + kGrid * q;
        if (i < L && j < L) gt[j * L + i] = acc[r][q];
      }
    }
  }
  __syncthreads();  // C^T is consumed: its room becomes W^T

  const int h_end = min(H, (blockIdx.x + 1) * HT);
  for (int h = blockIdx.x * HT; h < h_end; ++h) {
    if (tid < 32) {  // a_cum: warp 0, 4 consecutive steps a lane
      const float ah = a[h];
      float seg[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * tid + k;
        float v = 0.f;
        if (j < L) {
          const float d = dt[(static_cast<size_t>(b) * S + s0 + j) * H + h];
          dts[j] = d;
          v = ah * d;
        }
        run += v;
        seg[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      const float off = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * tid + k;
        if (j < L) acum[j] = off + seg[k];
      }
    }
    const T* xb = x + b * x_bs + s0 * x_ss + static_cast<long long>(h) * P;
    for (int idx = tid; idx < L * P; idx += kThreads) {
      xs[idx] = repro::to_float(xb[(idx / P) * x_ss + idx % P]);
    }
    __syncthreads();

    const float atot = acum[L - 1];
    for (int j = tid; j < L; j += kThreads) {
      sw[j] = dts[j] * expf(atot - acum[j]);
      cumdecay[(static_cast<size_t>(b) * S + s0 + j) * H + h] = expf(acum[j]);
    }
    if (tid == 0) totals[(static_cast<size_t>(b) * NC + c) * H + h] = expf(atot);
    for (int idx = tid; idx < L * L; idx += kThreads) {
      const int j = idx / L;
      const int i = idx % L;
      wt[idx] = i >= j ? gt[idx] * expf(acum[i] - acum[j]) * dts[j] : 0.f;
    }
    __syncthreads();

    // y = W x: rows i = tj + 16 r, columns p = ti + 16 q
    {
      float acc[kRows][kPCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < kPCols; ++q) acc[r][q] = 0.f;
      }
      for (int j = 0; j < L; ++j) {
        float wv[kRows];
        float xv[kPCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = tj + kGrid * r;
          wv[r] = i < L ? wt[j * L + i] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = ti + kGrid * q;
          xv[q] = p < P ? xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int q = 0; q < kPCols; ++q) acc[r][q] += wv[r] * xv[q];
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = tj + kGrid * r;
        if (i >= L) continue;
        float* yrow = y + ((static_cast<size_t>(b) * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = ti + kGrid * q;
          if (p < P) yrow[p] = acc[r][q];
        }
      }
    }

    // state = (B o sw)^T x: rows n = tj + 16 r, columns p = ti + 16 q
    {
      float acc[kSRows][kPCols];
#pragma unroll
      for (int r = 0; r < kSRows; ++r) {
#pragma unroll
        for (int q = 0; q < kPCols; ++q) acc[r][q] = 0.f;
      }
      for (int j = 0; j < L; ++j) {
        const float s = sw[j];
        float bv[kSRows];
        float xv[kPCols];
#pragma unroll
        for (int r = 0; r < kSRows; ++r) {
          const int n = tj + kGrid * r;
          bv[r] = n < N ? bt[n * Lp + j] * s : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = ti + kGrid * q;
          xv[q] = p < P ? xs[j * P + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kSRows; ++r) {
#pragma unroll
          for (int q = 0; q < kPCols; ++q) acc[r][q] += bv[r] * xv[q];
        }
      }
      float* sb = states + (static_cast<size_t>(b) * NC + c) * H * N * P +
                  static_cast<size_t>(h) * N * P;
#pragma unroll
      for (int r = 0; r < kSRows; ++r) {
        const int n = tj + kGrid * r;
        if (n >= N) continue;
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = ti + kGrid * q;
          if (p < P) sb[n * P + p] = acc[r][q];
        }
      }
    }
    __syncthreads();  // the next head overwrites xs, W^T and the vectors
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, void* y, void* states,
                   void* cumdecay, void* totals, long long x_bs,
                   long long x_ss, long long b_bs, long long b_ss,
                   long long c_bs, long long c_ss, int B, int S, int H, int P,
                   int N, int L, int HT, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(L, N, P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunks_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((H + HT - 1) / HT, S / L, B);
  ssd_chunks_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(cumdecay),
      static_cast<float*>(totals), x_bs, x_ss, b_bs, b_ss, c_bs, c_ss, S, H,
      P, N, L, HT);
  return cudaSuccess;
}

}  // namespace

extern "C" int repro_ssd_chunks(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, void* y, void* states, void* cumdecay, void* totals,
    long long x_bs, long long x_ss, long long b_bs, long long b_ss,
    long long c_bs, long long c_ss, int B, int S, int H, int P, int N, int L,
    int HT, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || HT <= 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN || L <= 0 || L > kMaxL || S % L) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32) {
    err = launch<float>(x, dt, a, bm, cm, y, states, cumdecay, totals, x_bs,
                        x_ss, b_bs, b_ss, c_bs, c_ss, B, S, H, P, N, L, HT, s);
  } else if (dtype == repro::kBFloat16) {
    err = launch<__nv_bfloat16>(x, dt, a, bm, cm, y, states, cumdecay, totals,
                                x_bs, x_ss, b_bs, b_ss, c_bs, c_ss, B, S, H, P,
                                N, L, HT, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
