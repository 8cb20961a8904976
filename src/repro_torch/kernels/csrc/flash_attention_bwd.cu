// Causal flash-attention backward with GQA: dq, dk, dv from (q, k, v, out,
// lse, do), the gradient of csrc/flash_attention.cu's forward.
//
// Replaces: repro/kernels/attention_xla.py, _core_bwd (the custom VJP of the
// chunked attention, :119-168).  No Pallas kernel of the reference has a
// backward; on a TPU the train step differentiates through that jnp VJP.
//
// Semantics: q (B, H, Sq, D), k (B, KH, Skv, D), v (B, KH, Skv, Dv), out and
// do (B, H, Sq, Dv), lse (B, H, Sq) f32, the row log-sum-exp of the scaled
// scores the forward wrote.  With s = scale * q . k and the forward's
// start-aligned causal mask (key j visible to query i iff j <= i):
//   p = exp(s - lse),  delta_i = sum_d do[i, d] out[i, d],
//   ds = p (do . v - delta),
//   dq = scale ds k,  dk = scale ds^T q,  dv = p^T do,
// dk and dv summed over the G = H / KH query heads of their kv head.  Every
// product accumulates in f32; outputs are cast to the inputs' type (bf16 or
// f32).  D and Dv up to 256, D != Dv allowed (MLA's qk 192 / v 128).
//
// Bound on the H100: at llama3.2-1b's train shape (B = 8, H = 32, KH = 8, S
// = 512, D = 64, bf16) the five products of the causal half take ~21.5
// GFLOP against ~84 MB of operands, so operations on the tensor cores (~0.02
// ms at 989 TFLOP/s) and bytes (~0.025 ms) are about even.  The wgmma route
// recomputes S and dP in its dq kernel: seven products, ~30 GFLOP.
//
// Two routes, the wrapper's choice (kernels/attention.py, flash_bwd_route).
// Neither uses atomics: every output is written once and every sum runs in
// a fixed order, so a call is bit for bit repeatable (the train loop's
// restart is held to the bit):
//  * bf16 with D and Dv multiples of 8, D up to 256, Dv up to 128, and
//    16-byte aligned operands (llama's, zamba2's and arctic's train shapes,
//    deepseek-v2's qk 192 / v 128): wgmma with TMA loads, three kernels
//    (the `wg` namespace below);
//  * f32 and every other shape: the CUDA cores, two kernels (the `cc`
//    namespace).
//
// CUDA cores.
//  * dk, dv: one CTA per (key block, kv head, batch).  The key block's K and
//    V tiles stay in shared memory; the CTA loops over the group's G heads
//    and, for each, over the query blocks on and below the diagonal,
//    staging each block's q, do, lse and delta (delta = rowsum(do * out) is
//    computed here, not by a separate pass).  The score and dP tiles are
//    computed, turned into P and dS in registers, written to shared memory
//    and folded into the dk and dv accumulators, which stay in registers.
//  * dq: one CTA per (query block, head, batch), walking the key blocks up
//    to the diagonal, recomputing P and dS the same way.
// A CTA is 256 threads in a 16 x 16 grid; each thread owns a (BM / 16)^2
// micro-tile of the (BM x BM) score tile (rows ty + 16a, keys tx + 16b)
// and rows ty + 16a, columns tx + 16c of its accumulator; shared-memory
// rows have an odd stride, so a warp's 16 row reads fall in 16 banks.  BM
// is 64 for head dims up to 128 and 32 above (the tiles stay within 227
// KB).  Tiles are staged in f32 whatever the element type.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads (the CUDA-core route)

struct Dims {
  int H, KH, Sq, Skv, D, Dv, causal;
  float scale;
};

namespace cc {

// an odd row stride >= n: the rows a warp reads at one column are in
// distinct banks
__host__ __device__ constexpr int odd_ld(int n) { return n | 1; }

// rows [row0, row0 + BM) of a (n_rows, width) row-major matrix into dst
// (BM x ld, f32), zeros past n_rows
template <typename T, int BM>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int row0, int n_rows,
                                      int width) {
  for (int idx = threadIdx.x; idx < BM * width; idx += kThreads) {
    const int r = idx / width, c = idx - r * width;
    dst[r * ld + c] = row0 + r < n_rows
                          ? repro::to_float(src[static_cast<size_t>(row0 + r) * width + c])
                          : 0.f;
  }
}

// a query block's lse and delta = rowsum(do * out) (do already staged)
template <typename T, int BM>
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s, const float* lse,
                                           const T* out, const float* dOs, int ldv, int row0,
                                           int Sq, int Dv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int i = row0 + r;
    float acc = 0.f;
    if (i < Sq) {
      for (int d = lane; d < Dv; d += 32) {
        acc += dOs[r * ldv + d] * repro::to_float(out[static_cast<size_t>(i) * Dv + d]);
      }
    }
    acc = repro::warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = i < Sq ? lse[i] : 0.f;
    }
  }
}

// acc[a][b] += sum_d A[ty + 16a][d] * B[tx + 16b][d]
template <int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][R], const float* A, int lda,
                                         const float* B, int ldb, int n, int ty, int tx) {
  for (int d = 0; d < n; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[r] = A[(ty + 16 * r) * lda + d];
      b[r] = B[(tx + 16 * r) * ldb + d];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// scores s -> p, dP dp -> scale * ds, for query rows i0 + ty + 16a and keys
// j0 + tx + 16b (masked entries 0)
template <int R>
__device__ __forceinline__ void probs(float (&s)[R][R], float (&dp)[R][R], const float* lse_s,
                                      const float* delta_s, int i0, int j0, int ty, int tx,
                                      const Dims& dm) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int il = ty + 16 * a, i = i0 + il;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const int j = j0 + tx + 16 * b;
      const bool valid = i < dm.Sq && j < dm.Skv && (!dm.causal || j <= i);
      const float p = valid ? expf(s[a][b] * dm.scale - lse_s[il]) : 0.f;
      s[a][b] = p;
      dp[a][b] = p * (dp[a][b] - delta_s[il]) * dm.scale;
    }
  }
}

// dk, dv: one CTA per (key block, kv head, batch); heaviest blocks first
template <typename T, int BM, int NDK, int NDV>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ out, const float* __restrict__ lse,
            const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, const Dims dm) {
  constexpr int R = BM / 16;
  extern __shared__ float smem[];
  const int ldk = odd_ld(dm.D), ldv = odd_ld(dm.Dv), ldp = BM + 16;
  float* Ks = smem;
  float* Vs = Ks + BM * ldk;
  float* Qs = Vs + BM * ldv;
  float* dOs = Qs + BM * ldk;
  float* Ps = dOs + BM * ldv;
  float* dSs = Ps + BM * ldp;
  float* lse_s = dSs + BM * ldp;
  float* delta_s = lse_s + BM;

  const int kb = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * BM, G = dm.H / dm.KH;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t kvh = static_cast<size_t>(b) * dm.KH + kh;
  stage<T, BM>(Ks, ldk, k + kvh * dm.Skv * dm.D, k0, dm.Skv, dm.D);
  stage<T, BM>(Vs, ldv, v + kvh * dm.Skv * dm.Dv, k0, dm.Skv, dm.Dv);

  float acc_k[R][NDK], acc_v[R][NDV];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int c = 0; c < NDK; ++c) acc_k[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NDV; ++c) acc_v[a][c] = 0.f;
  }
  const int nq = (dm.Sq + BM - 1) / BM;
  // causal: a query block before the key block sees none of its keys
  const int qb0 = dm.causal ? kb : 0;
  for (int hq = 0; hq < G; ++hq) {
    const size_t qh = static_cast<size_t>(b) * dm.H + kh * G + hq;
    for (int qb = qb0; qb < nq; ++qb) {
      const int q0 = qb * BM;
      __syncthreads();  // the last block's tiles are consumed
      stage<T, BM>(Qs, ldk, q + qh * dm.Sq * dm.D, q0, dm.Sq, dm.D);
      stage<T, BM>(dOs, ldv, dout + qh * dm.Sq * dm.Dv, q0, dm.Sq, dm.Dv);
      __syncthreads();
      stage_rows<T, BM>(lse_s, delta_s, lse + qh * dm.Sq, out + qh * dm.Sq * dm.Dv, dOs, ldv,
                        q0, dm.Sq, dm.Dv);
      __syncthreads();
      float s[R][R], dp[R][R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
      }
      tile_dot<R>(s, Qs, ldk, Ks, ldk, dm.D, ty, tx);
      tile_dot<R>(dp, dOs, ldv, Vs, ldv, dm.Dv, ty, tx);
      probs<R>(s, dp, lse_s, delta_s, q0, k0, ty, tx, dm);
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int c = 0; c < R; ++c) {
          Ps[(ty + 16 * a) * ldp + tx + 16 * c] = s[a][c];
          dSs[(ty + 16 * a) * ldp + tx + 16 * c] = dp[a][c];
        }
      }
      __syncthreads();
      const int rows = min(BM, dm.Sq - q0);
      for (int i = 0; i < rows; ++i) {
        float pa[R], da[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pa[a] = Ps[i * ldp + ty + 16 * a];
          da[a] = dSs[i * ldp + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NDK; ++c) {
          if (tx + 16 * c < dm.D) {
            const float qv = Qs[i * ldk + tx + 16 * c];
#pragma unroll
            for (int a = 0; a < R; ++a) acc_k[a][c] = fmaf(da[a], qv, acc_k[a][c]);
          }
        }
#pragma unroll
        for (int c = 0; c < NDV; ++c) {
          if (tx + 16 * c < dm.Dv) {
            const float ov = dOs[i * ldv + tx + 16 * c];
#pragma unroll
            for (int a = 0; a < R; ++a) acc_v[a][c] = fmaf(pa[a], ov, acc_v[a][c]);
          }
        }
      }
    }
  }
  T* dkb = dk + kvh * dm.Skv * dm.D;
  T* dvb = dv + kvh * dm.Skv * dm.Dv;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= dm.Skv) continue;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = tx + 16 * c;
      if (d < dm.D) dkb[static_cast<size_t>(j) * dm.D + d] = repro::from_float<T>(acc_k[a][c]);
    }
#pragma unroll
    for (int c = 0; c < NDV; ++c) {
      const int d = tx + 16 * c;
      if (d < dm.Dv) dvb[static_cast<size_t>(j) * dm.Dv + d] = repro::from_float<T>(acc_v[a][c]);
    }
  }
}

// dq: one CTA per (query block, head, batch); heaviest blocks first
template <typename T, int BM, int NDK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ out, const float* __restrict__ lse, const T* __restrict__ dout,
          T* __restrict__ dq, const Dims dm) {
  constexpr int R = BM / 16;
  extern __shared__ float smem[];
  const int ldk = odd_ld(dm.D), ldv = odd_ld(dm.Dv), ldp = BM + 16;
  float* Qs = smem;
  float* dOs = Qs + BM * ldk;
  float* Ks = dOs + BM * ldv;
  float* Vs = Ks + BM * ldk;
  float* dSs = Vs + BM * ldv;
  float* lse_s = dSs + BM * ldp;
  float* delta_s = lse_s + BM;

  const int qb = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * BM, kh = h / (dm.H / dm.KH);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qh = static_cast<size_t>(b) * dm.H + h;
  const size_t kvh = static_cast<size_t>(b) * dm.KH + kh;
  stage<T, BM>(Qs, ldk, q + qh * dm.Sq * dm.D, q0, dm.Sq, dm.D);
  stage<T, BM>(dOs, ldv, dout + qh * dm.Sq * dm.Dv, q0, dm.Sq, dm.Dv);
  __syncthreads();
  stage_rows<T, BM>(lse_s, delta_s, lse + qh * dm.Sq, out + qh * dm.Sq * dm.Dv, dOs, ldv, q0,
                    dm.Sq, dm.Dv);

  float acc_q[R][NDK];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int c = 0; c < NDK; ++c) acc_q[a][c] = 0.f;
  }
  const int nk = (dm.Skv + BM - 1) / BM;
  // causal: key blocks past the query block's last row are masked whole
  const int nk_end = dm.causal ? min(nk, qb + 1) : nk;
  for (int kb = 0; kb < nk_end; ++kb) {
    const int k0 = kb * BM;
    __syncthreads();  // the last key block is consumed (and lse / delta staged)
    stage<T, BM>(Ks, ldk, k + kvh * dm.Skv * dm.D, k0, dm.Skv, dm.D);
    stage<T, BM>(Vs, ldv, v + kvh * dm.Skv * dm.Dv, k0, dm.Skv, dm.Dv);
    __syncthreads();
    float s[R][R], dp[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.f;
    }
    tile_dot<R>(s, Qs, ldk, Ks, ldk, dm.D, ty, tx);
    tile_dot<R>(dp, dOs, ldv, Vs, ldv, dm.Dv, ty, tx);
    probs<R>(s, dp, lse_s, delta_s, q0, k0, ty, tx, dm);
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int c = 0; c < R; ++c) dSs[(ty + 16 * a) * ldp + tx + 16 * c] = dp[a][c];
    }
    __syncthreads();
    const int keys = min(BM, dm.Skv - k0);
    for (int j = 0; j < keys; ++j) {
      float da[R];
#pragma unroll
      for (int a = 0; a < R; ++a) da[a] = dSs[(ty + 16 * a) * ldp + j];
#pragma unroll
      for (int c = 0; c < NDK; ++c) {
        if (tx + 16 * c < dm.D) {
          const float kv = Ks[j * ldk + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < R; ++a) acc_q[a][c] = fmaf(da[a], kv, acc_q[a][c]);
        }
      }
    }
  }
  T* dqb = dq + qh * dm.Sq * dm.D;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= dm.Sq) continue;
#pragma unroll
    for (int c = 0; c < NDK; ++c) {
      const int d = tx + 16 * c;
      if (d < dm.D) dqb[static_cast<size_t>(i) * dm.D + d] = repro::from_float<T>(acc_q[a][c]);
    }
  }
}

template <typename K>
cudaError_t allow(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int BM, int NDK, int NDV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const float* lse, const void* dout, void* dq, void* dk, void* dv, int B,
                   const Dims& dm, cudaStream_t s) {
  const size_t ldk = odd_ld(dm.D), ldv = odd_ld(dm.Dv), ldp = BM + 16;
  const size_t tiles = 2 * BM * ldk + 2 * BM * ldv;
  const size_t smem_kv = sizeof(float) * (tiles + 2 * BM * ldp + 2 * BM);
  const size_t smem_q = sizeof(float) * (tiles + BM * ldp + 2 * BM);
  auto* kv_kernel = dkdv_kernel<T, BM, NDK, NDV>;
  auto* q_kernel = dq_kernel<T, BM, NDK>;
  cudaError_t err = allow(kv_kernel, smem_kv);
  if (err == cudaSuccess) err = allow(q_kernel, smem_q);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(out);
  const T* dot = static_cast<const T*>(dout);
  kv_kernel<<<dim3((dm.Skv + BM - 1) / BM, dm.KH, B), kThreads, smem_kv, s>>>(
      qt, kt, vt, ot, lse, dot, static_cast<T*>(dk), static_cast<T*>(dv), dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kernel<<<dim3((dm.Sq + BM - 1) / BM, dm.H, B), kThreads, smem_q, s>>>(
      qt, kt, vt, ot, lse, dot, static_cast<T*>(dq), dm);
  return cudaGetLastError();
}

// the tile and the accumulator widths from the head dims: 4 or 8 columns
// a thread (head dims up to 64 / 128) at 64-row tiles, 16 at 32-row tiles
template <typename T>
cudaError_t launch_dims(const void* q, const void* k, const void* v, const void* out,
                        const float* lse, const void* dout, void* dq, void* dk, void* dv, int B,
                        const Dims& dm, cudaStream_t s) {
  if (dm.D > 128 || dm.Dv > 128)
    return launch<T, 32, 16, 16>(q, k, v, out, lse, dout, dq, dk, dv, B, dm, s);
  if (dm.D <= 64 && dm.Dv <= 64)
    return launch<T, 64, 4, 4>(q, k, v, out, lse, dout, dq, dk, dv, B, dm, s);
  if (dm.D <= 64) return launch<T, 64, 4, 8>(q, k, v, out, lse, dout, dq, dk, dv, B, dm, s);
  if (dm.Dv <= 64) return launch<T, 64, 8, 4>(q, k, v, out, lse, dout, dq, dk, dv, B, dm, s);
  return launch<T, 64, 8, 8>(q, k, v, out, lse, dout, dq, dk, dv, B, dm, s);
}

}  // namespace cc


// -- bf16 on wgmma + TMA ---------------------------------------------------------------
//
// Three kernels on PyTorch's stream, each CTA one consumer warpgroup (M =
// 64 rows of every product) and one producer warp that issues TMA loads
// (3-D maps (head dim, S, B * heads): a box past S or the head dim is
// zero-filled, never the next head's rows; head dims load in boxes of 64,
// one 128-byte swizzled row: NK boxes for q and k, NV for v and do, D up
// to 256 takes four, Dv up to 128 two).  At NK >= 3 dK / dV takes two
// consumer warpgroups (flash_bwd_dkdv_split, below), and at NK 3 a dQ CTA
// two query tiles (flash_bwd_dq_pair).
//  * flash_bwd_delta: delta = rowsum(do * out) in f32, once a call, into a
//    workspace the wrapper allocates, rows (b h, 0, i) = lse * log2 e and
//    (b h, 1, i) = delta, Sq padded to 64; padded rows get +inf and 0, so
//    their probabilities are exactly 0 with no mask.  8 lanes a row, each
//    with 16-byte loads of out and do all issued before any is used, 4
//    rows a warp.  Neither later kernel reads out.
//  * flash_bwd_dkdv: one CTA per (key tile of 64, kv head, batch), the
//    heaviest (first) key tiles first.  K and V are loaded once; each (query
//    head of the group, query block on or below the diagonal) streams its
//    Q and dO tiles and its 64-row slice of the workspace through a ring of
//    two stages on full / empty mbarriers.  S^T = K Q^T and dP^T = V dO^T
//    are SS wgmma (both K-major); P^T = exp2(S^T scale log2 e - lse2) and
//    dS^T = P^T (dP^T - delta) are formed on the accumulator fragments (the
//    causal mask only on the diagonal tile, keys past Skv on the ragged
//    one); then dV += P^T dO and dK += dS^T Q are RS wgmma, P^T and dS^T
//    rounded to bf16 in registers as the A operands and dO and Q read
//    MN-major from the tiles that served as the score products' K-major B.
//    dV's product runs while dS^T is formed.  dK and dV stay in f32
//    registers over the whole group and are written once, in bf16, dK times
//    scale.
//  * flash_bwd_dq: one CTA per (query tile of 64, head, batch), the heaviest
//    (last) tiles first.  Q, dO and the workspace slice are loaded once; K
//    and V tiles up to the diagonal stream through the ring.  S = Q K^T and
//    dP = dO V^T (SS), dS in registers, dQ += dS K (RS, K read MN-major);
//    dQ is written once, times scale.  It reads nothing dK / dV writes, so
//    it launches as a programmatic (PDL) dependent of dK / dV and fills the
//    SMs that grid's tail frees (0.122 -> 0.115 ms at llama's train shape on
//    the H100); it waits for dK / dV at its end, so what follows on the
//    stream sees all three outputs.
//  * flash_bwd_dkdv_split, for NK >= 3 (qk 136-256): one warpgroup holding
//    dK (32 NK f32 registers a thread) beside dV, S^T, dP^T and both A
//    operands passes the 255-register cap at NK 3, so two consumer
//    warpgroups share a 64-key tile, split by output.  Warpgroup V forms
//    S^T and P^T, writes P^T (f32) to an exchange buffer of the stage,
//    arrives on the stage's named barrier and runs dV += P^T dO;
//    warpgroup K forms dP^T, waits on that barrier, reads P^T, forms dS^T
//    and runs dK += dS^T Q.  Both fragments of a 64 x 64 tile have one
//    layout, so thread t of K reads what thread t of V wrote.  The buffer
//    is reused with its stage, after the stage's empty barrier has counted
//    K's arrival.  The producer is a whole warpgroup (`setmaxnreg` 40 /
//    232: 384 threads, one CTA an SM); at NK 3 the ring has three stages
//    (dK / dV 0.1104 -> 0.1057 ms at deepseek-v2's qk 192 / v 128 on the
//    H100).  The arithmetic is the one-warpgroup kernel's: P^T stays f32
//    through the buffer.
//  * flash_bwd_dq_pair, for NK 3: flash_bwd_dq's smem (~125 KB) allows one
//    CTA an SM, one warpgroup, so a CTA takes two query tiles, one a
//    consumer warpgroup (dQ 96 registers, S, dP, dS's A operands: 176), on
//    one stream of K and V tiles (a ring of three stages) with a producer
//    warpgroup (`setmaxnreg` 40 / 232): dQ 0.0879 -> 0.0687 ms at
//    deepseek-v2's qk 192 / v 128 on the H100, 0.0662 with the third
//    stage.  At NK 4 two such warpgroups (208 registers a thread) spill
//    under 232, so flash_bwd_dq runs there at one CTA an SM.
// Every sum runs in one order: the group's heads, then query blocks, in
// the dK / dV CTA; key blocks in the dQ CTA; k16 steps within a product.

namespace wg {

using namespace repro::hopper;
using bf16 = __nv_bfloat16;

constexpr int kBM = 64;  // a CTA's keys or queries, and a streamed tile's rows
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;
constexpr int kRow = 128;               // bytes of a swizzled row: 64 bf16 head dims
constexpr int kBox = kBM * kRow;        // a 64-row box of 64 head dims
constexpr int kRowsBytes = 2 * kBM * 4;  // a tile's lse2 and delta slices
constexpr int kRowsSlot = 1024;         // ... padded: tiles stay 1024-byte aligned
constexpr int kMaxD = 256;   // q and k's head dim: four column boxes
constexpr int kMaxDv = 128;  // v and do's: two (the delta pass reads 16 chunks a row)
constexpr int kXBytes = kBM * kBM * 4;  // the split kernel's P^T exchange, f32
constexpr int kSplitConsumers = 2 * kConsumers;
constexpr int kSplitThreads = kSplitConsumers + 128;  // and a producer warpgroup
constexpr int kDeltaThreads = 256;  // the delta pass: 8 lanes a row
constexpr float kLog2e = 1.4426950408889634f;

// Sq rounded up to whole tiles: the workspace's row length
__host__ __device__ constexpr int padded(int sq) { return (sq + kBM - 1) / kBM * kBM; }

// NK, NV: column boxes of q / k's (1-4) and of v / do's (1 or 2) head dims
template <int NK, int NV>
struct Cfg {
  static constexpr int kK = NK * kBox;  // a q or k tile
  static constexpr int kV = NV * kBox;  // a v or do tile
  static constexpr int kBars = (2 * kStages + 1) * 8;
  // dK / dV: K, V resident; stages of (Q, dO, rows)
  static constexpr int kKVStage = kK + kV + kRowsSlot;
  static constexpr int kKVBarOffset = kK + kV + kStages * kKVStage;
  static constexpr int kKVSmem = kKVBarOffset + kBars + 1024;
  // dQ: Q, dO, rows resident; stages of (K, V)
  static constexpr int kQStage = kK + kV;
  static constexpr int kQBarOffset = kK + kV + kRowsSlot + kStages * kQStage;
  static constexpr int kQSmem = kQBarOffset + kBars + 1024;
  // dK / dV CTAs an SM: two where its two f32 accumulators take one box each
  static constexpr int kKVMinBlocks = NK + NV == 2 ? 2 : 1;
  // dQ CTAs an SM: two of ~149 KB do not fit at NK 4
  static constexpr int kQMinBlocks = NK >= 3 ? 1 : 2;
  // the pair dQ kernel (NK 3): two tiles' Q, dO and rows resident; three
  // stages of (K, V) (203 KB)
  static constexpr int kQTile = kK + kV + kRowsSlot;
  static constexpr int kPairStages = 3;
  static constexpr int kPairBarOffset = 2 * kQTile + kPairStages * kQStage;
  static constexpr int kPairSmem = kPairBarOffset + (2 * kPairStages + 1) * 8 + 1024;
  // the split dK / dV kernel: K, V resident; stages of (Q, dO, rows, P^T),
  // three where they fit (211 KB at NK 3)
  static constexpr int kSplitStage = kK + kV + kRowsSlot + kXBytes;
  static constexpr int kSplitStages = NK == 3 ? 3 : 2;
  static constexpr int kSplitBarOffset = kK + kV + kSplitStages * kSplitStage;
  static constexpr int kSplitSmem = kSplitBarOffset + (2 * kSplitStages + 1) * 8 + 1024;
};

__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_delta(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ rows, int Sq, int sq_pad,
                int Dv) {
  // B * H * sq_pad rows, a multiple of the CTA's 32: every lane reaches the shuffles
  const int r = blockIdx.x * (kDeltaThreads / 8) + threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  const int bh = r / sq_pad, i = r - bh * sq_pad;
  float acc = 0.f;
  if (i < Sq) {
    const size_t base = (static_cast<size_t>(bh) * Sq + i) * Dv;
    uint4 o[2], g[2];  // 16-byte chunks sub and sub + 8 of the row (Dv <= 128)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 8 * (sub + 8 * j);
      o[j] = g[j] = make_uint4(0u, 0u, 0u, 0u);
      if (c < Dv) {
        o[j] = *reinterpret_cast<const uint4*>(out + base + c);
        g[j] = *reinterpret_cast<const uint4*>(dout + base + c);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&o[j]);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&g[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(op[e]), b = __bfloat1622float2(gp[e]);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (sub == 0) {
    float* row = rows + static_cast<size_t>(bh) * 2 * sq_pad;
    row[i] = i < Sq ? lse[static_cast<size_t>(bh) * Sq + i] * kLog2e
                    : __int_as_float(0x7f800000);  // +inf: p = 0
    row[sq_pad + i] = acc;
  }
}

// d (64 x 64) = A B^T over the NB column boxes at a and b, both 64-row
// tiles read K-major.  Every k16 step runs, also those past the head dim
// (zero-filled, they add 0): skipping steps at run time made ptxas
// serialize the wgmmas (C7515), ~25% of the call at llama's shape.
template <int NB>
__device__ __forceinline__ void mma_ss(float (&d)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const int off = (kk / 4) * kBox + (kk % 4) * 32;  // 32 bytes of a row a step
    mma_bf16_ss_n64(d, desc_sw128(a + off), desc_sw128(b + off), kk > 0);
  }
}

__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  mma_bf16_rs_n64(d, a, b, 1);
}
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  mma_bf16_rs_n128(d, a, b, 1);
}
__device__ __forceinline__ void mma_rs(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  mma_bf16_rs_n192(d, a, b, 1);
}
__device__ __forceinline__ void mma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  mma_bf16_rs_n256(d, a, b, 1);
}

// d (64 x 64 NB) += X T: X's A operands (4 k16 steps over T's 64 rows), T
// a 64-row tile of NB column boxes read MN-major
template <int R>
__device__ __forceinline__ void mma_acc(float (&d)[R], const uint32_t (&a)[4][4],
                                        const uint8_t* t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(d, a[kk], desc_sw128(t + kk * 16 * kRow, kBox));
}

// a 64 x 64 accumulator fragment as bf16 A operands: k16 step kk is its
// registers 8 kk .. 8 kk + 7, in pairs
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
  }
}

template <int R>
__device__ __forceinline__ void fence_a(uint32_t (&a)[4][R]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs(a[kk]);
}

// a 64 x 64 NB f32 accumulator (rows row0 + 16 warp + lane / 4 (+ 8)) times
// `mul` to dst rows of `width` columns, bf16; t: the thread's index in its
// warpgroup
template <int R>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[R], int row0,
                                           int n_rows, int width, float mul,
                                           unsigned t = threadIdx.x) {
  const int lane = t % 32;
  const int r0 = row0 + 16 * (t / 32) + lane / 4;
#pragma unroll
  for (int i = 0; i < R; i += 2) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (row < n_rows && col < width) {  // width % 8 == 0, so col + 1 < width too
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(row) * width + col) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

template <int NK, int NV>
__global__ void __launch_bounds__(kThreads, Cfg<NK, NV>::kKVMinBlocks)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap do_map,
               const __grid_constant__ CUtensorMap rows_map, bf16* __restrict__ dk,
               bf16* __restrict__ dv, const Dims dm) {
  using C = Cfg<NK, NV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;
  uint8_t* vs = ks + C::kK;
  uint8_t* stages = vs + C::kV;  // stage s: Q, dO, then the rows slice
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kKVBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int kh = blockIdx.x, b = blockIdx.y, kb = blockIdx.z;  // key tile 0 is the heaviest
  const int k0 = kb * kBM, G = dm.H / dm.KH;
  const int nq = (dm.Sq + kBM - 1) / kBM;
  const int qb0 = dm.causal ? kb : 0;  // a query block before the key tile sees none of it
  const int per_head = max(nq - qb0, 0);
  const int n_it = G * per_head;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  // the dQ grid (no reader of dK / dV) may start on the SMs this grid's tail frees
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread issues the loads
    if (tid == kConsumers) {
      const int kvh = b * dm.KH + kh;
      mbar_expect_tx(kv_full, C::kK + C::kV);
#pragma unroll
      for (int c = 0; c < NK; ++c) tma_load_3d(ks + c * kBox, &k_map, kv_full, 64 * c, k0, kvh);
#pragma unroll
      for (int c = 0; c < NV; ++c) tma_load_3d(vs + c * kBox, &v_map, kv_full, 64 * c, k0, kvh);
      for (int t = 0; t < n_it; ++t) {
        const int s = t % kStages;
        const int bh = b * dm.H + kh * G + t / per_head;
        const int q0 = (qb0 + t % per_head) * kBM;
        uint8_t* st = stages + s * C::kKVStage;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::kK + C::kV + kRowsBytes);
#pragma unroll
        for (int c = 0; c < NK; ++c) tma_load_3d(st + c * kBox, &q_map, &full[s], 64 * c, q0, bh);
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          tma_load_3d(st + C::kK + c * kBox, &do_map, &full[s], 64 * c, q0, bh);
        }
        tma_load_2d(st + C::kK + C::kV, &rows_map, &full[s], q0, 2 * bh);
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = dm.scale * kLog2e;
  float dk_acc[32 * NK], dv_acc[32 * NV];
#pragma unroll
  for (int i = 0; i < 32 * NK; ++i) dk_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32 * NV; ++i) dv_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int t = 0; t < n_it; ++t) {
    const int s = t % kStages;
    const int q0 = (qb0 + t % per_head) * kBM;
    const uint8_t* qs = stages + s * C::kKVStage;
    const uint8_t* dos = qs + C::kK;
    const float* lse2 = reinterpret_cast<const float*>(dos + C::kV);
    const float* delta = lse2 + kBM;
    mbar_wait(&full[s], (t / kStages) & 1);

    // S^T (keys x queries) and dP^T: register i at key key0 + 8 ((i / 2) %
    // 2), query q0 + 8 (i / 4) + 2 (lane % 4) + i % 2
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    wgmma_fence();  // each product its own stage: S^T's registers are read while dP^T runs
    mma_ss<NK>(st, ks, qs);
    wgmma_commit();
    wgmma_fence();
    mma_ss<NV>(dpt, vs, dos);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    const bool edge = (dm.causal && k0 + kBM - 1 > q0) || k0 + kBM > dm.Skv;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        float p = exp2f(fmaf(st[i], scale_log2, -(e % 2 ? l.y : l.x)));
        if (edge) {
          const int key = key0 + 8 * (e / 2), query = q0 + col + e % 2;
          if ((dm.causal && key > query) || key >= dm.Skv) p = 0.f;
        }
        st[i] = p;
      }
    }
    uint32_t pa[4][4];
    pack_a(pa, st);
    wgmma_fence();
    mma_acc(dv_acc, pa, dos);  // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done (dV's product runs on)
    fence_regs(dpt);

#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * n + 2 * (lane % 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * n + e;
        dpt[i] = st[i] * (dpt[i] - (e % 2 ? dl.y : dl.x));
      }
    }
    uint32_t da[4][4];
    pack_a(da, dpt);
    wgmma_fence();
    mma_acc(dk_acc, da, qs);  // dK += dS^T Q (times scale at the end)
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_a(pa);
    fence_a(da);
    mbar_arrive(&empty[s]);
  }

  const size_t kvh = static_cast<size_t>(b) * dm.KH + kh;
  store_rows(dk + kvh * dm.Skv * dm.D, dk_acc, k0, dm.Skv, dm.D, dm.scale);
  store_rows(dv + kvh * dm.Skv * dm.Dv, dv_acc, k0, dm.Skv, dm.Dv, 1.f);
}

// dK / dV at NK >= 3: warpgroup V (threads 0-127) owns dV, warpgroup K
// (128-255) dK, the producer warpgroup (256-383) the loads; see the block
// comment above
template <int NK, int NV>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_bwd_dkdv_split(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap rows_map, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const Dims dm) {
  using C = Cfg<NK, NV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = smem;
  uint8_t* vs = ks + C::kK;
  uint8_t* stages = vs + C::kV;  // stage s: Q, dO, the rows slice, then P^T
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kSplitBarOffset);
  uint64_t* empty = full + C::kSplitStages;
  uint64_t* kv_full = empty + C::kSplitStages;

  const int kh = blockIdx.x, b = blockIdx.y, kb = blockIdx.z;  // key tile 0 is the heaviest
  const int k0 = kb * kBM, G = dm.H / dm.KH;
  const int nq = (dm.Sq + kBM - 1) / kBM;
  const int qb0 = dm.causal ? kb : 0;  // a query block before the key tile sees none of it
  const int per_head = max(nq - qb0, 0);
  const int n_it = G * per_head;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kSplitStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSplitConsumers);  // both warpgroups read both tiles
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  // the dQ grid (no reader of dK / dV) may start on the SMs this grid's tail frees
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __syncthreads();

  if (tid >= kSplitConsumers) {  // the producer warpgroup: one thread issues the loads
    regs_dealloc<40>();
    if (tid != kSplitConsumers) return;
    const int kvh = b * dm.KH + kh;
    mbar_expect_tx(kv_full, C::kK + C::kV);
#pragma unroll
    for (int c = 0; c < NK; ++c) tma_load_3d(ks + c * kBox, &k_map, kv_full, 64 * c, k0, kvh);
#pragma unroll
    for (int c = 0; c < NV; ++c) tma_load_3d(vs + c * kBox, &v_map, kv_full, 64 * c, k0, kvh);
    for (int t = 0; t < n_it; ++t) {
      const int s = t % C::kSplitStages;
      const int bh = b * dm.H + kh * G + t / per_head;
      const int q0 = (qb0 + t % per_head) * kBM;
      uint8_t* st = stages + s * C::kSplitStage;
      mbar_wait(&empty[s], ((t / C::kSplitStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], C::kK + C::kV + kRowsBytes);
#pragma unroll
      for (int c = 0; c < NK; ++c) tma_load_3d(st + c * kBox, &q_map, &full[s], 64 * c, q0, bh);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        tma_load_3d(st + C::kK + c * kBox, &do_map, &full[s], 64 * c, q0, bh);
      }
      tma_load_2d(st + C::kK + C::kV, &rows_map, &full[s], q0, 2 * bh);
    }
    return;
  }

  regs_alloc<232>();
  const bool owns_dv = tid < kConsumers;  // warpgroup V; else warpgroup K
  const unsigned wt = tid % kConsumers;    // the thread's index in its warpgroup
  const int warp = wt / 32, lane = wt % 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  const float scale_log2 = dm.scale * kLog2e;
  const size_t kvh = static_cast<size_t>(b) * dm.KH + kh;
  mbar_wait(kv_full, 0);

  if (owns_dv) {
    float dv_acc[32 * NV];
#pragma unroll
    for (int i = 0; i < 32 * NV; ++i) dv_acc[i] = 0.f;
    for (int t = 0; t < n_it; ++t) {
      const int s = t % C::kSplitStages;
      const int q0 = (qb0 + t % per_head) * kBM;
      uint8_t* qs = stages + s * C::kSplitStage;
      uint8_t* dos = qs + C::kK;
      const float* lse2 = reinterpret_cast<const float*>(dos + C::kV);
      float2* xp = reinterpret_cast<float2*>(dos + C::kV + kRowsSlot);
      mbar_wait(&full[s], (t / C::kSplitStages) & 1);

      // S^T (keys x queries): register i at key key0 + 8 ((i / 2) % 2),
      // query q0 + 8 (i / 4) + 2 (lane % 4) + i % 2
      float st[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = 0.f;
      wgmma_fence();
      mma_ss<NK>(st, ks, qs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);

      const bool edge = (dm.causal && k0 + kBM - 1 > q0) || k0 + kBM > dm.Skv;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = 8 * n + 2 * (lane % 4);
        const float2 l = *reinterpret_cast<const float2*>(lse2 + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * n + e;
          float p = exp2f(fmaf(st[i], scale_log2, -(e % 2 ? l.y : l.x)));
          if (edge) {
            const int key = key0 + 8 * (e / 2), query = q0 + col + e % 2;
            if ((dm.causal && key > query) || key >= dm.Skv) p = 0.f;
          }
          st[i] = p;
        }
      }
      // P^T to warpgroup K: pair j of every thread's fragment is one row
      // of 128 float2, a warp's 32 stores consecutive
#pragma unroll
      for (int j = 0; j < 16; ++j) xp[j * kConsumers + wt] = make_float2(st[2 * j], st[2 * j + 1]);
      named_arrive(1 + s, kSplitConsumers);
      uint32_t pa[4][4];
      pack_a(pa, st);
      wgmma_fence();
      mma_acc(dv_acc, pa, dos);  // dV += P^T dO
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_a(pa);
      mbar_arrive(&empty[s]);
    }
    store_rows(dv + kvh * dm.Skv * dm.Dv, dv_acc, k0, dm.Skv, dm.Dv, 1.f, wt);
    return;
  }

  float dk_acc[32 * NK];
#pragma unroll
  for (int i = 0; i < 32 * NK; ++i) dk_acc[i] = 0.f;
  for (int t = 0; t < n_it; ++t) {
    const int s = t % C::kSplitStages;
    const uint8_t* qs = stages + s * C::kSplitStage;
    const uint8_t* dos = qs + C::kK;
    const float* delta = reinterpret_cast<const float*>(dos + C::kV) + kBM;
    const float2* xp = reinterpret_cast<const float2*>(dos + C::kV + kRowsSlot);
    mbar_wait(&full[s], (t / C::kSplitStages) & 1);

    // dP^T, laid out as S^T
    float dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dpt[i] = 0.f;
    wgmma_fence();
    mma_ss<NV>(dpt, vs, dos);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dpt);

    named_sync(1 + s, kSplitConsumers);  // P^T of this stage is written
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * n + 2 * (lane % 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * n + 2 * h;
        const float2 p = xp[(i / 2) * kConsumers + wt];
        dpt[i] = p.x * (dpt[i] - dl.x);
        dpt[i + 1] = p.y * (dpt[i + 1] - dl.y);
      }
    }
    uint32_t da[4][4];
    pack_a(da, dpt);
    wgmma_fence();
    mma_acc(dk_acc, da, qs);  // dK += dS^T Q (times scale at the end)
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_a(da);
    mbar_arrive(&empty[s]);
  }
  store_rows(dk + kvh * dm.Skv * dm.D, dk_acc, k0, dm.Skv, dm.D, dm.scale, wt);
}

template <int NK, int NV>
__global__ void __launch_bounds__(kThreads, Cfg<NK, NV>::kQMinBlocks)
flash_bwd_dq(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap do_map,
             const __grid_constant__ CUtensorMap rows_map, bf16* __restrict__ dq,
             const Dims dm) {
  using C = Cfg<NK, NV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* dos = qs + C::kK;
  const float* lse2 = reinterpret_cast<const float*>(dos + C::kV);
  uint8_t* stages = dos + C::kV + kRowsSlot;  // stage s: K, then V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kQBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // heaviest tiles first
  const int bh = b * dm.H + h, kvh = b * dm.KH + h / (dm.H / dm.KH);
  const int q_last = min(q0 + kBM, dm.Sq) - 1;
  const int n_all = (dm.Skv + kBM - 1) / kBM;
  const int n_kv = dm.causal ? min(n_all, q_last / kBM + 1) : n_all;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, C::kK + C::kV + kRowsBytes);
#pragma unroll
      for (int c = 0; c < NK; ++c) tma_load_3d(qs + c * kBox, &q_map, q_full, 64 * c, q0, bh);
#pragma unroll
      for (int c = 0; c < NV; ++c) tma_load_3d(dos + c * kBox, &do_map, q_full, 64 * c, q0, bh);
      tma_load_2d(dos + C::kV, &rows_map, q_full, q0, 2 * bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        uint8_t* st = stages + s * C::kQStage;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::kK + C::kV);
#pragma unroll
        for (int c = 0; c < NK; ++c) {
          tma_load_3d(st + c * kBox, &k_map, &full[s], 64 * c, t * kBM, kvh);
        }
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          tma_load_3d(st + C::kK + c * kBox, &v_map, &full[s], 64 * c, t * kBM, kvh);
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows of the tile: r0, r0 + 8
  const float scale_log2 = dm.scale * kLog2e;
  float dq_acc[32 * NK];
#pragma unroll
  for (int i = 0; i < 32 * NK; ++i) dq_acc[i] = 0.f;
  mbar_wait(q_full, 0);
  const float l[2] = {lse2[r0], lse2[r0 + 8]};
  const float dl[2] = {lse2[kBM + r0], lse2[kBM + r0 + 8]};

  for (int t = 0; t < n_kv; ++t) {
    const int s = t % kStages;
    const uint8_t* ks = stages + s * C::kQStage;
    const uint8_t* vs = ks + C::kK;
    mbar_wait(&full[s], (t / kStages) & 1);

    // S and dP (queries x keys): register i at row q0 + r0 + 8 ((i / 2) %
    // 2), key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_ss<NK>(sc, qs, ks);
    wgmma_commit();
    wgmma_fence();
    mma_ss<NV>(dp, dos, vs);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    const int k0 = t * kBM;
    const bool edge = (dm.causal && k0 + kBM - 1 > q0) || k0 + kBM > dm.Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(fmaf(sc[i], scale_log2, -l[(i / 2) % 2]));
      if (edge) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int row = q0 + r0 + 8 * ((i / 2) % 2);
        if ((dm.causal && key > row) || key >= dm.Skv) p = 0.f;
      }
      sc[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i / 2) % 2]);
    uint32_t da[4][4];
    pack_a(da, dp);
    wgmma_fence();
    mma_acc(dq_acc, da, ks);  // dQ += dS K (times scale at the end)
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_a(da);
    mbar_arrive(&empty[s]);
  }

  store_rows(dq + static_cast<size_t>(bh) * dm.Sq * dm.D, dq_acc, q0, dm.Sq, dm.D, dm.scale);
  // the grid ends after the dK / dV grid it overlapped: what follows on the
  // stream sees all three outputs
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// dQ at NK 3: one warpgroup's dQ (96 registers) with S, dP and dS fits
// at one CTA an SM, so a CTA takes two query tiles (2z and 2z + 1, z
// the pair), one a consumer warpgroup, both reading one stream of K and V
// tiles up to the later tile's diagonal: K and V are loaded once for 128
// queries, and the two warpgroups share the SM's tensor cores.  A
// warpgroup whose tile ends earlier (or lies past Sq) waits for and frees
// the stages it does not read.  Each warpgroup's arithmetic is
// flash_bwd_dq's.
template <int NK, int NV>
__global__ void __launch_bounds__(kSplitThreads, 1)
flash_bwd_dq_pair(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const __grid_constant__ CUtensorMap rows_map, bf16* __restrict__ dq,
                  const Dims dm) {
  using C = Cfg<NK, NV>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* stages = smem + 2 * C::kQTile;  // tile w: Q, dO, rows at w kQTile; stage s: K, V
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kPairBarOffset);
  uint64_t* empty = full + C::kPairStages;
  uint64_t* q_full = empty + C::kPairStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int pair = gridDim.z - 1 - blockIdx.z;  // heaviest pairs first
  const int bh = b * dm.H + h, kvh = b * dm.KH + h / (dm.H / dm.KH);
  const int n_all = (dm.Skv + kBM - 1) / kBM;
  // the key blocks tile w reads: up to its diagonal, none past Sq
  auto blocks_of = [&](int w) {
    const int q0 = (2 * pair + w) * kBM;
    if (q0 >= dm.Sq) return 0;
    const int q_last = min(q0 + kBM, dm.Sq) - 1;
    return dm.causal ? min(n_all, q_last / kBM + 1) : n_all;
  };
  const int n_kv = max(blocks_of(0), blocks_of(1));
  const int n_tiles = (2 * pair + 1) * kBM < dm.Sq ? 2 : 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::kPairStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kSplitConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kSplitConsumers) {  // the producer warpgroup: one thread issues the loads
    regs_dealloc<40>();
    if (tid != kSplitConsumers) return;
    mbar_expect_tx(q_full, n_tiles * (C::kK + C::kV + kRowsBytes));
    for (int w = 0; w < n_tiles; ++w) {
      uint8_t* qs = smem + w * C::kQTile;
      const int q0 = (2 * pair + w) * kBM;
#pragma unroll
      for (int c = 0; c < NK; ++c) tma_load_3d(qs + c * kBox, &q_map, q_full, 64 * c, q0, bh);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        tma_load_3d(qs + C::kK + c * kBox, &do_map, q_full, 64 * c, q0, bh);
      }
      tma_load_2d(qs + C::kK + C::kV, &rows_map, q_full, q0, 2 * bh);
    }
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % C::kPairStages;
      uint8_t* st = stages + s * C::kQStage;
      mbar_wait(&empty[s], ((t / C::kPairStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], C::kK + C::kV);
#pragma unroll
      for (int c = 0; c < NK; ++c) tma_load_3d(st + c * kBox, &k_map, &full[s], 64 * c, t * kBM, kvh);
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        tma_load_3d(st + C::kK + c * kBox, &v_map, &full[s], 64 * c, t * kBM, kvh);
      }
    }
    return;
  }

  regs_alloc<232>();
  const int w = tid / kConsumers;       // this warpgroup's tile of the pair
  const unsigned wt = tid % kConsumers;  // the thread's index in its warpgroup
  const int warp = wt / 32, lane = wt % 32;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows of the tile: r0, r0 + 8
  const int q0 = (2 * pair + w) * kBM;
  const int n_mine = blocks_of(w);
  const uint8_t* qs = smem + w * C::kQTile;
  const uint8_t* dos = qs + C::kK;
  const float* lse2 = reinterpret_cast<const float*>(dos + C::kV);
  const float scale_log2 = dm.scale * kLog2e;
  float dq_acc[32 * NK];
#pragma unroll
  for (int i = 0; i < 32 * NK; ++i) dq_acc[i] = 0.f;
  mbar_wait(q_full, 0);
  const float l[2] = {lse2[r0], lse2[r0 + 8]};
  const float dl[2] = {lse2[kBM + r0], lse2[kBM + r0 + 8]};

  for (int t = 0; t < n_mine; ++t) {
    const int s = t % C::kPairStages;
    const uint8_t* ks = stages + s * C::kQStage;
    const uint8_t* vs = ks + C::kK;
    mbar_wait(&full[s], (t / C::kPairStages) & 1);

    // S and dP (queries x keys): register i at row q0 + r0 + 8 ((i / 2) %
    // 2), key k0 + 8 (i / 4) + 2 (lane % 4) + i % 2
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_ss<NK>(sc, qs, ks);
    wgmma_commit();
    wgmma_fence();
    mma_ss<NV>(dp, dos, vs);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    const int k0 = t * kBM;
    const bool edge = (dm.causal && k0 + kBM - 1 > q0) || k0 + kBM > dm.Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = exp2f(fmaf(sc[i], scale_log2, -l[(i / 2) % 2]));
      if (edge) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int row = q0 + r0 + 8 * ((i / 2) % 2);
        if ((dm.causal && key > row) || key >= dm.Skv) p = 0.f;
      }
      sc[i] = p;
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dl[(i / 2) % 2]);
    uint32_t da[4][4];
    pack_a(da, dp);
    wgmma_fence();
    mma_acc(dq_acc, da, ks);  // dQ += dS K (times scale at the end)
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_a(da);
    mbar_arrive(&empty[s]);
  }
  // the stages the other tile reads past this one's last block: waited for
  // (their phase is the current one) and freed
  for (int t = n_mine; t < n_kv; ++t) {
    mbar_wait(&full[t % C::kPairStages], (t / C::kPairStages) & 1);
    mbar_arrive(&empty[t % C::kPairStages]);
  }

  if (n_mine > 0) {
    store_rows(dq + static_cast<size_t>(bh) * dm.Sq * dm.D, dq_acc, q0, dm.Sq, dm.D, dm.scale,
               wt);
  }
  // the grid ends after the dK / dV grid it overlapped: what follows on the
  // stream sees all three outputs
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// the workspace's floats for B * H rows of Sq: lse2 and delta, Sq padded
inline size_t workspace_elems(int B, int H, int Sq) {
  return static_cast<size_t>(B) * H * 2 * padded(Sq);
}

template <int NK, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const float* lse, const void* dout, void* dq, void* dk, void* dv,
                   float* rows, int B, const Dims& dm, cudaStream_t s) {
  using C = Cfg<NK, NV>;
  const int sq_pad = padded(dm.Sq), BH = B * dm.H;
  flash_bwd_delta<<<BH * (sq_pad / (kDeltaThreads / 8)), kDeltaThreads, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse, rows, dm.Sq, sq_pad,
      dm.Dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap q_map, k_map, v_map, do_map, rows_map;
  err = map_heads(&q_map, q, dm.D, dm.Sq, BH, kBM);
  if (err == cudaSuccess) err = map_heads(&k_map, k, dm.D, dm.Skv, B * dm.KH, kBM);
  if (err == cudaSuccess) err = map_heads(&v_map, v, dm.Dv, dm.Skv, B * dm.KH, kBM);
  if (err == cudaSuccess) err = map_heads(&do_map, dout, dm.Dv, dm.Sq, BH, kBM);
  if (err == cudaSuccess) {
    // (sq_pad, 2 B H) f32: a box is a tile's lse2 row and its delta row
    const uint64_t dims[2] = {static_cast<uint64_t>(sq_pad), 2ull * BH};
    const uint64_t strides[1] = {4ull * sq_pad};
    const uint32_t box[2] = {kBM, 2};
    err = make_map(&rows_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, rows, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err != cudaSuccess) return err;
  // dK / dV on one consumer warpgroup up to two column boxes of q / k, on
  // two above; dQ on a CTA a query tile, but at three boxes a CTA a tile
  // pair (at four, two tiles' dQ in 232 registers a thread spill)
  constexpr bool kSplit = NK >= 3;
  constexpr bool kPair = NK == 3;
  static const cudaError_t smem_err = [] {
    cudaError_t e;
    if constexpr (NK >= 3) {
      e = allow_smem(flash_bwd_dkdv_split<NK, NV>, C::kSplitSmem);
    } else {
      e = allow_smem(flash_bwd_dkdv<NK, NV>, C::kKVSmem);
    }
    if (e != cudaSuccess) return e;
    if constexpr (NK == 3) {
      return allow_smem(flash_bwd_dq_pair<NK, NV>, C::kPairSmem);
    } else {
      return allow_smem(flash_bwd_dq<NK, NV>, C::kQSmem);
    }
  }();
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 kv_grid(dm.KH, B, (dm.Skv + kBM - 1) / kBM);
  if constexpr (kSplit) {
    flash_bwd_dkdv_split<NK, NV><<<kv_grid, kSplitThreads, C::kSplitSmem, s>>>(
        q_map, k_map, v_map, do_map, rows_map, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        dm);
  } else {
    flash_bwd_dkdv<NK, NV><<<kv_grid, kThreads, C::kKVSmem, s>>>(
        q_map, k_map, v_map, do_map, rows_map, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        dm);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // a programmatic dependent of the dK / dV grid: both read only what the
  // delta pass (finished before dK / dV started) and the inputs hold
  const int nq = (dm.Sq + kBM - 1) / kBM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dm.H, B, kPair ? (nq + 1) / 2 : nq);
  cfg.blockDim = dim3(kPair ? kSplitThreads : kThreads);
  cfg.dynamicSmemBytes = kPair ? C::kPairSmem : C::kQSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if constexpr (kPair) {
    err = cudaLaunchKernelEx(&cfg, flash_bwd_dq_pair<NK, NV>, q_map, k_map, v_map, do_map,
                             rows_map, static_cast<bf16*>(dq), dm);
  } else {
    err = cudaLaunchKernelEx(&cfg, flash_bwd_dq<NK, NV>, q_map, k_map, v_map, do_map, rows_map,
                             static_cast<bf16*>(dq), dm);
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace wg

// route codes: kernels/attention.py's BWD_ROUTES
constexpr int kRouteCudaCores = 0;
constexpr int kRouteWgmma = 1;

}  // namespace

// The route's kernels, one call; the wrapper (kernels/attention.py,
// flash_attention_bwd) checks shapes, types and contiguity and allocates
// the wgmma route's workspace (`workspace_elems` floats; null on the CUDA
// cores).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, void* workspace,
                                         long long workspace_elems, int B, int H, int KH,
                                         int Sq, int Skv, int D, int Dv, int causal,
                                         float scale, int dtype, int route, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 || D <= 0 || D > 256 ||
      Dv <= 0 || Dv > 256 || !q || !k || !v || !out || !lse || !dout || !dq || !dk || !dv) {
    return cudaErrorInvalidValue;
  }
  const Dims dm{H, KH, Sq, Skv, D, Dv, causal, scale};
  const float* l = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteWgmma) {
    // what the route takes: bf16, head dims multiples of 8 (TMA's 16-byte
    // strides), q / k's up to four column boxes and v's up to two, 16-byte
    // aligned operands (TMA, and
    // the delta pass's 16-byte loads), a workspace of the right size
    const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
                            reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                            reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
                            reinterpret_cast<uintptr_t>(workspace);
    if (dtype != repro::kBFloat16 || D % 8 || Dv % 8 || D > wg::kMaxD || Dv > wg::kMaxDv ||
        bases % 16 || !workspace ||
        workspace_elems < static_cast<long long>(wg::workspace_elems(B, H, Sq))) {
      return cudaErrorInvalidValue;
    }
    float* ws = static_cast<float*>(workspace);
    if (D <= 64 && Dv <= 64) return wg::launch<1, 1>(q, k, v, out, l, dout, dq, dk, dv, ws, B, dm, s);
    if (D <= 64) return wg::launch<1, 2>(q, k, v, out, l, dout, dq, dk, dv, ws, B, dm, s);
    if (D <= 128) {
      if (Dv <= 64) return wg::launch<2, 1>(q, k, v, out, l, dout, dq, dk, dv, ws, B, dm, s);
      return wg::launch<2, 2>(q, k, v, out, l, dout, dq, dk, dv, ws, B, dm, s);
    }
    if (D <= 192) {
      if (Dv <= 64) return wg::launch<3, 1>(q, k, v, out, l, dout, dq, dk, dv, ws, B, dm, s);
      return wg::launch<3, 2>(q, k, v, out, l, dout, dq, dk, dv, ws, B, dm, s);
    }
    if (Dv <= 64) return wg::launch<4, 1>(q, k, v, out, l, dout, dq, dk, dv, ws, B, dm, s);
    return wg::launch<4, 2>(q, k, v, out, l, dout, dq, dk, dv, ws, B, dm, s);
  }
  if (route != kRouteCudaCores) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32) {
    return cc::launch_dims<float>(q, k, v, out, l, dout, dq, dk, dv, B, dm, s);
  }
  if (dtype == repro::kBFloat16) {
    return cc::launch_dims<__nv_bfloat16>(q, k, v, out, l, dout, dq, dk, dv, B, dm, s);
  }
  return cudaErrorInvalidValue;
}
