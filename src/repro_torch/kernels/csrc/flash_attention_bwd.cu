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
// ms at 989 TFLOP/s) and bytes (~0.025 ms) are about even.
//
// Two routes, the wrapper's choice (kernels/attention.py, flash_bwd_route),
// each two kernels with no atomics, every output written once and every sum
// in a fixed order, so a call is bit for bit repeatable (the train loop's
// restart is held to the bit):
//  * bf16 with D and Dv multiples of 16 up to 64 (llama's train shape):
//    mma.sync m16n8k16 on the tensor cores (the `tc` namespace below);
//  * f32 and every other shape: the CUDA cores (the `cc` namespace).
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

// -- bf16 on the tensor cores: mma.sync m16n8k16 -------------------------------------
//
// The FlashAttention-2 backward's shape on mma.sync.  Tiles of 64 keys and
// 64 queries in shared memory as bf16, rows padded by 16 bytes (so the 8
// rows an ldmatrix reads fall in distinct banks); 4 warps a CTA, each the
// M = 16 rows of its products.  dk, dv: a warp owns 16 of the CTA's keys
// and computes S^T = K Q^T and dP^T = V dO^T for them against each query
// block (A from K / V, B from Q / dO by ldmatrix), P^T and dS^T on the
// accumulator fragments, then dV += P^T dO and dK += dS^T Q with P^T and
// dS^T, rounded to bf16, as A operands straight from the registers (B by
// ldmatrix.trans).  dq: a warp owns 16 of the CTA's queries (q and do as A
// fragments held in registers) and walks the key blocks: S = Q K^T, dP =
// dO V^T, then dQ += dS K.  Accumulation is f32 throughout; no tile of P
// or dS goes through shared memory.

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBM = 64;      // keys or queries a tile
constexpr int kThreads = 128;  // 4 warps, 16 rows each
constexpr int kMaxD = 64;    // head dims, q/k and v: multiples of 16 up to 64
constexpr int kLd = kMaxD + 8;  // the widest padded row (bf16 elements)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b for one m16n8k16 tile, bf16 in, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo -> low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [row0, row0 + 64) of a (n_rows, width) bf16 matrix into dst (64 x
// ld), 16 bytes a load, zeros past n_rows (width % 8 == 0)
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src, int row0, int n_rows,
                                      int width) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < kBM * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * width + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// a query block's lse and delta = rowsum(do * out): warp w the rows 16 w ..
// 16 w + 15 (do already staged)
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s, const float* lse,
                                           const bf16* out, const bf16* dOs, int ldv, int row0,
                                           int Sq, int Dv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
    const int i = row0 + r;
    float acc = 0.f;
    if (i < Sq) {
      for (int d = lane; d < Dv; d += 32) {
        acc += __bfloat162float(dOs[r * ldv + d]) *
               __bfloat162float(out[static_cast<size_t>(i) * Dv + d]);
      }
    }
    acc = repro::warp_sum(acc);
    if (lane == 0) {
      delta_s[r] = acc;
      lse_s[r] = i < Sq ? lse[i] : 0.f;
    }
  }
}

// acc[nt] (8 n-tiles: the 64 rows of M, as columns) += A (16 rows of T at
// row m0) . M^T over k-steps of 16 up to `width`: A by ldmatrix from T, B
// by ldmatrix from M's rows
__device__ __forceinline__ void rows_dot(float (&acc)[8][4], const bf16* T, int m0,
                                         const bf16* M, int ld, int width, int lane) {
#pragma unroll
  for (int ks = 0; ks < kMaxD / 16; ++ks) {
    if (16 * ks >= width) break;
    uint32_t a[4];
    ldsm_x4(a, T + (m0 + (lane & 15)) * ld + 16 * ks + 8 * (lane >> 4));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, M + (16 * np + (lane & 7) + 8 * (lane >> 4)) * ld + 16 * ks +
                     8 * ((lane >> 3) & 1));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// the same with the A fragments given (held in registers)
__device__ __forceinline__ void frag_dot(float (&acc)[8][4], const uint32_t (&a)[kMaxD / 16][4],
                                         const bf16* M, int ld, int width, int lane) {
#pragma unroll
  for (int ks = 0; ks < kMaxD / 16; ++ks) {
    if (16 * ks >= width) break;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, M + (16 * np + (lane & 7) + 8 * (lane >> 4)) * ld + 16 * ks +
                     8 * ((lane >> 3) & 1));
      mma(acc[2 * np], a[ks], b[0], b[1]);
      mma(acc[2 * np + 1], a[ks], b[2], b[3]);
    }
  }
}

// acc (n-tiles over `width` columns) += X (16 x 64, as accumulator fragments
// x: rows this warp's, columns the 64 rows of M) . M (64 x width, row-major):
// X rounded to bf16 as A operands, M by ldmatrix.trans
__device__ __forceinline__ void acc_dot(float (&acc)[kMaxD / 8][4], const float (&x)[8][4],
                                        const bf16* M, int ld, int width, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < kMaxD / 16; ++np) {
      if (16 * np >= width) break;
      uint32_t b[4];
      ldsm_x4_t(b, M + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 16 * np +
                       8 * (lane >> 4));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// a warp's 16 x width accumulator (rows row0 + g, row0 + g + 8) to dst rows
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[kMaxD / 8][4], int row0,
                                           int n_rows, int width, int lane) {
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < kMaxD / 8; ++nt) {
    const int col = 8 * nt + c2;
    if (col >= width) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + g + 8 * h;
      if (row < n_rows) {
        *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(row) * width + col) =
            __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
        const bf16* __restrict__ out, const float* __restrict__ lse,
        const bf16* __restrict__ dout, bf16* __restrict__ dk, bf16* __restrict__ dv,
        const Dims dm) {
  __shared__ __align__(16) bf16 Ks[kBM * kLd];
  __shared__ __align__(16) bf16 Vs[kBM * kLd];
  __shared__ __align__(16) bf16 Qs[kBM * kLd];
  __shared__ __align__(16) bf16 dOs[kBM * kLd];
  __shared__ float lse_s[kBM], delta_s[kBM];
  const int ldk = dm.D + 8, ldv = dm.Dv + 8;
  const int kb = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * kBM, G = dm.H / dm.KH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), m0 = 16 * warp;
  const size_t kvh = static_cast<size_t>(b) * dm.KH + kh;
  stage(Ks, ldk, k + kvh * dm.Skv * dm.D, k0, dm.Skv, dm.D);
  stage(Vs, ldv, v + kvh * dm.Skv * dm.Dv, k0, dm.Skv, dm.Dv);

  float acc_k[kMaxD / 8][4], acc_v[kMaxD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxD / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = acc_v[nt][e] = 0.f;
  }
  const int nq = (dm.Sq + kBM - 1) / kBM;
  const int qb0 = dm.causal ? kb : 0;  // a query block before the keys sees none
  for (int hq = 0; hq < G; ++hq) {
    const size_t qh = static_cast<size_t>(b) * dm.H + kh * G + hq;
    for (int qb = qb0; qb < nq; ++qb) {
      const int q0 = qb * kBM;
      __syncthreads();  // the last block's tiles are consumed
      stage(Qs, ldk, q + qh * dm.Sq * dm.D, q0, dm.Sq, dm.D);
      stage(dOs, ldv, dout + qh * dm.Sq * dm.Dv, q0, dm.Sq, dm.Dv);
      __syncthreads();
      stage_rows(lse_s, delta_s, lse + qh * dm.Sq, out + qh * dm.Sq * dm.Dv, dOs, ldv, q0,
                 dm.Sq, dm.Dv);
      __syncthreads();
      // S^T (this warp's 16 keys x the 64 queries) and dP^T
      float s[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      }
      rows_dot(s, Ks, m0, Qs, ldk, dm.D, lane);
      rows_dot(dp, Vs, m0, dOs, ldv, dm.Dv, lane);
      // element e of n-tile nt: key k0 + m0 + g + 8 (e / 2), query q0 + 8 nt + c2 + e % 2
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = k0 + m0 + g + 8 * (e >> 1);
          const int ql = 8 * nt + c2 + (e & 1), i = q0 + ql;
          const bool valid = i < dm.Sq && j < dm.Skv && (!dm.causal || j <= i);
          const float p = valid ? expf(s[nt][e] * dm.scale - lse_s[ql]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta_s[ql]) * dm.scale;
        }
      }
      acc_dot(acc_v, s, dOs, ldv, dm.Dv, lane);   // dV += P^T dO
      acc_dot(acc_k, dp, Qs, ldk, dm.D, lane);    // dK += dS^T Q (scale folded)
    }
  }
  store_rows(dk + kvh * dm.Skv * dm.D, acc_k, k0 + m0, dm.Skv, dm.D, lane);
  store_rows(dv + kvh * dm.Skv * dm.Dv, acc_v, k0 + m0, dm.Skv, dm.Dv, lane);
}

__global__ void __launch_bounds__(kThreads)
dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
      const bf16* __restrict__ out, const float* __restrict__ lse,
      const bf16* __restrict__ dout, bf16* __restrict__ dq, const Dims dm) {
  __shared__ __align__(16) bf16 Qs[kBM * kLd];
  __shared__ __align__(16) bf16 dOs[kBM * kLd];
  __shared__ __align__(16) bf16 Ks[kBM * kLd];
  __shared__ __align__(16) bf16 Vs[kBM * kLd];
  __shared__ float lse_s[kBM], delta_s[kBM];
  const int ldk = dm.D + 8, ldv = dm.Dv + 8;
  const int qb = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qb * kBM, kh = h / (dm.H / dm.KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), m0 = 16 * warp;
  const size_t qh = static_cast<size_t>(b) * dm.H + h;
  const size_t kvh = static_cast<size_t>(b) * dm.KH + kh;
  stage(Qs, ldk, q + qh * dm.Sq * dm.D, q0, dm.Sq, dm.D);
  stage(dOs, ldv, dout + qh * dm.Sq * dm.Dv, q0, dm.Sq, dm.Dv);
  __syncthreads();
  stage_rows(lse_s, delta_s, lse + qh * dm.Sq, out + qh * dm.Sq * dm.Dv, dOs, ldv, q0, dm.Sq,
             dm.Dv);
  __syncthreads();
  // this warp's 16 query rows: q and do as A fragments, lse and delta
  uint32_t qa[kMaxD / 16][4], da[kMaxD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kMaxD / 16; ++ks) {
    if (16 * ks < dm.D) ldsm_x4(qa[ks], Qs + (m0 + (lane & 15)) * ldk + 16 * ks + 8 * (lane >> 4));
    if (16 * ks < dm.Dv) {
      ldsm_x4(da[ks], dOs + (m0 + (lane & 15)) * ldv + 16 * ks + 8 * (lane >> 4));
    }
  }
  const float lse_r[2] = {lse_s[m0 + g], lse_s[m0 + g + 8]};
  const float delta_r[2] = {delta_s[m0 + g], delta_s[m0 + g + 8]};

  float acc_q[kMaxD / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMaxD / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_q[nt][e] = 0.f;
  }
  const int nk = (dm.Skv + kBM - 1) / kBM;
  // causal: key blocks past the query block's last row are masked whole
  const int nk_end = dm.causal ? min(nk, qb + 1) : nk;
  for (int kb = 0; kb < nk_end; ++kb) {
    const int k0 = kb * kBM;
    __syncthreads();  // the last key block is consumed
    stage(Ks, ldk, k + kvh * dm.Skv * dm.D, k0, dm.Skv, dm.D);
    stage(Vs, ldv, v + kvh * dm.Skv * dm.Dv, k0, dm.Skv, dm.Dv);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
    frag_dot(s, qa, Ks, ldk, dm.D, lane);
    frag_dot(dp, da, Vs, ldv, dm.Dv, lane);
    // element e of n-tile nt: query q0 + m0 + g + 8 (e / 2), key k0 + 8 nt + c2 + e % 2
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = q0 + m0 + g + 8 * (e >> 1);
        const int j = k0 + 8 * nt + c2 + (e & 1);
        const bool valid = i < dm.Sq && j < dm.Skv && (!dm.causal || j <= i);
        const float p = valid ? expf(s[nt][e] * dm.scale - lse_r[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - delta_r[e >> 1]) * dm.scale;
      }
    }
    acc_dot(acc_q, dp, Ks, ldk, dm.D, lane);  // dQ += dS K (scale folded)
  }
  store_rows(dq + qh * dm.Sq * dm.D, acc_q, q0 + m0, dm.Sq, dm.D, lane);
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* out,
                   const float* lse, const void* dout, void* dq, void* dk, void* dv, int B,
                   const Dims& dm, cudaStream_t s) {
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* ot = static_cast<const bf16*>(out);
  const bf16* dot = static_cast<const bf16*>(dout);
  dkdv_tc<<<dim3((dm.Skv + kBM - 1) / kBM, dm.KH, B), kThreads, 0, s>>>(
      qt, kt, vt, ot, lse, dot, static_cast<bf16*>(dk), static_cast<bf16*>(dv), dm);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_tc<<<dim3((dm.Sq + kBM - 1) / kBM, dm.H, B), kThreads, 0, s>>>(
      qt, kt, vt, ot, lse, dot, static_cast<bf16*>(dq), dm);
  return cudaGetLastError();
}

}  // namespace tc

// route codes: kernels/attention.py's BWD_ROUTES
constexpr int kRouteCudaCores = 0;
constexpr int kRouteMma = 1;

}  // namespace

// Both kernels, one call; the wrapper (kernels/attention.py,
// flash_attention_bwd) checks shapes, types and contiguity.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, int B, int H, int KH,
                                         int Sq, int Skv, int D, int Dv, int causal,
                                         float scale, int dtype, int route, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 || D <= 0 || D > 256 ||
      Dv <= 0 || Dv > 256 || !q || !k || !v || !out || !lse || !dout || !dq || !dk || !dv) {
    return cudaErrorInvalidValue;
  }
  const Dims dm{H, KH, Sq, Skv, D, Dv, causal, scale};
  const float* l = static_cast<const float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteMma) {
    // what the tensor-core route takes: bf16, head dims multiples of 16 up
    // to 64, 16-byte aligned operands (its 16-byte loads)
    const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
                            reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                            reinterpret_cast<uintptr_t>(dv);
    if (dtype != repro::kBFloat16 || D % 16 || Dv % 16 || D > tc::kMaxD ||
        Dv > tc::kMaxD || bases % 16) {
      return cudaErrorInvalidValue;
    }
    return tc::launch(q, k, v, out, l, dout, dq, dk, dv, B, dm, s);
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
