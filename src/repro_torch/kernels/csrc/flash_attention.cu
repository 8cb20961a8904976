// Causal flash-attention forward with GQA: prompt prefill.
//
// Replaces: repro/kernels/attention.py, flash_attention_pallas
// (_flash_kernel).
//
// Semantics: q (B, H, Sq, D), k/v (B, KH, Skv, D); query head h reads kv
// head h / (H / KH).  Scores (q * scale) . k with scale = 1/sqrt(D), the
// causal mask aligned at the start (key j visible to query i iff j <= i,
// as in the TPU kernel), softmax in f32, out = p . v in q's dtype.  Unlike
// the TPU kernel, ragged edges are masked here, so any Sq / Skv works.
//
// Bound on the H100: bytes at short prompts, operations at long ones.
// Causal attention does ~2 * Sq * Skv * D * H flops (half of the dense
// 4 * Sq * Skv * D * H) on 2 * (2 * H * Sq + 2 * KH * Skv) * D bytes in
// bf16; with llama3.2-1b's heads (H = 32, KH = 8, D = 64) the two bounds
// meet at Sq = Skv ~ 740.  This first kernel does its products on the
// CUDA cores in f32 (67 TFLOP/s peak), not on the tensor cores
// (989 TFLOP/s bf16), so it stays far above either bound; wgmma tiles and
// TMA loads are later work.
//
// Design: one CTA of 4 warps per (b, h, 32-row query tile); each warp owns
// 8 query rows and keeps their running max, sum and f32 accumulator in
// registers (each lane holds 1/32 of the head dims).  The CTA loops over
// 32-key K/V tiles up to the diagonal, staging each tile in shared memory
// as f32 (K rows padded by one float so lane j reads key j without bank
// conflicts); lane j scores key j against the row, the warp reduces max
// and sum, and p is broadcast by shuffle for the P.V update.  The q tile
// is staged once, pre-scaled.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBQ = 32;   // query rows per CTA
constexpr int kBKV = 32;  // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kMaxDimPerLane = 4;  // head dims up to 128
constexpr float kNeg = -1e30f;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int KH, int Sq, int Skv, int D, int causal,
                       float scale) {
  extern __shared__ float smem[];
  float* qs = smem;               // kBQ x D
  float* ks = qs + kBQ * D;       // kBKV x (D + 1)
  float* vs = ks + kBKV * (D + 1);  // kBKV x D
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * KH + kh) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * KH + kh) * Skv * D;
  T* ob = out + (static_cast<size_t>(b) * H + h) * Sq * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D;
    qs[i] = q0 + r < Sq
                ? repro::to_float(qb[static_cast<size_t>(q0 + r) * D + i % D]) * scale
                : 0.f;
  }

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxDimPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDimPerLane; ++i) acc[rr][i] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int i = tid; i < kBKV * D; i += kWarps * 32) {
      const int j = i / D;
      const int d = i % D;
      const bool in = k0 + j < Skv;
      const size_t off = static_cast<size_t>(k0 + j) * D + d;
      ks[j * (D + 1) + d] = in ? repro::to_float(kb[off]) : 0.f;
      vs[j * D + d] = in ? repro::to_float(vb[off]) : 0.f;
    }
    __syncthreads();
    const int kv = k0 + lane;  // this lane's key
    const int tn = min(kBKV, Skv - k0);
    const float* krow = ks + lane * (D + 1);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = rr * kWarps + warp;  // interleaved: balances the diagonal
      const int qi = q0 + r;
      if (qi >= Sq) continue;  // warp-uniform
      const float* qrow = qs + r * D;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
      const bool valid = kv < Skv && (!causal || kv <= qi);
      s = valid ? s : kNeg;
      const float m_new = fmaxf(m[rr], repro::warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + repro::warp_sum(p);
#pragma unroll
      for (int i = 0; i < kMaxDimPerLane; ++i) acc[rr][i] *= alpha;
      for (int j = 0; j < tn; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < kMaxDimPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] += pj * vs[j * D + d];
        }
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + rr * kWarps + warp;
    if (qi >= Sq) continue;
    const float lv = l[rr] == 0.f ? 1.f : l[rr];
#pragma unroll
    for (int i = 0; i < kMaxDimPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) {
        ob[static_cast<size_t>(qi) * D + d] = repro::from_float<T>(acc[rr][i] / lv);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KH, int Sq, int Skv, int D, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * D + kBKV * (D + 1) + kBKV * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, KH, Sq, Skv, D,
      causal, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int KH, int Sq, int Skv, int D,
                                     int causal, float scale, int dtype,
                                     void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 ||
      D <= 0 || D > 32 * kMaxDimPerLane) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32) {
    err = launch<float>(q, k, v, out, B, H, KH, Sq, Skv, D, causal, scale, s);
  } else if (dtype == repro::kBFloat16) {
    err = launch<__nv_bfloat16>(q, k, v, out, B, H, KH, Sq, Skv, D, causal,
                                scale, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
