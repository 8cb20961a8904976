// Fused paged attention through the page table: decode (S = 1) and extend
// (S >= 1, causal within the chunk), GQA and the MLA operands.
//
// Replaces: repro/kernels/paged_attention.py, paged_attention_pallas
// (its body: online softmax over the page walk).
//
// Semantics, per (slot b, kv head kh): the G query heads of the group and
// the S chunk positions are fused into R = G * S rows, row r <-> (group
// g = r / S, chunk s = r % S), whose query position is index[b] + s.  Row r
// attends pool positions t <= index[b] + s; position t lives in pool page
// pages[b, t / page_size] at row t % page_size.  Scores are
// (q . k [+ q_rope . k_rope]) * scale, softmax in f32, out = p . v.
//
// Bound on the H100: bytes.  Every resident K/V row is read once per kv
// head, against 4 * G * D flops per row: at llama3.2-1b decode (G = 4,
// D = 64, bf16) that is 2 flops per byte, far under the ~295 the tensor
// cores need.  At the serving shape (8 slots, 8 kv heads, <= 1024
// positions) a layer's K/V is a few MB, so the kernel is bound by memory
// latency and by how many loads it keeps in flight, more than by bandwidth.
//
// Design: one CTA of 16 warps per (b, kh).  The warps split the work into
// tasks (row r, split sp), splits = 16 / R when R < 16: a task walks the
// 32-position blocks c0 = 32 * (sp + k * splits) of row r, so a row's
// position walk runs on `splits` warps at once.  In a block, lane t
// takes position c0 + t: it looks up its page itself (in place of the
// TPU's scalar prefetch) and scores its K row with 16-byte loads, so a
// warp has 32 independent K rows in flight.  The online softmax (running
// max, sum and f32 accumulator; lanes own 1/32 of the head dims of the
// accumulator) takes the block; p and the V row index are broadcast by
// shuffle for the P.V update.  Positions past a row's query position (and
// the null page past a slot's allocation) are never read; the explicit
// re-mask of p and the l == 0 -> 1 guard of the TPU body are kept.  The
// splits' partial (max, sum, accumulator) meet in shared memory and are
// merged by one warp per row.  Splitting across CTAs, to fill 132 SMs at
// decode, is later work.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kMaxDimPerLane = 16;  // head dims up to 512 (MLA latent rank)
constexpr float kNeg = -1e30f;

// dot product of two rows of n elements, in f32, with 16-byte loads when
// the rows allow them
template <typename T>
__device__ __forceinline__ float dot_row(const T* __restrict__ a,
                                         const T* __restrict__ b, int n) {
  constexpr int kVec = 16 / sizeof(T);
  float s = 0.f;
  const bool aligned = n % kVec == 0 &&
                       (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  if (aligned) {
    for (int i = 0; i < n; i += kVec) {
      const uint4 va = *reinterpret_cast<const uint4*>(a + i);
      const uint4 vb = *reinterpret_cast<const uint4*>(b + i);
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s += repro::to_float(ea[j]) * repro::to_float(eb[j]);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) s += repro::to_float(a[i]) * repro::to_float(b[i]);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const T* __restrict__ q_rope,
                       const T* __restrict__ kr_pool,
                       const int* __restrict__ pages,
                       const int* __restrict__ index, T* __restrict__ out,
                       int KH, int S, int R, int Dk, int Dv, int Dr, int ps,
                       int mp, float scale) {
  extern __shared__ float smem[];  // splits > 1: per-warp (m, l, acc[Dv])
  float* part_m = smem;
  float* part_l = part_m + kWarps;
  float* part_acc = part_l + kWarps;

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* page_row = pages + static_cast<size_t>(b) * mp;
  const int base = index[b];
  const int cap = ps * mp;  // positions the table row can address
  const int splits = R >= kWarps ? 1 : kWarps / R;
  const size_t row0 = (static_cast<size_t>(b) * KH + kh) * R;

  for (int task = warp; task < R * splits; task += kWarps) {
    const int r = task % R;
    const int sp = task / R;
    const int n_pos = min(base + r % S + 1, cap);
    const T* qrow = q + (row0 + r) * Dk;
    const T* qrrow = Dr > 0 ? q_rope + (row0 + r) * Dr : nullptr;

    float acc[kMaxDimPerLane];
#pragma unroll
    for (int i = 0; i < kMaxDimPerLane; ++i) acc[i] = 0.f;
    float m = kNeg;
    float l = 0.f;

    for (int c0 = 32 * sp; c0 < n_pos; c0 += 32 * splits) {
      const int cn = min(32, n_pos - c0);
      const int pos = c0 + lane;
      const bool valid = lane < cn;
      float s = kNeg;
      long long vrow = 0;
      if (valid) {
        const int page = page_row[pos / ps];
        vrow = (static_cast<long long>(page) * KH + kh) * ps + pos % ps;
        s = dot_row(k_pool + vrow * Dk, qrow, Dk);
        if (Dr > 0) {  // MLA: kr_pool is (P, 1, ps, Dr)
          const long long rrow = static_cast<long long>(page) * ps + pos % ps;
          s += dot_row(kr_pool + rrow * Dr, qrrow, Dr);
        }
        s *= scale;
      }
      const float m_new = fmaxf(m, repro::warp_max(s));
      // explicit re-mask: lanes past the block end contribute nothing
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + repro::warp_sum(p);
#pragma unroll
      for (int i = 0; i < kMaxDimPerLane; ++i) acc[i] *= alpha;
#pragma unroll 4
      for (int t = 0; t < cn; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const long long vt = __shfl_sync(0xffffffffu, vrow, t);
        const T* vr = v_pool + vt * Dv;
#pragma unroll
        for (int i = 0; i < kMaxDimPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < Dv) acc[i] += pt * repro::to_float(vr[d]);
        }
      }
      m = m_new;
    }

    if (splits == 1) {
      const float lv = l == 0.f ? 1.f : l;
#pragma unroll
      for (int i = 0; i < kMaxDimPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dv) out[(row0 + r) * Dv + d] = repro::from_float<T>(acc[i] / lv);
      }
    } else {  // task == warp here: R * splits <= kWarps
      if (lane == 0) {
        part_m[warp] = m;
        part_l[warp] = l;
      }
#pragma unroll
      for (int i = 0; i < kMaxDimPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dv) part_acc[warp * Dv + d] = acc[i];
      }
    }
  }

  if (splits > 1) {
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {  // merge row r's splits
      float mx = kNeg;
      for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, part_m[r + R * sp]);
      float lsum = 0.f;
      for (int sp = 0; sp < splits; ++sp) {
        lsum += part_l[r + R * sp] * expf(part_m[r + R * sp] - mx);
      }
      const float lv = lsum == 0.f ? 1.f : lsum;
      for (int d = lane; d < Dv; d += 32) {
        float a = 0.f;
        for (int sp = 0; sp < splits; ++sp) {
          const int w = r + R * sp;
          a += part_acc[w * Dv + d] * expf(part_m[w] - mx);
        }
        out[(row0 + r) * Dv + d] = repro::from_float<T>(a / lv);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* q_rope, const void* kr_pool, const void* pages,
                   const void* index, void* out, int B, int KH, int S, int R,
                   int Dk, int Dv, int Dr, int ps, int mp, float scale,
                   cudaStream_t stream) {
  const int splits = R >= kWarps ? 1 : kWarps / R;
  const size_t smem = splits > 1 ? sizeof(float) * kWarps * (2 + Dv) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  paged_attention_kernel<T><<<dim3(KH, B), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const T*>(q_rope),
      static_cast<const T*>(kr_pool), static_cast<const int*>(pages),
      static_cast<const int*>(index), static_cast<T*>(out), KH, S, R, Dk, Dv,
      Dr, ps, mp, scale);
  return cudaSuccess;
}

}  // namespace

extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* q_rope,
    const void* kr_pool, const void* pages, const void* index, void* out,
    int B, int H, int KH, int S, int Dk, int Dv, int Dr, int page_size,
    int max_pages, float scale, int dtype, void* stream) {
  if (B <= 0 || KH <= 0 || S <= 0 || H % KH || page_size <= 0 ||
      max_pages <= 0 || Dk > 32 * kMaxDimPerLane ||
      Dv > 32 * kMaxDimPerLane || Dr < 0 ||
      (Dr > 0 && (q_rope == nullptr || kr_pool == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const int R = (H / KH) * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kFloat32) {
    err = launch<float>(q, k_pool, v_pool, q_rope, kr_pool, pages, index, out,
                        B, KH, S, R, Dk, Dv, Dr, page_size, max_pages, scale, s);
  } else if (dtype == repro::kBFloat16) {
    err = launch<__nv_bfloat16>(q, k_pool, v_pool, q_rope, kr_pool, pages,
                                index, out, B, KH, S, R, Dk, Dv, Dr, page_size,
                                max_pages, scale, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
