// RMSNorm backward, plain and add forms: dx and dw from (x, dy, w), per row
// in f32, with r = rsqrt(mean(x^2) + eps):
//
//   plain  dx = r * (w * dy) - x * r^3 * mean(x * w * dy)
//   add    the same on the forward's sum s = x + delta, plus ds, the
//          gradient arriving at the sum output (the residual stream);
//          the result is both dx and ddelta
//   dw     = sum over rows of dy * x * r, in w's type
//
// Replaces: repro/kernels/ref.py, rmsnorm_ref (:33), as XLA's autodiff
// differentiates it inside the reference's train step (no Pallas kernel of
// the reference has a backward); the add form also takes the residual add's
// gradient that XLA fuses beside it.
//
// Bound on the H100: bytes.  A row reads x and dy (and ds) once and writes
// dx once: 6 (add: 8) bytes an element in bf16, ~10 flops an element; at
// llama3.2-1b's train shape (4096 rows of 2048) ~50 MB, ~0.015 ms at 3.35
// TB/s.  The dw partials (CTAs x d f32) are written and read once more.
//
// Design: one read of the row, as the forward (csrc/rmsnorm.cu): a CTA of
// tpr threads (the forward's plan, kernels/rmsnorm.py:norm_plan) takes
// rows_per_cta consecutive rows, each thread holding nv slots of 8 elements
// in registers (16-byte loads where d % 8 == 0 and the rows are aligned,
// elements tpr apart otherwise).  The two row sums, sum(x^2) and
// sum(x * w * dy), are reduced together in one pass; dx is computed from the
// registers.  The weight's slots are loaded once per CTA and the thread's dw
// terms accumulate in registers over its rows, then go to the CTA's row of
// an f32 partial buffer; a second kernel sums the partials of each column
// over the CTAs in a fixed order.  No atomics: a call is bit for bit
// repeatable.  Rows longer than the registers hold (d > 8192) take a
// two-pass loop that re-reads the row and accumulates dw in the CTA's own
// partial row.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 8;         // elements a thread loads at a time
constexpr int kCtaThreads = 512;  // the most threads of a CTA
constexpr int kRegChunks = 2;     // chunks a thread keeps in registers
constexpr int kReduceThreads = 256;

struct Args {
  const void* x;   // the norm's input (add: the forward's sum s)
  const void* dy;  // gradient of the norm's output
  const void* ds;  // add: gradient of the sum output; null for plain
  const void* w;   // (d,)
  void* dx;
  float* partial;  // (n_cta, d) dw terms of each CTA
  int rows, d, rows_per_cta;
  float eps;
  bool w_bf16;
};

struct Slot {
  int first, step;
};

template <bool kVec>
__device__ __forceinline__ Slot slot_of(int j, int t, int tpr) {
  return kVec ? Slot{(j * tpr + t) * kChunk, 1} : Slot{j * kChunk * tpr + t, tpr};
}

// 8 elements of a row as f32 (0 past d)
template <typename T, bool kVec>
__device__ __forceinline__ void load8(const T* row, Slot s, int d, float (&v)[kChunk]) {
  if constexpr (kVec && sizeof(T) == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + s.first));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + s.first) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if constexpr (kVec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + s.first));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      v[2 * i] = __low2float(h[i]);
      v[2 * i + 1] = __high2float(h[i]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = s.first + e * s.step;
      v[e] = i < d ? repro::to_float(row[i]) : 0.f;
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store8(T* row, Slot s, int d, const float (&v)[kChunk]) {
  if constexpr (kVec && sizeof(T) == 4) {
    reinterpret_cast<float4*>(row + s.first)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(row + s.first)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else if constexpr (kVec) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(row + s.first) = u;
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = s.first + e * s.step;
      if (i < d) row[i] = repro::from_float<T>(v[e]);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void load_w8(const Args& a, Slot s, float (&v)[kChunk]) {
  if (a.w_bf16) {
    load8<__nv_bfloat16, kVec>(static_cast<const __nv_bfloat16*>(a.w), s, a.d, v);
  } else {
    load8<float, kVec>(static_cast<const float*>(a.w), s, a.d, v);
  }
}

// (sum of v.x, sum of v.y) over the CTA; every thread gets both.  The
// leading barrier lets a CTA call it once a row.
__device__ __forceinline__ float2 cta_sum2(float2 v) {
  __shared__ float2 part[kCtaThreads / 32];
  v.x = repro::warp_sum(v.x);
  v.y = repro::warp_sum(v.y);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return v;
  __syncthreads();  // the last row's partials are read
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int i = 0; i < warps; ++i) {
    s.x += part[i].x;
    s.y += part[i].y;
  }
  return s;
}

// the row's gradient from its sums: dx = r w dy - x c (+ ds), c = r^3 mean(x w dy)
template <bool kAdd>
__device__ __forceinline__ void row_grad(const float (&x)[kChunk], const float (&dy)[kChunk],
                                         const float (&ds)[kChunk], const float (&w)[kChunk],
                                         float r, float c, float (&dx)[kChunk]) {
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    dx[e] = r * w[e] * dy[e] - x[e] * c;
    if constexpr (kAdd) dx[e] += ds[e];
  }
}

template <typename T, int kNv, bool kVec, bool kAdd>
__global__ void __launch_bounds__(kCtaThreads)
norm_bwd_kernel(const Args a) {
  const int t = threadIdx.x, tpr = blockDim.x;
  const int r0 = blockIdx.x * a.rows_per_cta;
  const int r1 = min(a.rows, r0 + a.rows_per_cta);
  const T* xs = static_cast<const T*>(a.x);
  const T* dys = static_cast<const T*>(a.dy);
  const T* dss = static_cast<const T*>(a.ds);
  T* dxs = static_cast<T*>(a.dx);
  float* part = a.partial + static_cast<size_t>(blockIdx.x) * a.d;
  const float inv_d = 1.f / static_cast<float>(a.d);
  float ds[kChunk] = {};
  if constexpr (kNv > 0) {
    float w[kNv][kChunk], dw[kNv][kChunk];
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
      if (s.first < a.d) load_w8<kVec>(a, s, w[j]);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) dw[j][e] = 0.f;
    }
    for (int row = r0; row < r1; ++row) {
      const size_t off = static_cast<size_t>(row) * a.d;
      float x[kNv][kChunk], dy[kNv][kChunk];
      float2 sums = make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < kNv; ++j) {
        const Slot s = slot_of<kVec>(j, t, tpr);
        if (s.first < a.d) {
          load8<T, kVec>(xs + off, s, a.d, x[j]);
          load8<T, kVec>(dys + off, s, a.d, dy[j]);
#pragma unroll
          for (int e = 0; e < kChunk; ++e) {
            sums.x += x[j][e] * x[j][e];
            sums.y += x[j][e] * w[j][e] * dy[j][e];
          }
        }
      }
      sums = cta_sum2(sums);
      const float r = rsqrtf(sums.x * inv_d + a.eps);
      const float c = r * r * r * sums.y * inv_d;
#pragma unroll
      for (int j = 0; j < kNv; ++j) {
        const Slot s = slot_of<kVec>(j, t, tpr);
        if (s.first < a.d) {
          if constexpr (kAdd) load8<T, kVec>(dss + off, s, a.d, ds);
          float dx[kChunk];
          row_grad<kAdd>(x[j], dy[j], ds, w[j], r, c, dx);
          store8<T, kVec>(dxs + off, s, a.d, dx);
#pragma unroll
          for (int e = 0; e < kChunk; ++e) dw[j][e] += dy[j][e] * x[j][e] * r;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
      if (s.first < a.d) {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          const int i = s.first + e * s.step;
          if (i < a.d) part[i] = dw[j][e];
        }
      }
    }
  } else {  // two passes a row; dw accumulates in this CTA's partial row
    for (int row = r0; row < r1; ++row) {
      const size_t off = static_cast<size_t>(row) * a.d;
      float x[kChunk], dy[kChunk], w[kChunk];
      float2 sums = make_float2(0.f, 0.f);
      for (int j = 0; slot_of<kVec>(j, t, tpr).first < a.d; ++j) {
        const Slot s = slot_of<kVec>(j, t, tpr);
        load8<T, kVec>(xs + off, s, a.d, x);
        load8<T, kVec>(dys + off, s, a.d, dy);
        load_w8<kVec>(a, s, w);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          sums.x += x[e] * x[e];
          sums.y += x[e] * w[e] * dy[e];
        }
      }
      sums = cta_sum2(sums);
      const float r = rsqrtf(sums.x * inv_d + a.eps);
      const float c = r * r * r * sums.y * inv_d;
      for (int j = 0; slot_of<kVec>(j, t, tpr).first < a.d; ++j) {
        const Slot s = slot_of<kVec>(j, t, tpr);
        load8<T, kVec>(xs + off, s, a.d, x);
        load8<T, kVec>(dys + off, s, a.d, dy);
        load_w8<kVec>(a, s, w);
        if constexpr (kAdd) load8<T, kVec>(dss + off, s, a.d, ds);
        float dx[kChunk];
        row_grad<kAdd>(x, dy, ds, w, r, c, dx);
        store8<T, kVec>(dxs + off, s, a.d, dx);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          const int i = s.first + e * s.step;
          if (i < a.d) part[i] = (row == r0 ? 0.f : part[i]) + dy[e] * x[e] * r;
        }
      }
    }
  }
}

// dw[i] = sum over the CTAs' partial rows, in CTA order
__global__ void __launch_bounds__(kReduceThreads)
dw_kernel(const float* __restrict__ partial, void* dw, int n_cta, int d, bool w_bf16) {
  const int i = blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= d) return;
  float acc = 0.f;
  for (int c = 0; c < n_cta; ++c) acc += partial[static_cast<size_t>(c) * d + i];
  if (w_bf16) {
    static_cast<__nv_bfloat16*>(dw)[i] = __float2bfloat16(acc);
  } else {
    static_cast<float*>(dw)[i] = acc;
  }
}

template <typename T, bool kVec, bool kAdd>
void launch_form(const Args& a, int n_cta, int tpr, int nv, cudaStream_t s) {
  if (nv == 1) {
    norm_bwd_kernel<T, 1, kVec, kAdd><<<n_cta, tpr, 0, s>>>(a);
  } else if (nv == 2) {
    norm_bwd_kernel<T, 2, kVec, kAdd><<<n_cta, tpr, 0, s>>>(a);
  } else {
    norm_bwd_kernel<T, 0, kVec, kAdd><<<n_cta, tpr, 0, s>>>(a);
  }
}

template <typename T>
void launch(const Args& a, int n_cta, int tpr, int nv, bool vec, cudaStream_t s) {
  const bool add = a.ds != nullptr;
  if (vec && add) launch_form<T, true, true>(a, n_cta, tpr, nv, s);
  else if (vec) launch_form<T, true, false>(a, n_cta, tpr, nv, s);
  else if (add) launch_form<T, false, true>(a, n_cta, tpr, nv, s);
  else launch_form<T, false, false>(a, n_cta, tpr, nv, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Both kernels, one call.  The wrapper (kernels/rmsnorm.py, rmsnorm_bwd)
// checks shapes, allocates the partials (n_cta x d f32) and picks the plan.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* dy, const void* ds, const void* w,
                                 void* dx, void* partial, void* dw, int rows, int d, float eps,
                                 int dtype, int w_dtype, int rows_per_cta, int tpr, int nv,
                                 void* stream) {
  const int chunks = (d + kChunk - 1) / kChunk;
  if (rows <= 0 || d <= 0 || rows_per_cta <= 0 || tpr < 32 || tpr % 32 ||
      tpr > kCtaThreads || nv < 0 || nv > kRegChunks || (nv > 0 && chunks > nv * tpr) ||
      !x || !dy || !w || !dx || !partial || !dw) {
    return cudaErrorInvalidValue;
  }
  if ((dtype != repro::kFloat32 && dtype != repro::kBFloat16) ||
      (w_dtype != repro::kFloat32 && w_dtype != repro::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  const int n_cta = (rows + rows_per_cta - 1) / rows_per_cta;
  const Args a{x, dy, ds, w, dx, static_cast<float*>(partial), rows, d, rows_per_cta, eps,
               w_dtype == repro::kBFloat16};
  // 16-byte loads and stores: rows of whole chunks, every base aligned
  const bool vec = d % kChunk == 0 && aligned16(x) && aligned16(dy) && aligned16(dx) &&
                   aligned16(w) && (ds == nullptr || aligned16(ds));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) launch<float>(a, n_cta, tpr, nv, vec, s);
  else launch<__nv_bfloat16>(a, n_cta, tpr, nv, vec, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_kernel<<<(d + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, s>>>(
      static_cast<const float*>(partial), dw, n_cta, d, w_dtype == repro::kBFloat16);
  return cudaGetLastError();
}
