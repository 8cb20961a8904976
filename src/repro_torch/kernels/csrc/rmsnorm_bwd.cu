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
// TB/s.  The dw partials (one f32 row a CTA) are written and read once more.
//
// Design: a persistent grid keeps the HBM stream busy across rows.
//
// - Rows go to row groups: a CTA holds `groups` groups of tpr threads (the
//   plan, kernels/rmsnorm.py:bwd_plan): a warp a row for rows of up to 32
//   chunks of 8 (d <= 256), else a group as wide as the row.  The grid is
//   sized from the card (SMs x the CTAs an SM holds), so every CTA is
//   resident, and group k of the grid takes rows k, k + G, k + 2G, ... (G
//   groups in all).  Few rows spread over more CTAs of fewer groups.
// - Each thread keeps nv slots of 8 elements in registers (16-byte loads
//   where d % 8 == 0 and the rows are aligned, elements tpr apart
//   otherwise).  Loads run ahead of the rows: with 16-byte chunks through
//   a ring of `stages` (2 or 3) rows in shared memory, each thread copying
//   its own chunks of x, dy and ds with cp.async (and reading back only
//   those, so no barrier is needed) stages - 1 rows ahead; otherwise
//   through a second set of registers, the next row's loads issued before
//   the current row's reduction.
// - A row's two sums, sum(x^2) and sum(x * w * dy), are reduced together:
//   by shuffles alone in a warp-wide group; across the group's warps
//   through shared memory on the group's own named barrier (one a row: the
//   slots alternate between two rows), never a CTA-wide barrier.
// - dw: each thread sums its columns' dy * x * r over its rows in
//   registers; the CTA's groups' sums are added in group order through
//   shared memory (after one CTA barrier), and the CTA writes one f32
//   partial row.  A second kernel, launched as a
//   programmatic dependent (PDL: its launch overlaps the first's tail),
//   sums the partial rows of each column: a CTA takes 32 columns, 16 lanes
//   of threads stride over the partial rows, and a fixed shared-memory
//   tree adds the 16 lanes.  No atomics: a call is bit for bit repeatable
//   (the order depends on the plan, so on the SM count).
// - Rows longer than the registers hold (d > 8192) take a two-pass loop
//   that re-reads the row and accumulates dw in the CTA's own partial row.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kChunk = 8;         // elements a thread loads at a time
constexpr int kCtaThreads = 512;  // the threads of a CTA, at most
constexpr int kRegChunks = 2;     // chunks a thread keeps in registers
constexpr int kMaxGroups = kCtaThreads / 32;
constexpr int kDwCols = 32;   // columns of a dw-reduction CTA
constexpr int kDwLanes = 16;  // its lanes of threads over the partial rows

struct Args {
  const void* x;   // the norm's input (add: the forward's sum s)
  const void* dy;  // gradient of the norm's output
  const void* ds;  // add: gradient of the sum output; null for plain
  const void* w;   // (d,)
  void* dx;
  float* partial;  // (gridDim.x, d): each CTA's dw terms
  int rows, d, groups;
  int stages;  // rows of the copy ring (16-byte layout); 0: the register double buffer
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

// 8 elements of a row as loaded, converted to f32 only where used, so the
// loads stay in flight until then
template <typename T, bool kVec>
struct Raw {
  T v[kChunk];
};
template <>
struct Raw<float, true> {
  float4 a, b;
};
template <>
struct Raw<__nv_bfloat16, true> {
  uint4 u;
};

template <typename T, bool kVec>
__device__ __forceinline__ void load_raw(const T* row, Slot s, int d, Raw<T, kVec>& r) {
  if constexpr (kVec && sizeof(T) == 4) {
    r.a = __ldg(reinterpret_cast<const float4*>(row + s.first));
    r.b = __ldg(reinterpret_cast<const float4*>(row + s.first) + 1);
  } else if constexpr (kVec) {
    r.u = __ldg(reinterpret_cast<const uint4*>(row + s.first));
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = s.first + e * s.step;
      r.v[e] = i < d ? row[i] : repro::from_float<T>(0.f);
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void to_f32(const Raw<T, kVec>& r, float (&v)[kChunk]) {
  if constexpr (kVec && sizeof(T) == 4) {
    v[0] = r.a.x; v[1] = r.a.y; v[2] = r.a.z; v[3] = r.a.w;
    v[4] = r.b.x; v[5] = r.b.y; v[6] = r.b.z; v[7] = r.b.w;
  } else if constexpr (kVec) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      v[2 * i] = __low2float(h[i]);
      v[2 * i + 1] = __high2float(h[i]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = repro::to_float(r.v[e]);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void load8(const T* row, Slot s, int d, float (&v)[kChunk]) {
  Raw<T, kVec> r;
  load_raw<T, kVec>(row, s, d, r);
  to_f32<T, kVec>(r, v);
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

// (sum of v.x, sum of v.y) over the row group's tpr threads; every thread
// gets both.  A warp-wide group reduces by shuffles alone; a wider one
// through `slots` (its warps' entries of this row's parity) on the group's
// named barrier.  The slots alternate between rows, so one barrier a row
// keeps a fast warp from overwriting what a slow one still reads.
__device__ __forceinline__ float2 group_sum2(float2 v, float2* slots, int g, int tpr) {
  v.x = repro::warp_sum(v.x);
  v.y = repro::warp_sum(v.y);
  if (tpr == 32) return v;
  const int warps = tpr >> 5, warp = (threadIdx.x >> 5) - g * warps;
  if ((threadIdx.x & 31) == 0) slots[warp] = v;
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(tpr) : "memory");
  float2 s = make_float2(0.f, 0.f);
  for (int i = 0; i < warps; ++i) {
    s.x += slots[i].x;
    s.y += slots[i].y;
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

// one row's x, dy (and ds) for a thread's nv slots, as loaded
template <typename T, int kNv, bool kVec, bool kAdd>
struct RowRaw {
  Raw<T, kVec> x[kNv], dy[kNv], ds[kAdd ? kNv : 1];
};

template <typename T, int kNv, bool kVec, bool kAdd>
__device__ __forceinline__ void load_row(const Args& a, int row, int t, int tpr,
                                         RowRaw<T, kNv, kVec, kAdd>& r) {
  const size_t off = static_cast<size_t>(row) * a.d;
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    const Slot s = slot_of<kVec>(j, t, tpr);
    if (s.first < a.d) {
      load_raw<T, kVec>(static_cast<const T*>(a.x) + off, s, a.d, r.x[j]);
      load_raw<T, kVec>(static_cast<const T*>(a.dy) + off, s, a.d, r.dy[j]);
      if constexpr (kAdd) load_raw<T, kVec>(static_cast<const T*>(a.ds) + off, s, a.d, r.ds[j]);
    }
  }
}

// One 16-byte (or two) asynchronous copy of a thread's chunk into its own
// shared-memory slot: cp.async, completed by cp.async.wait_group
template <typename T>
__device__ __forceinline__ void cp_async_chunk(Raw<T, true>* dst, const T* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(Raw<T, true>)) / 16; ++k) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + 16 * k),
                 "l"(reinterpret_cast<const char*>(src) + 16 * k)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's copy groups are in flight (n < 4)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// One row of a row group from its loaded chunks `cur`: the two sums,
// reduced over the group, then dx stored and the thread's dw terms added
template <typename T, int kNv, bool kVec, bool kAdd>
__device__ __forceinline__ void row_step(const Args& a, const RowRaw<T, kNv, kVec, kAdd>& cur,
                                         const float (&w)[kNv][kChunk],
                                         float (&dw)[kNv][kChunk], int row, int t, int tpr,
                                         int g, float2* slots) {
  float2 sm = make_float2(0.f, 0.f);
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    if (slot_of<kVec>(j, t, tpr).first < a.d) {
      float x[kChunk], dy[kChunk];
      to_f32(cur.x[j], x);
      to_f32(cur.dy[j], dy);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        sm.x += x[e] * x[e];
        sm.y += x[e] * w[j][e] * dy[e];
      }
    }
  }
  sm = group_sum2(sm, slots, g, tpr);
  const float inv_d = 1.f / static_cast<float>(a.d);
  const float r = rsqrtf(sm.x * inv_d + a.eps);
  const float c = r * r * r * sm.y * inv_d;
  T* dxs = static_cast<T*>(a.dx) + static_cast<size_t>(row) * a.d;
#pragma unroll
  for (int j = 0; j < kNv; ++j) {
    const Slot s = slot_of<kVec>(j, t, tpr);
    if (s.first < a.d) {  // converted again: fewer registers live across the reduction
      float x[kChunk], dy[kChunk], ds[kChunk] = {}, dx[kChunk];
      to_f32(cur.x[j], x);
      to_f32(cur.dy[j], dy);
      if constexpr (kAdd) to_f32(cur.ds[j], ds);
      row_grad<kAdd>(x, dy, ds, w[j], r, c, dx);
      store8<T, kVec>(dxs, s, a.d, dx);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) dw[j][e] += dy[e] * x[e] * r;
    }
  }
}

// The main pass (kNv > 0: the row in registers; kNv == 0: two passes a row)
template <typename T, int kNv, bool kVec, bool kAdd>
__global__ void __launch_bounds__(kCtaThreads, (kNv == 1 && sizeof(T) == 2) || kNv == 0 ? 2 : 1)
norm_bwd_rows(const Args a) {
  // the dw reduction may launch now: it waits for this grid's end itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the copy rings (16-byte layout, a.stages > 0), then the groups' dw terms
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 sums[2][kCtaThreads / 32];  // a row's sums, one entry a warp
  const int tpr = blockDim.x / a.groups;
  const int g = threadIdx.x / tpr, t = threadIdx.x - g * tpr;
  const int stride = gridDim.x * a.groups;  // the grid's row groups
  const int first_warp = g * (tpr >> 5);     // the group's reduction slots
  float* part = a.partial + static_cast<size_t>(blockIdx.x) * a.d;
  int row = blockIdx.x * a.groups + g;
  if constexpr (kNv > 0) {
    float w[kNv][kChunk], dw[kNv][kChunk];
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
      if (s.first < a.d) load_w8<kVec>(a, s, w[j]);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) dw[j][e] = 0.f;
    }
    RowRaw<T, kNv, kVec, kAdd> cur;
    if constexpr (kVec) {
      // a ring of `stages` rows a thread, each thread's own chunks: the
      // copies for rows stages - 1 ahead are in flight while a row is
      // reduced, and a thread reads back only what it copied (no barrier)
      constexpr int kTensors = kAdd ? 3 : 2;
      using R = Raw<T, true>;
      R* mine = reinterpret_cast<R*>(smem) +
                static_cast<size_t>(g) * a.stages * kTensors * kNv * tpr + t;
      const T* src[3] = {static_cast<const T*>(a.x), static_cast<const T*>(a.dy),
                         static_cast<const T*>(a.ds)};
      auto issue = [&](int r, int stage) {
        if (r < a.rows) {
          const size_t off = static_cast<size_t>(r) * a.d;
#pragma unroll
          for (int j = 0; j < kNv; ++j) {
            const Slot s = slot_of<true>(j, t, tpr);
            if (s.first < a.d) {
#pragma unroll
              for (int k = 0; k < kTensors; ++k) {
                cp_async_chunk(mine + ((stage * kTensors + k) * kNv + j) * tpr,
                               src[k] + off + s.first);
              }
            }
          }
        }
        cp_async_commit();  // empty past the last row: the group count stays uniform
      };
      for (int k = 0; k + 1 < a.stages; ++k) issue(row + k * stride, k);
      for (int i = 0; row < a.rows; row += stride, ++i) {
        const int stage = i % a.stages;
        issue(row + (a.stages - 1) * stride, (i + a.stages - 1) % a.stages);
        cp_async_wait(a.stages - 1);  // this row's copies have landed
#pragma unroll
        for (int j = 0; j < kNv; ++j) {
          if (slot_of<true>(j, t, tpr).first < a.d) {
            const R* at = mine + (stage * kTensors * kNv + j) * tpr;
            cur.x[j] = at[0];
            cur.dy[j] = at[kNv * tpr];
            if constexpr (kAdd) cur.ds[j] = at[2 * kNv * tpr];
          }
        }
        row_step(a, cur, w, dw, row, t, tpr, g, &sums[i & 1][first_warp]);
      }
      cp_async_wait(0);
    } else {
      // a register double buffer: the next row's loads go out before this
      // row's reduction
      RowRaw<T, kNv, kVec, kAdd> next;
      if (row < a.rows) load_row(a, row, t, tpr, cur);
      for (int i = 0; row < a.rows; row += stride, ++i) {
        if (row + stride < a.rows) load_row(a, row + stride, t, tpr, next);
        row_step(a, cur, w, dw, row, t, tpr, g, &sums[i & 1][first_warp]);
        cur = next;
      }
    }
    // the CTA's partial row: each group's terms, then (several groups)
    // their sum a column in group order, through shared memory (after
    // every group is done with its ring)
    float* cta_dw = reinterpret_cast<float*>(smem);
    if (a.groups > 1) __syncthreads();
    float* dst = a.groups == 1 ? part : cta_dw + static_cast<size_t>(g) * a.d;
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const int i = s.first + e * s.step;
        if (i < a.d) dst[i] = dw[j][e];
      }
    }
    if (a.groups > 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < a.d; i += blockDim.x) {
        float acc = cta_dw[i];
        for (int k = 1; k < a.groups; ++k) acc += cta_dw[static_cast<size_t>(k) * a.d + i];
        part[i] = acc;
      }
    }
  } else {  // two passes a row (one group a CTA); dw accumulates in the CTA's partial row
    const T* xs = static_cast<const T*>(a.x);
    const T* dys = static_cast<const T*>(a.dy);
    const T* dss = static_cast<const T*>(a.ds);
    T* dxs = static_cast<T*>(a.dx);
    const float inv_d = 1.f / static_cast<float>(a.d);
    float ds[kChunk] = {};
    bool first = true;
    for (int parity = 0; row < a.rows; row += stride, parity ^= 1) {
      const size_t off = static_cast<size_t>(row) * a.d;
      float x[kChunk], dy[kChunk], w[kChunk];
      float2 sm = make_float2(0.f, 0.f);
      for (int j = 0; slot_of<kVec>(j, t, tpr).first < a.d; ++j) {
        const Slot s = slot_of<kVec>(j, t, tpr);
        load8<T, kVec>(xs + off, s, a.d, x);
        load8<T, kVec>(dys + off, s, a.d, dy);
        load_w8<kVec>(a, s, w);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) {
          sm.x += x[e] * x[e];
          sm.y += x[e] * w[e] * dy[e];
        }
      }
      sm = group_sum2(sm, &sums[parity][first_warp], g, tpr);
      const float r = rsqrtf(sm.x * inv_d + a.eps);
      const float c = r * r * r * sm.y * inv_d;
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
          if (i < a.d) part[i] = (first ? 0.f : part[i]) + dy[e] * x[e] * r;
        }
      }
      first = false;
    }
    if (first) {  // a CTA with no row (never in the plan) still writes its row
      for (int i = threadIdx.x; i < a.d; i += blockDim.x) part[i] = 0.f;
    }
  }
}

// dw[i] = the sum of column i over the partial rows: lane l of the CTA's 16
// sums rows l, l + 16, ... in order (8 loads in flight a thread), then a
// fixed tree adds the lanes
__global__ void __launch_bounds__(kDwCols * kDwLanes)
norm_bwd_dw(const float* __restrict__ partial, void* dw, int n_part, int d, bool w_bf16) {
  // a programmatic dependent: wait for the main pass to end and its
  // partial rows to be visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ float acc[kDwLanes][kDwCols];
  const int c = threadIdx.x % kDwCols, lane = threadIdx.x / kDwCols;
  const int col = blockIdx.x * kDwCols + c;
  float s = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int p = lane; p < n_part; p += kDwLanes) s += partial[static_cast<size_t>(p) * d + col];
  }
  acc[lane][c] = s;
  __syncthreads();
#pragma unroll
  for (int o = kDwLanes / 2; o > 0; o >>= 1) {
    if (lane < o) acc[lane][c] += acc[lane + o][c];
    __syncthreads();
  }
  if (lane == 0 && col < d) {
    if (w_bf16) {
      static_cast<__nv_bfloat16*>(dw)[col] = __float2bfloat16(acc[0][c]);
    } else {
      static_cast<float*>(dw)[col] = acc[0][c];
    }
  }
}

// the most dynamic shared memory a CTA takes: the H100's 227 KB a CTA,
// less 1 KB for the static shared memory beside it
constexpr int kMaxSmem = 232448 - 1024;

template <typename T, int kNv, bool kVec, bool kAdd>
cudaError_t launch_rows(const Args& a, dim3 grid, dim3 block, size_t smem, cudaStream_t s) {
  static const cudaError_t smem_err = cudaFuncSetAttribute(
      norm_bwd_rows<T, kNv, kVec, kAdd>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (smem_err != cudaSuccess) return smem_err;
  norm_bwd_rows<T, kNv, kVec, kAdd><<<grid, block, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kVec, bool kAdd>
cudaError_t launch_form(const Args& a, dim3 grid, dim3 block, size_t smem, int nv,
                        cudaStream_t s) {
  if (nv == 1) return launch_rows<T, 1, kVec, kAdd>(a, grid, block, smem, s);
  if (nv == 2) return launch_rows<T, 2, kVec, kAdd>(a, grid, block, smem, s);
  return launch_rows<T, 0, kVec, kAdd>(a, grid, block, smem, s);
}

template <typename T>
cudaError_t launch(const Args& a, dim3 grid, dim3 block, size_t smem, int nv, bool vec,
                   cudaStream_t s) {
  const bool add = a.ds != nullptr;
  if (vec && add) return launch_form<T, true, true>(a, grid, block, smem, nv, s);
  if (vec) return launch_form<T, true, false>(a, grid, block, smem, nv, s);
  if (add) return launch_form<T, false, true>(a, grid, block, smem, nv, s);
  return launch_form<T, false, false>(a, grid, block, smem, nv, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Both kernels, one call.  The wrapper (kernels/rmsnorm.py, rmsnorm_bwd)
// checks shapes, picks the plan (bwd_plan: ctas, groups, tpr, nv, stages)
// and allocates the partials (ctas x d f32).
extern "C" int repro_rmsnorm_bwd(const void* x, const void* dy, const void* ds, const void* w,
                                 void* dx, void* partial, void* dw, int rows, int d, float eps,
                                 int dtype, int w_dtype, int ctas, int groups, int tpr, int nv,
                                 int stages, void* stream) {
  const int chunks = (d + kChunk - 1) / kChunk;
  if (rows <= 0 || d <= 0 || ctas <= 0 || groups < 1 || groups > kMaxGroups || tpr < 32 ||
      tpr % 32 || groups * tpr > kCtaThreads || nv < 0 || nv > kRegChunks ||
      (nv > 0 && chunks > nv * tpr) || (nv == 0 && groups != 1) || stages < 0 || stages > 4 ||
      stages == 1 || (stages > 0 && nv == 0) || !x || !dy || !w || !dx || !partial || !dw) {
    return cudaErrorInvalidValue;
  }
  if ((dtype != repro::kFloat32 && dtype != repro::kBFloat16) ||
      (w_dtype != repro::kFloat32 && w_dtype != repro::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  // 16-byte loads and stores, through the copy ring: rows of whole chunks,
  // every base aligned, a ring in the plan; else elements tpr apart
  // through the register double buffer
  const bool vec = d % kChunk == 0 && aligned16(x) && aligned16(dy) && aligned16(dx) &&
                   aligned16(w) && (ds == nullptr || aligned16(ds)) && stages > 0;
  if (!vec) stages = 0;
  const Args a{x, dy, ds, w, dx, static_cast<float*>(partial), rows, d, groups, stages, eps,
               w_dtype == repro::kBFloat16};
  // shared memory: the rings (stages x groups x tensors x the row's chunks),
  // reused after the rows for the groups' dw terms (groups x d floats, at
  // most 512 / tpr x (nv x tpr x 8) = 8192: 32 KB)
  const size_t elem = dtype == repro::kFloat32 ? 4 : 2;
  const size_t ring =
      static_cast<size_t>(stages) * groups * (ds ? 3 : 2) * nv * tpr * kChunk * elem;
  const size_t terms = groups > 1 ? static_cast<size_t>(groups) * d * sizeof(float) : 0;
  const size_t smem = ring > terms ? ring : terms;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ctas), block(groups * tpr);
  cudaError_t err = dtype == repro::kFloat32
                        ? launch<float>(a, grid, block, smem, nv, vec, s)
                        : launch<__nv_bfloat16>(a, grid, block, smem, nv, vec, s);
  if (err != cudaSuccess) return err;
  // the dw reduction, a programmatic dependent of the main pass
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((d + kDwCols - 1) / kDwCols);
  cfg.blockDim = dim3(kDwCols * kDwLanes);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, norm_bwd_dw, static_cast<const float*>(partial), dw, ctas, d,
                           w_dtype == repro::kBFloat16);
  return err != cudaSuccess ? err : cudaGetLastError();
}
