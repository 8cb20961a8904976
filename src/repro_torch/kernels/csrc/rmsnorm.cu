// RMSNorm in three forms over one row-reduction body, per row in f32:
//
//   plain  out = cast(x * rsqrt(mean(x^2) + eps) * w)
//   add    s = cast(x + delta);  out = plain(s)
//          (the residual add before a block's norm, rounded to x's type
//          before the norm squares it, as the reference adds in x.dtype)
//   gated  g = (y + d_skip[h] * x) * silu(z);
//          out = cast(g * rsqrt(mean(g^2) + eps) * w)
//          (Mamba-2's gated norm over rows of di = H * P; y is f32, x, z and
//          out are the compute type)
//
// Replaces: repro/kernels/rmsnorm.py, rmsnorm_pallas (_rmsnorm_kernel), and
// the jnp code XLA fuses around it inside the reference's jitted step: the
// residual adds that feed each norm (repro/models/lm.py:236-245, 262, and
// the final norm's input) and the gated norm (repro/models/ssm.py:149-157).
//
// Bound on the H100: bytes.  Each form reads its inputs once and writes its
// outputs once (the (d,) weight and (H,) skip are small): plain 2 rows * d,
// add 4 rows * d elements, gated 10 bytes an element at f32 y and bf16 x, z,
// out; ~3-12 flops an element against ~295 the tensor cores would need per
// byte.  At decode (8 rows) the bytes take well under a microsecond at 3.35
// TB/s, so the time is one launch and one dependent round trip to memory; at
// prefill (512 rows) it is bandwidth.
//
// Design: every load is issued before any arithmetic.  A row is served by a
// CTA of tpr threads (a multiple of 32, up to 512), each holding nv slots
// of 8 elements in registers (16-byte loads of bf16, two of f32): x, delta
// or y / x / z, and the weight, all at once (bf16 stays packed until used).
// The sum of squares is reduced in f32 (warp shuffles, then one
// shared-memory pass over the CTA's warps), and the row is scaled from the
// registers and written with 16-byte stores: one read of the row, where the
// first kernel read it twice.  A CTA serves one row; the host picks tpr
// from d (kernels/rmsnorm.py, norm_plan): rows of up to 1024 chunks of 8,
// d <= 8192, stay in registers, longer rows take a two-pass loop that
// recomputes the row from its inputs.  (A row split across a cluster of up to 8 CTAs, reduced through
// distributed shared memory, was slower at decode: +1.0-1.4 us plain,
// +0.5-0.8 us gated, on the cluster launch and barrier.)  Vector loads need
// d and the gated head dim multiples of 8, 16-byte aligned pointers and
// 16-byte steps; the gated form decides per operand, since in the Mamba-2
// decode step x arrives head dim outermost (from the conv's einsum) and
// takes strided loads.  Any other layout takes the scalar path of the same
// body, elements tpr apart so that a warp's loads coalesce: no d, no row
// count and no stride is refused.  Each operand is read in place through
// its (batch, sequence, head, dim) strides: z and x are column slices of
// wider tensors in the Mamba-2 block.  Nothing is written in place: s and
// out are fresh outputs.
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kChunk = 8;         // elements a thread loads at a time
constexpr int kCtaThreads = 512;  // threads of a CTA
constexpr int kRegChunks = 2;     // chunks a thread keeps in registers
// from this many rows (about the H100's 132 SMs: past it rows wait for a
// second CTA slot on an SM) the gated form loads its weight late (kLateW)
constexpr int kLateWeightRows = 128;

enum Form { kPlain = 0, kAdd = 1, kGated = 2 };

// an input read in place: element (h, i) of row (b, t) at
// p + b * sb + t * ss + h * sh + i * sp (elements); plain and add rows are
// one dense head of d elements
struct Operand {
  const void* p;
  long long sb, ss, sh, sp;
  bool vec;  // 16-byte loads: aligned, sp == 1, 16-byte steps
};

struct Args {
  Operand a, b, c;  // plain, add: x, delta; gated: y (f32), x, z
  const void* skip;  // gated: d_skip (H,), the weight's type
  const void* w;     // (d,)
  void* s_out;       // add: x + delta, contiguous rows
  void* out;         // contiguous rows
  int rows, seq, d, head_dim;
  float eps;
  bool w_bf16;
};

// 8 elements as loaded: bf16 stay packed in 4 registers until used
template <typename T>
struct Pack {
  float v[kChunk];
  __device__ __forceinline__ float get(int e) const { return v[e]; }
};
template <>
struct Pack<__nv_bfloat16> {
  __nv_bfloat162 h[kChunk / 2];
  __device__ __forceinline__ float get(int e) const {
    return e & 1 ? __high2float(h[e >> 1]) : __low2float(h[e >> 1]);
  }
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, Pack<T>& out) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    out.v[0] = a.x; out.v[1] = a.y; out.v[2] = a.z; out.v[3] = a.w;
    out.v[4] = b.x; out.v[5] = b.y; out.v[6] = b.z; out.v[7] = b.w;
  } else {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) out.h[i] = h[i];
  }
}

template <typename T>
__device__ __forceinline__ void set(Pack<T>& out, int e, T x) {
  if constexpr (sizeof(T) == 4) {
    out.v[e] = x;
  } else if (e & 1) {
    out.h[e >> 1].y = x;
  } else {
    out.h[e >> 1].x = x;
  }
}

// A thread's slot of 8 elements of a row: element e at first + e * step.
// The vector path takes 8 neighbours (a chunk of 8, in one head); the
// scalar path takes elements tpr apart, so that a warp's loads coalesce.
struct Slot {
  int first, step;
};

template <bool kVec>
__device__ __forceinline__ Slot slot_of(int j, int t, int tpr) {
  return kVec ? Slot{(j * tpr + t) * kChunk, 1} : Slot{j * kChunk * tpr + t, tpr};
}

// the slot's elements of one operand's row into `out` (0 past d).  kHeads:
// the row is read through the operand's head strides (the gated form's
// (H, P) rows); otherwise it is dense.
template <typename T, bool kVec, bool kHeads>
__device__ __forceinline__ void load8(const T* row, const Operand& o, Slot s, int d,
                                      int head_dim, Pack<T>& out) {
  if constexpr (kVec) {
    const T* p = row + s.first;
    if constexpr (kHeads) {
      const int h = s.first / head_dim;
      p = row + h * o.sh + (s.first - h * head_dim) * o.sp;
      if (!o.vec) {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) set(out, e, p[e * o.sp]);
        return;
      }
    }
    load_vec<T>(p, out);
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = s.first + e * s.step;
      T x = repro::from_float<T>(0.f);
      if (i < d) {
        if constexpr (kHeads) {
          const int h = i / head_dim;
          x = row[h * o.sh + (i - h * head_dim) * o.sp];
        } else {
          x = row[i];
        }
      }
      set(out, e, x);
    }
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store8(T* row, Slot s, int d, const float (&v)[kChunk]) {
  if constexpr (kVec) {
    T* p = row + s.first;
    if constexpr (sizeof(T) == 4) {
      reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < kChunk / 2; ++i)
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);  // round to nearest even
      *reinterpret_cast<uint4*>(p) = u;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = s.first + e * s.step;
      if (i < d) row[i] = repro::from_float<T>(v[e]);
    }
  }
}

__device__ __forceinline__ float load_param(const void* p, bool bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// the slot of the weight, f32 or bf16 (a uniform branch)
template <bool kVec>
__device__ __forceinline__ void load_w8(const void* w, bool bf16, Slot s, int d,
                                        float (&v)[kChunk]) {
  if (kVec && !bf16) {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(w) + s.first);
    const float4 a = __ldg(p), b = __ldg(p + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else if (kVec) {
    Pack<__nv_bfloat16> pk;
    load_vec(static_cast<const __nv_bfloat16*>(w) + s.first, pk);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = pk.get(e);
  } else {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      const int i = s.first + e * s.step;
      v[e] = i < d ? load_param(w, bf16, i) : 0.f;
    }
  }
}

// A slot's inputs as loaded: loads only, so that a thread issues every
// load of its slots before the first use of any.
template <int kForm, typename T>
struct Raw {
  using A = typename std::conditional<kForm == kGated, float, T>::type;
  Pack<A> a;                               // x, or gated y
  Pack<T> b;                               // delta, or gated x
  Pack<T> c;                               // gated z
  float skip[kForm == kGated ? kChunk : 1];  // gated d_skip per element
  float w[kChunk];
};

// one row's operands
template <int kForm, typename T>
struct Row {
  const typename Raw<kForm, T>::A* a;
  const T* b;
  const T* c;
  T* s;
  T* out;
};

template <int kForm, typename T>
__device__ __forceinline__ Row<kForm, T> row_of(const Args& a, int row) {
  using A = typename Raw<kForm, T>::A;
  const long long b = row / a.seq, t = row % a.seq;
  Row<kForm, T> r{};
  r.a = static_cast<const A*>(a.a.p) + b * a.a.sb + t * a.a.ss;
  if constexpr (kForm != kPlain) r.b = static_cast<const T*>(a.b.p) + b * a.b.sb + t * a.b.ss;
  if constexpr (kForm == kGated) r.c = static_cast<const T*>(a.c.p) + b * a.c.sb + t * a.c.ss;
  if constexpr (kForm == kAdd) r.s = static_cast<T*>(a.s_out) + static_cast<size_t>(row) * a.d;
  r.out = static_cast<T*>(a.out) + static_cast<size_t>(row) * a.d;
  return r;
}

template <int kForm, typename T, bool kVec>
__device__ __forceinline__ void load_slot(const Args& a, const Row<kForm, T>& r, Slot s,
                                          Raw<kForm, T>& raw, bool with_w) {
  using A = typename Raw<kForm, T>::A;
  constexpr bool kHeads = kForm == kGated;
  load8<A, kVec, kHeads>(r.a, a.a, s, a.d, a.head_dim, raw.a);
  if constexpr (kForm != kPlain) load8<T, kVec, kHeads>(r.b, a.b, s, a.d, a.head_dim, raw.b);
  if constexpr (kForm == kGated) {
    load8<T, kVec, kHeads>(r.c, a.c, s, a.d, a.head_dim, raw.c);
    if constexpr (kVec) {  // one head a chunk
      const float sk = load_param(a.skip, a.w_bf16, s.first / a.head_dim);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) raw.skip[e] = sk;
    } else {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        const int i = s.first + e * s.step;
        raw.skip[e] = i < a.d ? load_param(a.skip, a.w_bf16, i / a.head_dim) : 0.f;
      }
    }
  }
  if (with_w) load_w8<kVec>(a.w, a.w_bf16, s, a.d, raw.w);
}

// the row's values before the norm (add: also writes s)
template <int kForm, typename T, bool kVec>
__device__ __forceinline__ void pre_norm(const Row<kForm, T>& r, Slot s, int d,
                                         const Raw<kForm, T>& raw, bool write_s,
                                         float (&v)[kChunk]) {
#pragma unroll
  for (int e = 0; e < kChunk; ++e) {
    if constexpr (kForm == kPlain) {
      v[e] = raw.a.get(e);
    } else if constexpr (kForm == kAdd) {
      // rounded to T before the norm, as torch's add in x.dtype
      v[e] = repro::to_float(repro::from_float<T>(raw.a.get(e) + raw.b.get(e)));
    } else {
      // (y + d_skip * x) * silu(z), each op rounded as the plain version's
      const float zz = raw.c.get(e);
      const float yy = __fadd_rn(raw.a.get(e), __fmul_rn(raw.skip[e], raw.b.get(e)));
      v[e] = __fmul_rn(yy, zz / (1.f + expf(-zz)));
    }
  }
  if constexpr (kForm == kAdd) {
    if (write_s) store8<T, kVec>(r.s, s, d, v);
  }
}

// the sum of ss over the CTA (a multiple of 32 threads); every thread
// calls it and gets the same sum
__device__ __forceinline__ float cta_sum(float ss) {
  __shared__ float partial[kCtaThreads / 32];
  ss = repro::warp_sum(ss);
  const int warps = blockDim.x >> 5;
  if (warps > 1) {
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int i = 0; i < warps; ++i) ss += partial[i];
  }
  return ss;
}

// kNv > 0: the thread's kNv slots stay in registers; kNv == 0: a two-pass
// loop over the row (rows past kRegChunks * kCtaThreads chunks).
// kLateW (the gated form at two chunks a thread, hundreds of rows): two
// chunks of y, x, z and w take ~100 registers a thread, one CTA an SM at
// mamba2's rows; loading the weight once the inputs are reduced to v, just
// before the row's reduction, leaves two.  At a few rows the weight's
// round trip would show, and it is loaded with the rest.
template <int kForm, typename T, int kNv, bool kVec, bool kLateW>
__global__ void __launch_bounds__(kCtaThreads)
norm_kernel(const Args a) {
  const int t = threadIdx.x, tpr = blockDim.x;
  const Row<kForm, T> r = row_of<kForm, T>(a, blockIdx.x);
  float ss = 0.f;
  if constexpr (kNv > 0) {
    Raw<kForm, T> raw[kNv];
    float v[kNv][kChunk];
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
      if (s.first < a.d) load_slot<kForm, T, kVec>(a, r, s, raw[j], !kLateW);
    }
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
      if (s.first < a.d) {
        pre_norm<kForm, T, kVec>(r, s, a.d, raw[j], true, v[j]);
#pragma unroll
        for (int e = 0; e < kChunk; ++e) ss += v[j][e] * v[j][e];
        if constexpr (kLateW) load_w8<kVec>(a.w, a.w_bf16, s, a.d, raw[j].w);
      }
    }
    const float inv = rsqrtf(cta_sum(ss) / static_cast<float>(a.d) + a.eps);
#pragma unroll
    for (int j = 0; j < kNv; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
      if (s.first < a.d) {
#pragma unroll
        for (int e = 0; e < kChunk; ++e) v[j][e] = v[j][e] * inv * raw[j].w[e];
        store8<T, kVec>(r.out, s, a.d, v[j]);
      }
    }
  } else {
    Raw<kForm, T> raw;
    float v[kChunk];
    for (int j = 0; slot_of<kVec>(j, t, tpr).first < a.d; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
      load_slot<kForm, T, kVec>(a, r, s, raw, false);
      pre_norm<kForm, T, kVec>(r, s, a.d, raw, true, v);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) ss += v[e] * v[e];
    }
    const float inv = rsqrtf(cta_sum(ss) / static_cast<float>(a.d) + a.eps);
    // the second pass recomputes the row from its inputs (L2-resident)
    for (int j = 0; slot_of<kVec>(j, t, tpr).first < a.d; ++j) {
      const Slot s = slot_of<kVec>(j, t, tpr);
      load_slot<kForm, T, kVec>(a, r, s, raw, true);
      pre_norm<kForm, T, kVec>(r, s, a.d, raw, false, v);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) v[e] = v[e] * inv * raw.w[e];
      store8<T, kVec>(r.out, s, a.d, v);
    }
  }
}

template <int kForm, typename T, bool kVec>
void launch_form(const Args& a, int tpr, int nv, cudaStream_t s) {
  if (nv == 1) {
    norm_kernel<kForm, T, 1, kVec, false><<<a.rows, tpr, 0, s>>>(a);
  } else if (nv == 2 && kForm == kGated && a.rows >= kLateWeightRows) {
    norm_kernel<kForm, T, 2, kVec, kForm == kGated><<<a.rows, tpr, 0, s>>>(a);
  } else if (nv == 2) {
    norm_kernel<kForm, T, 2, kVec, false><<<a.rows, tpr, 0, s>>>(a);
  } else {
    norm_kernel<kForm, T, 0, kVec, false><<<a.rows, tpr, 0, s>>>(a);
  }
}

template <int kForm, typename T>
void launch_form(const Args& a, int tpr, int nv, bool vec, cudaStream_t s) {
  if (vec) launch_form<kForm, T, true>(a, tpr, nv, s);
  else launch_form<kForm, T, false>(a, tpr, nv, s);
}

template <typename T>
void launch(int form, const Args& a, int tpr, int nv, bool vec, cudaStream_t s) {
  if (form == kPlain) launch_form<kPlain, T>(a, tpr, nv, vec, s);
  else if (form == kAdd) launch_form<kAdd, T>(a, tpr, nv, vec, s);
  else launch_form<kGated, T>(a, tpr, nv, vec, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// 16-byte loads of an operand of e-byte elements: an aligned base, unit
// steps within a head and 16-byte steps between heads, rows and batches
bool vector_operand(const Operand& o, int e) {
  return o.p && aligned16(o.p) && o.sp == 1 && (o.sb * e) % 16 == 0 && (o.ss * e) % 16 == 0 &&
         (o.sh * e) % 16 == 0;
}

}  // namespace

// The wrapper (kernels/rmsnorm.py) checks shapes and picks the plan; this
// entry point refuses a plan the kernel cannot run, and picks the vector
// path itself from d, the head dim, the pointers and the strides.
extern "C" int repro_rmsnorm(int form, const void* a, const void* b, const void* c,
                             const void* skip, const void* w, void* s_out, void* out,
                             long long a_sb, long long a_ss, long long a_sh, long long a_sp,
                             long long b_sb, long long b_ss, long long b_sh, long long b_sp,
                             long long c_sb, long long c_ss, long long c_sh, long long c_sp,
                             int rows, int seq, int d, int head_dim, float eps, int dtype,
                             int w_dtype, int tpr, int nv, void* stream) {
  const int chunks = (d + kChunk - 1) / kChunk;
  if (form < kPlain || form > kGated || rows <= 0 || d <= 0 || seq <= 0 || rows % seq ||
      head_dim <= 0 || d % head_dim || tpr < 32 || tpr % 32 || tpr > kCtaThreads || nv < 0 ||
      nv > kRegChunks || (nv > 0 && chunks > nv * tpr) ||
      !a || !w || !out || (form == kAdd && (!b || !s_out)) ||
      (form == kGated && (!b || !c || !skip))) {
    return cudaErrorInvalidValue;
  }
  if ((dtype != repro::kFloat32 && dtype != repro::kBFloat16) ||
      (w_dtype != repro::kFloat32 && w_dtype != repro::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  const int e = dtype == repro::kFloat32 ? 4 : 2;
  Args args{{a, a_sb, a_ss, a_sh, a_sp, false}, {b, b_sb, b_ss, b_sh, b_sp, false},
            {c, c_sb, c_ss, c_sh, c_sp, false}, skip, w, s_out, out,
            rows, seq, d, head_dim, eps, w_dtype == repro::kBFloat16};
  args.a.vec = vector_operand(args.a, form == kGated ? 4 : e);  // the gated form's y is f32
  args.b.vec = form != kPlain && vector_operand(args.b, e);
  args.c.vec = form == kGated && vector_operand(args.c, e);
  // the row's chunks in one head each, and the outputs and the weight
  // written / read with 16-byte vectors; plain and add rows load only so
  bool vec = d % kChunk == 0 && head_dim % kChunk == 0 && aligned16(out) && aligned16(w) &&
             (form != kAdd || aligned16(s_out));
  if (form != kGated) vec = vec && args.a.vec && (form == kPlain || args.b.vec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) {
    launch<float>(form, args, tpr, nv, vec, s);
  } else {
    launch<__nv_bfloat16>(form, args, tpr, nv, vec, s);
  }
  return cudaGetLastError();
}
