// Grouped MoE expert products over the routed (token, expert) pairs:
//
//   h[pair]  = cast(cast(silu(cast(x[t] @ w_gate[e]))) * cast(x[t] @ w_up[e]))
//   y[pair]  = cast(cast(h[pair] @ w_down[e]) * cast(w[pair]))
//   out[t]   = y[t, 0] + y[t, 1] + ...   (in slot order, each add cast)
//
// for pair = t * top_k + j, the j-th expert e = topi[t, j] of token t and
// its combine weight w = topv[t, j]; cast rounds to the operands' type.
// These are the capacity route's roundings (repro_torch/models/moe.py):
// the two differ only in the order a product accumulates.
//
// Replaces no TPU kernel: the reference's expert products are einsums that
// XLA compiles (repro/models/moe.py), batched over every expert's capacity
// slots.  At decode that reads every expert's weights (160 x 3 x 5120 x
// 1536 bf16 a DeepSeek-V2 layer) and builds (B, E, C, D) dispatch and
// combine tensors for a few hundred routed rows.  This kernel serves only
// the calls where no choice can drop (a row's S tokens within an expert's
// capacity), so it needs no slots: it reads the experts the tokens chose.
//
// Bound on the H100: bytes, the touched experts' three D x F matrices (an
// expert's rows are the few tokens that chose it, ~1-2 at decode, far
// below the ~295 flops a byte where the tensor cores would bound it).
//
// Four launches on the stream, no atomics on values (a replay is the same
// bits as its eager call):
//   1. moe_pack (one CTA): each expert's pair count, their offsets and the
//      pair ids grouped by expert (the order within an expert's group may
//      differ between calls: each row's products depend on no other row,
//      so the results do not); it adds the experts read and held to the
//      call's tally, a (2,) int64 the wrapper keeps on the device.
//   2. gate/up (grid: F / 64 column tiles x E experts): a CTA reads its
//      expert's count and returns before any weight load if it is 0.
//      Otherwise it streams w_gate[e] and w_up[e] in 64 x 64 K-slices
//      through a 4-stage cp.async ring, with the expert's routed x rows
//      (gathered by token) beside each slice, and multiplies with mma.sync
//      m16n8k16 (bf16): up to 4 M-tiles of 16 rows a pass share each
//      staged weight fragment, and an expert with more rows takes further
//      passes.  Its epilogue writes h = silu(g) u by the pair's place in
//      the expert grouping: g and u never reach device memory.
//   3. down (grid: D / 64 x E): the same skip and ring over h's rows (one
//      expert's are contiguous) and w_down[e]; the epilogue scales by the
//      combine weight and writes row `pair` of the (T, top_k, D) buffer y.
//   4. combine: each token's top_k rows of y summed in slot order.
// Tiles are swizzled (16-byte chunk c of a 128-byte row r at c ^ (r % 8)),
// so ldmatrix reads them without bank conflicts.  f32 operands take the
// CUDA cores through the same grid and the same skip (the f32 served
// traces; no tensor-core route keeps f32's bits).
#include <algorithm>
#include <climits>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;        // the column tile (N) and the K-slice
constexpr int kRowBytes = 128;   // a tile row: 64 bf16
constexpr int kStages = 4;       // the cp.async ring
constexpr int kThreads = 128;    // 4 warps, 16 columns each
constexpr int kMaxMTiles = 4;    // mma.sync M-tiles a pass holds
constexpr int kPassRows = 16 * kMaxMTiles;
constexpr int kPackThreads = 1024;
constexpr int kMaxExperts = 1024;
constexpr int kSimtRows = 16;    // rows a pass of the f32 route holds

struct Args {
  const void* a;         // gate/up: x (T, K); down: h (P, K) grouped by expert
  const void* w0;        // (E, K, N): w_gate, or w_down
  const void* w1;        // (E, K, N): w_up (gate/up only)
  const int* offsets;    // (E + 1,) each expert's first grouped row
  const int* order;      // (P,) pair ids grouped by expert
  const float* topv;     // (P,) combine weights (down only)
  void* out;             // gate/up: h (P, N) by grouped row; down: y (P, N) by pair
  int K, N, top_k;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// The rows of the pass from grouped row `first` of expert rows [lo, lo + rows):
// the A row each reads (a token of x, or a grouped row of h; -1 past the
// pass), where its result goes, and (down) its combine weight rounded to
// the operands' type.
template <bool kGated, typename T>
__device__ __forceinline__ void pass_rows(const Args& m, int lo, int first, int n_rows,
                                          int cap, int* src, int* dst, float* wt) {
  for (int r = threadIdx.x; r < cap; r += blockDim.x) {
    if (r < n_rows) {
      const int row = lo + first + r;
      const int pair = m.order[row];
      src[r] = kGated ? pair / m.top_k : row;
      dst[r] = kGated ? row : pair;
      wt[r] = kGated ? 0.0f : repro::to_float(repro::from_float<T>(m.topv[pair]));
    } else {
      src[r] = -1;
    }
  }
}

// -- 1. pack ---------------------------------------------------------------------

__global__ void __launch_bounds__(kPackThreads) moe_pack(
    const long long* topi, int pairs, int n_experts, int* offsets, int* order,
    unsigned long long* tally) {
  __shared__ int count[kMaxExperts];
  __shared__ int cursor[kMaxExperts];
  for (int e = threadIdx.x; e < n_experts; e += blockDim.x) count[e] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const long long e = topi[p];
    if (e >= 0 && e < n_experts) atomicAdd(&count[e], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // an exclusive scan over the experts, a chunk a lane
    const int lane = threadIdx.x;
    const int per = (n_experts + 31) / 32;
    const int lo = min(lane * per, n_experts), hi = min(lo + per, n_experts);
    int sum = 0, touched = 0;
    for (int e = lo; e < hi; ++e) {
      sum += count[e];
      touched += count[e] > 0;
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    int run = incl - sum;
    for (int e = lo; e < hi; ++e) {
      offsets[e] = run;
      cursor[e] = run;
      run += count[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) touched += __shfl_xor_sync(0xffffffffu, touched, o);
    if (lane == 31) offsets[n_experts] = incl;
    if (lane == 0) {
      atomicAdd(&tally[0], static_cast<unsigned long long>(touched));
      atomicAdd(&tally[1], static_cast<unsigned long long>(n_experts));
    }
  }
  __syncthreads();
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const long long e = topi[p];
    if (e >= 0 && e < n_experts) order[atomicAdd(&cursor[e], 1)] = p;
  }
}

// -- 2-3. the expert products on the tensor cores (bf16) ---------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = repro::hopper::smem_u32(dst);
  const int n = valid ? 16 : 0;  // zero-fill a row past the pass
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(repro::hopper::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(repro::hopper::smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// One pass of MT M-tiles: rows src[0, 16 MT) against the CTA's 64 columns,
// K streamed through the ring; `a_rows` is the A region's rows a stage
// (16 x the launch's M-tiles).
template <bool kGated, int MT>
__device__ void mma_pass(const Args& m, int e, int n0, int a_rows, const int* src,
                         const int* dst, const float* wt, int n_rows, char* smem) {
  constexpr int kW = kGated ? 2 : 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int stage = (a_rows + kW * kTile) * kRowBytes;
  const int kt_n = m.K / kTile;
  const bf16* a = static_cast<const bf16*>(m.a);

  auto load = [&](int kt, int slot) {
    char* base = smem + slot * stage;
    const int k0 = kt * kTile;
    for (int c = tid; c < MT * 16 * 8; c += kThreads) {
      const int r = c >> 3, ch = c & 7;
      const int s = src[r];
      cp16(base + swz(r, ch), a + static_cast<size_t>(s < 0 ? 0 : s) * m.K + k0 + ch * 8,
           s >= 0);
    }
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const bf16* wb = static_cast<const bf16*>(w ? m.w1 : m.w0) +
                       (static_cast<size_t>(e) * m.K + k0) * m.N + n0;
      char* dst_s = base + (a_rows + w * kTile) * kRowBytes;
      for (int c = tid; c < kTile * 8; c += kThreads) {
        const int r = c >> 3, ch = c & 7;
        cp16(dst_s + swz(r, ch), wb + static_cast<size_t>(r) * m.N + ch * 8, true);
      }
    }
  };

  float acc[kW][MT][2][4];
#pragma unroll
  for (int w = 0; w < kW; ++w)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[w][i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // slot kt's tiles are in; every warp is done with kt - 1's slot
    if (kt + kStages - 1 < kt_n) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_commit();
    const char* base = smem + (kt % kStages) * stage;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        ldsm_x4(af[i], base + swz(i * 16 + (lane & 15), kk * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, base + (a_rows + w * kTile) * kRowBytes +
                           swz(kk * 16 + (lane & 15), warp * 2 + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[w][i][0], af[i], bfr[0], bfr[1]);
          mma_bf16(acc[w][i][1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free for the next pass

  bf16* out = static_cast<bf16*>(m.out);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = i * 16 + (lane >> 2) + half * 8;
        if (r >= n_rows) continue;
        const int col = n0 + warp * 16 + j * 8 + (lane & 3) * 2;
        float v0, v1;
        if constexpr (kGated) {
          const float g0 = round_bf16(acc[0][i][j][half * 2]);
          const float g1 = round_bf16(acc[0][i][j][half * 2 + 1]);
          v0 = round_bf16(silu(g0)) * round_bf16(acc[1][i][j][half * 2]);
          v1 = round_bf16(silu(g1)) * round_bf16(acc[1][i][j][half * 2 + 1]);
        } else {
          v0 = round_bf16(acc[0][i][j][half * 2]) * wt[r];
          v1 = round_bf16(acc[0][i][j][half * 2 + 1]) * wt[r];
        }
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(dst[r]) * m.N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
}

template <bool kGated>
__global__ void __launch_bounds__(kThreads) moe_mma(Args m, int m_tiles) {
  const int e = blockIdx.y, n0 = blockIdx.x * kTile;
  const int lo = m.offsets[e], rows = m.offsets[e + 1] - lo;
  if (rows == 0) return;  // an expert no token chose: none of its weights is read
  extern __shared__ __align__(128) char smem[];
  __shared__ int src[kPassRows], dst[kPassRows];
  __shared__ float wt[kPassRows];
  const int cap = 16 * m_tiles;
  for (int first = 0; first < rows; first += cap) {
    const int n_rows = min(cap, rows - first);
    pass_rows<kGated, bf16>(m, lo, first, n_rows, cap, src, dst, wt);
    __syncthreads();
    switch ((n_rows + 15) / 16) {
      case 1: mma_pass<kGated, 1>(m, e, n0, cap, src, dst, wt, n_rows, smem); break;
      case 2: mma_pass<kGated, 2>(m, e, n0, cap, src, dst, wt, n_rows, smem); break;
      case 3: mma_pass<kGated, 3>(m, e, n0, cap, src, dst, wt, n_rows, smem); break;
      default: mma_pass<kGated, 4>(m, e, n0, cap, src, dst, wt, n_rows, smem); break;
    }
    __syncthreads();  // the pass's rows are read before the next pass writes them
  }
}

// -- 2-3. the expert products on the CUDA cores (f32) ------------------------------

template <bool kGated>
__global__ void __launch_bounds__(kThreads) moe_simt(Args m) {
  const int e = blockIdx.y, n0 = blockIdx.x * kTile;
  const int lo = m.offsets[e], rows = m.offsets[e + 1] - lo;
  if (rows == 0) return;
  __shared__ float xs[kSimtRows][kTile];
  __shared__ int src[kSimtRows], dst[kSimtRows];
  __shared__ float wt[kSimtRows];
  const float* a = static_cast<const float*>(m.a);
  const float* w0 = static_cast<const float*>(m.w0) + static_cast<size_t>(e) * m.K * m.N;
  const float* w1 = kGated ? static_cast<const float*>(m.w1) + static_cast<size_t>(e) * m.K * m.N
                           : nullptr;
  const int col = n0 + (threadIdx.x & (kTile - 1));
  const int group = threadIdx.x / kTile;  // rows group * 8 .. + 8
  for (int first = 0; first < rows; first += kSimtRows) {
    const int n_rows = min(kSimtRows, rows - first);
    pass_rows<kGated, float>(m, lo, first, n_rows, kSimtRows, src, dst, wt);
    float acc0[8] = {}, acc1[8] = {};
    for (int k0 = 0; k0 < m.K; k0 += kTile) {
      __syncthreads();  // src is written; the last slice is read
      for (int c = threadIdx.x; c < kSimtRows * kTile; c += kThreads) {
        const int r = c / kTile, kk = c % kTile;
        xs[r][kk] = src[r] < 0 ? 0.0f : a[static_cast<size_t>(src[r]) * m.K + k0 + kk];
      }
      __syncthreads();
      for (int kk = 0; kk < kTile; ++kk) {
        const size_t at = static_cast<size_t>(k0 + kk) * m.N + col;
        const float g = w0[at];
        const float u = kGated ? w1[at] : 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xv = xs[group * 8 + i][kk];
          acc0[i] = fmaf(xv, g, acc0[i]);
          if (kGated) acc1[i] = fmaf(xv, u, acc1[i]);
        }
      }
    }
    float* out = static_cast<float*>(m.out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = group * 8 + i;
      if (r < n_rows) {
        out[static_cast<size_t>(dst[r]) * m.N + col] =
            kGated ? silu(acc0[i]) * acc1[i] : acc0[i] * wt[r];
      }
    }
    __syncthreads();  // the pass's rows are read before the next pass writes them
  }
}

// -- 4. combine ----------------------------------------------------------------------

template <typename T>
__global__ void moe_combine(const T* y, const long long* topi, T* out, int tokens, int top_k,
                            int n_experts, int d) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(tokens) * d) return;
  const int t = static_cast<int>(i / d), c = static_cast<int>(i % d);
  float acc = 0.0f;
  bool first = true;
  for (int j = 0; j < top_k; ++j) {
    const long long e = topi[static_cast<size_t>(t) * top_k + j];
    if (e < 0 || e >= n_experts) continue;  // packed nowhere: adds nothing
    const float v = repro::to_float(y[(static_cast<size_t>(t) * top_k + j) * d + c]);
    acc = first ? v : repro::to_float(repro::from_float<T>(acc + v));
    first = false;
  }
  out[i] = repro::from_float<T>(acc);
}

template <typename T>
cudaError_t launch_all(const Args& gate_up, const Args& down, const long long* topi,
                       unsigned long long* tally, int* offsets, int* order, const void* y,
                       void* out, int tokens, int top_k, int n_experts, int d, int f,
                       cudaStream_t stream) {
  moe_pack<<<1, kPackThreads, 0, stream>>>(topi, tokens * top_k, n_experts, offsets, order,
                                           tally);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_gu(f / kTile, n_experts), grid_dn(d / kTile, n_experts);
  if constexpr (std::is_same<T, bf16>::value) {
    const int m_tiles = std::min(kMaxMTiles, (tokens + 15) / 16);
    const int a_bytes = 16 * m_tiles * kRowBytes;
    const int smem_gu = kStages * (a_bytes + 2 * kTile * kRowBytes);
    const int smem_dn = kStages * (a_bytes + kTile * kRowBytes);
    if ((err = repro::hopper::allow_smem(moe_mma<true>, smem_gu)) != cudaSuccess) return err;
    if ((err = repro::hopper::allow_smem(moe_mma<false>, smem_dn)) != cudaSuccess) return err;
    moe_mma<true><<<grid_gu, kThreads, smem_gu, stream>>>(gate_up, m_tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    moe_mma<false><<<grid_dn, kThreads, smem_dn, stream>>>(down, m_tiles);
  } else {
    moe_simt<true><<<grid_gu, kThreads, 0, stream>>>(gate_up);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    moe_simt<false><<<grid_dn, kThreads, 0, stream>>>(down);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n = static_cast<long long>(tokens) * d;
  const int threads = 256;
  moe_combine<T><<<static_cast<unsigned>((n + threads - 1) / threads), threads, 0, stream>>>(
      static_cast<const T*>(y), topi, static_cast<T*>(out), tokens, top_k, n_experts, d);
  return cudaGetLastError();
}

}  // namespace

// x (T, D), topi (T, top_k) int64, topv (T, top_k) f32, w_gate / w_up
// (E, D, F), w_down (E, F, D) -> out (T, D), all but the indices and the
// weights of one dtype; offsets (E + 1,) and order (T top_k,) int32, h
// (T top_k, F) and y (T top_k, D) the wrapper's workspace; tally (2,)
// int64: experts read and held, added to.
extern "C" int repro_moe_experts(const void* x, const void* topi, const void* topv,
                                 const void* w_gate, const void* w_up, const void* w_down,
                                 void* offsets, void* order, void* h, void* y, void* out,
                                 void* tally, int tokens, int top_k, int n_experts, int d, int f,
                                 int dtype, void* stream) {
  if (!x || !topi || !topv || !w_gate || !w_up || !w_down || !offsets || !order || !h || !y ||
      !out || !tally || tokens <= 0 || top_k <= 0 || top_k > n_experts ||
      n_experts > kMaxExperts || d <= 0 || f <= 0 || d % kTile || f % kTile ||
      static_cast<long long>(tokens) * top_k > INT_MAX / 2 ||
      (dtype != repro::kFloat32 && dtype != repro::kBFloat16)) {
    return cudaErrorInvalidValue;
  }
  const int* off = static_cast<const int*>(offsets);
  const int* ord = static_cast<const int*>(order);
  const float* wv = static_cast<const float*>(topv);
  const Args gate_up{x, w_gate, w_up, off, ord, wv, h, d, f, top_k};
  const Args down{h, w_down, nullptr, off, ord, wv, y, f, d, top_k};
  auto s = static_cast<cudaStream_t>(stream);
  auto ti = static_cast<const long long*>(topi);
  auto ta = static_cast<unsigned long long*>(tally);
  if (dtype == repro::kBFloat16) {
    return launch_all<bf16>(gate_up, down, ti, ta, static_cast<int*>(offsets),
                            static_cast<int*>(order), y, out, tokens, top_k, n_experts, d, f, s);
  }
  return launch_all<float>(gate_up, down, ti, ta, static_cast<int*>(offsets),
                           static_cast<int*>(order), y, out, tokens, top_k, n_experts, d, f, s);
}
