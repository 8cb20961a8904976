// Causal flash-attention forward with GQA: prompt prefill.
//
// Replaces: repro/kernels/attention.py, flash_attention_pallas
// (_flash_kernel).
//
// Semantics: q (B, H, Sq, D), k (B, KH, Skv, D), v (B, KH, Skv, Dv), out
// (B, H, Sq, Dv); query head h reads kv head h / (H / KH).  Scores (q . k)
// * scale with scale = 1/sqrt(D) (the qk dim, as the TPU kernel), the
// causal mask aligned at the start (key j visible to query i iff j <= i,
// as in the TPU kernel), softmax in f32, out = p . v in q's dtype.  Unlike
// the TPU kernel, ragged edges are masked here, so any Sq / Skv works.
// Where the caller gives an lse buffer (B, H, Sq) f32 (training: the
// backward kernel, csrc/flash_attention_bwd.cu, recomputes probabilities
// from it), each row's log-sum-exp of its scaled scores is written there,
// as attention_xla.py's _core_fwd saves it; serving passes none.
//
// Bound on the H100: bytes at short prompts, operations at long ones.
// Causal attention does ~2 * Sq * Skv * D * H flops (half of the dense
// 4 * Sq * Skv * D * H) on 2 * (2 * H * Sq + 2 * KH * Skv) * D bytes in
// bf16; with llama3.2-1b's heads (H = 32, KH = 8, D = 64) the two bounds
// meet at Sq = Skv ~ 740 on the bf16 tensor cores (989 TFLOP/s).
//
// Two routes.  The wrapper (kernels/attention.py, flash_route) picks one by
// dtype, shape and alignment and passes it in; repro_flash_attention
// refuses a wgmma request that TMA cannot load:
//
// bf16 with D and Dv multiples of 8, D <= 256, Dv <= 128 and 16-byte
// aligned operands (every serving config's prefill, deepseek-v2's MLA at qk
// 192 / v 128 among them): an FA3-shaped kernel on the tensor cores.
// One CTA per (query tile of 64 rows, head, batch): one consumer warpgroup
// and one producer warp.  The producer loads the q tile once and keeps TMA
// loads of the K and V tiles in flight through two shared-memory stages,
// each completing on an mbarrier (the consumer frees a stage on another).
// The consumer computes S = Q K^T with bf16 wgmma (Q and K K-major, f32
// accumulators), scales S after the product, takes the online softmax on
// the accumulator fragment in registers, converts P to bf16 in registers
// as the A operand of O += P V (V read MN-major, as stored), and writes
// O / l once, rows Dv apart.  Loads use 3-D tensor maps (D or Dv, S, B *
// heads): a ragged sequence edge is out of bounds, zero-filled, and
// masked, never the next head's rows.  Head dims are loaded in column
// boxes of 64 (128 bytes, the swizzle's row), NBK = ceil(D / 64) for q and
// k (1-4) and NBV = ceil(Dv / 64) for v (1-2), each pair an instantiation;
// key tiles are 128 / NBV wide, so S (64 / NBV registers a thread) and O
// (32 NBV) keep 96 f32 accumulators a thread at every width (D = Dv = 64:
// one box, 128 keys; zamba2's 112 and arctic's 128: two boxes, 64 keys;
// qk 192 / v 128: three and two, 64 keys, 104 KB of shared memory).  Dims
// past D or Dv are zero-filled, so Q K^T runs ceil(D / 16) k16 steps and P V
// an N of 64 NBV.  Key tiles above the diagonal are skipped, and only the
// diagonal tile and the ragged edge are masked.  The grid runs the
// heaviest (last) query tiles first.  The KV head's G = H / KH query heads
// are not packed into one CTA: each CTA reads its KV head's tiles, which
// the G heads' CTAs find in L2.
//
// f32, and every other bf16 shape (v's head dim past 128, q's past 256, a
// head dim not a multiple of 8, an unaligned operand; D and Dv up to 512):
// a CUDA-core kernel, templated on the element type and on v's head dims
// per lane; chip_smoke's f32 served
// traces hold it token for token against the plain version.  Shared
// memory grows with D and Dv (~194 KB at 512 / 512), set above 48 KB
// through cudaFuncAttributeMaxDynamicSharedMemorySize.  One CTA of 4 warps per
// (b, h, 32-row query tile); each warp owns 8 query rows and keeps their
// running max, sum and f32 accumulator in registers (each lane holds 1/32
// of v's head dims).  The CTA loops over 32-key K/V tiles up to the
// diagonal, staging each in shared memory (K rows padded by one float so
// lane j reads key j without bank conflicts); lane j scores key j against
// the row, the warp reduces max and sum, and p is broadcast by shuffle for
// the P.V update.  The q tile is staged once, pre-scaled, and every tile
// is staged in f32 whatever the element type.  Where D == Dv one flat
// loop stages K and V together: on the H100 a second loop for V cost the
// f32 route ~10% at D = 64, and staging a row per warp ~20%
// (scripts/ab_parent_change.py flash_kernels).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// -- CUDA cores: f32, and bf16 off the wgmma route ---------------------------------

namespace cc {

constexpr int kBQ = 32;   // query rows per CTA
constexpr int kBKV = 32;  // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kMaxDimPerLane = 16;  // head dims up to 512
constexpr float kNeg = -1e30f;

// T: the element type (loaded through repro::to_float, stored by a cast).
// DV: v's head dims per lane, 4, 8 or 16 >= ceil(Dv / 32).  q and k
// need no such count: lane j scores key j over all D from shared memory.
template <typename T, int DV>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H, int KH, int Sq, int Skv,
                       int D, int Dv, int causal, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // kBQ x D
  float* ks = qs + kBQ * D;         // kBKV x (D + 1)
  float* vs = ks + kBKV * (D + 1);  // kBKV x Dv
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const T* qb = q + (static_cast<size_t>(b) * H + h) * Sq * D;
  const T* kb = k + (static_cast<size_t>(b) * KH + kh) * Skv * D;
  const T* vb = v + (static_cast<size_t>(b) * KH + kh) * Skv * Dv;
  T* ob = out + (static_cast<size_t>(b) * H + h) * Sq * Dv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D;
    qs[i] = q0 + r < Sq
                ? repro::to_float(qb[static_cast<size_t>(q0) * D + i]) * scale
                : 0.f;
  }

  float m[kRowsPerWarp];
  float l[kRowsPerWarp];
  float acc[kRowsPerWarp][DV];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[rr][i] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBKV) {
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    if (D == Dv) {  // one flat loop, two loads an index (K rows padded)
      for (int i = tid; i < kBKV * D; i += kWarps * 32) {
        const int j = i / D;
        const bool in = k0 + j < Skv;
        const size_t off = static_cast<size_t>(k0) * D + i;
        ks[i + j] = in ? repro::to_float(kb[off]) : 0.f;
        vs[i] = in ? repro::to_float(vb[off]) : 0.f;
      }
    } else {
      for (int i = tid; i < kBKV * D; i += kWarps * 32) {
        const int j = i / D;
        ks[i + j] = k0 + j < Skv ? repro::to_float(kb[static_cast<size_t>(k0) * D + i]) : 0.f;
      }
      for (int i = tid; i < kBKV * Dv; i += kWarps * 32) {
        vs[i] = k0 + i / Dv < Skv ? repro::to_float(vb[static_cast<size_t>(k0) * Dv + i]) : 0.f;
      }
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
      for (int i = 0; i < DV; ++i) acc[rr][i] *= alpha;
      for (int j = 0; j < tn; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DV; ++i) {
          const int d = lane + 32 * i;
          if (d < Dv) acc[rr][i] += pj * vs[j * Dv + d];
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
    if (lse != nullptr && lane == 0) {
      lse[(static_cast<size_t>(b) * H + h) * Sq + qi] = m[rr] + logf(lv);
    }
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      const int d = lane + 32 * i;
      if (d < Dv) {
        ob[static_cast<size_t>(qi) * Dv + d] = repro::from_float<T>(acc[rr][i] / lv);
      }
    }
  }
}

template <typename T, int DV>
cudaError_t launch_dv(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int H, int KH, int Sq, int Skv, int D,
                      int Dv, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * D + kBKV * (D + 1) + kBKV * Dv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, DV><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, KH, Sq, Skv, D,
      Dv, causal, scale);
  return cudaSuccess;
}

// v's dims per lane, rounded up to 4, 8 or 16: below 4 ptxas held the
// kernel to 64 registers and spilled, so head dims up
// to 128 take 4 a lane, as the first f32 kernel did
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int KH, int Sq, int Skv, int D,
                   int Dv, int causal, float scale, cudaStream_t stream) {
  const int per_lane = (Dv + 31) / 32;
  if (per_lane <= 4)
    return launch_dv<T, 4>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale,
                           stream);
  if (per_lane <= 8)
    return launch_dv<T, 8>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale,
                           stream);
  return launch_dv<T, kMaxDimPerLane>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal,
                                      scale, stream);
}

}  // namespace cc

// -- bf16: wgmma + TMA -------------------------------------------------------------

namespace tc {

using namespace repro::hopper;

constexpr int kBM = 64;  // query rows per CTA: one consumer warpgroup
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;
constexpr int kRow = 128;  // bytes of a swizzled row: 64 bf16 head dims
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// NBK column boxes of 64 head dims for q and k, NBV for v, BKV keys per
// tile: 128 / NBV, so S (BKV / 2 registers a thread) and O (32 NBV) hold
// 96 f32 accumulators a thread at every width
template <int NBK, int NBV>
struct Cfg {
  static constexpr int kBKV = 128 / NBV;
  static constexpr int kQBytes = NBK * kBM * kRow;
  static constexpr int kKBytes = NBK * kBKV * kRow;  // a K tile
  static constexpr int kVBytes = NBV * kBKV * kRow;  // a V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + (2 * kStages + 1) * 8 + 1024;
  static constexpr int kS = kBKV / 2;  // score registers a thread
  static constexpr int kO = 32 * NBV;  // output registers a thread
};

// S = Q K^T (N = keys) and O += P V (N = head dims) at the tile widths
__device__ __forceinline__ void mma_qk(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  mma_bf16_ss_n128(d, a, b, acc);
}
__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  mma_bf16_ss_n64(d, a, b, acc);
}
__device__ __forceinline__ void mma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  mma_bf16_rs_n64(d, a, b, 1);
}
__device__ __forceinline__ void mma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  mma_bf16_rs_n128(d, a, b, 1);
}

template <int NBK, int NBV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int H,
             int KH, int Sq, int Skv, int D, int Dv, int causal, float scale_log2) {
  using C = Cfg<NBK, NBV>;
  constexpr int kBKV = C::kBKV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* kv = smem + C::kQBytes;  // stage s: K at s * kStageBytes, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // heaviest tiles first
  const int kh = h / (H / KH);
  const int q_last = min(q0 + kBM, Sq) - 1;
  const int n_all = (Skv + kBKV - 1) / kBKV;
  const int n_kv = causal ? min(n_all, q_last / kBKV + 1) : n_all;
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

  if (tid >= kConsumers) {  // producer warp: one thread issues the loads
    if (tid == kConsumers) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < NBK; ++c) {
        tma_load_3d(qs + c * kBM * kRow, &q_map, q_full, 64 * c, q0, b * H + h);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::kStageBytes);
        uint8_t* ks = kv + s * C::kStageBytes;
#pragma unroll
        for (int c = 0; c < NBK; ++c) {
          tma_load_3d(ks + c * kBKV * kRow, &k_map, &full[s], 64 * c, t * kBKV, b * KH + kh);
        }
#pragma unroll
        for (int c = 0; c < NBV; ++c) {
          tma_load_3d(ks + C::kKBytes + c * kBKV * kRow, &v_map, &full[s], 64 * c,
                      t * kBKV, b * KH + kh);
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const int ksteps = (D + 15) / 16;
  float o[C::kO];
#pragma unroll
  for (int i = 0; i < C::kO; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int t = 0; t < n_kv; ++t) {
    const int s = t % kStages;
    const uint8_t* ks = kv + s * C::kStageBytes;
    const uint8_t* vs = ks + C::kKBytes;
    mbar_wait(&full[s], (t / kStages) & 1);

    float sc[C::kS];
#pragma unroll
    for (int i = 0; i < C::kS; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NBK; ++kk) {  // k16 steps: 32 bytes of a row each
      if (kk < ksteps) {
        const int c = kk / 4, off = (kk % 4) * 32;
        mma_qk(sc, desc_sw128(qs + c * kBM * kRow + off),
               desc_sw128(ks + c * kBKV * kRow + off), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax on the fragment: register i holds row r0 + 8 * ((i / 2)
    // % 2), key k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2
    const int k0 = t * kBKV;
    const bool edge = (causal && k0 + kBKV - 1 > q0) || k0 + kBKV > Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < C::kS; ++i) {
      float x = sc[i] * scale_log2;  // log2 domain: exp(s) = exp2(s * log2 e)
      if (edge) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int row = r0 + 8 * ((i / 2) % 2);
        if (key >= Skv || (causal && key > row)) x = kNeg;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
    }
    // every row sees key 0 in tile 0, so m is finite and masked p are 0
#pragma unroll
    for (int i = 0; i < C::kS; ++i) {
      const float p = exp2f(sc[i] - m[(i / 2) % 2]);
      sc[i] = p;
      sum[(i / 2) % 2] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int i = 0; i < C::kO; ++i) o[i] *= alpha[(i / 2) % 2];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      // the A fragment of keys 16 kk .. 16 kk + 15 is the S fragment's
      // registers 8 kk .. 8 kk + 7, packed in pairs
      const uint32_t a[4] = {
          pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]), pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
          pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]), pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
      mma_pv(o, a, desc_sw128(vs + kk * 16 * kRow, kBKV * kRow));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* ob = out + (static_cast<size_t>(b) * H + h) * Sq * Dv;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
    // m is in log2 units (scores times scale * log2 e): lse = (m + log2 l) ln 2
    const int row = r0 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && row < Sq) {
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
#pragma unroll
  for (int i = 0; i < C::kO; i += 2) {
    const int row = r0 + 8 * ((i / 2) % 2);
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (row < Sq && col < Dv) {  // Dv % 8 == 0, so col + 1 < Dv too
      const float lv = l[(i / 2) % 2];
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(row) * Dv + col) =
          __floats2bfloat162_rn(o[i] / lv, o[i + 1] / lv);
    }
  }
}

template <int NBK, int NBV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int KH, int Sq, int Skv, int D,
                   int Dv, int causal, float scale, cudaStream_t stream) {
  using C = Cfg<NBK, NBV>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = map_heads(&q_map, q, D, Sq, B * H, kBM);
  if (err == cudaSuccess) err = map_heads(&k_map, k, D, Skv, B * KH, C::kBKV);
  if (err == cudaSuccess) err = map_heads(&v_map, v, Dv, Skv, B * KH, C::kBKV);
  if (err != cudaSuccess) return err;
  static const cudaError_t smem_err = allow_smem(flash_kernel<NBK, NBV>, C::kSmem);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid(H, B, (Sq + kBM - 1) / kBM);
  flash_kernel<NBK, NBV><<<grid, kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), lse, H, KH, Sq,
      Skv, D, Dv, causal, scale * kLog2e);
  return cudaSuccess;
}

// the instantiation for q / k's column boxes (1-4) and v's (1-2)
template <int NBV>
cudaError_t launch_nbk(int nbk, const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int H, int KH, int Sq, int Skv, int D, int Dv,
                       int causal, float scale, cudaStream_t stream) {
  switch (nbk) {
    case 1: return launch<1, NBV>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale, stream);
    case 2: return launch<2, NBV>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale, stream);
    case 3: return launch<3, NBV>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale, stream);
    default: return launch<4, NBV>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale, stream);
  }
}

}  // namespace tc

// route codes: kernels/attention.py's ROUTES
constexpr int kRouteCudaCores = 0;
constexpr int kRouteWgmma = 1;

}  // namespace

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse_out,
                                     int B, int H,
                                     int KH, int Sq, int Skv, int D, int Dv,
                                     int causal, float scale, int dtype,
                                     int route, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH || Sq <= 0 || Skv <= 0 ||
      D <= 0 || D > 32 * cc::kMaxDimPerLane || Dv <= 0 ||
      Dv > 32 * cc::kMaxDimPerLane) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);  // null: not asked for
  cudaError_t err;
  if (route == kRouteWgmma) {
    // what TMA can load: bf16, head dims multiples of 8 (16-byte rows) in at
    // most four column boxes for q and k and two for v, 16-byte bases
    const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v)) % 16 == 0;
    if (dtype != repro::kBFloat16 || D % 8 || Dv % 8 || D > 256 || Dv > 128 || !aligned) {
      return cudaErrorInvalidValue;
    }
    const int nbk = (D + 63) / 64;
    err = Dv <= 64
              ? tc::launch_nbk<1>(nbk, q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal,
                                  scale, s)
              : tc::launch_nbk<2>(nbk, q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal,
                                  scale, s);
  } else if (route != kRouteCudaCores) {
    return cudaErrorInvalidValue;
  } else if (dtype == repro::kBFloat16) {
    err = cc::launch<__nv_bfloat16>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale,
                                    s);
  } else if (dtype == repro::kFloat32) {
    err = cc::launch<float>(q, k, v, out, lse, B, H, KH, Sq, Skv, D, Dv, causal, scale, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
