// The 3xTF32 tensor-core GEMM body shared by the f32 matmul and the Schur
// update (matmul.cu) and the complex matmul (complex_matmul.cu).  Each of
// them is one __global__ kernel that names its operands and its epilogue
// and calls gemm_tile below.
//
// The tensor cores take f32 only as TF32 (10 mantissa bits): one pass errs
// by a few 1e-2 at K = 2048, far outside f32's accuracy.  So each operand
// is split, x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and every
// K step accumulates A_lo B_hi + A_hi B_lo + A_hi B_hi in f32 (small terms
// first; A_lo B_lo, ~2^-22 relative, is dropped): f32 accuracy at three
// TF32 products.
//
// One CTA owns a 128 x 128 output tile and walks one or two "legs", each a
// product A_l @ (s_l B_l) with s_l = +-1, all summed into one accumulator:
// matmul and the Schur update walk one leg, each plane of the complex
// matmul two.  A producer warpgroup keeps TMA loads of the raw f32 A
// (128 x 32, 128-byte swizzled) and B (32 x 128) tiles in flight through a
// ring of three stages, each completing on an mbarrier, and gives its
// registers to the consumers (setmaxnreg).  Two consumer warpgroups, 64
// output rows each, issue m64n128k8 tf32 wgmmas: A from registers (each
// thread loads its fragment of the raw tile and splits it there), B from
// shared memory.  tf32 wgmma takes B K-major only, so B is transposed as
// it is split, into hi/lo planes in a double-buffered pair of tiles; the
// sign s_l is applied there (the hi and lo of -x are exactly -hi and -lo).
// The next stage's split (B's planes, A's fragments in a second set of
// registers) overlaps the products of the current one (wgmma is
// asynchronous).  The tensor cores accumulate with truncation, which
// biases a long sum: each K step's products go to a fresh accumulator that
// is then added, in f32 on the CUDA cores, to the running one.  TMA
// zero-fills the ragged edges and the epilogue is called only for output
// pairs inside the matrix, so any M works; N and K must be multiples of 4
// (16-byte global strides for TMA), and the operands 16-byte aligned: the
// wrappers pad and copy what is not (kernels/matmul.py, tma_operands).
#pragma once

#include <initializer_list>

#include "hopper.cuh"

namespace repro {
namespace tf32_gemm {

using namespace hopper;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;  // 32 f32 = one 128-byte swizzled row
constexpr int kStages = 3;
constexpr int kConsumers = 256;  // two warpgroups, 64 output rows each
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kTile = kBM * kBK * 4;  // bytes of an A (or B) tile
constexpr int kSplitOffset = kStages * 2 * kTile;  // raw A, B per stage
constexpr int kBarOffset = kSplitOffset + 2 * 2 * kTile;  // 2 x B hi/lo
constexpr int kSmem = kBarOffset + 2 * kStages * 8 + 1024;  // + alignment

// One product of a CTA's walk: A (M x K) @ (sign * B (K x N)), by TMA maps.
struct Leg {
  const CUtensorMap* a;
  const CUtensorMap* b;
  float sign;
};

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  hi = make_float4(to_tf32(x.x), to_tf32(x.y), to_tf32(x.z), to_tf32(x.w));
  lo = make_float4(to_tf32(x.x - hi.x), to_tf32(x.y - hi.y),
                   to_tf32(x.z - hi.z), to_tf32(x.w - hi.w));
}

// A stage's raw B (32 k x 128 n, row-major) times `sign` -> hi and lo
// planes of 128 rows of 32 k (K-major, 128-byte swizzled as TMA would have)
__device__ __forceinline__ void split_b(const float* raw_b, float* out, int tid,
                                        float sign) {
  float* b_hi = out;
  float* b_lo = out + kBN * kBK;
#pragma unroll
  for (int i = 0; i < kBN * kBK / 4 / kConsumers; ++i) {
    const int u = tid + i * kConsumers;
    const int n = u % kBN, q = u / kBN;  // column n, k = 4q .. 4q + 3
    const float4 x = make_float4(
        sign * raw_b[(4 * q) * kBN + n], sign * raw_b[(4 * q + 1) * kBN + n],
        sign * raw_b[(4 * q + 2) * kBN + n], sign * raw_b[(4 * q + 3) * kBN + n]);
    const int off = n * kBK + 4 * (q ^ (n & 7));
    float4 hi, lo;
    split4(x, hi, lo);
    *reinterpret_cast<float4*>(b_hi + off) = hi;
    *reinterpret_cast<float4*>(b_lo + off) = lo;
  }
}

// This thread's A fragments of a stage (rows `row`, `row` + 8 of the
// swizzled 128 x 32 raw tile; 4 k8 steps of 4 registers), split into tf32
// hi and lo.  Fragment register j of step kk: row + 8 * (j % 2), column
// 8 * kk + lane % 4 + 4 * (j / 2), as wgmma's m64k8 tf32 A operand.
__device__ __forceinline__ void split_a(const float* raw_a, int row, int lane,
                                        uint32_t (&hi)[16], uint32_t (&lo)[16]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = row + 8 * (j % 2);
      const int chunk = (2 * kk + j / 2) ^ (r & 7);
      const float x = raw_a[r * kBK + 4 * chunk + lane % 4];
      const float h = to_tf32(x);
      hi[4 * kk + j] = __float_as_uint(h);
      lo[4 * kk + j] = __float_as_uint(to_tf32(x - h));
    }
  }
}

// The CTA's output tile (blockIdx.y, blockIdx.x) of sum_l A_l @ (s_l B_l),
// every A_l (M x K) and B_l (K x N), walked leg by leg in K steps of 32.
// `epilogue(row, col, x, y)` takes the sums at (row, col) and (row, col +
// 1) for every such pair inside the M x N output.  Launch with kThreads
// threads and kSmem bytes of dynamic shared memory; K > 0.
template <int Legs, typename Epilogue>
__device__ __forceinline__ void gemm_tile(const Leg (&legs)[Legs], int M, int N,
                                          int K, Epilogue epilogue) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;  // K steps of one leg
  const int steps = Legs * nk;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer: one thread issues the loads
    regs_dealloc<40>();
    if (tid == kConsumers) {
      for (int t = 0; t < steps; ++t) {
        const int s = t % kStages;
        const bool second = Legs > 1 && t >= nk;
        const int k0 = (second ? t - nk : t) * kBK;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTile);
        uint8_t* raw = smem + s * 2 * kTile;
        tma_load_2d(raw, second ? legs[Legs - 1].a : legs[0].a, &full[s], k0, m0);
        tma_load_2d(raw + kTile, second ? legs[Legs - 1].b : legs[0].b, &full[s], n0, k0);
      }
    }
    return;
  }

  regs_alloc<232>();  // 64 + 64 accumulators, 2 x 32 A fragment registers
  const int wg = tid / 128, lane = tid % 32;
  const int row0 = wg * 64 + 16 * ((tid % 128) / 32) + lane / 4;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  auto raw = [&](int t) { return reinterpret_cast<const float*>(smem + (t % kStages) * 2 * kTile); };
  auto planes = [&](int t) { return reinterpret_cast<float*>(smem + kSplitOffset + (t & 1) * 2 * kTile); };
  // stage t: B (times its leg's sign) split into planes t & 1, this
  // thread's A fragments into registers; then the raw stage is free
  auto split = [&](int t, uint32_t (&a_hi)[16], uint32_t (&a_lo)[16]) {
    const float sign = Legs > 1 && t >= nk ? legs[Legs - 1].sign : legs[0].sign;
    mbar_wait(&full[t % kStages], (t / kStages) & 1);
    split_b(raw(t) + kBM * kBK, planes(t), tid, sign);
    split_a(raw(t), row0, lane, a_hi, a_lo);
    mbar_arrive(&empty[t % kStages]);
    fence_async_smem();
  };
  // the products of stage t from `a_hi`, `a_lo` (split in the step before),
  // while stage t + 1 is split into `next_hi`, `next_lo`
  auto step = [&](int t, uint32_t (&a_hi)[16], uint32_t (&a_lo)[16],
                  uint32_t (&next_hi)[16], uint32_t (&next_lo)[16]) {
    const float* b_hi = planes(t);
    const float* b_lo = b_hi + kBN * kBK;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {  // 8 tf32 = 32 bytes per step
      const uint32_t hi[4] = {a_hi[4 * kk], a_hi[4 * kk + 1], a_hi[4 * kk + 2], a_hi[4 * kk + 3]};
      const uint32_t lo[4] = {a_lo[4 * kk], a_lo[4 * kk + 1], a_lo[4 * kk + 2], a_lo[4 * kk + 3]};
      mma_tf32_rs_n128(part, lo, desc_sw128(b_hi + 8 * kk), kk > 0);
      mma_tf32_rs_n128(part, hi, desc_sw128(b_lo + 8 * kk), 1);
      mma_tf32_rs_n128(part, hi, desc_sw128(b_hi + 8 * kk), 1);
    }
    wgmma_commit();
    if (t + 1 < steps) split(t + 1, next_hi, next_lo);
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(a_hi);
    fence_regs(a_lo);
    // The tensor cores' f32 sums truncate; over K = 2048 the bias of 768
    // truncated additions reaches ~3e-3.  Each K step's partial sum (12
    // products) is added here, rounded to nearest, instead.
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    named_sync(1, kConsumers);  // planes t read by both, planes t + 1 written
  };
  uint32_t a0_hi[16], a0_lo[16], a1_hi[16], a1_lo[16];  // two steps' fragments
  split(0, a0_hi, a0_lo);
  named_sync(1, kConsumers);
  for (int t = 0; t < steps; t += 2) {
    step(t, a0_hi, a0_lo, a1_hi, a1_lo);
    if (t + 1 < steps) step(t + 1, a1_hi, a1_lo, a0_hi, a0_lo);
  }

  // accumulator register i: row row0 + 8 * ((i / 2) % 2), column
  // 8 * (i / 4) + 2 * (lane % 4) + i % 2 (hopper.cuh)
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = m0 + row0 + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
    if (row < M && col < N) epilogue(row, col, acc[i], acc[i + 1]);  // N % 4 == 0
  }
}

// -- host ------------------------------------------------------------------------

// The TMA maps of one leg: A (M x K, row-major) in 32 x 128 boxes with the
// 128-byte swizzle, B (K x N, row-major) in 128 x 32 boxes.
inline cudaError_t make_a_map(CUtensorMap* map, const void* a, int M, int K) {
  const uint64_t dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t strides[1] = {sizeof(float) * static_cast<uint64_t>(K)};
  const uint32_t box[2] = {kBK, kBM};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

inline cudaError_t make_b_map(CUtensorMap* map, const void* b, int K, int N) {
  const uint64_t dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t strides[1] = {sizeof(float) * static_cast<uint64_t>(N)};
  const uint32_t box[2] = {kBN, kBK};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, b, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The shapes and operands the kernels take: M, N > 0, K >= 0, N and K
// multiples of 4, every operand 16-byte aligned.
inline bool valid(int M, int N, int K, std::initializer_list<const void*> ptrs) {
  if (M <= 0 || N <= 0 || K < 0 || N % 4 || K % 4) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

inline dim3 grid(int M, int N, int planes = 1) {
  return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, planes);
}

}  // namespace tf32_gemm
}  // namespace repro
