// Mamba-2 SSD chunk terms: the intra-chunk output, the chunk's final state,
// the cumulative decay and the chunk total, per (batch, chunk, head).
//
// Replaces: repro/kernels/ssd.py, ssd_chunks_pallas (_ssd_chunk_kernel).
//
// Semantics, for batch b, chunk c of L steps (positions s0 = c * L ..) and
// head h, with a_cum = cumsum(a[h] * dt) over the chunk and a_tot its last
// entry:
//   y[i, p]      = sum_{j <= i} (C_i . B_j) * exp(a_cum[i] - a_cum[j])
//                                * dt[j] * x[j, p]
//   state[n, p]  = sum_j (B[j, n] * dt[j] * exp(a_tot - a_cum[j])) * x[j, p]
//   cumdecay[i]  = exp(a_cum[i]),   total = exp(a_tot)
// B and C (B, S, N) are one group shared by every head.  x, B and C are
// f32 or bf16; dt and a f32; every sum and every output is f32.  The exp
// is taken only where i >= j (above the diagonal the difference is
// positive and may overflow), of the difference of the cumulative sums,
// as the TPU kernel does.  Zero-padded steps (dt = 0) need no special
// case: their decay is 1 and their update 0.  L, N and P have no limit
// but the shared memory each route's tiles take (below).
//
// Bound on the H100: bytes.  At mamba2's prefill (B = 1, S = 512, H = 80,
// P = 64, N = 128, L = 128) the call moves ~27 MB (x in, y and the states
// out), 0.008 ms at 3.35 TB/s, against ~2.4 GFLOP of products on the bf16
// route (C B^T per CTA, and the two split products of y and of the state
// per head), ~0.0025 ms on the bf16 tensor cores.
//
// Two routes, chosen by dtype in repro_ssd_chunks:
//
// bf16 (every config's compute dtype, the serving path's): the chunk read
// as flash attention with the softmax replaced by a decay mask: C is Q, B
// is K (one group for every head), x is V per head and W = G o Lambda o
// dt_j is P.  The grid is (tiles of heads, roles, batch x chunks); a role
// is one 64-row tile rt of y, or one 64-row tile nt of the state (its N
// dims); the tile of heads is sized here (heads_per_cta) so that the grid
// is about two CTAs an SM.  Each CTA is one consumer warpgroup and one
// producer warp; the producer brings 64 x 64 bf16 boxes by TMA (128-byte
// swizzle) through a two-stage ring of 16 KB stages, each completing on
// an mbarrier.  Maps
// are 4-D (N, L, chunks, batch) over B and C and 5-D (P, H, L, chunks,
// batch) over x, so a ragged chunk or N / P edge is zero-filled, never
// the next chunk's rows.
//  - G = C B^T by bf16 wgmma (m64n64k16, both K-major) with an f32
//    accumulator: the products of bf16 inputs are exact.  A y CTA forms
//    its G tiles (rt, kt <= rt) once, keeps them in shared memory in
//    fragment order (each thread reads back only its own registers; 16 KB
//    a tile) and walks its tile of heads with them.  Tiles that do not fit
//    (chunks past ~700 rows) are formed again per head from streamed C/B.
//  - Per head, warp 0 scans a * dt (a lane takes ceil(L / 32) steps).
//    W = G o exp(a_cum_i - a_cum_j) o dt_j is formed on the fragment, split
//    into hi = bf16(W) and lo = bf16(W - hi) register A operands, and
//    y += W_hi x + W_lo x runs as two register-A wgmma products with x
//    read MN-major (as flash reads V).  Key tiles above the diagonal are
//    skipped.  One bf16 pass of W errs ~1e-2 on y; the split ~5e-5
//    (tests/test_torch_ssd.py emulates both).
//  - A state CTA computes state[nt rows, 64-column box of P] =
//    sum_j (B o sw)^T x, its A operand (B o sw)^T built in registers from
//    the B box in shared memory and split hi/lo the same way.  The state
//    CTA of nt = 0 writes cumdecay and the totals.
// The wrapper (kernels/ssd.py) pads N and P to multiples of 8 and copies
// operands whose strides TMA cannot take.
//
// f32 (parity: chip_smoke's f32 served traces hold it token for token):
// CUDA cores, one CTA of 256 threads (a 16 x 16 grid) per (tile of heads,
// chunk x row tile of 128, batch).  Per head it forms one 128 x 128 block
// of G = C B^T at a time (N in tiles of 128, register micro-tiles of 8 x
// 8), writes the decay-weighted W^T over the staged C^T, and accumulates
// y = W x for P in tiles of 64 (8 x 4 micro-tiles).  The CTA of the last
// row tile also accumulates the state over all key tiles (N in tiles of
// 128, P in tiles of 64).  A ragged chunk (a 97-token prompt runs L = 97)
// is masked.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kSmemMax = 232448;  // the H100's opt-in limit per block

// heads one CTA walks: the fewest that keep a grid of ctas_per_head *
// ceil(H / ht) CTAs to per_sm CTAs on each of the device's SMs (one wave)
cudaError_t heads_per_cta(long long ctas_per_head, int H, int per_sm, int* ht) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long slots = static_cast<long long>(per_sm) * sms;
  *ht = static_cast<int>(std::max(1LL, std::min<long long>(H, (ctas_per_head * H + slots - 1) / slots)));
  return cudaSuccess;
}

// a_cum over the chunk's L steps by one warp (lane l takes ceil(L / 32)
// consecutive steps), into acum, dts and sw = dt * exp(a_tot - a_cum); dt
// points at step 0 of this (batch, chunk, head), steps H apart.  Writes
// exp(a_cum) and exp(a_tot) where cumdecay / total are given.
__device__ __forceinline__ void chunk_decay(const float* __restrict__ dt, int H,
                                            float ah, int L, float* acum,
                                            float* dts, float* sw,
                                            float* cumdecay, float* total) {
  const int lane = threadIdx.x & 31;
  const int per = (L + 31) / 32;
  const int j0 = lane * per;
  float run = 0.f;
  for (int k = 0; k < per; ++k) {
    const int j = j0 + k;
    if (j < L) {
      const float d = dt[static_cast<size_t>(j) * H];
      dts[j] = d;
      run += ah * d;
    }
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const float off = incl - run;
  float seg = 0.f, last = 0.f;
  for (int k = 0; k < per; ++k) {
    const int j = j0 + k;
    if (j < L) {
      seg += ah * dts[j];
      last = off + seg;
      acum[j] = last;
    }
  }
  // a_tot is a_cum[L - 1] itself, as the plain version takes it
  const float atot = __shfl_sync(0xffffffffu, last, (L - 1) / per);
  for (int k = 0; k < per; ++k) {
    const int j = j0 + k;
    if (j < L) {
      sw[j] = dts[j] * expf(atot - acum[j]);
      if (cumdecay != nullptr) cumdecay[static_cast<size_t>(j) * H] = expf(acum[j]);
    }
  }
  if (total != nullptr && lane == 0) *total = expf(atot);
}

// -- bf16: wgmma + TMA ---------------------------------------------------------------

namespace tc {

using namespace repro::hopper;

constexpr int kT = 64;           // rows, keys, state rows and head dims per tile
constexpr int kRow = 128;        // bytes of a swizzled row: 64 bf16
constexpr int kBox = kT * kRow;  // one 64 x 64 bf16 box: 8 KB
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // one warpgroup and one producer warp
constexpr int kStages = 2;
constexpr int kStage = 2 * kBox;  // (C, B), (x, -) or (x, B)
constexpr int kGTile = 32 * kConsumers * 4;  // a G tile in fragment order: 16 KB

// byte offsets into the 1024-aligned dynamic shared memory
struct Layout {
  int kt;       // 64-row tiles of the chunk
  int gcache;   // G tiles kept in shared memory
  int g_off;    // the G tiles
  int vec_off;  // a_cum, dt and sw: two buffers (by head parity) of kt * 64 each
  int bar_off;
  int bytes;    // with the 1024 bytes of alignment slack
};

__host__ __device__ inline Layout layout(int L, int gcache) {
  Layout s;
  s.kt = (L + kT - 1) / kT;
  s.gcache = gcache;
  s.g_off = kStages * kStage;
  s.vec_off = s.g_off + gcache * kGTile;
  s.bar_off = s.vec_off + 2 * 3 * s.kt * kT * 4;
  s.bytes = s.bar_off + (2 * kStages) * 8 + 1024;
  return s;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 p;
  p.x = lo;  // the lower k index in the low half
  p.y = hi;
  return *reinterpret_cast<const uint32_t*>(&p);
}

// a pair of A elements (k, k + 1) split into hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(v0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(v1 - __bfloat162float(h1)));
}

// element (row r, column n) of a 128-byte-swizzled 64 x 64 bf16 box
__device__ __forceinline__ float box_at(const uint8_t* box, int r, int n) {
  const int off = r * kRow + ((((n * 2) >> 4) ^ (r & 7)) << 4) + ((n * 2) & 15);
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(box + off));
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const __grid_constant__ CUtensorMap x_map,
           const __grid_constant__ CUtensorMap b_map,
           const __grid_constant__ CUtensorMap c_map,
           const float* __restrict__ dt, const float* __restrict__ a,
           float* __restrict__ y, float* __restrict__ states,
           float* __restrict__ cumdecay, float* __restrict__ totals, int S,
           int H, int P, int N, int L, int NC, int HT, int gcache) {
  const Layout lay = layout(L, gcache);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + kStages;
  float* gc = reinterpret_cast<float*>(smem + lay.g_off);
  float* vec = reinterpret_cast<float*>(smem + lay.vec_off);

  const CUtensorMap* xm = &x_map;
  const CUtensorMap* bmap = &b_map;
  const CUtensorMap* cmap = &c_map;
  const int KT = lay.kt;
  const int role = blockIdx.y;
  const bool is_y = role < KT;  // y row tile rt, or state tile nt
  const int rt = role, nt = role - KT;
  const int b = blockIdx.z / NC, c = blockIdx.z % NC;
  const int s0 = c * L;
  const int h_begin = blockIdx.x * HT, h_end = min(H, h_begin + HT);
  const int NB = (N + kT - 1) / kT;  // 64-column boxes of N
  const int PB = (P + kT - 1) / kT;  // and of P
  const int n_g = is_y ? rt + 1 : 0;  // G tiles of a y CTA
  const int n_cached = min(n_g, gcache);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: one thread issues the loads
    if (tid != kConsumers) return;
    int t = 0;
    auto stage = [&](int bytes) -> uint8_t* {
      const int s = t % kStages;
      mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(&full[s], bytes);
      return smem + s * kStage;
    };
    auto load_g = [&](int kt) {  // C rows rt and B rows kt, box by box of N
      for (int nb = 0; nb < NB; ++nb, ++t) {
        uint8_t* st = stage(2 * kBox);
        tma_load_4d(st, cmap, &full[t % kStages], nb * kT, rt * kT, c, b);
        tma_load_4d(st + kBox, bmap, &full[t % kStages], nb * kT, kt * kT, c, b);
      }
    };
    for (int kt = 0; kt < n_cached; ++kt) load_g(kt);
    for (int h = h_begin; h < h_end; ++h) {
      for (int pb = 0; pb < PB; ++pb) {
        for (int kt = 0; kt < (is_y ? n_g : KT); ++kt) {
          if (is_y && kt >= n_cached) load_g(kt);
          uint8_t* st = stage(is_y ? kBox : 2 * kBox);
          tma_load_5d(st, xm, &full[t % kStages], pb * kT, h, kt * kT, c, b);
          if (!is_y) {
            tma_load_4d(st + kBox, bmap, &full[t % kStages], nt * kT, kt * kT, c, b);
          }
          ++t;
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // fragment rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);        // fragment columns c0 + 8 q, + 1
  int t = 0;

  // G tile kt of row tile rt: sum over the boxes of N, 4 k16 steps each
  auto form_g = [&](float (&g)[32]) {
    for (int nb = 0; nb < NB; ++nb, ++t) {
      const int s = t % kStages;
      const uint8_t* st = smem + s * kStage;
      mbar_wait(&full[s], (t / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_bf16_ss_n64(g, desc_sw128(st + kk * 32), desc_sw128(st + kBox + kk * 32),
                        nb > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(g);
      mbar_arrive(&empty[s]);
    }
  };
  for (int kt = 0; kt < n_cached; ++kt) {
    float g[32];
    form_g(g);
#pragma unroll
    for (int i = 0; i < 32; ++i) gc[(kt * 32 + i) * kConsumers + tid] = g[i];
  }

  for (int h = h_begin; h < h_end; ++h) {
    const int buf = (h - h_begin) & 1;
    float* acum = vec + buf * 3 * KT * kT;
    float* dts = acum + KT * kT;
    float* sw = dts + KT * kT;
    if (warp == 0) {
      const bool writer = !is_y && nt == 0;
      chunk_decay(dt + (static_cast<size_t>(b) * S + s0) * H + h, H, a[h], L, acum, dts,
                  sw, writer ? cumdecay + (static_cast<size_t>(b) * S + s0) * H + h : nullptr,
                  writer ? totals + (static_cast<size_t>(b) * NC + c) * H + h : nullptr);
    }
    named_sync(1, kConsumers);

    for (int pb = 0; pb < PB; ++pb) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < (is_y ? n_g : KT); ++kt) {
        uint32_t ahi[4][4], alo[4][4];
        if (is_y) {
          float g[32];
          if (kt < n_cached) {
#pragma unroll
            for (int i = 0; i < 32; ++i) g[i] = gc[(kt * 32 + i) * kConsumers + tid];
          } else {
            form_g(g);
          }
          // W on the fragment: register i is row rt * 64 + r0 + 8 ((i / 2) % 2),
          // key kt * 64 + 8 (i / 4) + c0 + i % 2
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int row = rt * kT + r0 + 8 * ((i / 2) % 2);
            const int col = kt * kT + 8 * (i / 4) + c0 + i % 2;
            g[i] = row >= col && row < L && col < L
                       ? g[i] * expf(acum[row] - acum[col]) * dts[col]
                       : 0.f;
          }
          // the A fragment of keys 16 kk .. 16 kk + 15 is registers 8 kk .. 8 kk + 7
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              split2(g[8 * kk + 2 * q], g[8 * kk + 2 * q + 1], ahi[kk][q], alo[kk][q]);
            }
          }
        }
        const int s = t % kStages;
        const uint8_t* st = smem + s * kStage;
        mbar_wait(&full[s], (t / kStages) & 1);
        if (!is_y) {
          // A = (B o sw)^T: row n = nt * 64 + r0 (+ 8), key j = kt * 64 + 16 kk
          // + c0 (+ 1, + 8, + 9), read from the B box (rows j, columns n)
          const uint8_t* bb = st + kBox;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int n = r0 + 8 * (q % 2);
              const int j = 16 * kk + c0 + 8 * (q / 2);
              const float w0 = sw[kt * kT + j], w1 = sw[kt * kT + j + 1];
              const bool in0 = kt * kT + j < L, in1 = kt * kT + j + 1 < L;
              split2(in0 ? box_at(bb, j, n) * w0 : 0.f, in1 ? box_at(bb, j + 1, n) * w1 : 0.f,
                     ahi[kk][q], alo[kk][q]);
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t xd = desc_sw128(st + kk * 16 * kRow, kBox);
          mma_bf16_rs_n64(acc, ahi[kk], xd, 1);
          mma_bf16_rs_n64(acc, alo[kk], xd, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&empty[s]);
        ++t;
      }
      // register i: row r0 + 8 ((i / 2) % 2), column 8 (i / 4) + c0 + i % 2
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = r0 + 8 * ((i / 2) % 2);
        const int p = pb * kT + 8 * (i / 4) + c0;
        if (p >= P) continue;  // P % 8 == 0, so p + 1 < P too
        const float2 v = make_float2(acc[i], acc[i + 1]);
        if (is_y) {
          const int ri = rt * kT + row;
          if (ri < L) {
            *reinterpret_cast<float2*>(
                y + ((static_cast<size_t>(b) * S + s0 + ri) * H + h) * P + p) = v;
          }
        } else {
          const int n = nt * kT + row;
          if (n < N) {
            *reinterpret_cast<float2*>(
                states + ((static_cast<size_t>(b) * NC + c) * H + h) * N * P +
                static_cast<size_t>(n) * P + p) = v;
          }
        }
      }
    }
  }
}

// Map of `rank` dims (innermost first) with strides in elements of dims
// 1.., loading boxes of 64 x .. with the 128-byte swizzle.
cudaError_t map_bf16(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                     const long long* strides, const uint32_t* box) {
  uint64_t bytes[4];
  for (int i = 0; i + 1 < rank; ++i) bytes[i] = 2ull * static_cast<uint64_t>(strides[i]);
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, base, dims, bytes, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

cudaError_t launch(const void* x, const void* dt, const void* a, const void* bm,
                   const void* cm, void* y, void* states, void* cumdecay,
                   void* totals, long long x_bs, long long x_ss, long long b_bs,
                   long long b_ss, long long c_bs, long long c_ss, int B, int S,
                   int H, int P, int N, int L, cudaStream_t stream) {
  if (P % 8 || N % 8) return cudaErrorInvalidValue;  // TMA's 16-byte strides
  const int NC = S / L;
  const Layout bare = layout(L, 0);
  const int kt = bare.kt;
  // a (batch, chunk) has kt y roles and ceil(N / 64) state roles; two
  // CTAs fit on an SM
  int HT = 1;
  cudaError_t err = heads_per_cta(static_cast<long long>(B) * NC * (kt + (N + kT - 1) / kT), H,
                                  2, &HT);
  if (err != cudaSuccess) return err;
  const int gcache = std::min(kt, (kSmemMax - bare.bytes) / kGTile);
  if (gcache < 1) return cudaErrorInvalidValue;  // past ~11,000 steps a chunk
  const Layout lay = layout(L, gcache);
  CUtensorMap x_map, b_map, c_map;
  const uint32_t box4[4] = {kT, kT, 1, 1}, box5[5] = {kT, 1, kT, 1, 1};
  const uint64_t xd[5] = {static_cast<uint64_t>(P), static_cast<uint64_t>(H),
                          static_cast<uint64_t>(L), static_cast<uint64_t>(NC),
                          static_cast<uint64_t>(B)};
  const long long xs[4] = {P, x_ss, L * x_ss, x_bs};
  const uint64_t nd[4] = {static_cast<uint64_t>(N), static_cast<uint64_t>(L),
                          static_cast<uint64_t>(NC), static_cast<uint64_t>(B)};
  const long long bs[3] = {b_ss, L * b_ss, b_bs}, cs[3] = {c_ss, L * c_ss, c_bs};
  err = map_bf16(&x_map, x, 5, xd, xs, box5);
  if (err == cudaSuccess) err = map_bf16(&b_map, bm, 4, nd, bs, box4);
  if (err == cudaSuccess) err = map_bf16(&c_map, cm, 4, nd, cs, box4);
  if (err != cudaSuccess) return err;
  static const cudaError_t smem_err = allow_smem(ssd_kernel, kSmemMax);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid((H + HT - 1) / HT, kt + (N + kT - 1) / kT, B * NC);
  ssd_kernel<<<grid, kThreads, lay.bytes, stream>>>(
      x_map, b_map, c_map, static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<float*>(y), static_cast<float*>(states), static_cast<float*>(cumdecay),
      static_cast<float*>(totals), S, H, P, N, L, NC, HT, gcache);
  return cudaSuccess;
}

}  // namespace tc

// -- f32: CUDA cores ------------------------------------------------------------------

namespace cc {

constexpr int kGrid = 16;  // threads form a kGrid x kGrid grid
constexpr int kThreads = kGrid * kGrid;
constexpr int kTL = 128;  // rows and keys per tile
constexpr int kTN = 128;  // state dims per tile
constexpr int kTP = 64;   // head dims per tile
constexpr int kLp = kTL + 1;
constexpr int kRows = kTL / kGrid;   // G / y rows per thread
constexpr int kSRows = kTN / kGrid;  // state rows per thread
constexpr int kPCols = kTP / kGrid;  // y / state columns per thread

size_t smem_floats(int L) {
  return static_cast<size_t>(std::max(kTL * kTL, kTN * kLp)) + kTN * kLp + kTL * kTP +
         3 * static_cast<size_t>(L);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunks_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, float* __restrict__ y,
                  float* __restrict__ states, float* __restrict__ cumdecay,
                  float* __restrict__ totals, long long x_bs, long long x_ss,
                  long long b_bs, long long b_ss, long long c_bs,
                  long long c_ss, int S, int H, int P, int N, int L, int HT) {
  extern __shared__ float smem[];
  float* wt = smem;                           // W^T: wt[j * kTL + i]
  float* ct = wt;                             // C^T: ct[n * kLp + i] (before W)
  float* bt = wt + max(kTL * kTL, kTN * kLp); // B^T: bt[n * kLp + j]
  float* xs = bt + kTN * kLp;                 // x tile: xs[j * kTP + p]
  float* acum = xs + kTL * kTP;
  float* dts = acum + L;
  float* sw = dts + L;

  const int RT = (L + kTL - 1) / kTL;
  const int c = blockIdx.y / RT;
  const int rt = blockIdx.y % RT;
  const int b = blockIdx.z;
  const int NC = S / L;
  const int s0 = c * L;
  const int i0 = rt * kTL;
  const int ni = min(kTL, L - i0);
  const int tid = threadIdx.x;
  const int ti = tid % kGrid;
  const int tj = tid / kGrid;
  const T* bb = bm + b * b_bs + s0 * b_ss;
  const T* cb = cm + b * c_bs + s0 * c_ss;

  const int h_end = min(H, (blockIdx.x + 1) * HT);
  for (int h = blockIdx.x * HT; h < h_end; ++h) {
    if (tid < 32) {
      chunk_decay(dt + (static_cast<size_t>(b) * S + s0) * H + h, H, a[h], L, acum, dts, sw,
                  rt == 0 ? cumdecay + (static_cast<size_t>(b) * S + s0) * H + h : nullptr,
                  rt == 0 ? totals + (static_cast<size_t>(b) * NC + c) * H + h : nullptr);
    }
    const T* xb = x + b * x_bs + s0 * x_ss + static_cast<long long>(h) * P;

    // y rows i0 .. i0 + ni, in tiles of kTP head dims
    for (int p0 = 0; p0 < P; p0 += kTP) {
      const int np = min(kTP, P - p0);
      float yacc[kRows][kPCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int q = 0; q < kPCols; ++q) yacc[r][q] = 0.f;
      }
      for (int kt = 0; kt <= rt; ++kt) {
        const int j0 = kt * kTL;
        const int nj = min(kTL, L - j0);
        // G block: thread (ti, tj) owns rows i = ti + 16 r, keys j = tj + 16 q
        float g[kRows][kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int q = 0; q < kRows; ++q) g[r][q] = 0.f;
        }
        for (int n0 = 0; n0 < N; n0 += kTN) {
          const int nn = min(kTN, N - n0);
          __syncthreads();  // the previous block's C^T / B^T / W^T are consumed
          for (int idx = tid; idx < kTL * nn; idx += kThreads) {
            const int r = idx / nn;  // n fastest across threads: coalesced reads
            const int n = idx % nn;
            ct[n * kLp + r] = r < ni ? repro::to_float(cb[(i0 + r) * c_ss + n0 + n]) : 0.f;
            bt[n * kLp + r] = r < nj ? repro::to_float(bb[(j0 + r) * b_ss + n0 + n]) : 0.f;
          }
          __syncthreads();
          for (int n = 0; n < nn; ++n) {
            float cv[kRows], bv[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              cv[r] = ct[n * kLp + ti + kGrid * r];
              bv[r] = bt[n * kLp + tj + kGrid * r];
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
#pragma unroll
              for (int q = 0; q < kRows; ++q) g[r][q] += cv[r] * bv[q];
            }
          }
        }
        __syncthreads();  // C^T is consumed: its room becomes W^T
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int i = ti + kGrid * r;
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const int j = tj + kGrid * q;
            const bool in = i < ni && j < nj && i0 + i >= j0 + j;
            wt[j * kTL + i] =
                in ? g[r][q] * expf(acum[i0 + i] - acum[j0 + j]) * dts[j0 + j] : 0.f;
          }
        }
        for (int idx = tid; idx < kTL * kTP; idx += kThreads) {
          const int j = idx / kTP;
          const int p = idx % kTP;
          xs[idx] = j < nj && p < np ? repro::to_float(xb[(j0 + j) * x_ss + p0 + p]) : 0.f;
        }
        __syncthreads();
        // y += W x: rows i = tj + 16 r, columns p = ti + 16 q
        for (int j = 0; j < nj; ++j) {
          float wv[kRows], xv[kPCols];
#pragma unroll
          for (int r = 0; r < kRows; ++r) wv[r] = wt[j * kTL + tj + kGrid * r];
#pragma unroll
          for (int q = 0; q < kPCols; ++q) xv[q] = xs[j * kTP + ti + kGrid * q];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int q = 0; q < kPCols; ++q) yacc[r][q] += wv[r] * xv[q];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = tj + kGrid * r;
        if (i >= ni) continue;
        float* yrow = y + ((static_cast<size_t>(b) * S + s0 + i0 + i) * H + h) * P + p0;
#pragma unroll
        for (int q = 0; q < kPCols; ++q) {
          const int p = ti + kGrid * q;
          if (p < np) yrow[p] = yacc[r][q];
        }
      }
    }

    // the state, by the CTA of the last row tile: rows n = tj + 16 r,
    // columns p = ti + 16 q, summed over every key tile
    if (rt == RT - 1) {
      float* sb = states + (static_cast<size_t>(b) * NC + c) * H * N * P +
                  static_cast<size_t>(h) * N * P;
      for (int n0 = 0; n0 < N; n0 += kTN) {
        const int nn = min(kTN, N - n0);
        for (int p0 = 0; p0 < P; p0 += kTP) {
          const int np = min(kTP, P - p0);
          float sacc[kSRows][kPCols];
#pragma unroll
          for (int r = 0; r < kSRows; ++r) {
#pragma unroll
            for (int q = 0; q < kPCols; ++q) sacc[r][q] = 0.f;
          }
          for (int j0 = 0; j0 < L; j0 += kTL) {
            const int nj = min(kTL, L - j0);
            __syncthreads();
            for (int idx = tid; idx < kTL * nn; idx += kThreads) {
              const int j = idx / nn;
              const int n = idx % nn;
              bt[n * kLp + j] = j < nj ? repro::to_float(bb[(j0 + j) * b_ss + n0 + n]) : 0.f;
            }
            for (int idx = tid; idx < kTL * kTP; idx += kThreads) {
              const int j = idx / kTP;
              const int p = idx % kTP;
              xs[idx] = j < nj && p < np ? repro::to_float(xb[(j0 + j) * x_ss + p0 + p]) : 0.f;
            }
            __syncthreads();
            for (int j = 0; j < nj; ++j) {
              const float s = sw[j0 + j];
              float bv[kSRows], xv[kPCols];
#pragma unroll
              for (int r = 0; r < kSRows; ++r) {
                const int n = tj + kGrid * r;
                bv[r] = n < nn ? bt[n * kLp + j] * s : 0.f;
              }
#pragma unroll
              for (int q = 0; q < kPCols; ++q) xv[q] = xs[j * kTP + ti + kGrid * q];
#pragma unroll
              for (int r = 0; r < kSRows; ++r) {
#pragma unroll
                for (int q = 0; q < kPCols; ++q) sacc[r][q] += bv[r] * xv[q];
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kSRows; ++r) {
            const int n = tj + kGrid * r;
            if (n >= nn) continue;
#pragma unroll
            for (int q = 0; q < kPCols; ++q) {
              const int p = ti + kGrid * q;
              if (p < np) sb[static_cast<size_t>(n0 + n) * P + p0 + p] = sacc[r][q];
            }
          }
        }
      }
    }
    __syncthreads();  // the next head overwrites the tiles and the vectors
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* a,
                   const void* bm, const void* cm, void* y, void* states,
                   void* cumdecay, void* totals, long long x_bs,
                   long long x_ss, long long b_bs, long long b_ss,
                   long long c_bs, long long c_ss, int B, int S, int H, int P,
                   int N, int L, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(L);
  if (smem > static_cast<size_t>(kSmemMax)) return cudaErrorInvalidValue;  // L past ~5,000
  static const cudaError_t smem_err = repro::hopper::allow_smem(ssd_chunks_kernel<T>, kSmemMax);
  if (smem_err != cudaSuccess) return smem_err;
  const int RT = (L + kTL - 1) / kTL;
  // one CTA per (chunk, row tile) and tile of heads fits on an SM
  int HT = 1;
  const cudaError_t err = heads_per_cta(static_cast<long long>(B) * (S / L) * RT, H, 1, &HT);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + HT - 1) / HT, (S / L) * RT, B);
  ssd_chunks_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(cumdecay),
      static_cast<float*>(totals), x_bs, x_ss, b_bs, b_ss, c_bs, c_ss, S, H,
      P, N, L, HT);
  return cudaSuccess;
}

}  // namespace cc

}  // namespace

extern "C" int repro_ssd_chunks(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, void* y, void* states, void* cumdecay, void* totals,
    long long x_bs, long long x_ss, long long b_bs, long long b_ss,
    long long c_bs, long long c_ss, int B, int S, int H, int P, int N, int L,
    int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || L <= 0 || S % L) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::kBFloat16) {
    err = tc::launch(x, dt, a, bm, cm, y, states, cumdecay, totals, x_bs, x_ss, b_bs,
                     b_ss, c_bs, c_ss, B, S, H, P, N, L, s);
  } else if (dtype == repro::kFloat32) {
    err = cc::launch<float>(x, dt, a, bm, cm, y, states, cumdecay, totals, x_bs,
                            x_ss, b_bs, b_ss, c_bs, c_ss, B, S, H, P, N, L, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
