// Fused paged attention through the page table, its page walk split across
// CTAs and across the warps of a CTA: decode (S = 1) and extend (S >= 1,
// causal within the chunk), GQA and the MLA operands.
//
// Replaces: repro/kernels/paged_attention.py, paged_attention_pallas
// (its body: online softmax over the page walk, grid (B, KH, max_pages)).
//
// Semantics, per (slot b, kv head kh): the G query heads of the group and
// the S chunk positions are fused into R = G * S rows, row r <-> (group
// g = r / S, chunk s = r % S), whose query position is index[b] + s.  Row r
// attends pool positions t <= index[b] + s; position t lives in pool page
// pages[b, t / page_size] at row t % page_size.  Scores are
// (q . k [+ q_rope . k_rope]) * scale, softmax in f32, out = p . v.
//
// Bound on the H100: bytes.  Every resident K/V row is needed once per kv
// head, against 4 * G * D flops per row: at llama3.2-1b decode (G = 4,
// D = 64, bf16) that is 2 flops per byte, far under the ~295 the tensor
// cores need.  At the serving shape (8 slots, 8 kv heads, <= 1024
// positions) a layer's K/V is ~5 MB, which the card's 3.35 TB/s moves in
// ~1.6 us: what bounds the kernel is the chain of dependent steps each CTA
// waits on (the index and page ids, then K/V, then the arithmetic, then
// the merge), how many SMs share the walk, and how many loads are in
// flight.  Measured on the card, each step of that chain costs a warp far
// more than its arithmetic, so the design shortens the chain and keeps the
// instructions on it few.  MLA is another matter: deepseek-v2's G = 128
// rows read one 576-wide row (512 latent, 64 rope) per position as keys
// and the 512 latent dims again as values, ~2 * 128 * 1088 flops per 1152
// bytes, ~240 flops a byte at decode, near the card's ~295 balance; its
// extend chunks (S times the rows on the same bytes) are bound by
// operations.
// Its own walk (the latent walk, below) puts them on wgmma.
//
// Design:
// - Grid (n_splits, KH * row blocks, B).  A split is a run of
//   `pages_per_split` whole pages, chosen by the wrapper from shapes alone,
//   so a long slot spreads over many CTAs.  A CTA whose split starts past
//   its slot's last query position exits at once: the ragged lengths of a
//   batch no longer tie the kernel to its longest slot.
// - One CTA serves every query row of its (slot, kv head) (a block of them
//   only past 64 rows, or 16 with Dv > 128 on the CUDA cores), so each K/V
//   row is read from device memory once per kv head.  Its warps form
//   position groups of RG warps, each warp holding its share of the rows: a
//   group walks every PG-th sub-tile of 8-32 positions on its own, with its
//   own online softmax and ring of 2-3 sub-tiles in shared memory, so no
//   barrier but the group's own (a single warp's, at every serving shape)
//   is waited on.
// - The CTA reads the slot's index, the split's page ids and q in one
//   round of loads (the TPU's scalar prefetch).  A page of one kv head is a
//   contiguous block of page_size rows, so a sub-tile comes by TMA, a few
//   2-D boxes of 128 bytes x 8-32 rows issued by one lane and counted on
//   the slot's mbarrier, with the 128-byte swizzle: the 8 rows a
//   quarter-warp reads fall on distinct banks.  Pages that TMA cannot take
//   (rows not whole 16-byte chunks of at least 128 bytes, pages not of 8k
//   rows) come by cp.async into the same layout.  The next sub-tiles' loads
//   are in flight while one is scored.  Positions past a slot's last query
//   position (and the null page behind them) are never loaded.
// - Two walks over a staged sub-tile, both with the TPU body's explicit
//   re-mask.  bf16 with Dk and Dv multiples of 16 up to 128 and more than 4
//   query rows a kv head (extend chunks): mma.sync on the tensor cores, a
//   warp's rows as the M of m16n8k16, q's fragments in registers, K's and
//   V's by ldmatrix, the online softmax on S's fragments, P rounded to bf16
//   as the A operand of P.V.  The tensor cores are not there for their
//   rate: a few mma and ldmatrix instructions replace the loops of loads
//   and FMAs a warp would otherwise wait through.  Otherwise (decode at
//   G <= 4, f32, the MLA operands, other head dims) the CUDA cores: a lane
//   scores one position against its warp's rows (q in shared memory as
//   f32, broadcast reads), warp-shuffle softmax, P.V with lanes on pairs of
//   v's dims.  Measured on the H100 (scripts/paged_variants.py), the
//   tensor cores gain 1.2-1.3x at 8-16 rows and lose at 1-4 rows (up to
//   1.2x slower), whose 16-row M is mostly zeros.  Divisors are set on the
//   host (FastDiv); the inner loops carry no branch.
// - The latent walk (the wrapper's route "latent": bf16, one pool passed
//   as keys and values, Dk == Dv a multiple of 64 up to 512, rope rows of
//   up to 64 dims, pages of a multiple of 8 rows; latent:: below): a CTA
//   per (split, 64 query rows, slot), a producer warpgroup staging each
//   64-position sub-tile by TMA once, two consumer warpgroups on wgmma
//   (S = [q | q_rope] [c | k_rope]^T with K = 576, then 256 of the latent's
//   512 columns each of O = P c).  The split plan comes from the wrapper
//   (latent_plan: one CTA an SM, splits of >= 128 positions); a plan of
//   one split writes the output itself and launches no merge.
// - Each (split, group) writes its partial (max, sum, f32 accumulator) to a
//   workspace; a second kernel merges each row's partials with log-sum-exp
//   weights, the l == 0 -> 1 guard and the cast to q's type (no counters,
//   no atomics: nothing to reset, and a CUDA graph captures both).  It is
//   launched as a programmatic dependent (Hopper's PDL), so its launch and
//   its read of the index overlap the split kernel.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 512;  // Dk, Dv and Dr (MLA latent rank)
constexpr int kMaxSub = 32;   // positions of a sub-tile: a lane each
constexpr int kRingBudget = 64 * 1024;  // bytes of the staging rings
constexpr int kSmemLimit = 227 * 1024;
constexpr float kNeg = -1e30f;

// n / d for 0 <= n < 2^31 as a multiply-high, an add and a shift (the
// divisors are set on the host, so no division is left in a loop)
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(n), m) + n) >> s);
  }
};

FastDiv make_div(int d) {
  unsigned s = 0;
  while ((1u << s) < static_cast<unsigned>(d)) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {static_cast<unsigned>(d), static_cast<unsigned>(m), s};
}

// how one pool's rows are copied when TMA cannot take them: `vec` bytes a
// copy, `cpr` copies a row; a lane's next copy is dk rows and dc copies on
struct Copy {
  int vec, cpr, dk, dc;
  FastDiv per_row;  // by cpr
};

Copy make_copy(int vec, int row_bytes) {
  const int cpr = row_bytes / vec;
  return {vec, cpr, 32 / cpr, 32 % cpr, make_div(cpr)};
}

// A staged row of a pool is cut into 128-byte column boxes; a slot holds,
// per pool, [box][sub rows][128 bytes] with the 128-byte swizzle (16-byte
// chunk c of row j at chunk c ^ (j % 8)), as TMA writes it and the copy
// path mirrors: a quarter-warp reading the same chunk of 8 rows hits 8
// distinct bank groups.  Byte b of row j of a pool region:
__device__ __forceinline__ int swz(int b, int j, int sub) {
  return (b >> 7) * (sub << 7) + (j << 7) + ((((b >> 4) & 7) ^ (j & 7)) << 4) + (b & 15);
}

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const void* q_rope;
  const void* kr_pool;
  const int* pages;
  const int* index;
  void* out;
  float* part_acc;  // (n_splits * pg, NR, Dv): each (split, group)'s accumulator
  float* part_ml;   // (n_splits * pg, NR, 2): its running max and sum
  int KH, S, R, Dk, Dv, Dr, ps, mp;
  int pps, n_splits;
  int rows;     // query rows per CTA (R, or an even block of it)
  int nrb;      // row blocks per kv head
  int rg;       // warps of a position group
  int pg;       // position groups
  int rows_w;   // rows per warp
  int q_rows;   // q rows staged: rg * (a warp's rows), zeros past `rows`
  int p_pitch;  // floats a position of a warp's p buffer holds (CUDA-core walk)
  int sub;      // positions per sub-tile (a multiple of 8)
  int stages;   // ring depth of each group
  int tma;      // 1: pages come by TMA in boxes of bh rows; 0: by cp.async
  int bh;       // TMA box rows: a multiple of 8 that divides page_size
  int nbk, nbv, nbr;              // 128-byte column boxes of a K / V / rope row
  int slot_bytes;                 // a staged sub-tile: sub * 128 * (nbk + nbv + nbr)
  Copy cp_k, cp_v, cp_r;          // each pool's copies (cp.async path)
  int qk, qr;                     // f32 pitch of q / q_rope rows in smem
  int q_vec, qr_vec;              // q / q_rope elements a load (16 bytes, or 1)
  FastDiv q_row, qr_row;          // by loads a row of q / q_rope
  FastDiv by_ps, by_rg, by_s;     // by page_size, rg, S
  int ring_bytes;                 // the groups' staging rings
  int NR;                         // B * H * S query rows in all
  float scale;
};

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = repro::hopper::smem_u32(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else if constexpr (kBytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  } else {  // a bf16 row of odd length: no cp.async that small
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 or 1: rings are 2-3 deep) of this thread's
// groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
}

// the barrier of a position group: its own warps (one warp: its lanes)
__device__ __forceinline__ void group_sync(int group, int warps) {
  if (warps == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * warps) : "memory");
  }
}

// the 16 bytes of `raw` as floats, in registers (no address taken)
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the top half of an f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// q's rows [0, n_rows) (contiguous, `dim` elements each) into shared memory
// as f32, rows `pitch` floats apart, zeros past n_rows (up to `rows`) and
// past dim; `vec` elements a load (16 bytes, or 1), `per_row` divides by
// the loads a row.  The loads go out before their stores.
template <typename T>
__device__ __forceinline__ void stage_q(float* dst, int pitch, const T* src, int n_rows,
                                        int dim, int rows, int vec, FastDiv per_row) {
  constexpr int kBatch = 4;
  for (int i = n_rows * pitch + threadIdx.x; i < rows * pitch; i += kThreads) dst[i] = 0.f;
  if (pitch != dim) {
    for (int r = threadIdx.x; r < n_rows; r += kThreads) {
      for (int d = dim; d < pitch; ++d) dst[r * pitch + d] = 0.f;
    }
  }
  constexpr int kVec = 16 / sizeof(T);
  const int n = n_rows * dim / vec;  // loads
  if (vec == 1) {  // rows that 16-byte loads do not fit
    for (int c = threadIdx.x; c < n; c += kThreads) {
      const int r = per_row.div(c);
      dst[r * pitch + c - r * dim] = repro::to_float(src[c]);
    }
    return;
  }
  for (int c0 = threadIdx.x; c0 < n; c0 += kBatch * kThreads) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      raw[u] = reinterpret_cast<const uint4*>(src)[min(c0 + u * kThreads, n - 1)];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n) {
        const int r = per_row.div(c);
        float* out = dst + r * pitch + (c - r * static_cast<int>(per_row.d)) * kVec;
        float f[kVec];
        unpack(raw[u], f);
#pragma unroll
        for (int i = 0; i < kVec; i += 4) {
          *reinterpret_cast<float4*>(out + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
        }
      }
    }
  }
}

// Stage the rows j = first, first + step, ... (< n) of one pool into a
// slot's region by cp.async, kBytes a copy, swizzled as TMA would.  Lane j
// holds row j's pool row in `prow`; every lane of the warp runs the loop
// (the shuffle needs them); the lane's first copy is its k-th row, copy col.
template <int kBytes, typename T>
__device__ __forceinline__ void stage_rows(char* dst, int sub, const T* pool, int dim,
                                           const Copy& cp, int prow, int first, int step,
                                           int total, int k, int col, int lane) {
  for (int c = lane; c - lane < total; c += 32) {
    const int j = min(first + k * step, 31);
    const long long row = __shfl_sync(0xffffffffu, prow, j);
    if (c < total) {
      cp_async<kBytes>(dst + swz(col * kBytes, j, sub),
                       reinterpret_cast<const char*>(pool + row * dim) + col * kBytes);
    }
    k += cp.dk;
    col += cp.dc;
    if (col >= cp.cpr) {
      col -= cp.cpr;
      ++k;
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_pool(char* dst, int sub, const T* pool, int dim,
                                           const Copy& cp, int prow, int first, int step,
                                           int mine, int lane) {
  const int total = mine * cp.cpr;
  const int k = cp.per_row.div(lane);
  const int col = lane - k * cp.cpr;
  switch (cp.vec) {
    case 16: stage_rows<16>(dst, sub, pool, dim, cp, prow, first, step, total, k, col, lane); break;
    case 8: stage_rows<8>(dst, sub, pool, dim, cp, prow, first, step, total, k, col, lane); break;
    case 4: stage_rows<4>(dst, sub, pool, dim, cp, prow, first, step, total, k, col, lane); break;
    default: stage_rows<2>(dst, sub, pool, dim, cp, prow, first, step, total, k, col, lane);
  }
}

// acc[r] += q_r . k_j over dim elements, for the kRows rows of a warp; k_j
// is row j of a staged pool region (swizzled), q rows `qpitch` floats apart
template <typename T, int kRows>
__device__ __forceinline__ void dot_rows(const char* region, int j, int sub, const float* q,
                                         int qpitch, int dim, float (&acc)[kRows]) {
  constexpr int kVec = 16 / sizeof(T);
  const char* row = region + (j << 7);
  const int sw = j & 7;
  int d = 0;
#pragma unroll 2
  for (; d + kVec <= dim; d += kVec) {
    const int ci = d / kVec;  // 16-byte chunk of the row
    float kf[kVec];
    unpack(*reinterpret_cast<const uint4*>(row + (ci >> 3) * (sub << 7) + (((ci & 7) ^ sw) << 4)),
           kf);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < kVec; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(q + r * qpitch + d + i);
        acc[r] = fmaf(qv.x, kf[i], fmaf(qv.y, kf[i + 1],
                 fmaf(qv.z, kf[i + 2], fmaf(qv.w, kf[i + 3], acc[r]))));
      }
    }
  }
  for (; d < dim; ++d) {
    const float kf = repro::to_float(
        *reinterpret_cast<const T*>(region + swz(d * static_cast<int>(sizeof(T)), j, sub)));
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(q[r * qpitch + d], kf, acc[r]);
  }
}

// v[d], v[d + 1] of a staged row as floats (d even; v[d + 1] may be the
// row's padding, never stored)
__device__ __forceinline__ float2 load_pair(const float* v) {
  return *reinterpret_cast<const float2*>(v);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v));
}

// What a warp walks with: the CTA's shared memory and its place in it.
// `slot` is the staged sub-tile (K, then V, then the rope keys), t0 the
// absolute position of its row 0, n its loaded positions.
struct Tile {
  const char* slot;
  int t0, n;
};

// The CUDA-core walk (f32, the MLA operands, head dims TMA and the tensor
// cores do not take).  kRows: rows a warp holds (1, 4 or 16); kPairs:
// pairs of v's head dims a lane holds (lane l: dims 2l and 2l + 1, then 64
// further per pair).  Lane j scores position j against the warp's rows (q
// in shared memory as f32, broadcast reads); online softmax with warp
// shuffles; P.V with p broadcast from shared memory.
template <typename T, int kRows, int kPairs>
struct CoreWalk {
  static constexpr int kPPitch = kRows < 16 ? kRows : kRows + 4;  // p buffer, conflict-free
  float m[kRows], l[kRows], acc[kRows][kPairs][2];
  int qpos[kRows];  // each row's query position; past the warp's rows: -1
  int vbox[kPairs], vchunk[kPairs], vbyte[kPairs];

  __device__ __forceinline__ void init(const Params& p, const float* q_s, int r_lo, int r_n,
                                       int row_lo, int base, int lane) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row_lo + r;
      qpos[r] = r < r_n ? base + row - p.by_s.div(row) * p.S : -1;
      m[r] = kNeg;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < kPairs; ++c) acc[r][c][0] = acc[r][c][1] = 0.f;
    }
    // this lane's head dims of v, clamped into the row (the pairs past Dv
    // are computed on the row's own values and never stored), as byte
    // offsets in a swizzled row: column box, chunk, byte in the chunk
#pragma unroll
    for (int c = 0; c < kPairs; ++c) {
      const int bytes = min(2 * lane + 64 * c, (p.Dv - 1) & ~1) * static_cast<int>(sizeof(T));
      vbox[c] = (bytes >> 7) * (p.sub << 7);
      vchunk[c] = (bytes >> 4) & 7;
      vbyte[c] = bytes & 15;
    }
  }

  __device__ __forceinline__ void step(const Params& p, const Tile& tile, const float* q_s,
                                       const float* qr_s, float* p_s, int r_lo, int lane) {
    const int v_off = p.sub * 128 * p.nbk, r_off = p.sub * 128 * (p.nbk + p.nbv);
    // scores: lane j takes position t0 + j against the warp's rows (lanes
    // past n score a stale row of the slot, masked below)
    const int jl = min(lane, p.sub - 1);
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    dot_rows<T, kRows>(tile.slot, jl, p.sub, q_s + r_lo * p.qk, p.qk, p.Dk, sc);
    if (p.Dr > 0) {
      dot_rows<T, kRows>(tile.slot + r_off, jl, p.sub, qr_s + r_lo * p.qr, p.qr, p.Dr, sc);
    }
    // online softmax per row (rows past the warp's: all masked, p = 0);
    // each lane keeps its own share of the sum
    float pr[kRows], alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool valid = lane < tile.n && tile.t0 + lane <= qpos[r];
      const float s = valid ? sc[r] * p.scale : kNeg;
      const float m_new = fmaxf(m[r], repro::warp_max(s));
      // explicit re-mask: masked positions contribute exactly nothing
      pr[r] = valid ? expf(s - m_new) : 0.f;
      alpha[r] = expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + pr[r];
      m[r] = m_new;
    }
    if constexpr (kRows == 1) {
      p_s[lane] = pr[0];
    } else {
#pragma unroll
      for (int r = 0; r < kRows; r += 4) {
        *reinterpret_cast<float4*>(p_s + lane * kPPitch + r) =
            make_float4(pr[r], pr[r + 1], pr[r + 2], pr[r + 3]);
      }
    }
    __syncwarp();
    // P.V over the sub-tile's loaded positions (never past them)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        acc[r][c][0] *= alpha[r];
        acc[r][c][1] *= alpha[r];
      }
    }
    const char* vs = tile.slot + v_off;
#pragma unroll 4
    for (int j = 0; j < tile.n; ++j) {
      float pj[kRows];
      if constexpr (kRows == 1) {
        pj[0] = p_s[j];
      } else {
#pragma unroll
        for (int r = 0; r < kRows; r += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(p_s + j * kPPitch + r);
          pj[r] = v4.x;
          pj[r + 1] = v4.y;
          pj[r + 2] = v4.z;
          pj[r + 3] = v4.w;
        }
      }
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        const float2 v = load_pair(reinterpret_cast<const T*>(
            vs + vbox[c] + (j << 7) + ((vchunk[c] ^ (j & 7)) << 4) + vbyte[c]));
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][c][0] = fmaf(pj[r], v.x, acc[r][c][0]);
          acc[r][c][1] = fmaf(pj[r], v.y, acc[r][c][1]);
        }
      }
    }
    __syncwarp();  // p_s is free for the next sub-tile
  }

  // the warp's partial of its rows: row r at part rows at0 + r
  __device__ __forceinline__ void write(const Params& p, size_t at0, int r_n, int lane) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) l[r] = repro::warp_sum(l[r]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= r_n) break;
#pragma unroll
      for (int c = 0; c < kPairs; ++c) {
        const int d = 2 * lane + 64 * c;
        float* out = p.part_acc + (at0 + r) * p.Dv + d;
        if (d < p.Dv) out[0] = acc[r][c][0];
        if (d + 1 < p.Dv) out[1] = acc[r][c][1];
      }
      if (lane == 0) {
        p.part_ml[(at0 + r) * 2] = m[r];
        p.part_ml[(at0 + r) * 2 + 1] = l[r];
      }
    }
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// d += a . b for one m16n8k16 tile, bf16 in, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor-core walk (bf16, Dk and Dv multiples of 16 up to 128, no rope
// keys, more than 4 rows a kv head): a warp's 16 rows (zeros past its own) are the M of mma.sync
// m16n8k16.  S = q K^T takes q's fragments from registers and K's from the
// swizzled slot by ldmatrix; the online softmax runs on S's fragments (a
// row's values in a quad of lanes); P, rounded to bf16, is the A operand
// of O += P V with V's fragments by ldmatrix.trans.  A lane holds rows
// lane / 4 and lane / 4 + 8.
struct TcWalk {
  static constexpr int kKSteps = 8;   // Dk / 16, at most
  static constexpr int kNTiles = 16;  // Dv / 8, at most
  uint32_t qa[kKSteps][4];
  float o[kNTiles][4];
  float m[2], l[2];
  int qpos[2];

  __device__ __forceinline__ void init(const Params& p, const float* q_s, int r_lo, int r_n,
                                       int row_lo, int base, int lane) {
    const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      qpos[h] = r < r_n ? base + row_lo + r - p.by_s.div(row_lo + r) * p.S : -1;
      m[h] = kNeg;
      l[h] = 0.f;
    }
    const float* q0 = q_s + (r_lo + g) * p.qk;
    const float* q1 = q0 + 8 * p.qk;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int k = 16 * ks + c2;
      if (k < p.Dk) {
        qa[ks][0] = pack_bf16(q0[k], q0[k + 1]);
        qa[ks][1] = pack_bf16(q1[k], q1[k + 1]);
        qa[ks][2] = pack_bf16(q0[k + 8], q0[k + 9]);
        qa[ks][3] = pack_bf16(q1[k + 8], q1[k + 9]);
      }
    }
#pragma unroll
    for (int t = 0; t < kNTiles; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  }

  __device__ __forceinline__ void step(const Params& p, const Tile& tile, const float*,
                                       const float*, float*, int, int lane) {
    const int n_tiles = p.sub >> 3;       // 8 positions each
    const int k_steps = p.Dk >> 4;
    const int v_tiles = p.Dv >> 3;
    const int box = p.sub << 7;           // a column box of the slot
    // S = q K^T: n-tile nt holds positions 8 nt .. 8 nt + 7
    float s[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if (nt >= n_tiles) continue;
      // lane l addresses row 8 nt + l % 8 of 16-byte chunk 2 ks + l / 8
      const int j = 8 * nt + (lane & 7);
#pragma unroll
      for (int ks = 0; ks < kKSteps; ks += 2) {
        if (ks >= k_steps) break;
        const int c = 2 * ks + (lane >> 3);
        uint32_t b[4];
        ldsm_x4(b, tile.slot + (c >> 3) * box + (j << 7) + (((c & 7) ^ (j & 7)) << 4));
        mma_bf16(s[nt], qa[ks], b[0], b[1]);
        if (ks + 1 < k_steps) mma_bf16(s[nt], qa[ks + 1], b[2], b[3]);
      }
    }
    // online softmax on the fragments: c0, c1 are row g, c2, c3 row g + 8,
    // at positions 8 nt + 2 (lane % 4) + {0, 1}
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * nt + 2 * (lane & 3) + e;
          const bool valid = j < tile.n && tile.t0 + j <= qpos[h];
          s[nt][2 * h + e] = valid ? s[nt][2 * h + e] * p.scale : kNeg;
          mx = fmaxf(mx, s[nt][2 * h + e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // explicit re-mask: masked positions contribute exactly nothing
          const float x = s[nt][2 * h + e];
          const float pv = x > kNeg ? expf(x - m_new) : 0.f;
          s[nt][2 * h + e] = pv;
          sum += pv;
        }
      }
      alpha[h] = expf(m[h] - m_new);
      l[h] = l[h] * alpha[h] + sum;  // this lane's share; the quad's at the end
      m[h] = m_new;
    }
#pragma unroll
    for (int t = 0; t < kNTiles; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }
    // O += P V over the positions in steps of 16 (n-tiles 2 kk, 2 kk + 1;
    // a missing second n-tile is p = 0 against the slot's own rows)
    const char* vs = tile.slot + box * p.nbk;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (2 * kk >= n_tiles) break;
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // lane l addresses position 16 kk + 8 ((l / 8) % 2) + l % 8 of chunk
      // (v's 8-dim tile) vt + l / 16
      const int j = min(16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7), p.sub - 1);
#pragma unroll
      for (int vt = 0; vt < kNTiles; vt += 2) {
        if (vt >= v_tiles) break;
        const int c = vt + (lane >> 4);
        uint32_t b[4];
        ldsm_x4_t(b, vs + (c >> 3) * box + (j << 7) + (((c & 7) ^ (j & 7)) << 4));
        mma_bf16(o[vt], pa, b[0], b[1]);
        mma_bf16(o[vt + 1], pa, b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void write(const Params& p, size_t at0, int r_n, int lane) {
    const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int r = g + 8 * h;
      if (r >= r_n) continue;
      float* out = p.part_acc + (at0 + r) * p.Dv;
#pragma unroll
      for (int t = 0; t < kNTiles; ++t) {
        if (8 * t < p.Dv) {
          out[8 * t + c2] = o[t][2 * h];
          out[8 * t + c2 + 1] = o[t][2 * h + 1];
        }
      }
      if ((lane & 3) == 0) {
        p.part_ml[(at0 + r) * 2] = m[h];
        p.part_ml[(at0 + r) * 2 + 1] = l[h];
      }
    }
  }
};

// The split kernel: a CTA per (split, kv head and row block, slot); its
// warps walk with `Walk` (CoreWalk or TcWalk)
template <typename T, typename Walk>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_split(const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap kr_map,
                      const __grid_constant__ Params p) {
  extern __shared__ __align__(16) char smem_raw[];
  // 1024-byte aligned for the swizzle, by an offset into the shared array
  // (so every access below stays a shared-memory one)
  char* smem = smem_raw + ((1024 - (repro::hopper::smem_u32(smem_raw) & 1023)) & 1023);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the merge may start
  if (p.tma && threadIdx.x < 3) {  // fetch the maps while the setup's loads fly
    const CUtensorMap* map = threadIdx.x == 0 ? &k_map : threadIdx.x == 1 ? &v_map : &kr_map;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sp = blockIdx.x;
  const int kh = blockIdx.y / p.nrb;
  const int rbase = (blockIdx.y - kh * p.nrb) * p.rows;  // the block's first row
  const int b = blockIdx.z;
  const int rows = min(p.rows, p.R - rbase);
  float* q_s = reinterpret_cast<float*>(smem + p.ring_bytes);
  float* qr_s = q_s + p.q_rows * p.qk;
  float* p_s = qr_s + p.q_rows * p.qr + warp * kMaxSub * p.p_pitch;
  int* page_s = reinterpret_cast<int*>(qr_s + p.q_rows * p.qr + kWarps * kMaxSub * p.p_pitch);
  uint64_t* bars = reinterpret_cast<uint64_t*>(page_s + ((p.pps + 1) & ~1));

  // one round of loads: the slot's index, the split's first page ids, q
  const int split_len = p.pps * p.ps;
  const int pos0 = sp * split_len;
  const int first_page = sp * p.pps;
  const int n_pages = min(p.pps, p.mp - first_page);
  const int* split_pages = p.pages + static_cast<size_t>(b) * p.mp + first_page;
  const int base = p.index[b];
  int page = 0;
  if (threadIdx.x < n_pages) page = split_pages[threadIdx.x];
  const size_t row0 = (static_cast<size_t>(b) * p.KH + kh) * p.R + rbase;
  stage_q(q_s, p.qk, static_cast<const T*>(p.q) + row0 * p.Dk, rows, p.Dk, p.q_rows,
          p.q_vec, p.q_row);
  if (p.Dr > 0) {
    stage_q(qr_s, p.qr, static_cast<const T*>(p.q_rope) + row0 * p.Dr, rows, p.Dr,
            p.q_rows, p.qr_vec, p.qr_row);
  }
  // positions the slot's last row attends; the split's share of them
  const int n_pos = min(base + p.S, p.ps * p.mp);
  if (pos0 >= n_pos) return;  // the whole split lies past the slot
  const int pos1 = min(pos0 + split_len, n_pos);
  if (threadIdx.x < n_pages) page_s[threadIdx.x] = page;
  // a split of more pages than threads: the rest of the pages it walks
  const int used = (pos1 - pos0 + p.ps - 1) / p.ps;
  for (int i = threadIdx.x + kThreads; i < used; i += kThreads) page_s[i] = split_pages[i];
  // the rings start as zeros: rows of a slot that a sub-tile does not
  // load hold finite values (the tensor cores multiply them by p = 0)
  for (int i = 16 * threadIdx.x; i < p.ring_bytes; i += 16 * kThreads) {
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
  }
  if (p.tma && threadIdx.x < p.pg * p.stages) repro::hopper::mbar_init(&bars[threadIdx.x], 1);
  repro::hopper::mbar_init_fence();
  __syncthreads();

  // this warp: rows [r_lo, r_lo + r_n) of position group `group`
  const int group = p.by_rg.div(warp);
  const int wr = warp - group * p.rg;
  const int r_lo = wr * p.rows_w;
  const int r_n = min(p.rows_w, rows - r_lo);
  const bool walker = group < p.pg;
  Walk walk;
  walk.init(p, q_s, r_lo, r_n, rbase + r_lo, base, lane);

  const int n_sub = (pos1 - pos0 + p.sub - 1) / p.sub;
  const int n_mine = walker && n_sub > group ? (n_sub - group + p.pg - 1) / p.pg : 0;
  char* ring = smem + (walker ? group : 0) * p.stages * p.slot_bytes;
  uint64_t* ring_bars = bars + (walker ? group : 0) * p.stages;
  const int v_off = p.sub * 128 * p.nbk;          // V's region in a slot
  const int r_off = p.sub * 128 * (p.nbk + p.nbv);  // the rope keys'
  const T* k_pool = static_cast<const T*>(p.k_pool);
  const T* v_pool = static_cast<const T*>(p.v_pool);
  const T* kr_pool = static_cast<const T*>(p.kr_pool);

  // stage this group's k-th sub-tile: by TMA, boxes of bh rows issued by
  // the group's first lane; or by cp.async, this warp copying rows wr,
  // wr + rg, ...
  auto issue = [&](int k) {
    char* slot = ring + (k % p.stages) * p.slot_bytes;
    const int t0 = (group + k * p.pg) * p.sub;  // from the split's first position
    const int n = min(p.sub, pos1 - pos0 - t0);
    if (p.tma) {
      if (wr != 0 || lane != 0) return;
      uint64_t* bar = &ring_bars[k % p.stages];
      const int boxes = (n + p.bh - 1) / p.bh;
      repro::hopper::fence_async_smem();  // the slot's last reads come first
      repro::hopper::mbar_expect_tx(bar, boxes * p.bh * 128 * (p.nbk + p.nbv + p.nbr));
      constexpr int kCols = 128 / sizeof(T);  // elements of a column box
      for (int x = 0; x < boxes; ++x) {
        const int t = t0 + x * p.bh;
        const int page_i = p.by_ps.div(t);
        const int pid = page_s[page_i];
        const int prow = t - page_i * p.ps;
        const int kv_row = (pid * p.KH + kh) * p.ps + prow;
        char* dst = slot + x * p.bh * 128;
        for (int c = 0; c < p.nbk; ++c) {
          repro::hopper::tma_load_2d(dst + c * (p.sub << 7), &k_map, bar, c * kCols, kv_row);
        }
        for (int c = 0; c < p.nbv; ++c) {
          repro::hopper::tma_load_2d(dst + v_off + c * (p.sub << 7), &v_map, bar, c * kCols,
                                     kv_row);
        }
        for (int c = 0; c < p.nbr; ++c) {  // MLA: kr_pool is (P, 1, ps, Dr)
          repro::hopper::tma_load_2d(dst + r_off + c * (p.sub << 7), &kr_map, bar, c * kCols,
                                     pid * p.ps + prow);
        }
      }
      return;
    }
    const int t = t0 + min(lane, n - 1);
    const int page_i = p.by_ps.div(t);
    const int pid = page_s[page_i];
    const int prow = t - page_i * p.ps;
    const int mine = n > wr ? p.by_rg.div(n - wr + p.rg - 1) : 0;
    const int kv_row = (pid * p.KH + kh) * p.ps + prow;  // pool rows < 2^31
    stage_pool(slot, p.sub, k_pool, p.Dk, p.cp_k, kv_row, wr, p.rg, mine, lane);
    stage_pool(slot + v_off, p.sub, v_pool, p.Dv, p.cp_v, kv_row, wr, p.rg, mine, lane);
    if (p.Dr > 0) {
      stage_pool(slot + r_off, p.sub, kr_pool, p.Dr, p.cp_r, pid * p.ps + prow, wr, p.rg, mine,
                 lane);
    }
    cp_async_commit();
  };

  // k < 0: the ring's first stages - 1 sub-tiles go out; then sub-tile k
  // is waited on and walked while sub-tile k + stages - 1 goes out
  for (int k = 1 - p.stages; k < n_mine; ++k) {
    if (k >= 0) {
      if (p.tma) {  // sub-tile k has landed
        repro::hopper::mbar_wait(&ring_bars[k % p.stages], (k / p.stages) & 1);
      } else {      // this lane's copies of sub-tile k have landed
        cp_async_wait(min(p.stages - 2, n_mine - k - 1));
      }
      group_sync(group, p.rg);  // ... and the group's; k - 1 is consumed
    }
    if (k + p.stages - 1 < n_mine) issue(k + p.stages - 1);
    if (k < 0 || r_n <= 0) continue;  // a warp past the last row only copies
    const int t0 = pos0 + (group + k * p.pg) * p.sub;  // absolute
    const Tile& tile{ring + (k % p.stages) * p.slot_bytes, t0, min(p.sub, pos1 - t0)};
    walk.step(p, tile, q_s, qr_s, p_s, r_lo, lane);
  }

  // the group's partial of its rows, as if the group were a split of its
  // own: the merge kernel combines every (split, group) that ran
  if (!walker || r_n <= 0) return;
  walk.write(p, (static_cast<size_t>(sp) * p.pg + group) * p.NR + row0 + r_lo, r_n, lane);
}

// -- the latent walk: MLA's latent pool as keys and values, on wgmma ---------

namespace latent {

using namespace repro::hopper;

constexpr int kRows = 64;              // query rows a CTA: the M of wgmma
constexpr int kSub = 64;               // positions a sub-tile: the N of S
constexpr int kStages = 2;
constexpr int kLatBoxes = 8;           // 64-dim column boxes of a 512-wide latent row
constexpr int kBoxes = kLatBoxes + 1;  // and the rope keys' box (Dr <= 64)
constexpr int kQBox = kRows * 128;     // bytes of a column box of q's tile
constexpr int kBox = kSub * 128;       // of a sub-tile
constexpr int kQBytes = kBoxes * kQBox;
constexpr int kSlotBytes = kBoxes * kBox;
constexpr int kHalf = 256;             // latent columns a consumer warpgroup holds
constexpr int kConsumers = 256;        // two warpgroups: columns [0, 256) and [256, 512)
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kSmemFixed = 1024 + kQBytes + kStages * kSlotBytes + (2 * kStages + 1) * 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A CTA per (split, 64-row tile of the kv head's R = G * S rows, slot): the
// two tiles of a decode step's 128 rows run side by side, each reading the
// latent once (one CTA walking both, the second reading it again from L2,
// was slower on the H100 at decode and at 16-token chunks).  The producer
// warpgroup gives its registers to the consumers, loads the tile's q and
// q_rope once (3-D maps (D, R, B): rows past R come as zeros) and keeps
// each sub-tile of kSub positions in flight by TMA through two stages: the
// latent rows once, as keys and as values, and the rope rows beside them,
// page by page, each stage completing on an mbarrier.  Each consumer
// warpgroup computes S = [q | q_rope] [c | k_rope]^T (K = 576 in k16
// steps, both operands K-major, f32 accumulators) for the whole tile,
// takes the online softmax on S's fragment with the explicit re-mask, and
// O[:, half] += P C[:, half] (P rounded to bf16 in registers as the A
// operand, C read MN-major from the same staged rows, N = 256).  The two
// warpgroups compute the same S and the same softmax (the same
// instructions on the same operands give the same bits), so nothing passes
// between them: a second Q K^T costs tensor-core time, not a handoff.
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_latent(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap qr_map,
                       const __grid_constant__ CUtensorMap c_map,
                       const __grid_constant__ CUtensorMap kr_map,
                       const __grid_constant__ Params p) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the merge may start
  const int tid = threadIdx.x;
  const int sp = blockIdx.x;
  const int b = blockIdx.z;
  char* qs = smem;
  char* slots = smem + kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + kStages * kSlotBytes);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;
  int* page_s = reinterpret_cast<int*>(q_full + 1);

  const int split_len = p.pps * p.ps;
  const int pos0 = sp * split_len;
  const int base = p.index[b];
  // positions the slot's last row attends (the merge reads a partial of
  // every split that starts before them); the split's share of them
  const int n_pos = min(base + p.S, p.ps * p.mp);
  if (pos0 >= n_pos) return;
  const int pos1 = min(pos0 + split_len, n_pos);
  // the tile's rows, the end of the positions they see in the split (its
  // largest chunk position bounds them: the causal skip) and the sub-tiles
  // that cover them
  const int rbase = blockIdx.y * kRows;
  const int rows = min(kRows, p.R - rbase);
  const int s0 = rbase - p.by_s.div(rbase) * p.S;
  const int end = min(pos1, base + min(s0 + rows, p.S));
  const int n_sub = end > pos0 ? (end - pos0 + kSub - 1) / kSub : 0;
  const int* split_pages = p.pages + static_cast<size_t>(b) * p.mp + sp * p.pps;
  for (int i = tid; i < (pos1 - pos0 + p.ps - 1) / p.ps; i += kThreads) page_s[i] = split_pages[i];
  // rows a sub-tile does not load (and q's and the slots' boxes past Dk)
  // hold zeros, never stale bits: P = 0 times them is 0
  for (int i = 16 * tid; i < kQBytes + kStages * kSlotBytes; i += 16 * kThreads) {
    if (i >= kQBytes || p.Dk < 64 * kLatBoxes) *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
  }
  fence_async_smem();
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const int nbl = p.Dk / 64;  // latent boxes loaded

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues the loads
    regs_dealloc<40>();
    if (tid != kConsumers) return;
    mbar_expect_tx(q_full, (nbl + 1) * kQBox);
    for (int c = 0; c < nbl; ++c) tma_load_3d(qs + c * kQBox, &q_map, q_full, 64 * c, rbase, b);
    tma_load_3d(qs + kLatBoxes * kQBox, &qr_map, q_full, 0, rbase, b);
    for (int k = 0; k < n_sub; ++k) {
      const int st = k % kStages;
      mbar_wait(&empty[st], ((k / kStages) & 1) ^ 1);
      char* slot = slots + st * kSlotBytes;
      const int t0 = k * kSub;  // from the split's first position
      const int n = min(kSub, end - pos0 - t0);
      const int boxes = (n + p.bh - 1) / p.bh;
      mbar_expect_tx(&full[st], boxes * p.bh * 128 * (nbl + 1));
      for (int x = 0; x < boxes; ++x) {
        const int tp = t0 + x * p.bh;
        const int page_i = p.by_ps.div(tp);
        const int row = page_s[page_i] * p.ps + tp - page_i * p.ps;  // KH = 1
        char* dst = slot + x * p.bh * 128;
        for (int c = 0; c < nbl; ++c) tma_load_2d(dst + c * kBox, &c_map, &full[st], 64 * c, row);
        tma_load_2d(dst + kLatBoxes * kBox, &kr_map, &full[st], 0, row);
      }
    }
    return;
  }

  regs_alloc<232>();
  const int wg = tid / 128;  // this warpgroup's half of the latent's columns
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const float scale_log2 = p.scale * kLog2e;
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rbase + r0 + 8 * h;
    qpos[h] = r0 + 8 * h < rows ? base + row - p.by_s.div(row) * p.S : -1;
  }
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int k = 0; k < n_sub; ++k) {
    const int st = k % kStages;
    const char* slot = slots + st * kSlotBytes;
    mbar_wait(&full[st], (k / kStages) & 1);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // k16 steps: 32 bytes of a row each
        mma_bf16_ss_n64(sc, desc_sw128(qs + c * kQBox + kk * 32),
                        desc_sw128(slot + c * kBox + kk * 32), c > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // online softmax on the fragment: register i holds row r0 + 8 * ((i /
    // 2) % 2), position t0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2; the
    // explicit re-mask: a masked position contributes exactly nothing, also
    // to a row that has seen none yet
    const int t0 = pos0 + k * kSub;
    const int n = min(kSub, end - t0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const bool valid = j < n && t0 + j <= qpos[(i / 2) % 2];
      sc[i] = valid ? sc[i] * scale_log2 : kNeg;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float pv = sc[i] > kNeg ? exp2f(sc[i] - m[(i / 2) % 2]) : 0.f;
      sc[i] = pv;
      sum[(i / 2) % 2] += pv;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] *= alpha[(i / 2) % 2];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSub / 16; ++kk) {
      // the A fragment of positions 16 kk .. 16 kk + 15 is S's registers 8
      // kk .. 8 kk + 7, packed in pairs
      const uint32_t a[4] = {
          pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]), pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
          pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]), pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
      mma_bf16_rs_n256(o, a, desc_sw128(slot + 4 * wg * kBox + kk * 16 * 128, kBox), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[st]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const size_t at0 = static_cast<size_t>(sp) * p.NR + static_cast<size_t>(b) * p.R + rbase;
  if (p.n_splits == 1) {
    // one split: the tile's rows are whole, so it writes them as the merge
    // of one partial would (acc * (1 / l), l == 0 -> 1, one rounding to
    // bf16), and no merge runs
    const float inv[2] = {1.f / (l[0] == 0.f ? 1.f : l[0]), 1.f / (l[1] == 0.f ? 1.f : l[1])};
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.out) + at0 * p.Dv;
#pragma unroll
    for (int i = 0; i < 128; i += 2) {
      const int r = r0 + 8 * ((i / 2) % 2);
      const int col = kHalf * wg + 8 * (i / 4) + 2 * (lane % 4);
      if (r < rows && col < p.Dv) {
        const float w = inv[(i / 2) % 2];
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(r) * p.Dv + col) =
            __floats2bfloat162_rn(o[i] * w, o[i + 1] * w);
      }
    }
    return;
  }

  // the tile's partial, as one (split, group) of the workspace: the
  // accumulator's half of each row, and (by the first warpgroup) its max,
  // in natural-log units as the merge weighs it, and its sum
#pragma unroll
  for (int i = 0; i < 128; i += 2) {
    const int r = r0 + 8 * ((i / 2) % 2);
    const int col = kHalf * wg + 8 * (i / 4) + 2 * (lane % 4);
    if (r < rows && col < p.Dv) {
      *reinterpret_cast<float2*>(p.part_acc + (at0 + r) * p.Dv + col) = make_float2(o[i], o[i + 1]);
    }
  }
  if (wg == 0 && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r < rows) {
        *reinterpret_cast<float2*>(p.part_ml + (at0 + r) * 2) = make_float2(m[h] * kLn2, l[h]);
      }
    }
  }
}

}  // namespace latent

// A warp per (query row, 64 of its head dims): merge the partials of every
// (split, group) that ran for the row's slot with log-sum-exp weights.  A
// partial that saw no position of this row holds (kNeg, 0, 0) and adds
// nothing.  The partials come 32 at a time, lane v holding partial v's
// weight; a lane's two dims of their accumulators are read kBatch partials
// at a time, all in flight together.  Launched as the split kernel's
// programmatic dependent: it reads the index while the split kernel runs,
// then waits for its partials.
template <typename T>
__global__ void __launch_bounds__(256)
paged_attention_merge(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ index, T* __restrict__ out,
                      int NR, int rows_per_slot, int S, int Dv, int cap,
                      int split_len, int n_splits, int groups) {
  constexpr int kBatch = 8;
  const int lane = threadIdx.x & 31;
  const int blocks = (Dv + 63) / 64;  // of 64 dims a row
  const int w = min(static_cast<int>(blockIdx.x * 8 + (threadIdx.x >> 5)), NR * blocks - 1);
  const int row = w / blocks;
  const int d0 = (w - row * blocks) * 64 + 2 * lane;
  const int n_pos = min(index[row / rows_per_slot] + S, cap);
  const int ran = groups * max(0, min(n_splits, (n_pos + split_len - 1) / split_len));
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (blockIdx.x * 8 + (threadIdx.x >> 5) >= NR * blocks) return;
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + row;  // partial v: ml[v * NR]
  float mx = kNeg;
  for (int v = lane; v < ran; v += 32) mx = fmaxf(mx, ml[static_cast<size_t>(v) * NR].x);
  mx = repro::warp_max(mx);
  const int d = min(d0, Dv - 1), d1 = min(d0 + 1, Dv - 1);
  float lsum = 0.f, a0 = 0.f, a1 = 0.f;
  for (int v32 = 0; v32 < ran; v32 += 32) {
    const int n = min(32, ran - v32);
    float wv = 0.f;
    if (lane < n) {
      const float2 mv = ml[static_cast<size_t>(v32 + lane) * NR];
      wv = expf(mv.x - mx);
      lsum = fmaf(mv.y, wv, lsum);
    }
    for (int u0 = 0; u0 < n; u0 += kBatch) {
      float x0[kBatch], x1[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float* acc =
            part_acc + (static_cast<size_t>(v32 + min(u0 + u, n - 1)) * NR + row) * Dv;
        x0[u] = acc[d];
        x1[u] = acc[d1];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float wu = __shfl_sync(0xffffffffu, wv, (u0 + u) & 31);
        if (u0 + u < n) {
          a0 = fmaf(x0[u], wu, a0);
          a1 = fmaf(x1[u], wu, a1);
        }
      }
    }
  }
  lsum = repro::warp_sum(lsum);
  const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
  T* o = out + static_cast<size_t>(row) * Dv;
  if (d0 < Dv) o[d0] = repro::from_float<T>(a0 * inv);
  if (d0 + 1 < Dv) o[d0 + 1] = repro::from_float<T>(a1 * inv);
}

// bytes per copy: 16 when the pool's base and rows allow it, else 8, 4, 2
int copy_bytes(const void* pool, int row_bytes) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(pool);
  for (int v = 16; v >= 4; v /= 2) {
    if (addr % v == 0 && row_bytes % v == 0) return v;
  }
  return 2;
}

// a 2-D map (D, rows) over a pool of `rows` rows of D elements, loading
// boxes of 128 bytes x bh rows with the 128-byte swizzle (columns past D
// come as zeros)
template <typename T>
cudaError_t pool_map(CUtensorMap* map, const void* pool, int D, long long rows, int bh) {
  const uint64_t dims[2] = {static_cast<uint64_t>(D), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {sizeof(T) * static_cast<uint64_t>(D)};
  const uint32_t box[2] = {128 / sizeof(T), static_cast<uint32_t>(bh)};
  return repro::hopper::make_map(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, pool, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// the merge of the partials, as the split kernel's programmatic dependent
template <typename T>
cudaError_t launch_merge(const Params& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.NR * ((p.Dv + 63) / 64) + 7) / 8));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_attention_merge<T>,
                            static_cast<const float*>(p.part_acc),
                            static_cast<const float*>(p.part_ml), p.index, static_cast<T*>(p.out),
                            p.NR, p.KH * p.R, p.S, p.Dv, p.ps * p.mp, p.pps * p.ps, p.n_splits,
                            p.pg);
}

template <typename T, typename Walk>
cudaError_t launch_split(const CUtensorMap (&maps)[3], const Params& p, int B, int smem,
                         cudaStream_t stream) {
  auto kernel = paged_attention_split<T, Walk>;
  if (smem > 48 * 1024) {
    const cudaError_t err = repro::hopper::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(p.n_splits, p.KH * p.nrb, B), kThreads, smem, stream>>>(maps[0], maps[1],
                                                                       maps[2], p);
  return cudaGetLastError();
}

// the CUDA-core walk for pairs of v's dims a lane and rows a warp
template <typename T>
cudaError_t launch_core(const CUtensorMap (&maps)[3], const Params& p, int pairs, int k_rows,
                        int B, int smem, cudaStream_t stream) {
  if (pairs == 8) return launch_split<T, CoreWalk<T, 4, 8>>(maps, p, B, smem, stream);
  if (k_rows == 1) {
    return pairs == 1 ? launch_split<T, CoreWalk<T, 1, 1>>(maps, p, B, smem, stream)
                      : launch_split<T, CoreWalk<T, 1, 2>>(maps, p, B, smem, stream);
  }
  if (k_rows == 4) {
    return pairs == 1 ? launch_split<T, CoreWalk<T, 4, 1>>(maps, p, B, smem, stream)
                      : launch_split<T, CoreWalk<T, 4, 2>>(maps, p, B, smem, stream);
  }
  return pairs == 1 ? launch_split<T, CoreWalk<T, 16, 1>>(maps, p, B, smem, stream)
                    : launch_split<T, CoreWalk<T, 16, 2>>(maps, p, B, smem, stream);
}

template <typename T>
cudaError_t launch(Params p, int B, int pool_pages, long long work_elems, cudaStream_t stream) {
  constexpr int e = sizeof(T);
  constexpr int kVec = 16 / e;
  const int dims[3] = {p.Dk, p.Dv, p.Dr};
  const void* pools[3] = {p.k_pool, p.v_pool, p.kr_pool};
  // TMA takes a pool whose rows are whole 16-byte chunks of at least one
  // column box, from a 16-byte aligned base; pages of a multiple of 8 rows
  p.bh = 0;
  for (int bh = 32; bh >= 8; bh -= 8) {
    if (p.ps % bh == 0) {
      p.bh = bh;
      break;
    }
  }
  p.tma = p.bh > 0;
  for (int i = 0; i < 3; ++i) {
    if (dims[i] > 0 && (dims[i] * e % 16 || dims[i] * e < 128 ||
                        reinterpret_cast<uintptr_t>(pools[i]) % 16)) {
      p.tma = 0;
    }
  }
  p.cp_k = make_copy(copy_bytes(p.k_pool, p.Dk * e), p.Dk * e);
  p.cp_v = make_copy(copy_bytes(p.v_pool, p.Dv * e), p.Dv * e);
  p.cp_r = p.Dr > 0 ? make_copy(copy_bytes(p.kr_pool, p.Dr * e), p.Dr * e) : make_copy(16, 16);
  p.nbk = (p.Dk * e + 127) / 128;
  p.nbv = (p.Dv * e + 127) / 128;
  p.nbr = (p.Dr * e + 127) / 128;
  p.qk = (p.Dk + 3) & ~3;
  p.qr = (p.Dr + 3) & ~3;
  p.q_vec = p.Dk % kVec == 0 && reinterpret_cast<uintptr_t>(p.q) % 16 == 0 ? kVec : 1;
  p.qr_vec = p.Dr % kVec == 0 && reinterpret_cast<uintptr_t>(p.q_rope) % 16 == 0 ? kVec : 1;
  p.q_row = make_div(p.Dk / p.q_vec);
  p.qr_row = make_div(std::max(p.Dr / p.qr_vec, 1));
  p.by_ps = make_div(p.ps);
  p.by_s = make_div(p.S);
  // the tensor cores take bf16 with Dk, Dv multiples of 16 up to 128, no
  // rope keys and more than 4 rows a kv head, 16 rows a warp; the CUDA
  // cores take the rest, a warp holding k_rows rows of `pairs` pairs of v's
  // dims
  const bool tc = e == 2 && p.Dr == 0 && p.Dk % 16 == 0 && p.Dk <= 128 && p.Dv % 16 == 0 &&
                  p.Dv <= 128 && p.R > 4;
  const int pairs = p.Dv <= 64 ? 1 : p.Dv <= 128 ? 2 : 8;
  const int k_rows = tc ? 16 : p.R == 1 && pairs < 8 ? 1 : pairs == 8 || p.R <= 4 ? 4 : 16;
  p.p_pitch = tc ? 0 : k_rows < 16 ? k_rows : k_rows + 4;
  p.nrb = (p.R + kWarps * k_rows - 1) / (kWarps * k_rows);
  p.rows = (p.R + p.nrb - 1) / p.nrb;
  p.rg = (p.rows + k_rows - 1) / k_rows;
  p.rows_w = (p.rows + p.rg - 1) / p.rg;
  p.pg = kWarps / p.rg;
  p.q_rows = p.rg * k_rows;
  p.by_rg = make_div(p.rg);
  // sub-tile and ring depth: the deepest that fit the rings' budget (a
  // sub-tile of whole TMA boxes)
  const int row_bytes = 128 * (p.nbk + p.nbv + p.nbr);
  const int choices[][2] = {{32, 3}, {32, 2}, {16, 3}, {16, 2}, {8, 2}};
  p.sub = 0;
  for (const auto& c : choices) {
    const int sub = p.tma ? c[0] / p.bh * p.bh : c[0];
    if (sub == 0) continue;
    p.sub = sub;
    p.stages = c[1];
    if (p.pg * p.stages * sub * row_bytes <= kRingBudget) break;
  }
  p.slot_bytes = p.sub * row_bytes;
  p.ring_bytes = p.pg * p.stages * p.slot_bytes;
  // the (max, sum) pairs after the accumulators, 8-byte aligned; the
  // caller's workspace must hold both
  const long long parts = static_cast<long long>(p.n_splits) * p.pg * p.NR;
  const long long ml_at = (parts * p.Dv + 1) & ~1ll;
  if (ml_at + 2 * parts > work_elems) return cudaErrorInvalidValue;
  p.part_ml = p.part_acc + ml_at;
  const int smem = 1024 + p.ring_bytes +
                   4 * (p.q_rows * (p.qk + p.qr) + kWarps * kMaxSub * p.p_pitch +
                        ((p.pps + 1) & ~1)) +
                   8 * p.pg * p.stages;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap maps[3] = {};
  if (p.tma) {
    const long long rows = static_cast<long long>(pool_pages) * p.ps;
    cudaError_t err = pool_map<T>(&maps[0], p.k_pool, p.Dk, rows * p.KH, p.bh);
    if (err == cudaSuccess) err = pool_map<T>(&maps[1], p.v_pool, p.Dv, rows * p.KH, p.bh);
    if (err == cudaSuccess && p.Dr > 0) err = pool_map<T>(&maps[2], p.kr_pool, p.Dr, rows, p.bh);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err;
  if constexpr (e == 2) {
    err = tc ? launch_split<T, TcWalk>(maps, p, B, smem, stream)
             : launch_core<T>(maps, p, pairs, k_rows, B, smem, stream);
  } else {
    err = launch_core<T>(maps, p, pairs, k_rows, B, smem, stream);
  }
  if (err != cudaSuccess) return err;
  return launch_merge<T>(p, stream);
}

// The latent walk: bf16, one kv head whose pool is both keys and values
// (Dk == Dv, a multiple of 64 up to 512), rope keys of at most 64 dims
// beside it, pages of a multiple of 8 rows, 16-byte aligned operands
// (repro_paged_attention checks); an error code for a request it cannot
// take.  One position group a CTA: its tile's partial is (split, 0).
cudaError_t launch_latent(Params p, int B, int pool_pages, long long work_elems,
                          cudaStream_t stream) {
  p.bh = p.ps % 32 == 0 ? 32 : p.ps % 16 == 0 ? 16 : 8;  // divides kSub and the page
  p.nrb = (p.R + latent::kRows - 1) / latent::kRows;  // tiles
  p.pg = 1;
  p.by_ps = make_div(p.ps);
  p.by_s = make_div(p.S);
  const long long parts = static_cast<long long>(p.n_splits) * p.NR;
  const long long ml_at = (parts * p.Dv + 1) & ~1ll;
  if (ml_at + 2 * parts > work_elems) return cudaErrorInvalidValue;
  p.part_ml = p.part_acc + ml_at;
  const int smem = latent::kSmemFixed + 4 * p.pps;
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap q_map, qr_map, c_map, kr_map;
  const long long rows = static_cast<long long>(pool_pages) * p.ps;
  cudaError_t err = repro::hopper::map_heads(&q_map, p.q, p.Dk, p.R, B, latent::kRows);
  if (err == cudaSuccess) err = repro::hopper::map_heads(&qr_map, p.q_rope, p.Dr, p.R, B, latent::kRows);
  if (err == cudaSuccess) err = pool_map<__nv_bfloat16>(&c_map, p.k_pool, p.Dk, rows, p.bh);
  if (err == cudaSuccess) err = pool_map<__nv_bfloat16>(&kr_map, p.kr_pool, p.Dr, rows, p.bh);
  if (err != cudaSuccess) return err;
  static const cudaError_t smem_err =
      repro::hopper::allow_smem(latent::paged_attention_latent, kSmemLimit);
  if (smem_err != cudaSuccess) return smem_err;
  const dim3 grid(p.n_splits, p.nrb, B);
  latent::paged_attention_latent<<<grid, latent::kThreads, smem, stream>>>(
      q_map, qr_map, c_map, kr_map, p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return err;  // one split: no merge
  return launch_merge<__nv_bfloat16>(p, stream);
}

// route codes: kernels/paged_attention.py's ROUTES
constexpr int kRouteSplit = 0;
constexpr int kRouteLatent = 1;

}  // namespace

// The pools hold `pool_pages` pages; `workspace` holds `workspace_elems`
// floats, at least a partial of every (split, position group) and query
// row: n_splits * groups * B * H * S * (Dv + 2), rounded up to even, with
// at most kWarps groups a CTA on the split walk and one on the latent walk
// (an error code if it is short); `pages_per_split` and `n_splits` are the
// wrapper's split plan (repro_torch/kernels/paged_attention.py,
// split_plan), of any size that covers the table.  `route` is the walk the
// wrapper picked (paged_route): the split walk takes every request; the
// latent walk refuses one it cannot take, and nothing falls back.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* q_rope,
    const void* kr_pool, const void* pages, const void* index, void* out,
    void* workspace, long long workspace_elems, int B, int H, int KH, int S, int Dk, int Dv,
    int Dr,
    int page_size, int max_pages, int pool_pages, int pages_per_split, int n_splits,
    float scale, int dtype, int route, void* stream) {
  if (B <= 0 || KH <= 0 || S <= 0 || H % KH || page_size <= 0 || pool_pages <= 0 ||
      max_pages <= 0 || Dk <= 0 || Dv <= 0 || Dk > kMaxDim || Dv > kMaxDim ||
      Dr < 0 || Dr > kMaxDim ||
      (Dr > 0 && (q_rope == nullptr || kr_pool == nullptr)) ||
      pages_per_split <= 0 ||
      n_splits != (max_pages + pages_per_split - 1) / pages_per_split ||
      workspace == nullptr) {
    return cudaErrorInvalidValue;
  }
  Params p{};
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.q_rope = q_rope;
  p.kr_pool = kr_pool;
  p.pages = static_cast<const int*>(pages);
  p.index = static_cast<const int*>(index);
  p.out = out;
  p.KH = KH;
  p.S = S;
  p.R = (H / KH) * S;
  p.Dk = Dk;
  p.Dv = Dv;
  p.Dr = Dr;
  p.ps = page_size;
  p.mp = max_pages;
  p.pps = pages_per_split;
  p.n_splits = n_splits;
  p.NR = B * H * S;
  p.scale = scale;
  p.part_acc = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteLatent) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(q_rope) |
                           reinterpret_cast<uintptr_t>(k_pool) |
                           reinterpret_cast<uintptr_t>(kr_pool);
    if (dtype != repro::kBFloat16 || k_pool != v_pool || KH != 1 || Dk != Dv || Dk % 64 ||
        Dr <= 0 || Dr > 64 || Dr % 8 || page_size % 8 || addr % 16) {
      return cudaErrorInvalidValue;
    }
    return launch_latent(p, B, pool_pages, workspace_elems, s);
  }
  if (route != kRouteSplit) return cudaErrorInvalidValue;
  if (dtype == repro::kFloat32) return launch<float>(p, B, pool_pages, workspace_elems, s);
  if (dtype == repro::kBFloat16) {
    return launch<__nv_bfloat16>(p, B, pool_pages, workspace_elems, s);
  }
  return cudaErrorInvalidValue;
}
