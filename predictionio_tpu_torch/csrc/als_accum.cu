// ALS normal-equation segment accumulators for Hopper (sm_90a).
//
// Replaces the two TPU kernels of predictionio_tpu/ops/als_pallas.py:
//  * _make_fused_kernel (built by make_fused_accum, called through
//    segment_stats_fused): for every segment, the sum over its COO rows of the
//    flat row [vec(w * v v^T) | rhs * v | valid | 0 ...], where v is the
//    opposite factor row, gathered per COO row, and (w, rhs, valid) come from
//    confidence_weights.  Entry point pio_als_fused_accum.
//  * _make_kernel (built by make_segment_accum, called per chunk through
//    segment_stats_pallas): the same per-segment sums over flat rows that the
//    caller built.  Entry point pio_als_segment_accum; it adds into a running
//    output, so a stream cut into chunks accumulates chunk by chunk.
// Column c of the row is w*v[c/k]*v[c%k] for c < k*k, rhs*v[c-k*k] for
// c < k*k+k, valid at c = k*k+k, and 0 up to the width (a multiple of 128).
//
// The stream (build_plan in predictionio_tpu_torch/ops/als_accum.py) is sorted
// by segment and padded per block of 128 segments to whole tiles of 1024 rows:
// tile t lies in block block_map[t], seg[t*1024 + r] is the row's segment
// within the block (0..127) or -1 for padding, padding only ends a block, and
// within a tile each segment's rows form one run, in increasing order.
//
// What bounds them on this card: each stream row is read once (its segment id,
// opposite index and three weights, 20 bytes, or the built row) and each output
// row written once; the arithmetic is ~3k^2 fp32 operations per row for the
// fused kernel and one add per row value for the chunk kernel, below the
// H100's operations-per-byte balance at every rank <= 32.  So both are bound by
// bytes; the opposite factor table (at most a few MB) stays in the 50 MB L2.
// Tensor cores are not used: at k=10 the per-segment Gram is 10 x 10, so a
// 16 x 8 MMA tile is mostly padding, and "bf16" rounds each formed product,
// which an MMA over bf16 operands cannot reproduce.
//
// Both kernels share the run/carry structure, with no float atomics:
//  * Pass 1: a run of a segment that starts and ends inside a tile is a whole
//    segment and is written to the output directly.  The tile's first run (it
//    may continue from the tile before) and its run at the last row (it may
//    continue into the next tile) go to a carry buffer [n_tiles, 2, width]
//    instead, their global segment ids to carry_seg [n_tiles, 2] (-1: none).
//  * Pass 2 (reduce_carries): the first entry of each carried segment sums that
//    segment's entries in tile order and adds the sum to the output.
//  * Every segment has one writer per launch and every sum has a fixed order,
//    so two runs give the same bits.  Each row value is formed with
//    __fmul_rn/__fadd_rn (never contracted into an FMA), as the plain version
//    forms it: (v[a]*v[b])*w, v[a]*rhs, valid; in "bf16" it is rounded to bf16
//    (round to nearest even) before it is added.
//
// Pass 1 of the fused kernel (accum_fused), one CTA per tile for all columns:
//  * Form each distinct value once.  With u = [v, 1] (length k+1), every value
//    of the row is u[a]*u[b] times a weight, a <= b <= k: w for b < k, rhs for
//    b = k (v[a]*1*rhs), and the count at a = b = k; that is the upper
//    triangle of u's Gram, k(k+1)/2 + k + 1 values (66 at k=10, 561 at k=32,
//    against 128 and 1,152 row columns).  The mirror column b*k+a is written
//    from the same register: (v[b]*v[a])*w and (v[a]*v[b])*w are the same bits.
//  * Every thread does useful work.  u is cut into groups of 4; a thread owns
//    one 4x4 block (ga <= gb) of the triangle, 16 sums in registers, and per
//    row reads 4 entries of u for its rows and 4 for its columns with two
//    16-byte shared loads (the weights come 4 rows at a time).  The tile's
//    1,024 rows are cut into row groups, one set of block threads each; a row
//    group's first and last runs are combined with their neighbours' in row
//    group order after the walk, so every segment's sum still has one fixed
//    order.
//  * Double-buffered staging with cp.async: 256 rows at a time (their segment
//    ids, weights and gathered factor rows, one or a few cp.async per row,
//    16 bytes where the rank allows it; Hopper's TMA has no row gather) are in
//    flight while the 256 before them are summed.  No per-element division.
//
// Pass 1 of the chunk kernel (accum_prefetch) moves 4 bytes per add, so the
// card's memory rate holds it only with enough bytes in flight: ~18 KB per SM
// by Little's law (3.35 TB/s over 132 SMs, ~0.7 us loaded latency).  A thread
// that loads one value per row behind the run check keeps ~one load per warp
// in flight (a thread-per-column kernel ran at 1.12 TB/s on an H100).  So:
//  * A unit is one (tile, 128-column slab): 1,024 rows of 512 bytes each, at
//    row * width * 4 + slab * 512, 16-byte aligned at every width.  A CTA is
//    one warp and walks one unit; a chunk (chunk_tiles in ops/als_accum.py)
//    is ~1,024 units at every width, ~8 warps per SM, one wave.
//  * Each lane owns four columns and issues its eight rows' 16-byte loads
//    and their segment ids before the run logic: 4 KB per warp, ~32 KB per
//    SM in flight.
//  * The lane walks the rows in order, four at a time with one check when
//    all four continue the current run (the segment is the same in every
//    lane: no divergence).  Each column's sum is taken in row order from 0,
//    as the thread-per-column kernel took it, so the two give the same bits.
//  * Timed on an H100 beside rings filled by Hopper's bulk copy
//    (cp.async.bulk into shared memory, counted on mbarriers): one-wave
//    rings were as fast within one call's spread, persistent ones slower
//    (PERF.md, section 6), so the plain loads stay.

// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (predictionio_tpu_torch/ops/_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 1024;  // rows per tile: T in ops/als_accum.py
constexpr int kSeg = 128;    // segments per block: S in ops/als_accum.py
constexpr int kSlab = 128;   // columns of a chunk-kernel unit and of a pass-2 CTA
constexpr int kPiece = 256;  // rows staged in shared memory at a time
constexpr int kMaxRank = 32;
// the fused kernel: threads per CTA at most, row groups at most
constexpr int kFusedThreads = 256;
constexpr int kMaxRowGroups = 64;
constexpr int kAbsent = -2;  // a row group whose first run is also its last
constexpr int kNoRun = -4;
static_assert(kPiece == 256, "a piece's four words are 4 x 64 chunks of 4 rows");

__device__ __forceinline__ float round_row(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// -- the chunk kernel's pass 1 ----------------------------------------------

__device__ __forceinline__ void add4(float4& a, float4 x) {
  a.x = __fadd_rn(a.x, x.x);
  a.y = __fadd_rn(a.y, x.y);
  a.z = __fadd_rn(a.z, x.z);
  a.w = __fadd_rn(a.w, x.w);
}

template <bool kBf16>
__device__ __forceinline__ float4 round4(float4 x) {
  const int b = kBf16 ? 1 : 0;
  return make_float4(round_row(x.x, b), round_row(x.y, b), round_row(x.z, b),
                     round_row(x.w, b));
}

// The runs of one unit as one lane walks them: its four columns col..col+3
// of tile t, whose segments lie in output block blk.
template <bool kBf16>
struct Runs {
  float* out;
  float* carry;
  size_t t;
  int blk, width, col;
  int cur = -1;   // segment of the current run (-1: none, or padding)
  int start = 0;  // row of the tile where the current run began
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  // a finished run: carried if it began at row 0 or reaches the tile's end,
  // else a whole segment, added to the output
  __device__ __forceinline__ void finish(bool at_end) {
    if (cur < 0) return;
    if (start == 0 || at_end) {
      float* c = carry + (t * 2 + (start == 0 ? 0 : 1)) * width + col;
      *reinterpret_cast<float4*>(c) = acc;
    } else {
      float4* o = reinterpret_cast<float4*>(
          out + static_cast<size_t>(blk * kSeg + cur) * width + col);
      float4 v = *o;
      add4(v, acc);
      *o = v;
    }
  }

  // tile row r, of segment s (-1: padding); s is the same in every lane
  __device__ __forceinline__ void step(int s, int r, float4 x) {
    if (s != cur) {
      finish(false);
      cur = s;
      start = r;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (s >= 0) add4(acc, round4<kBf16>(x));
  }

  // tile rows r..r+3: one check where all four continue the current run
  __device__ __forceinline__ void step4(int4 s, int r, float4 x0, float4 x1,
                                        float4 x2, float4 x3) {
    if (cur >= 0 && s.x == cur && s.y == cur && s.z == cur && s.w == cur) {
      add4(acc, round4<kBf16>(x0));
      add4(acc, round4<kBf16>(x1));
      add4(acc, round4<kBf16>(x2));
      add4(acc, round4<kBf16>(x3));
      return;
    }
    step(s.x, r, x0);
    step(s.y, r + 1, x1);
    step(s.z, r + 2, x2);
    step(s.w, r + 3, x3);
  }

  // the unit's end: its last run, and (one lane of slab 0) the tile's
  // carried segments; first is the segment of row 0
  __device__ __forceinline__ void end(int first, int* carry_seg, bool writer) {
    finish(true);
    if (writer) {
      carry_seg[2 * t] = first >= 0 ? blk * kSeg + first : -1;
      carry_seg[2 * t + 1] = (cur >= 0 && start != 0) ? blk * kSeg + cur : -1;
    }
  }
};

// Grid (n_tiles * n_slabs), one warp each: CTA u walks unit u = (tile,
// slab), each lane loading its float4 of 8 rows (and the 8 rows' segment
// ids) before the run logic.
template <bool kBf16>
__global__ void __launch_bounds__(32)
accum_prefetch(const int* __restrict__ seg, const int* __restrict__ block_map,
               const float* __restrict__ rows, int width, float* __restrict__ out,
               float* __restrict__ carry, int* __restrict__ carry_seg) {
  const int n_slabs = width / kSlab;
  const int t = blockIdx.x / n_slabs, slab = blockIdx.x - t * n_slabs;
  const int lane = threadIdx.x;
  const size_t row0 = static_cast<size_t>(t) * kTile;
  const float* src = rows + row0 * width + slab * kSlab + 4 * lane;
  const int* sg = seg + row0;
  Runs<kBf16> runs{out, carry, static_cast<size_t>(t), block_map[t], width,
                   slab * kSlab + 4 * lane};
  for (int r = 0; r < kTile; r += 8) {
    float4 x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x[e] = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r + e) * width));
    }
    const int4 sa = __ldg(reinterpret_cast<const int4*>(sg + r));
    const int4 sb = __ldg(reinterpret_cast<const int4*>(sg + r + 4));
    runs.step4(sa, r, x[0], x[1], x[2], x[3]);
    runs.step4(sb, r + 4, x[4], x[5], x[6], x[7]);
  }
  runs.end(__ldg(sg), carry_seg, slab == 0 && lane == 0);
}

// -- pass 2, shared by both kernels -----------------------------------------

// Entry e = 2*tile + slot of carry_seg / carry.  The entries of one segment
// follow each other in tile order, with an empty slot 1 between two where a
// tile holds that segment alone.
__global__ void __launch_bounds__(kSlab)
reduce_carries(const int* __restrict__ carry_seg,
               const float* __restrict__ carry, int n_entries, int width,
               float* __restrict__ out) {
  const int e = blockIdx.x;
  const int g = carry_seg[e];
  if (g < 0) return;
  if ((e & 1) == 0 && e >= 2) {
    // slot 0 continues the previous tile's last run when that run is g
    const int prev = carry_seg[e - 1] >= 0 ? carry_seg[e - 1] : carry_seg[e - 2];
    if (prev == g) return;  // an earlier entry owns g
  }
  int end = e + 1;
  while (end < n_entries) {
    const int sg = carry_seg[end];
    if (sg == g || (sg < 0 && (end & 1))) {
      ++end;
    } else {
      break;
    }
  }
  const int c = blockIdx.y * kSlab + threadIdx.x;
  float sum = 0.f;
#pragma unroll 4
  for (int i = e; i < end; ++i) {
    if (carry_seg[i] == g) {
      sum = __fadd_rn(sum, carry[static_cast<size_t>(i) * width + c]);
    }
  }
  float* o = out + static_cast<size_t>(g) * width + c;
  *o = __fadd_rn(*o, sum);
}

// -- the fused kernel's pass 1 ------------------------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The geometry of one fused CTA, from the rank alone: u = [v, 1] in g
// groups of 4 (row stride 4g floats in shared memory), items = g(g+1)/2
// blocks, row_groups sets of block threads, each walking kTile / row_groups
// rows.
struct FusedGeom {
  int g, stride, items, row_groups, threads, group_rows, piece_rows;
};

__host__ __device__ inline FusedGeom fused_geom(int k) {
  FusedGeom f;
  f.g = (k + 4) / 4;
  f.stride = 4 * f.g;
  f.items = f.g * (f.g + 1) / 2;
  f.row_groups = 1;
  while (f.row_groups * 2 <= kMaxRowGroups &&
         f.items * f.row_groups * 2 <= kFusedThreads) {
    f.row_groups *= 2;
  }
  f.threads = f.items * f.row_groups;
  f.group_rows = kTile / f.row_groups;
  f.piece_rows = kPiece / f.row_groups;  // per row group, per piece
  return f;
}

// floats of one staging buffer: u rows (one spare row between row groups
// keeps the groups' reads on other banks) and the four per-row words
__host__ __device__ inline int fused_buffer_floats(const FusedGeom& f) {
  return (kPiece + f.row_groups) * f.stride + 4 * kPiece;
}

// The output columns of Gram entry (a, b), a <= b <= k: the column and its
// mirror (-1: none).
__device__ __forceinline__ void gram_cols(int a, int b, int k, int* col,
                                          int* mirror) {
  if (b < k) {
    *col = a * k + b;
    *mirror = a == b ? -1 : b * k + a;
  } else {
    *col = k * k + a;  // rhs * v[a], or the count at a = k
    *mirror = -1;
  }
}

// Grid (n_tiles).  Thread tid owns block `item = tid % items` (rows 4ga..,
// columns 4gb.. of u's Gram) for row group `rg = tid / items`.
template <bool kBf16>
__global__ void __launch_bounds__(kFusedThreads, 3)
accum_fused(const int* __restrict__ seg, const int* __restrict__ block_map,
            const int* __restrict__ oth, const float* __restrict__ wrv,
            const float* __restrict__ factors, int k, int width,
            float* __restrict__ out, float* __restrict__ carry,
            int* __restrict__ carry_seg) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const FusedGeom f = fused_geom(k);
  const int buf_floats = fused_buffer_floats(f);
  const int ncol = 16 * f.items;
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int blk = block_map[t];
  const int item = tid % f.items;
  const int rg = tid / f.items;
  int ga = 0, rem = item;
  while (rem >= f.g - ga) {
    rem -= f.g - ga;
    ++ga;
  }
  const int gb = ga + rem;
  // the products this thread forms: a <= b <= k, a < k (a = b = k is the
  // count, kept in its own sum); jk: the column of this block holding b = k
  unsigned mask = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = 4 * ga + i, b = 4 * gb + j;
      if (a <= b && b <= k && a < k) mask |= 1u << (4 * i + j);
    }
  }
  const int jk = k - 4 * gb;  // in 0..3 when this block's columns reach b = k
  const size_t row0 = static_cast<size_t>(t) * kTile;
  const int cp_bytes = k % 4 == 0 ? 16 : (k % 2 == 0 ? 8 : 4);
  const int cp_floats = cp_bytes / 4;
  const int n_pieces = f.group_rows / f.piece_rows;
  // the row groups' first runs [row_groups][ncol], past the staging buffers
  float* fcarry = smem + 2 * buf_floats;

  // u[k] = 1 and the zero columns past it never change: set them once in
  // both buffers (the gathers write columns 0..k-1 only)
  for (int e = tid; e < 2 * (kPiece + f.row_groups); e += f.threads) {
    float* row = smem + (e / (kPiece + f.row_groups)) * buf_floats +
                 (e % (kPiece + f.row_groups)) * f.stride;
    for (int d = k; d < f.stride; ++d) row[d] = d == k ? 1.f : 0.f;
  }

  // tile row of piece-local row pl of piece p (row group pl / piece_rows;
  // both counts are powers of two, so shifts and masks)
  const int lpr = __ffs(f.piece_rows) - 1;
  const int lgr = __ffs(f.group_rows) - 1;
  auto tile_row = [&](int p, int pl) {
    return ((pl >> lpr) << lgr) + p * f.piece_rows + (pl & (f.piece_rows - 1));
  };
  // the segment ids and opposite rows a thread gathers for (piece-local
  // rows tid + i * threads), loaded a piece ahead of their gathers
  int gseg[4], goth[4];
  auto fetch = [&](int p) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pl = tid + i * f.threads;
      if (pl < kPiece) {
        const size_t r = row0 + tile_row(p, pl);
        gseg[i] = seg[r];
        goth[i] = oth[r];
      }
    }
  };
  // copy piece p into buffer b: its four per-row words, and each real
  // row's factors (padding rows' factors are never read)
  auto stage = [&](int p, int b) {
    float* u = smem + b * buf_floats;
    int* sseg = reinterpret_cast<int*>(u + (kPiece + f.row_groups) * f.stride);
    for (int e = tid; e < kPiece; e += f.threads) {
      const int j = e >> 6;          // which word: seg, w, rhs, valid
      const int pl = (e & 63) << 2;  // piece-local row, 4 at a time
      const int r = tile_row(p, pl);
      const void* src =
          j == 0 ? static_cast<const void*>(seg + row0 + r)
                 : static_cast<const void*>(wrv + row0 * 3 + (j - 1) * kTile + r);
      cp_async(sseg + j * kPiece + pl, src, 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pl = tid + i * f.threads;
      if (pl < kPiece && gseg[i] >= 0) {
        const float* src = factors + static_cast<size_t>(goth[i]) * k;
        float* dst = u + (pl + (pl >> lpr)) * f.stride;
        for (int d = 0; d < k; d += cp_floats) cp_async(dst + d, src + d, cp_bytes);
      }
    }
    cp_async_commit();
  };

  float acc[16];
  float cacc = 0.f;  // the count, owned by the block with (k, k)
#pragma unroll
  for (int x = 0; x < 16; ++x) acc[x] = 0.f;
  int cur = -1;    // segment of the current run (-1: none, or padding)
  int start = 0;   // row of the row group where the current run began
  int fseg = -1;   // segment of the row group's first row

  // this thread's 16 sums (the count in its slot) to dst[16]
  auto store16 = [&](float* dst) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool count = 4 * ga + i == k && 4 * gb + j == k;
        dst[4 * i + j] = count ? cacc : acc[4 * i + j];
      }
    }
  };
  // a run that ended before the row group's end: the first run is kept for
  // the combine; any other is a whole segment, written out
  auto end_run = [&]() {
    if (cur < 0) return;
    if (start == 0) {
      store16(fcarry + rg * ncol + 16 * item);
      return;
    }
    float* o = out + static_cast<size_t>(blk * kSeg + cur) * width;
#pragma unroll 1
    for (int x = 0; x < 16; ++x) {
      const int a = 4 * ga + x / 4, b = 4 * gb + x % 4;
      if (a > b || b > k) continue;
      int col, mirror;
      gram_cols(a, b, k, &col, &mirror);
      float v = acc[0];
#pragma unroll
      for (int y = 1; y < 16; ++y) v = x == y ? acc[y] : v;
      v = a == k ? cacc : v;
      o[col] = v;
      if (mirror >= 0) o[mirror] = v;
    }
  };
  // one stream row's products into the sums
  auto form = [&](const float* ur, float w, float rhs, float val) {
    const float4 xa = *reinterpret_cast<const float4*>(ur + 4 * ga);
    const float4 yb = *reinterpret_cast<const float4*>(ur + 4 * gb);
    const float xs[4] = {xa.x, xa.y, xa.z, xa.w};
    const float ys[4] = {yb.x, yb.y, yb.z, yb.w};
    float z[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] = j == jk ? rhs : w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mask & (1u << (4 * i + j))) {
          const float x = __fmul_rn(__fmul_rn(xs[i], ys[j]), z[j]);
          acc[4 * i + j] = __fadd_rn(acc[4 * i + j], round_row(x, kBf16 ? 1 : 0));
        }
      }
    }
    cacc = __fadd_rn(cacc, round_row(val, kBf16 ? 1 : 0));
  };

  fetch(0);
  stage(0, 0);
  if (n_pieces > 1) fetch(1);
  for (int p = 0; p < n_pieces; ++p) {
    if (p + 1 < n_pieces) {
      stage(p + 1, (p + 1) & 1);
      if (p + 2 < n_pieces) fetch(p + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // piece p has landed for every thread
    const float* u = smem + (p & 1) * buf_floats;
    const int* sseg = reinterpret_cast<const int*>(u + (kPiece + f.row_groups) * f.stride);
    const float* sw = reinterpret_cast<const float*>(sseg) + kPiece;
    const float* urow = u + (rg * f.piece_rows + rg) * f.stride;
    for (int i4 = 0; i4 < f.piece_rows; i4 += 4) {
      const int pl = rg * f.piece_rows + i4;
      const int4 s4 = *reinterpret_cast<const int4*>(sseg + pl);
      if (cur >= 0 && s4.x == cur && s4.y == cur && s4.z == cur && s4.w == cur) {
        // four rows of the current run: no run ends (the common case)
        const float4 w4 = *reinterpret_cast<const float4*>(sw + pl);
        const float4 r4 = *reinterpret_cast<const float4*>(sw + kPiece + pl);
        const float4 v4 = *reinterpret_cast<const float4*>(sw + 2 * kPiece + pl);
        const float* ur = urow + i4 * f.stride;
        form(ur, w4.x, r4.x, v4.x);
        form(ur + f.stride, w4.y, r4.y, v4.y);
        form(ur + 2 * f.stride, w4.z, r4.z, v4.z);
        form(ur + 3 * f.stride, w4.w, r4.w, v4.w);
        continue;
      }
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        const int s = sseg[pl + q];  // the same for the whole row group
        if (s != cur) {
          end_run();
          cur = s;
          start = p * f.piece_rows + i4 + q;
          if (start == 0) fseg = s;
#pragma unroll
          for (int x = 0; x < 16; ++x) acc[x] = 0.f;
          cacc = 0.f;
        }
        if (s < 0) continue;
        form(urow + (i4 + q) * f.stride, sw[pl + q], sw[kPiece + pl + q],
             sw[2 * kPiece + pl + q]);
      }
    }
    __syncthreads();  // buffer p & 1 is consumed before piece p + 2 lands
  }

  // the row groups' last runs and segment ids, over the staging buffers
  float* lcarry = smem;  // [row_groups][ncol]
  int* rgseg = reinterpret_cast<int*>(smem + f.row_groups * ncol);  // [rg][2]
  store16((start == 0 ? fcarry : lcarry) + rg * ncol + 16 * item);
  if (item == 0) {
    rgseg[2 * rg] = fseg;
    rgseg[2 * rg + 1] = start != 0 ? cur : kAbsent;
  }
  __syncthreads();

  // combine the row groups' edge runs in row group order: a run holding the
  // tile's row 0 is carry slot 0, one reaching its last row carry slot 1,
  // any other a whole segment
  for (int c = tid; c < ncol; c += f.threads) {
    const int it = c / 16;
    int ca = 0, crem = it;
    while (crem >= f.g - ca) {
      crem -= f.g - ca;
      ++ca;
    }
    const int a = 4 * ca + (c % 16) / 4, b = 4 * (ca + crem) + c % 4;
    if (a > b || b > k) continue;
    int col, mirror;
    gram_cols(a, b, k, &col, &mirror);
    int run = kNoRun;
    bool has_start = false;
    float sum = 0.f;
    auto flush = [&](bool at_end) {
      if (run < 0) return;
      float* dst =
          has_start ? carry + (static_cast<size_t>(t) * 2) * width
          : at_end  ? carry + (static_cast<size_t>(t) * 2 + 1) * width
                    : out + static_cast<size_t>(blk * kSeg + run) * width;
      dst[col] = sum;
      if (mirror >= 0) dst[mirror] = sum;
    };
    for (int g = 0; g < f.row_groups; ++g) {
      for (int slot = 0; slot < 2; ++slot) {
        const int s = rgseg[2 * g + slot];
        if (slot == 1 && s == kAbsent) continue;
        if (s != run) {
          flush(false);
          run = s;
          sum = 0.f;
          has_start = g == 0 && slot == 0;
        }
        if (s >= 0) {
          sum = __fadd_rn(sum, (slot == 0 ? fcarry : lcarry)[g * ncol + c]);
        }
      }
    }
    flush(true);
  }
  // the zero columns of both carry slots, and the carried segments' ids
  for (int c = k * k + k + 1 + tid; c < width; c += f.threads) {
    carry[(static_cast<size_t>(t) * 2) * width + c] = 0.f;
    carry[(static_cast<size_t>(t) * 2 + 1) * width + c] = 0.f;
  }
  if (tid == 0) {
    const int first = rgseg[0];
    int last = first;
    bool one_run = true;
    for (int e = 1; e < 2 * f.row_groups; ++e) {
      const int s = rgseg[e];
      if ((e & 1) && s == kAbsent) continue;
      last = s;
      one_run = one_run && s == first;
    }
    carry_seg[2 * t] = first >= 0 ? blk * kSeg + first : -1;
    carry_seg[2 * t + 1] = (last >= 0 && !one_run) ? blk * kSeg + last : -1;
  }
}


int launch_reduce(const int* carry_seg, const float* carry, int n_tiles,
                  int width, float* out, cudaStream_t stream) {
  const dim3 grid2(2 * n_tiles, width / kSlab);
  reduce_carries<<<grid2, kSlab, 0, stream>>>(carry_seg, carry, 2 * n_tiles,
                                              width, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch_fused(const int* seg, const int* block_map, const int* oth,
                 const float* wrv, const float* factors, int n_tiles, int k,
                 int width, float* out, float* carry, int* carry_seg,
                 cudaStream_t stream) {
  const FusedGeom f = fused_geom(k);
  // the staging buffers (later the last runs and the segment ids), then
  // the first runs
  const int staged = 2 * fused_buffer_floats(f);
  const int ncol = 16 * f.items;
  const int last_runs = f.row_groups * ncol + 2 * f.row_groups;
  const size_t smem =
      sizeof(float) *
      ((staged > last_runs ? staged : last_runs) + f.row_groups * ncol);
  cudaError_t err = cudaFuncSetAttribute(
      accum_fused<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  accum_fused<kBf16><<<n_tiles, f.threads, smem, stream>>>(
      seg, block_map, oth, wrv, factors, k, width, out, carry, carry_seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_reduce(carry_seg, carry, n_tiles, width, out, stream);
}

int launch_chunk(const int* seg, const int* block_map, const float* rows,
                 int n_tiles, int width, int bf16, float* out, float* carry,
                 int* carry_seg, cudaStream_t s) {
  const int n_units = n_tiles * (width / kSlab);
  if (bf16) {
    accum_prefetch<true><<<n_units, 32, 0, s>>>(seg, block_map, rows, width, out,
                                                carry, carry_seg);
  } else {
    accum_prefetch<false><<<n_units, 32, 0, s>>>(seg, block_map, rows, width, out,
                                                 carry, carry_seg);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_reduce(carry_seg, carry, n_tiles, width, out, s);
}

}  // namespace

// Both entry points launch pass 1 and pass 2 on `stream` and return the first
// cudaGetLastError() that is not cudaSuccess, else 0.  The caller allocates
// every buffer, checks types and shapes, and zeroes `out` [n_seg, width] before
// the first launch that adds into it; carry [n_tiles, 2, width] f32 and
// carry_seg [n_tiles, 2] i32 are scratch.  Indices must be in range: seg in
// [-1, 128), block_map[t] * 128 + 127 < n_seg, oth below the factor rows.

// The fused kernel: seg/oth [n_tiles, 1024] i32, wrv [n_tiles, 3, 1024] f32
// (w, rhs, valid), factors [*, k] f32, width = row_width(k).  It writes every
// segment of the blocks its tiles map to (out must be zero there).
extern "C" int pio_als_fused_accum(const int* seg, const int* block_map,
                                   const int* oth, const float* wrv,
                                   const float* factors, int n_tiles, int k,
                                   int width, int bf16, float* out,
                                   float* carry, int* carry_seg,
                                   void* stream) {
  if (n_tiles <= 0) return n_tiles == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (k < 1 || k > kMaxRank || k * k + k + 1 > width || width % kSlab != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_fused<true>(seg, block_map, oth, wrv, factors, n_tiles,
                                   k, width, out, carry, carry_seg, s)
              : launch_fused<false>(seg, block_map, oth, wrv, factors, n_tiles,
                                    k, width, out, carry, carry_seg, s);
}

// The chunk kernel: seg [n_tiles, 1024] i32, rows [n_tiles * 1024, width]
// f32 and out, all 16-byte aligned (the kernel moves 16 bytes at a time);
// adds each segment's sum into out.
extern "C" int pio_als_segment_accum(const int* seg, const int* block_map,
                                     const float* rows, int n_tiles,
                                     int width, int bf16, float* out,
                                     float* carry, int* carry_seg,
                                     void* stream) {
  if (n_tiles < 0 || width <= 0 || width % kSlab != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  return launch_chunk(seg, block_map, rows, n_tiles, width, bf16, out, carry,
                      carry_seg, static_cast<cudaStream_t>(stream));
}
