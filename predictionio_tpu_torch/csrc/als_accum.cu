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
// What bounds it on this card: each stream row is read once (its segment id,
// opposite index and three weights, 20 bytes, or the built row) and each output
// row written once; the arithmetic is ~3k^2 fp32 operations per row, below the
// H100's operations-per-byte balance at every rank <= 32.  So it is bound by
// bytes; the opposite factor table (at most a few MB) stays in the 50 MB L2.
//
// What the design does about that (simple and deterministic, no float atomics):
//  * Pass 1: one CTA per (tile, 128-column slab), one thread per column.  The
//    CTA stages 256 rows at a time in shared memory (segment ids, weights and,
//    for the fused kernel, the gathered factor rows) and every thread walks the
//    rows in order with a running sum in a register.  A run that starts and
//    ends inside the tile is a whole segment: it is added to the output
//    directly.  The tile's first run (it may continue from the tile before)
//    and its run at the last row (it may continue into the next tile) go to a
//    carry buffer [n_tiles, 2, width] instead, their global segment ids to
//    carry_seg [n_tiles, 2] (-1: no such run).
//  * Pass 2: one CTA per (carry entry, slab).  The first entry of each carried
//    segment sums that segment's entries in tile order and adds the sum to the
//    output.  A hot segment spread over many tiles is summed by many pass-1
//    CTAs in parallel and only its carries are summed in turn.
//  * Every segment has one writer per launch and every sum has a fixed order,
//    so two runs give the same bits.  Each row value is formed with
//    __fmul_rn/__fadd_rn (never contracted into an FMA), as the plain version
//    forms it: (v[a]*v[b])*w, v[a]*rhs, valid; in "bf16" it is rounded to
//    bf16 (round to nearest even) before it is added.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (predictionio_tpu_torch/ops/_kernels.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 1024;  // rows per tile: T in ops/als_accum.py
constexpr int kSeg = 128;    // segments per block: S in ops/als_accum.py
constexpr int kSlab = 128;   // columns per CTA, one thread each
constexpr int kPiece = 256;  // rows staged in shared memory at a time
constexpr int kMaxRank = 32;

__device__ __forceinline__ float round_row(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Pass 1.  kBuild: the fused kernel (rows made from oth, wrv and factors);
// else rows are read from `rows` [n_tiles * 1024, width].
template <bool kBuild>
__global__ void __launch_bounds__(kSlab)
accum_tiles(const int* __restrict__ seg, const int* __restrict__ block_map,
            const int* __restrict__ oth, const float* __restrict__ wrv,
            const float* __restrict__ factors, const float* __restrict__ rows,
            int k, int width, int bf16, float* __restrict__ out,
            float* __restrict__ carry, int* __restrict__ carry_seg) {
  extern __shared__ float smem[];
  int* sseg = reinterpret_cast<int*>(smem);  // [kPiece]
  float* sw = smem + kPiece;                 // [kPiece] w
  float* srhs = sw + kPiece;                 // [kPiece] rhs
  float* sval = srhs + kPiece;               // [kPiece] valid
  float* sv = sval + kPiece;                 // [kPiece][k] gathered factors

  const int t = blockIdx.x;
  const int c = blockIdx.y * kSlab + threadIdx.x;
  const size_t row0 = static_cast<size_t>(t) * kTile;
  const int blk = block_map[t];

  // what column c takes from a built row
  const int kk = k * k;
  const int kind = c < kk ? 0 : (c < kk + k ? 1 : (c == kk + k ? 2 : 3));
  const int a = kind == 0 ? c / k : (kind == 1 ? c - kk : 0);
  const int b = kind == 0 ? c - (c / k) * k : 0;

  int cur = -1;    // segment of the current run (-1: none, or padding)
  int start = 0;   // row of the tile where the current run began
  int first = -1;  // segment of row 0
  float acc = 0.f;

  // a finished run: carried if it began at row 0 or reaches the tile's end,
  // else a whole segment, added to the output
  auto finish = [&](bool at_end) {
    if (cur < 0) return;
    if (start == 0) {
      carry[(static_cast<size_t>(t) * 2) * width + c] = acc;
    } else if (at_end) {
      carry[(static_cast<size_t>(t) * 2 + 1) * width + c] = acc;
    } else {
      float* o = out + static_cast<size_t>(blk * kSeg + cur) * width + c;
      *o = __fadd_rn(*o, acc);
    }
  };

  for (int base = 0; base < kTile; base += kPiece) {
    __syncthreads();  // the previous piece is consumed
    for (int i = threadIdx.x; i < kPiece; i += kSlab) {
      sseg[i] = seg[row0 + base + i];
      if (kBuild) {
        const size_t wo = static_cast<size_t>(t) * 3 * kTile + base + i;
        sw[i] = wrv[wo];
        srhs[i] = wrv[wo + kTile];
        sval[i] = wrv[wo + 2 * kTile];
      }
    }
    if (kBuild) {
      __syncthreads();  // sseg is written
      for (int i = threadIdx.x; i < kPiece * k; i += kSlab) {
        const int r = i / k;
        sv[i] = sseg[r] >= 0
                    ? factors[static_cast<size_t>(oth[row0 + base + r]) * k +
                              (i - r * k)]
                    : 0.f;
      }
    }
    __syncthreads();
    if (base == 0) first = sseg[0];
    for (int r = 0; r < kPiece; ++r) {
      const int s = sseg[r];  // the same for every thread: no divergence
      if (s != cur) {
        finish(false);
        cur = s;
        start = base + r;
        acc = 0.f;
      }
      if (s < 0) continue;
      float x;
      if (kBuild) {
        const float* v = sv + r * k;
        if (kind == 0) {
          x = __fmul_rn(__fmul_rn(v[a], v[b]), sw[r]);
        } else if (kind == 1) {
          x = __fmul_rn(v[a], srhs[r]);
        } else {
          x = kind == 2 ? sval[r] : 0.f;
        }
      } else {
        x = rows[(row0 + base + r) * width + c];
      }
      acc = __fadd_rn(acc, round_row(x, bf16));
    }
  }
  finish(true);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    carry_seg[2 * t] = first >= 0 ? blk * kSeg + first : -1;
    carry_seg[2 * t + 1] = (cur >= 0 && start != 0) ? blk * kSeg + cur : -1;
  }
}

// Pass 2: entry e = 2*tile + slot of carry_seg / carry.  The entries of one
// segment follow each other in tile order, with an empty slot 1 between two
// where a tile holds that segment alone.
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

template <bool kBuild>
int launch(const int* seg, const int* block_map, const int* oth,
           const float* wrv, const float* factors, const float* rows,
           int n_tiles, int k, int width, int bf16, float* out, float* carry,
           int* carry_seg, cudaStream_t stream) {
  if (n_tiles <= 0 || width <= 0 || width % kSlab != 0) {
    return n_tiles == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  }
  if (kBuild && (k < 1 || k > kMaxRank || k * k + k + 1 > width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid1(n_tiles, width / kSlab);
  const size_t smem =
      (4 * kPiece + (kBuild ? kPiece * k : 0)) * sizeof(float);
  accum_tiles<kBuild><<<grid1, kSlab, smem, stream>>>(
      seg, block_map, oth, wrv, factors, rows, k, width, bf16, out, carry,
      carry_seg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2(2 * n_tiles, width / kSlab);
  reduce_carries<<<grid2, kSlab, 0, stream>>>(carry_seg, carry, 2 * n_tiles,
                                              width, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points launch pass 1 and pass 2 on `stream` and return the first
// cudaGetLastError() that is not cudaSuccess, else 0.  The caller allocates
// every buffer, checks types and shapes, and zeroes `out` [n_seg, width] before
// the first launch that adds into it; carry [n_tiles, 2, width] f32 and
// carry_seg [n_tiles, 2] i32 are scratch.  Indices must be in range: seg in
// [-1, 128), block_map[t] * 128 + 127 < n_seg, oth below the factor rows.

// The fused kernel: seg/oth [n_tiles, 1024] i32, wrv [n_tiles, 3, 1024] f32
// (w, rhs, valid), factors [*, k] f32, width = row_width(k).
extern "C" int pio_als_fused_accum(const int* seg, const int* block_map,
                                   const int* oth, const float* wrv,
                                   const float* factors, int n_tiles, int k,
                                   int width, int bf16, float* out,
                                   float* carry, int* carry_seg,
                                   void* stream) {
  return launch<true>(seg, block_map, oth, wrv, factors, nullptr, n_tiles, k,
                      width, bf16, out, carry, carry_seg,
                      static_cast<cudaStream_t>(stream));
}

// The chunk kernel: seg [n_tiles, 1024] i32, rows [n_tiles * 1024, width] f32;
// adds each segment's sum into out.
extern "C" int pio_als_segment_accum(const int* seg, const int* block_map,
                                     const float* rows, int n_tiles,
                                     int width, int bf16, float* out,
                                     float* carry, int* carry_seg,
                                     void* stream) {
  return launch<false>(seg, block_map, nullptr, nullptr, nullptr, rows,
                       n_tiles, 0, width, bf16, out, carry, carry_seg,
                       static_cast<cudaStream_t>(stream));
}
