// Fused score + top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel predictionio_tpu/ops/topk.py::_make_fused_topk_kernel
// (built by _fused_topk_call, called through fused_topk_batch): for each query
// row q_b of q [B, r] and each table row t_j of t [N, r], score s_bj = q_b . t_j,
// with rows j >= limit scored -inf but keeping their real ids, and keep the k
// best per query ordered by (value desc, id asc) -- lax.top_k's tie rule.  The
// [B, N] score matrix never exists in device memory.  Output: packed [2, B, k]
// f32, row 0 the scores, row 1 the ids (exact below 2^24).
//
// What bounds it on this card: at the serving shape (B=4096, N=26,744, r=10,
// k=10) the inputs are ~1.2 MB and the output 0.33 MB, ~0.5 us of HBM time at
// 3.35 TB/s, while the work is 2.2 GFLOP of fp32 FMA (~33 us at 67 TFLOP/s)
// plus 110 M scored candidates to select from.  So it is bound by CUDA-core
// FMA and selection work, not memory; r=10 is far too thin for tensor cores.
//
// What the design does about that:
//  * The TPU grid sweeps all of N per batch block on one core.  Here N is cut
//    into slabs, one CTA per (8-query block, slab) pair, so even a 512-query
//    wave puts several CTAs on each of the 132 SMs (pass 1).  Each CTA stages
//    one tile of table rows in shared memory (row stride r|1 is odd, so the 32
//    lanes reading 32 rows hit 32 banks) and every warp scores its own query
//    against it with fp32 FMAs in a fixed order, so duplicate rows score
//    bit-identically.
//  * Selection keeps the running k-best of a query in the registers of its
//    warp (position p lives in lane p%32, slot p/32), sorted under the
//    two-key order.  A candidate is tested against the current k-th entry
//    (one compare); only those that beat it are inserted, by a warp-wide
//    rank count (ballot + popc) and a one-position shift (shuffles).  After
//    the first tiles almost every candidate is rejected by the one compare.
//  * Pass 2 merges the n_splits * k candidates of each query with the same
//    warp routine and writes the packed output.  Slabs are disjoint, so the
//    merge sees every id at most once and the result is exactly the top-k
//    of the full row, ties included.
//  * Empty slots hold the sentinel (-inf, RETIRED_ID = 2^25), which loses the
//    id tie-break to every real row, masked rows included; callers guarantee
//    k <= N, so it never reaches the output.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (predictionio_tpu_torch/ops/_kernels.py).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Must match RETIRED_ID in predictionio_tpu_torch/ops/topk.py.
constexpr int kRetiredId = 1 << 25;
// Queries per pass-1 CTA, one warp each.  Must match QUERIES_PER_CTA in
// predictionio_tpu_torch/ops/topk.py, which sizes the grid and shared memory.
constexpr int kQueriesPerCta = 8;
// Queries per pass-2 CTA, one warp each.
constexpr int kMergeWarps = 4;

__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// The running k-best of one query, held by one warp.  KW = ceil(k / 32)
// register slots per lane; position p = m * 32 + lane.
template <int KW>
struct WarpTopK {
  float v[KW];
  int id[KW];
  float kth_v;  // the entry at position k-1 (warp-uniform)
  int kth_i;
  int k;

  __device__ __forceinline__ void init(int k_) {
    k = k_;
#pragma unroll
    for (int m = 0; m < KW; ++m) {
      v[m] = -CUDART_INF_F;
      id[m] = kRetiredId;
    }
    kth_v = -CUDART_INF_F;
    kth_i = kRetiredId;
  }

  // Insert (cv, ci) (warp-uniform) at its rank; the entry at k-1 falls off.
  __device__ __forceinline__ void insert(float cv, int ci, int lane) {
    int pos = 0;
#pragma unroll
    for (int m = 0; m < KW; ++m) {
      const int p = m * 32 + lane;
      pos += __popc(__ballot_sync(kFull, p < k && beats(v[m], id[m], cv, ci)));
    }
    if (pos >= k) return;
    // shift positions > pos up by one, high slots first so each slot still
    // reads its lower neighbour's old value
#pragma unroll
    for (int m = KW - 1; m >= 0; --m) {
      float up_v = __shfl_up_sync(kFull, v[m], 1);
      int up_i = __shfl_up_sync(kFull, id[m], 1);
      if (m > 0) {
        const float carry_v = __shfl_sync(kFull, v[m > 0 ? m - 1 : 0], 31);
        const int carry_i = __shfl_sync(kFull, id[m > 0 ? m - 1 : 0], 31);
        if (lane == 0) {
          up_v = carry_v;
          up_i = carry_i;
        }
      }
      const int p = m * 32 + lane;
      if (p > pos) {
        v[m] = up_v;
        id[m] = up_i;
      } else if (p == pos) {
        v[m] = cv;
        id[m] = ci;
      }
    }
    const int mk = (k - 1) >> 5;
    float tv = v[0];
    int ti = id[0];
#pragma unroll
    for (int m = 1; m < KW; ++m) {
      if (m == mk) {
        tv = v[m];
        ti = id[m];
      }
    }
    kth_v = __shfl_sync(kFull, tv, (k - 1) & 31);
    kth_i = __shfl_sync(kFull, ti, (k - 1) & 31);
  }

  // Every lane offers one candidate; those that beat the k-th entry are
  // inserted one at a time, lowest lane first.
  __device__ __forceinline__ void offer(float cv, int ci, bool valid, int lane) {
    unsigned pending =
        __ballot_sync(kFull, valid && beats(cv, ci, kth_v, kth_i));
    while (pending) {
      const int src = __ffs(pending) - 1;
      pending &= pending - 1;
      const float bv = __shfl_sync(kFull, cv, src);
      const int bi = __shfl_sync(kFull, ci, src);
      if (beats(bv, bi, kth_v, kth_i)) insert(bv, bi, lane);
    }
  }
};

// Pass 1: grid (ceil(B / kQueriesPerCta), n_splits).  CTA (x, y) scores
// queries [x*8, x*8+8) against table rows [y*rows_per_split, ...) one tile of
// tile_rows at a time and writes each query's slab k-best to
// cand_{v,i}[query, y, :].
template <int KW>
__global__ void __launch_bounds__(kQueriesPerCta * 32)
fused_topk_partial(const float* __restrict__ q, const float* __restrict__ t,
                   int B, int N, int r, int k, int limit, int tile_rows,
                   int rows_per_split, int n_splits,
                   float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ float smem[];
  const int rs = r | 1;  // odd row stride: conflict-free column reads
  float* qs = smem;                       // [kQueriesPerCta][r]
  float* ts = smem + kQueriesPerCta * r;  // [tile_rows][rs]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kQueriesPerCta;
  const int qrow = q0 + warp;
  const int split = blockIdx.y;

  for (int i = threadIdx.x; i < kQueriesPerCta * r; i += blockDim.x) {
    qs[i] = q0 + i / r < B ? q[(size_t)q0 * r + i] : 0.f;
  }
  WarpTopK<KW> best;
  best.init(k);
  const float* qv = qs + warp * r;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  for (int base = row_begin; base < row_end; base += tile_rows) {
    const int rows = min(tile_rows, row_end - base);
    __syncthreads();  // the previous tile is consumed (and qs is written)
    const float* src = t + (size_t)base * r;
    for (int i = threadIdx.x; i < rows * r; i += blockDim.x) {
      const int rr = i / r;
      ts[rr * rs + (i - rr * r)] = src[i];
    }
    __syncthreads();
    if (qrow < B) {
      for (int j0 = 0; j0 < rows; j0 += 32) {
        const int rr = j0 + lane;
        const bool valid = rr < rows;
        const int gid = base + rr;
        float s = -CUDART_INF_F;
        if (valid && gid < limit) {
          const float* tr = ts + rr * rs;
          float acc = 0.f;  // a +0 start: an all-(-0) product sum stays +0
          for (int d = 0; d < r; ++d) acc = fmaf(qv[d], tr[d], acc);
          s = acc;
        }
        best.offer(s, gid, valid, lane);
      }
    }
  }
  if (qrow < B) {
    const size_t off = ((size_t)qrow * n_splits + split) * k;
#pragma unroll
    for (int m = 0; m < KW; ++m) {
      const int p = m * 32 + lane;
      if (p < k) {
        cand_v[off + p] = best.v[m];
        cand_i[off + p] = best.id[m];
      }
    }
  }
}

// Pass 2: one warp per query merges its n_cand = n_splits * k candidates and
// writes packed out[0, b, :] (scores) and out[1, b, :] (ids as f32).
template <int KW>
__global__ void __launch_bounds__(kMergeWarps * 32)
fused_topk_merge(const float* __restrict__ cand_v,
                 const int* __restrict__ cand_i, int B, int n_cand, int k,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int qrow = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (qrow >= B) return;  // whole warp
  WarpTopK<KW> best;
  best.init(k);
  const float* cv = cand_v + (size_t)qrow * n_cand;
  const int* ci = cand_i + (size_t)qrow * n_cand;
  for (int j0 = 0; j0 < n_cand; j0 += 32) {
    const int j = j0 + lane;
    const bool valid = j < n_cand;
    best.offer(valid ? cv[j] : -CUDART_INF_F, valid ? ci[j] : kRetiredId,
               valid, lane);
  }
  float* out_v = out + (size_t)qrow * k;
  float* out_i = out + (size_t)B * k + (size_t)qrow * k;
#pragma unroll
  for (int m = 0; m < KW; ++m) {
    const int p = m * 32 + lane;
    if (p < k) {
      out_v[p] = best.v[m];
      out_i[p] = (float)best.id[m];
    }
  }
}

template <int KW>
cudaError_t launch(const float* q, const float* t, int B, int N, int r, int k,
                   int limit, int tile_rows, int rows_per_split, int n_splits,
                   float* cand_v, int* cand_i, float* out,
                   cudaStream_t stream) {
  const dim3 grid1((B + kQueriesPerCta - 1) / kQueriesPerCta, n_splits);
  const size_t smem =
      (size_t)(kQueriesPerCta * r + tile_rows * (r | 1)) * sizeof(float);
  fused_topk_partial<KW><<<grid1, kQueriesPerCta * 32, smem, stream>>>(
      q, t, B, N, r, k, limit, tile_rows, rows_per_split, n_splits, cand_v,
      cand_i);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((B + kMergeWarps - 1) / kMergeWarps);
  fused_topk_merge<KW><<<grid2, kMergeWarps * 32, 0, stream>>>(
      cand_v, cand_i, B, n_splits * k, k, out);
  return cudaGetLastError();
}

}  // namespace

// Launch both passes on `stream`; returns the first cudaGetLastError() that is
// not cudaSuccess, else 0.
// Scratch cand_v [B, n_splits, k] f32 and cand_i [B, n_splits, k] i32 and the
// output out [2, B, k] f32 are allocated by the caller; the caller also checks
// shapes, 1 <= k <= 128, and that the shared memory fits in 48 KB.
extern "C" int pio_fused_topk(const float* q, const float* t, int B, int N,
                              int r, int k, int limit, int tile_rows,
                              int rows_per_split, int n_splits, float* cand_v,
                              int* cand_i, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1:
      return launch<1>(q, t, B, N, r, k, limit, tile_rows, rows_per_split,
                       n_splits, cand_v, cand_i, out, s);
    case 2:
      return launch<2>(q, t, B, N, r, k, limit, tile_rows, rows_per_split,
                       n_splits, cand_v, cand_i, out, s);
    case 3:
      return launch<3>(q, t, B, N, r, k, limit, tile_rows, rows_per_split,
                       n_splits, cand_v, cand_i, out, s);
    case 4:
      return launch<4>(q, t, B, N, r, k, limit, tile_rows, rows_per_split,
                       n_splits, cand_v, cand_i, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
