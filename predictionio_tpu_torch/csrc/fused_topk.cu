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
// FMA and selection work, not memory.  Tensor cores are not used: r <= 32 is a
// thin contraction, and each score must be one fixed-order fmaf chain from a
// +0 start so that duplicate rows score the same bits and exact inputs stay
// bitwise equal to the plain version.
//
// What the design does about that:
//  * Register-blocked scoring.  A CTA of 128 threads takes a block of 32
//    queries (8 for a small wave, so that it still fills the card with few
//    slabs, or for a k past 64, so that the merges spread over more CTAs)
//    against a tile of 64 table rows.  Queries and tile are staged in
//    shared memory as rows, the rank padded with zeros to a multiple of 4
//    (zero terms at the end of the chain keep every score's bits), each row
//    an odd number of 16-byte words long so that 8 neighbouring rows' loads
//    hit 8 bank groups.  Each thread holds a 4-query (or 1-query) x 4-row
//    micro-tile of sums in registers: per 4 steps of d, four 16-byte loads
//    of its queries and four of its rows feed 64 FMAs (0.125 load
//    instructions, 0.5 loaded floats per FMA), and every staged row is read
//    by all the block's queries.
//  * Double-buffered staging with cp.async: the next tile is in flight
//    while this one is scored.  A rank past 64 is staged and scored in
//    chunks of 64 columns, the sums carried in registers between chunks, so
//    any rank whose query block fits in shared memory is taken.
//  * Threshold-filtered selection (the shape of WarpSelect/BlockSelect in
//    Johnson, Douze and Jegou, "Billion-scale similarity search with GPUs",
//    2017).  Each query keeps its k-best sorted in shared memory and its
//    current k-th entry as a threshold; a score that beats it is appended to
//    the query's queue in shared memory (a shared-memory integer atomic gives
//    its slot).  Once a queue holds 32 entries (k of them, up to 64, for a
//    larger k), or at the end, one warp merges it into the k-best: it sorts
//    the queue in registers with a bitonic network of shuffles, then each
//    queued entry's place is its rank plus a binary search in the k-best,
//    and each k-best entry's place a binary search in the sorted queue,
//    scattered in place.  Keys (value, id) are distinct (each row is scored
//    once per query), so the result is the top-k under a total order: the
//    order in which survivors reach the queue does not change it, and a
//    repeat gives the same bits.
//  * N is cut into slabs, one CTA per (query block, slab), so that small
//    waves still fill the card (pass 1); with more than one slab, pass 2
//    sorts each query's slab lists at once where they fit a warp's
//    registers (n_slabs * k <= 128), else merges into its k-best the prefix
//    of each slab list that beats its running k-th entry, with the same
//    warp merge.
//  * A k-best holds only real rows; an empty position is written as the
//    sentinel (-inf, RETIRED_ID = 2^25), which pass 2 drops.  Callers
//    guarantee k <= N, so the sentinel never reaches the output.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (predictionio_tpu_torch/ops/_kernels.py).

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Must match RETIRED_ID in predictionio_tpu_torch/ops/topk.py.
constexpr int kRetiredId = 1 << 25;
// Table rows per staged tile; must match TILE_ROWS_CUDA in ops/topk.py
// (pio_fused_topk refuses a slab that is not whole tiles).
constexpr int kTileRows = 64;
// Rank columns of a tile staged at once.
constexpr int kChunk = 64;
// Queue slots per query.
constexpr int kQueueCap = 128;
// Threads per pass-1 CTA (4 warps): 8 query groups x 16 row groups.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Largest k (MAX_FUSED_K in ops/topk.py): a warp holds at most kMaxK / 32
// entries per lane.
constexpr int kMaxK = 128;
constexpr int kPerLane = kMaxK / 32;
static_assert(kQueueCap <= kMaxK, "a lane holds at most kPerLane queued entries");
// Queries per pass-2 CTA, one warp each.
constexpr int kMergeWarps = 4;

__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Sort the 32 * U entries (v[u], id[u]) of a warp, entry e = 32u + lane,
// under the two-key order, winners first (a bitonic network: compare and
// exchange with shuffles across lanes, in registers across slots).  Equal
// keys (the padding sentinels) are never exchanged.
template <int U>
__device__ __forceinline__ void warp_sort(float* v, int* id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * U; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int du = stride >> 5;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u & du) continue;  // u is the lower entry of the pair
          const int w = u | du;
          // in a block sorted winners first the lower entry takes the winner
          const bool first = ((32 * u + lane) & size) == 0;
          if (first ? beats(v[w], id[w], v[u], id[u])
                    : beats(v[u], id[u], v[w], id[w])) {
            const float tv = v[u];
            const int ti = id[u];
            v[u] = v[w];
            id[u] = id[w];
            v[w] = tv;
            id[w] = ti;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float ov = __shfl_xor_sync(kFull, v[u], stride);
          const int oi = __shfl_xor_sync(kFull, id[u], stride);
          const bool lower = (lane & stride) == 0;
          const bool first = ((32 * u + lane) & size) == 0;
          if (lower == first ? beats(ov, oi, v[u], id[u])
                             : beats(v[u], id[u], ov, oi)) {
            v[u] = ov;
            id[u] = oi;
          }
        }
      }
    }
  }
}

// Merge m unordered entries (qv, qi) into the sorted k-best (lv, li) of cnt
// entries, in place, by one warp; sv/si are m slots of scratch.  Returns the
// new count, min(k, cnt + m).  Keys must be distinct.
__device__ int warp_merge(float* lv, int* li, int cnt, const float* qv,
                          const int* qi, int m, float* sv, int* si, int k,
                          int lane) {
  float ev[kPerLane];
  int ei[kPerLane], epos[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int i = lane + 32 * u;
    ev[u] = i < m ? qv[i] : -CUDART_INF_F;  // the padding loses to all
    ei[u] = i < m ? qi[i] : INT_MAX;
  }
  // the queue sorted: entry e = 32u + lane is the e-th best
  if (m <= 32) {
    warp_sort<1>(ev, ei, lane);
  } else if (m <= 64) {
    warp_sort<2>(ev, ei, lane);
  } else {
    warp_sort<kPerLane>(ev, ei, lane);
  }
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int e = lane + 32 * u;
    epos[u] = INT_MAX;
    if (e < m) {
      int lo = 0, hi = cnt;  // k-best entries that beat it
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (beats(lv[mid], li[mid], ev[u], ei[u])) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      sv[e] = ev[u];
      si[e] = ei[u];
      epos[u] = e + lo;
    }
  }
  __syncwarp();
  float fv[kPerLane];
  int fi[kPerLane], fpos[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    const int p = lane + 32 * u;
    fpos[u] = INT_MAX;
    if (p < cnt) {
      fv[u] = lv[p];
      fi[u] = li[p];
      int lo = 0, hi = m;  // queued entries that beat it
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (beats(sv[mid], si[mid], fv[u], fi[u])) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      fpos[u] = p + lo;
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) {
    if (epos[u] < k) {
      lv[epos[u]] = ev[u];
      li[epos[u]] = ei[u];
    }
    if (fpos[u] < k) {
      lv[fpos[u]] = fv[u];
      li[fpos[u]] = fi[u];
    }
  }
  __syncwarp();
  return min(k, cnt + m);
}

// Write a k-best of cnt entries as k (value, id) pairs, sentinels past cnt;
// ids as f32 into a packed output, or as int32.
__device__ __forceinline__ void write_best(const float* lv, const int* li,
                                           int cnt, int k, int lane,
                                           float* out_v, float* out_if,
                                           int* out_i) {
  for (int p = lane; p < k; p += 32) {
    const bool have = p < cnt;
    out_v[p] = have ? lv[p] : -CUDART_INF_F;
    const int id = have ? li[p] : kRetiredId;
    if (out_if != nullptr) {
      out_if[p] = static_cast<float>(id);
    } else {
      out_i[p] = id;
    }
  }
}

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

// Shared-memory row strides (floats) for padded rank rp: of the query block
// (the whole rank) and of a table tile (one chunk of at most kChunk columns).
// A stride of an odd number of 16-byte words puts the 16-byte loads of 8
// neighbouring rows on 8 different bank groups.
__host__ __device__ inline int query_stride(int rp) {
  return (rp / 4) % 2 == 1 ? rp : rp + 4;
}

__host__ __device__ inline int tile_stride(int rp) {
  return rp <= kChunk ? query_stride(rp) : query_stride(kChunk);
}

// Pass 1: grid (ceil(B / Q), n_splits) for a block of Q = 8 * QI queries
// (QI = 4 or 1).  CTA (x, y) scores queries [Qx, Qx + Q) against table rows
// [y * rows_per_split, ...) one 64-row tile at a time, each tile in chunks
// of kChunk rank columns (one chunk up to rank 64); every (tile, chunk) is
// copied in with cp.async while the one before it is scored.  With one
// split it writes the packed output; else each query's slab k-best to
// cand_{v,i}[query, y, :].
// (At least 6 CTAs of 8 queries per SM: ptxas then keeps that instantiation
// at 80 registers without spills, where left alone it spilled.)
template <int QI>
__global__ void __launch_bounds__(kThreads, QI == 1 ? 6 : 4)
fused_topk_partial(const float* __restrict__ q, const float* __restrict__ t,
                   int B, int N, int r, int k, int limit, int rows_per_split,
                   int n_splits, float* __restrict__ cand_v,
                   int* __restrict__ cand_i, float* __restrict__ out) {
  // the block's queries: a warp's lanes stand for them in the merge step
  constexpr int kQ = 8 * QI;
  static_assert(kQ <= 32, "one lane per query of the block");
  extern __shared__ float4 smem4[];
  const int rp = (r + 3) / 4 * 4;
  const int rsq = query_stride(rp);
  const int rst = tile_stride(rp);
  float* qs = reinterpret_cast<float*>(smem4);  // [kQ][rsq]
  float* ts = qs + kQ * rsq;                    // [2][64][rst]
  float* lv = ts + 2 * kTileRows * rst;         // [kQ][k] k-best values
  int* li = reinterpret_cast<int*>(lv + kQ * k);                 // ids
  float* quv = reinterpret_cast<float*>(li + kQ * k);            // [kQ][cap]
  int* qui = reinterpret_cast<int*>(quv + kQ * kQueueCap);
  float* sv = reinterpret_cast<float*>(qui + kQ * kQueueCap);
  int* si = reinterpret_cast<int*>(sv + kWarps * kQueueCap);    // [4][cap]
  int* qcnt = si + kWarps * kQueueCap;                            // [kQ]
  int* lcnt = qcnt + kQ;                                          // [kQ]
  float* thv = reinterpret_cast<float*>(lcnt + kQ);               // [kQ]
  int* thi = reinterpret_cast<int*>(thv + kQ);                    // [kQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kQ;
  const int split = blockIdx.y;
  const int qg = tid >> 4;  // queries qg + 8i (i < QI) of the block
  const int rg = tid & 15;  // rows rg + 16j (j < 4) of the tile
  // copy unit: 16 bytes where the rows allow it
  const int cf = r % 4 == 0 ? 4 : (r % 2 == 0 ? 2 : 1);
  const int n_chunks = (rp + kChunk - 1) / kChunk;
  const int row_begin = split * rows_per_split;
  const int row_end = min(N, row_begin + rows_per_split);
  const int n_units = (row_end - row_begin + kTileRows - 1) / kTileRows * n_chunks;

  for (int e = tid; e < kQ * rsq; e += kThreads) qs[e] = 0.f;
  if (tid < kQ) {
    qcnt[tid] = 0;
    lcnt[tid] = 0;
    thv[tid] = -CUDART_INF_F;  // beaten by every row, masked ones included
    thi[tid] = INT_MAX;
  }
  __syncthreads();  // the zeros land before the copies
  {
    const int qq = tid % kQ;
    if (q0 + qq < B) {
      const float* src = q + static_cast<size_t>(q0 + qq) * r;
      for (int c = (tid / kQ) * cf; c < r; c += (kThreads / kQ) * cf) {
        cp_async(qs + qq * rsq + c, src + c, 4 * cf);
      }
    }
  }
  // copy the next unit (tile next_tile, chunk next_chunk) into buffer buf;
  // the chunk's zero columns past r are written here too (counters, not
  // divisions, walk the units)
  int next_tile = 0, next_chunk = 0;
  auto stage = [&](int buf) {
    const int base = row_begin + next_tile * kTileRows;
    const int c0 = next_chunk * kChunk;
    const int rows = min(kTileRows, row_end - base);
    const int width = min(kChunk, r - c0);
    const int padded = min(kChunk, rp - c0);
    float* tb = ts + buf * kTileRows * rst;
    const int j = tid % kTileRows;
    if (j < rows) {
      const float* src = t + static_cast<size_t>(base + j) * r + c0;
      float* dst = tb + j * rst;
      for (int c = (tid / kTileRows) * cf; c < width;
           c += (kThreads / kTileRows) * cf) {
        cp_async(dst + c, src + c, 4 * cf);
      }
      for (int c = width + tid / kTileRows; c < padded; c += kThreads / kTileRows) {
        dst[c] = 0.f;
      }
    }
    cp_async_commit();
    if (++next_chunk == n_chunks) {
      next_chunk = 0;
      ++next_tile;
    }
  };

  float acc[QI][4];
  stage(0);  // in one group with the query block
  int chunk = 0, base = row_begin;  // the unit being scored
  for (int u = 0; u < n_units; ++u) {
    if (u + 1 < n_units) {
      stage((u + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u (and the query block) landed; merges are done
    const int c0 = chunk * kChunk;
    const int padded = min(kChunk, rp - c0);
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < QI; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;  // +0: -0 sums stay +0
      }
    }
    const float* qp = qs + qg * rsq + c0;
    const float* tp = ts + (u & 1) * kTileRows * rst + rg * rst;
#pragma unroll 2
    for (int d = 0; d < padded; d += 4) {
      float a[QI][4], b[4][4];
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(qp + 8 * i * rsq + d);
        a[i][0] = x.x; a[i][1] = x.y; a[i][2] = x.z; a[i][3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(tp + 16 * j * rst + d);
        b[j][0] = y.x; b[j][1] = y.y; b[j][2] = y.z; b[j][3] = y.w;
      }
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
#pragma unroll
        for (int i = 0; i < QI; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i][dd], b[j][dd], acc[i][j]);
        }
      }
    }
    const bool tile_done = chunk == n_chunks - 1;
    if (tile_done) {
      const int rows = min(kTileRows, row_end - base);
#pragma unroll
      for (int i = 0; i < QI; ++i) {
        const int qq = qg + 8 * i;
        if (q0 + qq >= B) continue;
        const float tv = thv[qq];
        const int ti = thi[qq];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = rg + 16 * j;
          const int gid = base + row;
          const float s = gid < limit ? acc[i][j] : -CUDART_INF_F;
          if (row < rows && beats(s, gid, tv, ti)) {
            const int pos = atomicAdd(&qcnt[qq], 1);
            quv[qq * kQueueCap + pos] = s;
            qui[qq * kQueueCap + pos] = gid;
          }
        }
      }
    }
    __syncthreads();  // buffer u & 1 is consumed; the queues are filled
    if (!tile_done) {
      ++chunk;
      continue;
    }
    chunk = 0;
    const bool last = base + kTileRows >= row_end;
    base += kTileRows;
    // merge once a queue holds 32 entries, or k up to 64: sooner for a small
    // k (its threshold tightens sooner), and never past kQueueCap after the
    // next tile
    const int merge_at = max(32, min(k, kQueueCap - kTileRows));
    // the queues due for a merge, one bit per query (one lane each), dealt
    // out to the warps in turn
    const int m_lane = lane < kQ ? qcnt[lane] : 0;
    unsigned due = __ballot_sync(kFull, m_lane >= merge_at || (last && m_lane > 0));
    // every warp has read the counts before any merge resets one, so all
    // warps deal out the same set
    __syncthreads();
    for (int nth = 0; due != 0; ++nth) {
      const int qq = __ffs(due) - 1;
      due &= due - 1;
      if (nth % kWarps != warp) continue;
      const int m = __shfl_sync(kFull, m_lane, qq);
      const int cnt = warp_merge(lv + qq * k, li + qq * k, lcnt[qq],
                                 quv + qq * kQueueCap, qui + qq * kQueueCap, m,
                                 sv + warp * kQueueCap, si + warp * kQueueCap,
                                 k, lane);
      if (lane == 0) {
        qcnt[qq] = 0;
        lcnt[qq] = cnt;
        if (cnt == k) {
          thv[qq] = lv[qq * k + k - 1];
          thi[qq] = li[qq * k + k - 1];
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int qq = warp; qq < kQ; qq += kWarps) {
    const int qrow = q0 + qq;
    if (qrow >= B) break;
    if (n_splits == 1) {
      write_best(lv + qq * k, li + qq * k, lcnt[qq], k, lane,
                 out + static_cast<size_t>(qrow) * k,
                 out + static_cast<size_t>(B + qrow) * k, nullptr);
    } else {
      const size_t off = (static_cast<size_t>(qrow) * n_splits + split) * k;
      write_best(lv + qq * k, li + qq * k, lcnt[qq], k, lane, cand_v + off,
                 nullptr, cand_i + off);
    }
  }
}


// Pass 2: one warp per query merges its n_splits slab lists (each sorted,
// sentinels at its tail) and writes packed out[0, b, :] and out[1, b, :].
// Where all the lists together fit a warp's registers (n_splits * k <=
// kMaxK) one sort of their real entries takes the place of the merges.
__global__ void __launch_bounds__(kMergeWarps * 32)
fused_topk_merge(const float* __restrict__ cand_v,
                 const int* __restrict__ cand_i, int B, int n_splits, int k,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* lv = reinterpret_cast<float*>(smem4) + warp * 6 * k;
  int* li = reinterpret_cast<int*>(lv + k);
  float* qv = reinterpret_cast<float*>(li + k);
  int* qi = reinterpret_cast<int*>(qv + k);
  float* sv = reinterpret_cast<float*>(qi + k);
  int* si = reinterpret_cast<int*>(sv + k);
  const int qrow = blockIdx.x * kMergeWarps + warp;
  if (qrow >= B) return;  // whole warp
  const int total = n_splits * k;
  if (total <= kMaxK) {
    const size_t base = static_cast<size_t>(qrow) * total;
    float v[kPerLane];
    int id[kPerLane];
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int e = lane + 32 * u;
      const int i = e < total ? cand_i[base + e] : kRetiredId;
      const bool real = i < kRetiredId;
      v[u] = real ? cand_v[base + e] : -CUDART_INF_F;  // the padding loses
      id[u] = real ? i : INT_MAX;
    }
    if (total <= 32) {
      warp_sort<1>(v, id, lane);
    } else if (total <= 64) {
      warp_sort<2>(v, id, lane);
    } else {
      warp_sort<kPerLane>(v, id, lane);
    }
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int p = lane + 32 * u;
      if (p < k) {
        const bool real = id[u] != INT_MAX;
        out[static_cast<size_t>(qrow) * k + p] = real ? v[u] : -CUDART_INF_F;
        out[static_cast<size_t>(B + qrow) * k + p] =
            static_cast<float>(real ? id[u] : kRetiredId);
      }
    }
    return;
  }
  int cnt = 0;
  float tv = -CUDART_INF_F;  // the running k-th entry, once there are k
  int ti = INT_MAX;
  for (int s = 0; s < n_splits; ++s) {
    const size_t off = (static_cast<size_t>(qrow) * n_splits + s) * k;
    // a slab's list is sorted: its real entries that beat the running
    // k-th entry form a prefix, and only that prefix is merged
    int m = 0;
    for (int p0 = 0; p0 < k; p0 += 32) {
      const int p = p0 + lane;
      const int id = p < k ? cand_i[off + p] : kRetiredId;
      const float v = p < k ? cand_v[off + p] : -CUDART_INF_F;
      const bool keep = id < kRetiredId && beats(v, id, tv, ti);
      if (keep) {
        qv[p] = v;
        qi[p] = id;
      }
      m += __popc(__ballot_sync(kFull, keep));
    }
    __syncwarp();
    if (m == 0) continue;
    cnt = warp_merge(lv, li, cnt, qv, qi, m, sv, si, k, lane);
    if (cnt == k) {
      tv = lv[k - 1];
      ti = li[k - 1];
    }
  }
  write_best(lv, li, cnt, k, lane, out + static_cast<size_t>(qrow) * k,
             out + static_cast<size_t>(B + qrow) * k, nullptr);
}

}  // namespace

// Pass 1's dynamic shared memory in bytes for rank r, k and a block of
// qpc queries: the query block (the whole rank) and two table tiles (one
// rank chunk each), rows padded by query_stride; each query's k-best and
// queue (value and id); one merge scratch per warp; four words per query.
static size_t partial_smem(int r, int k, int qpc) {
  const int rp = (r + 3) / 4 * 4;
  return sizeof(float) *
         (static_cast<size_t>(qpc) * query_stride(rp) +
          2 * kTileRows * tile_stride(rp) + 2 * qpc * k +
          2 * qpc * kQueueCap + 2 * kWarps * kQueueCap + 4 * qpc);
}

template <int QI>
static cudaError_t launch_partial(const float* q, const float* t, int B, int N,
                                  int r, int k, int limit, int rows_per_split,
                                  int n_splits, float* cand_v, int* cand_i,
                                  float* out, cudaStream_t s,
                                  cudaEvent_t started) {
  const size_t smem = partial_smem(r, k, 8 * QI);
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_partial<QI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (started != nullptr) {
    err = cudaEventRecord(started, s);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + 8 * QI - 1) / (8 * QI), n_splits);
  fused_topk_partial<QI><<<grid, kThreads, smem, s>>>(
      q, t, B, N, r, k, limit, rows_per_split, n_splits, cand_v, cand_i, out);
  return cudaGetLastError();
}

// The dynamic shared memory of a pass-1 CTA in bytes (what ops/topk.py's
// kernel_geometry fits onto the card), or -1 for an input pio_fused_topk
// refuses.
extern "C" int pio_fused_topk_smem(int r, int k, int qpc) {
  if (k < 1 || k > kMaxK || r < 1 || (qpc != 8 && qpc != 32)) return -1;
  const size_t bytes = partial_smem(r, k, qpc);
  return bytes > INT_MAX ? -1 : static_cast<int>(bytes);
}

// The card's shared memory: per CTA after opting in, per SM, and reserved
// by the system per CTA, in bytes; returns a CUDA error code, else 0.
extern "C" int pio_device_smem(int device, int* limits) {
  const cudaDeviceAttr attrs[3] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(&limits[i], attrs[i], device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Launch pass 1 for blocks of qpc queries (8 or 32) and, with more than one
// split, pass 2 on `stream`; returns the first CUDA error that is not
// cudaSuccess, else 0.  Scratch cand_v [B, n_splits, k] f32 and cand_i
// [B, n_splits, k] i32 (unused with one split) and the output out [2, B, k]
// f32 are allocated by the caller; the caller also checks shapes and that
// the shared memory fits (kernel_geometry).  `started` and `ended`, when not
// null, are timing events recorded on `stream` just before pass 1 and just
// after the last pass, with no host work between them but the launches: their
// elapsed time is the kernel's own.
extern "C" int pio_fused_topk(const float* q, const float* t, int B, int N,
                              int r, int k, int limit, int qpc,
                              int rows_per_split, int n_splits, float* cand_v,
                              int* cand_i, float* out, void* stream,
                              void* started, void* ended) {
  if (k < 1 || k > kMaxK || r < 1 || B < 1 || n_splits < 1 ||
      rows_per_split < 1 || rows_per_split % kTileRows != 0 ||
      (qpc != 8 && qpc != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaEvent_t ev0 = static_cast<cudaEvent_t>(started);
  cudaError_t err =
      qpc == 32 ? launch_partial<4>(q, t, B, N, r, k, limit, rows_per_split,
                                    n_splits, cand_v, cand_i, out, s, ev0)
                : launch_partial<1>(q, t, B, N, r, k, limit, rows_per_split,
                                    n_splits, cand_v, cand_i, out, s, ev0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_splits > 1) {
    const dim3 grid2((B + kMergeWarps - 1) / kMergeWarps);
    fused_topk_merge<<<grid2, kMergeWarps * 32,
                       kMergeWarps * 6 * k * sizeof(float), s>>>(
        cand_v, cand_i, B, n_splits, k, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (ended != nullptr) {
    err = cudaEventRecord(static_cast<cudaEvent_t>(ended), s);
  }
  return static_cast<int>(err);
}
