// score_topk: the best topk entities of every query, top-k of V @ A^T,
// without the (b, n) score matrix.
//
// Replaces the TPU kernel src/repro/kernels/score_topk.py:score_topk (a
// Pallas grid walking (pn, k) panels of A in order, keeping a
// VMEM-resident (b, topk) running top-k merged by topk extract-max sweeps
// per panel).  Hopper runs CTAs in no order, so the work is split in two:
//
//   Stage 1, grid (query groups, chunks of n).  A CTA stages its Q query
//   rows of V in shared memory and walks its chunk of A in tiles of
//   THREADS rows, one row per thread, held in registers (zero-padded to
//   KMAX).  Each (row, query) score is an fp32 FMA chain; no TF32, no
//   tensor cores.  A score that beats the query's current topk-th entry
//   joins that query's candidate buffer (warp-aggregated shared-memory
//   atomics).  After each tile one warp per query sorts the candidates
//   (bitonic, in shared memory) and merges them into the query's sorted
//   list by rank.  The CTA writes its lists to a (b, chunks, topk)
//   scratch, padded with (-inf, -1).
//   Stage 2, one CTA per query, runs the same filter and merge over the
//   chunks' candidates and writes (b, topk), padded with (-inf, -1) where
//   fewer than topk exist (topk > n).
//
// Order: higher score first, then lower index.  It is total (NaN scores
// aside), so the result does not depend on the chunking, and equal scores
// give the lowest index first, as repro's kernel does.  No atomics decide
// a result: the candidate buffers fill in any order and are then sorted.
//
// Bound on an H100: at the serve path's ranks (k <= 32) the reads of A are
// 4nk bytes for 2bnk flop, so the kernel is bound by operations once b
// exceeds ~10 queries (67 TFLOP/s fp32 over 3.35 TB/s = 20 flop/byte), by
// bytes below that.  Design against both: each row of A is read from
// device memory once per query group (groups of the same chunk are
// neighbours in the grid and share it through L2), and each loaded row
// serves the group's Q queries from registers, with V read as float4
// broadcasts from shared memory.  The selection costs little once the
// lists are full: few rows beat the topk-th score.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace stopk {

constexpr int THREADS = 256;  // rows per tile == candidate slots per query
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 64;
constexpr int MAX_TOPK = 1024;
constexpr int MAX_SMEM = 232448;  // 227 KB of dynamic shared memory
constexpr int MAX_Q = 32;         // queries per stage-1 CTA
constexpr int GROUPS = 4;         // query groups the batch is split into
                                  // (more when MAX_Q or MAX_SMEM caps Q)
constexpr int CTAS_PER_SM = 2;    // stage-1 CTAs per SM the chunking aims at

__device__ __forceinline__ bool precedes(float s, int i, float t, int j) {
  return s > t || (s == t && i < j);
}

// Per-CTA selection state for Q queries, all in shared memory.
struct Lists {
  float* ls;  // [Q][topk] running best, sorted
  int* li;
  float* cs;  // [Q][THREADS] this tile's candidates, unsorted
  int* ci;
  float* ns;  // [WARPS][topk] merge output
  int* ni;
  int* cnt;     // [Q] candidates in the buffer
  int* filled;  // [Q] entries in the list (<= topk)
  float* ts;    // [Q] the list's topk-th entry, once filled == topk
  int* ti;
};

// Bytes of a Lists for q queries.
__host__ __device__ inline size_t lists_bytes(int q, int topk) {
  return 4 * (2 * (size_t)q * topk + 2 * (size_t)q * THREADS +
              2 * (size_t)WARPS * topk + 4 * (size_t)q);
}

// The register width of a row of A for rank k.
inline int kmax(int k) {
  return k <= 4 ? 4 : k <= 8 ? 8 : k <= 16 ? 16 : k <= 32 ? 32 : 64;
}

// Stage 1's shared memory for Q queries: their V rows, then the Lists.
inline size_t chunk_smem(int Q, int k, int topk) {
  return (size_t)Q * kmax(k) * sizeof(float) + lists_bytes(Q, topk);
}

__device__ __forceinline__ Lists carve(unsigned char* p, int q, int topk) {
  Lists L;
  float* f = reinterpret_cast<float*>(p);
  L.ls = f;
  f += (size_t)q * topk;
  L.li = reinterpret_cast<int*>(f);
  f += (size_t)q * topk;
  L.cs = f;
  f += (size_t)q * THREADS;
  L.ci = reinterpret_cast<int*>(f);
  f += (size_t)q * THREADS;
  L.ns = f;
  f += (size_t)WARPS * topk;
  L.ni = reinterpret_cast<int*>(f);
  f += (size_t)WARPS * topk;
  L.cnt = reinterpret_cast<int*>(f);
  f += q;
  L.filled = reinterpret_cast<int*>(f);
  f += q;
  L.ts = f;
  f += q;
  L.ti = reinterpret_cast<int*>(f);
  return L;
}

// Offer (s, idx) to query q's buffer if it beats the list's topk-th entry
// (or the list is not full).  Every lane of the warp calls it.
__device__ __forceinline__ void offer(const Lists& L, int q, int topk,
                                      float s, int idx, bool live, int lane) {
  const bool pass =
      live && (L.filled[q] < topk || precedes(s, idx, L.ts[q], L.ti[q]));
  const unsigned mask = __ballot_sync(0xffffffffu, pass);
  if (mask == 0u) return;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&L.cnt[q], __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (pass) {
    const int slot = base + __popc(mask & ((1u << lane) - 1u));
    L.cs[q * THREADS + slot] = s;
    L.ci[q * THREADS + slot] = idx;
  }
}

// Entries of the sorted xs[0..m) that precede (s, i): a prefix.
__device__ __forceinline__ int count_preceding(const float* xs, const int* xi,
                                               int m, float s, int i) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (precedes(xs[mid], xi[mid], s, i)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One warp merges query q's buffer into its list.
__device__ void merge(const Lists& L, int q, int topk, int lane, int warp) {
  const int cnt = L.cnt[q];
  float* cs = L.cs + q * THREADS;
  int* ci = L.ci + q * THREADS;
  float* ls = L.ls + (size_t)q * topk;
  int* li = L.li + (size_t)q * topk;
  float* ns = L.ns + (size_t)warp * topk;
  int* ni = L.ni + (size_t)warp * topk;

  // bitonic sort of the candidates, padded to a power of two with
  // (-inf, INT_MAX), which every real candidate precedes
  int P = 1;
  while (P < cnt) P <<= 1;
  for (int j = cnt + lane; j < P; j += 32) {
    cs[j] = -INFINITY;
    ci[j] = INT_MAX;
  }
  __syncwarp();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < P / 2; t += 32) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const float a = cs[lo], b = cs[hi];
        const int ia = ci[lo], ib = ci[hi];
        const bool forward = (lo & size) == 0;
        if (forward ? precedes(b, ib, a, ia) : precedes(a, ia, b, ib)) {
          cs[lo] = b;
          cs[hi] = a;
          ci[lo] = ib;
          ci[hi] = ia;
        }
      }
      __syncwarp();
    }
  }

  // merge by rank: an entry's place is its own position plus the entries
  // of the other sorted run that precede it; the order is strict, so the
  // places are distinct
  const int have = L.filled[q];
  for (int i = lane; i < have; i += 32) {
    const float s = ls[i];
    const int x = li[i];
    const int r = i + count_preceding(cs, ci, cnt, s, x);
    if (r < topk) {
      ns[r] = s;
      ni[r] = x;
    }
  }
  for (int j = lane; j < cnt; j += 32) {
    const float s = cs[j];
    const int x = ci[j];
    const int r = j + count_preceding(ls, li, have, s, x);
    if (r < topk) {
      ns[r] = s;
      ni[r] = x;
    }
  }
  __syncwarp();
  const int now = min(have + cnt, topk);
  for (int r = lane; r < now; r += 32) {
    ls[r] = ns[r];
    li[r] = ni[r];
  }
  __syncwarp();
  if (lane == 0) {
    L.filled[q] = now;
    L.cnt[q] = 0;
    if (now == topk) {
      L.ts[q] = ls[topk - 1];
      L.ti[q] = li[topk - 1];
    }
  }
}

template <int KMAX>
__device__ __forceinline__ void load_row(float (&a)[KMAX],
                                         const float* __restrict__ A,
                                         long long r, int k, bool live,
                                         bool vec) {
#pragma unroll
  for (int c = 0; c < KMAX; ++c) a[c] = 0.f;
  if (!live) return;
  const float* row = A + r * k;
  if (vec) {
#pragma unroll
    for (int c = 0; c < KMAX; c += 4) {
      if (c < k) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + c));
        a[c] = v.x;
        a[c + 1] = v.y;
        a[c + 2] = v.z;
        a[c + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < k) a[c] = __ldg(row + c);
    }
  }
}

template <int KMAX>
__device__ __forceinline__ float dot(const float* __restrict__ v,
                                     const float (&a)[KMAX]) {
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float s = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < KMAX / 4; ++c4) {
    const float4 w = v4[c4];
    s = fmaf(w.x, a[4 * c4], s);
    s = fmaf(w.y, a[4 * c4 + 1], s);
    s = fmaf(w.z, a[4 * c4 + 2], s);
    s = fmaf(w.w, a[4 * c4 + 3], s);
  }
  return s;
}

// Stage 1: the best topk of chunk blockIdx.y for queries
// [blockIdx.x * Q, +Q) into part[q][chunk][0..topk).
template <int KMAX>
__global__ void __launch_bounds__(THREADS)
chunk_kernel(const float* __restrict__ V, const float* __restrict__ A,
             float* __restrict__ part_s, int* __restrict__ part_i, int b,
             int n, int k, int topk, int Q, int chunk_rows, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Vs = reinterpret_cast<float*>(smem);  // [Q][KMAX]
  const Lists L = carve(smem + (size_t)Q * KMAX * sizeof(float), Q, topk);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * Q;
  const int qn = min(Q, b - q0);
  const int chunk = blockIdx.y;

  for (int f = tid; f < Q * KMAX; f += THREADS) {
    const int q = f / KMAX;
    const int c = f % KMAX;
    Vs[f] = (q < qn && c < k) ? V[(long long)(q0 + q) * k + c] : 0.f;
  }
  for (int q = tid; q < Q; q += THREADS) {
    L.cnt[q] = 0;
    L.filled[q] = 0;
  }
  __syncthreads();

  const long long r0 = (long long)chunk * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const bool vec =
      (k % 4 == 0) && ((reinterpret_cast<uintptr_t>(A) & 15u) == 0);
  for (long long base = r0; base < r1; base += THREADS) {
    const long long r = base + tid;
    const bool live = r < r1;
    float a[KMAX];
    load_row<KMAX>(a, A, r, k, live, vec);
    for (int q = 0; q < qn; ++q) {
      offer(L, q, topk, dot<KMAX>(Vs + q * KMAX, a), (int)r, live, lane);
    }
    __syncthreads();
    for (int q = warp; q < qn; q += WARPS) {
      if (L.cnt[q] > 0) merge(L, q, topk, lane, warp);
    }
    __syncthreads();
  }

  for (int f = tid; f < qn * topk; f += THREADS) {
    const int q = f / topk;
    const int j = f % topk;
    const long long o = ((long long)(q0 + q) * n_chunks + chunk) * topk + j;
    const bool has = j < L.filled[q];
    part_s[o] = has ? L.ls[(size_t)q * topk + j] : -INFINITY;
    part_i[o] = has ? L.li[(size_t)q * topk + j] : -1;
  }
}

// Stage 2: query blockIdx.x's best topk over all chunks' candidates.
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             float* __restrict__ out_s, int* __restrict__ out_i, int n_chunks,
             int topk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lists L = carve(smem, 1, topk);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long q = blockIdx.x;
  if (tid == 0) {
    L.cnt[0] = 0;
    L.filled[0] = 0;
  }
  __syncthreads();

  const long long total = (long long)n_chunks * topk;
  const float* ps = part_s + q * total;
  const int* pi = part_i + q * total;
  for (long long base = 0; base < total; base += THREADS) {
    const long long e = base + tid;
    const bool live = e < total;
    const float s = live ? ps[e] : -INFINITY;
    const int x = live ? pi[e] : -1;
    offer(L, 0, topk, s, x, live && x >= 0, lane);
    __syncthreads();
    if (warp == 0 && L.cnt[0] > 0) merge(L, 0, topk, lane, 0);
    __syncthreads();
  }

  for (int j = tid; j < topk; j += THREADS) {
    const bool has = j < L.filled[0];
    out_s[q * topk + j] = has ? L.ls[j] : -INFINITY;
    out_i[q * topk + j] = has ? L.li[j] : -1;
  }
}

template <int KMAX>
cudaError_t launch(const float* V, const float* A, float* part_s, int* part_i,
                   float* out_s, int* out_i, int b, int n, int k, int topk,
                   int Q, int chunk_rows, int n_chunks, cudaStream_t stream) {
  const size_t smem1 = chunk_smem(Q, KMAX, topk);
  const size_t smem2 = lists_bytes(1, topk);
  if (smem1 > (size_t)MAX_SMEM || smem2 > (size_t)MAX_SMEM) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  const dim3 grid1((b + Q - 1) / Q, n_chunks);
  chunk_kernel<KMAX><<<grid1, THREADS, smem1, stream>>>(
      V, A, part_s, part_i, b, n, k, topk, Q, chunk_rows, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<<<b, THREADS, smem2, stream>>>(part_s, part_i, out_s, out_i,
                                              n_chunks, topk);
  return cudaGetLastError();
}

}  // namespace stopk

// The launch plan for (b, n, k, topk) on a card with sms SMs: the batch
// splits into GROUPS groups of Q queries (more groups when MAX_Q or shared
// memory caps Q) and n into chunks of whole tiles, so that stage 1 has
// about CTAS_PER_SM CTAs per SM; smaller groups give longer chunks, which
// spread each chunk's first (full) merge over more rows.  Writes Q,
// chunk_rows and n_chunks to plan[0..3).  Returns cudaErrorInvalidValue
// for arguments outside the kernel's limits.
extern "C" int repro_score_topk_plan(int b, int n, int k, int topk, int sms,
                                     int* plan) {
  if (b < 1 || n < 1 || k < 1 || k > stopk::MAX_K || topk < 1 ||
      topk > stopk::MAX_TOPK || sms < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int fit = 0;
  for (int q = 1; q <= stopk::MAX_Q; ++q) {
    if (stopk::chunk_smem(q, k, topk) <= (size_t)stopk::MAX_SMEM) fit = q;
  }
  if (fit == 0) return (int)cudaErrorInvalidValue;
  const int Q = std::min(fit, (b + stopk::GROUPS - 1) / stopk::GROUPS);
  const int groups = (b + Q - 1) / Q;
  const int want =
      std::max(1, (stopk::CTAS_PER_SM * sms + groups - 1) / groups);
  const long long rows = ((long long)n + want - 1) / want;
  const long long chunk_rows =
      (rows + stopk::THREADS - 1) / stopk::THREADS * stopk::THREADS;
  plan[0] = Q;
  plan[1] = (int)chunk_rows;
  plan[2] = (int)(((long long)n + chunk_rows - 1) / chunk_rows);
  return (int)cudaSuccess;
}

// out (b, topk) = the best topk of V (b, k) @ A (n, k)^T per row, through
// the (b, n_chunks, topk) scratch part.  Q queries share a CTA; chunks
// hold chunk_rows rows of A (the last one fewer).  Returns the launches'
// cudaError_t; cudaErrorInvalidValue for arguments outside the limits.
extern "C" int repro_score_topk(const float* V, const float* A, float* part_s,
                                int* part_i, float* out_s, int* out_i, int b,
                                int n, int k, int topk, int Q, int chunk_rows,
                                int n_chunks, void* stream) {
  if (b < 1 || n < 1 || k < 1 || k > stopk::MAX_K || topk < 1 ||
      topk > stopk::MAX_TOPK || Q < 1 || chunk_rows < 1 || n_chunks < 1 ||
      n_chunks > 65535 || (long long)chunk_rows * n_chunks < n) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 4) {
    err = stopk::launch<4>(V, A, part_s, part_i, out_s, out_i, b, n, k, topk,
                          Q, chunk_rows, n_chunks, st);
  } else if (k <= 8) {
    err = stopk::launch<8>(V, A, part_s, part_i, out_s, out_i, b, n, k, topk,
                          Q, chunk_rows, n_chunks, st);
  } else if (k <= 16) {
    err = stopk::launch<16>(V, A, part_s, part_i, out_s, out_i, b, n, k, topk,
                           Q, chunk_rows, n_chunks, st);
  } else if (k <= 32) {
    err = stopk::launch<32>(V, A, part_s, part_i, out_s, out_i, b, n, k, topk,
                           Q, chunk_rows, n_chunks, st);
  } else {
    err = stopk::launch<64>(V, A, part_s, part_i, out_s, out_i, b, n, k, topk,
                           Q, chunk_rows, n_chunks, st);
  }
  return (int)err;
}
