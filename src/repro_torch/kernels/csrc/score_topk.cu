// score_topk: the best topk entities of every query, top-k of V @ A^T,
// without the (b, n) score matrix.
//
// Replaces the TPU kernel src/repro/kernels/score_topk.py:score_topk (a
// Pallas grid walking (pn, k) panels of A in order, keeping a
// VMEM-resident (b, topk) running top-k merged by topk extract-max sweeps
// per panel).  Hopper runs CTAs in no order, so the work is split in two
// launches: stage 1 keeps per-warp lists over chunks of A, stage 2 merges
// each query's lists.
//
// Bound on an H100: 2bnk fp32 operations against 4nk bytes of A (V and
// the result are small): bytes below ~10 queries at k <= 32 (67 TFLOP/s
// over 3.35 TB/s = 20 flop per byte), operations above.  At the serve
// shape (b = 32, k = 3) both are under a microsecond, so what costs there
// is fixed: launches, filling the lists, merging them.  The design:
//
//  * A copy ring.  Stage 1 runs one CTA per SM (grid: query blocks x
//    chunks of n, from the wrapper's plan, kernels/score_topk.py).  A
//    producer warp streams the chunk's rows of A in tiles of TILE = 256
//    rows into a STAGES-deep shared-memory ring with 16-byte cp.async
//    copies, each lane's group arriving on the slot's full mbarrier; the
//    consumer warps release a slot through its empty mbarrier.  No CTA
//    barrier follows the prologue.  For k % 4 == 0 each row lands at a
//    stride ks = k or k + 4 floats with ks / 4 odd, so the float4 reads of
//    32 consecutive rows hit distinct banks; other k copy the tile as it
//    lies (stride k, scalar reads, conflict-free for odd k).
//  * Register-tiled scoring.  The CTA's queries (up to 64) sit in shared
//    memory; consumer warp (g, rw) owns query group g of Q queries and
//    every rws-th tile (row warp rw; rws <= STAGES, so that a warp's tiles
//    keep to its own ring slots and it waits for their phases in order).
//    Lane l scores rows l + 32 r (r < R = 8) against the Q queries: per 4
//    columns R float4 loads of A and Q broadcast float4 loads of V feed
//    4 R Q FMAs.  Each score is the ascending-c chain s = fmaf(V[q][c],
//    A[row][c], s) from s = 0, in fp32 (no TF32), the chain the first port
//    of this kernel used, so results are bit-identical to it.
//  * Warp selection in registers (Johnson, Douze and Jegou, "Billion-scale
//    similarity search with GPUs", 2017, section 4).  For each of its
//    queries a warp keeps a sorted list of 32 E entries (E = 1..32, the
//    smallest with 32 E >= topk), position e * 32 + lane in register e of
//    that lane, and its topk-th score as a threshold in a register.  A
//    tile in which no lane's best row reaches a threshold is dropped by
//    one compare per query and one vote.  Otherwise survivors go to a
//    per-(warp, query) buffer in shared memory (ballot and popc place
//    them), and when one might overflow, all the warp's buffers are
//    merged in rounds: a round takes 32 entries per query, sorts them
//    across the lanes (bitonic, by shuffles; the Q networks step
//    together), sets the reversed batch against the list's last 32
//    entries (keeping the preceding of each pair: the top 32 E of the
//    union, as a bitonic sequence), bitonic-merges the 32 E entries
//    (shuffles for distances below 32, register swaps above), raises the
//    thresholds and drops what no longer reaches them.  No barrier outside
//    the warp is involved.
//  * Fill and seed.  A list admits everything until it holds topk
//    entries, so each (warp, query) pays its fill (two rounds) once per
//    chunk.  For large n the wrapper first runs both stages over a prefix
//    of A and passes that result as `seed`: its topk-th score per query is
//    no higher than the final one, so every list starts from it and few
//    rows survive the one compare.
//  * Stage 2: one CTA of eight warps per query.  Each warp streams an
//    eighth of the query's partial lists through the same filter and
//    merge, from a threshold no lower than any full list's topk-th score;
//    seven hand their lists to warp 0 through shared memory, which merges
//    them and writes the result.
//
// Order: higher score first, then lower index.  It is total (NaN scores
// aside), so the result depends on neither the plan nor the order of the
// merges, and equal scores give the lowest index first, as repro's kernel
// does.  Empty slots are (-inf, INT_MAX) inside the kernels, which every
// real entry precedes, and (-inf, -1) in the partial lists and the result
// (topk > n).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace stopk {

constexpr int R = 8;                      // rows per lane in a tile
constexpr int TILE = 32 * R;              // rows per tile
constexpr int WARPS = 8;                  // consumer warps (stage 1 and 2)
constexpr int THREADS = 32 * WARPS + 32;  // + the producer warp
constexpr int STAGES = 2;                 // ring depth
constexpr int CAP = 128;                  // buffered survivors per list
constexpr int MAX_K = 64;
constexpr int MAX_TOPK = 1024;
constexpr int MAX_SMEM = 232448;          // 227 KB of dynamic shared memory
constexpr int NONE = INT_MAX;             // the index of an empty slot
constexpr unsigned FULL = 0xffffffffu;

// Queries per consumer warp for lists of E registers per lane: Q * E <= 8
// keeps the lists in 16 registers.
__host__ __device__ constexpr int queries(int E) { return E >= 8 ? 1 : 8 / E; }

struct Params {
  const float* V;   // (b, k)
  const float* A;   // (n, k), 16-byte aligned
  float* part_s;    // (b, lists, topk)
  int* part_i;
  int b, n, k, topk;
  int qg;           // query groups per CTA (a power of two <= WARPS)
  int rws;          // row warps: warps per query group, <= STAGES
  int chunk_rows;   // rows of A per CTA, a multiple of TILE
  int ks;           // row stride of a ring tile, in floats
  int kv;           // row stride of the staged V: k rounded up to 4
  int lists;        // partial lists per query: chunks * row warps
  const float* seed;   // (b, topk): this call's result on a subset of A's
  const int* seed_i;   // rows, or null; its topk-th entry per query, which
                       // the result's topk-th entry precedes or equals,
                       // starts every list's threshold
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed; the whole warp
// calls it and leaves it together (its lanes poll independently).  A
// wait of ~2^35 cycles (~20 s) can only be a fault: trap, so that the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) break;
    if (start < 0)
      start = clock64();
    else if (clock64() - start > (1ll << 35))
      __trap();
  }
  __syncwarp();
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Close this thread's copies of a tile into a group and count the thread
// on the slot's full barrier once they have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * WARPS) : "memory");
}

// Bitwise, not short-circuit, so that it compiles to predicates, not
// branches, between the shuffles of the networks below.
__device__ __forceinline__ bool precedes(float s, int i, float t, int j) {
  return (s > t) | ((s == t) & (i < j));
}

// (s, i) precedes or is the threshold entry (t, j): what a candidate must
// do to stay.  A floor from the seed or from stage 2's lists is a real
// entry that may belong to the result.
__device__ __forceinline__ bool reaches(float s, int i, float t, int j) {
  return (s > t) | ((s == t) & (i <= j));
}

// Compare-exchange with the lane `d` apart: keep the preceding entry of
// the pair if `first`, else the other.
__device__ __forceinline__ void cx_lanes(float& s, int& i, int d,
                                         bool first) {
  const float t = __shfl_xor_sync(FULL, s, d);
  const int j = __shfl_xor_sync(FULL, i, d);
  const bool take = first == precedes(t, j, s, i);
  s = take ? t : s;
  i = take ? j : i;
}

// Bitonic sort of one entry per lane for each of Q queries, preceding
// entries to lower lanes.  The queries step through each compare-exchange
// together, so their shuffles overlap instead of waiting in turn; the
// steps are a loop, to keep the code short.
template <int Q>
__device__ __forceinline__ void sort32(float (&s)[Q], int (&i)[Q], int lane) {
#pragma unroll 1
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll 1
    for (int d = size >> 1; d > 0; d >>= 1) {
      const bool desc = size == 32 || (lane & size) == 0;
      const bool first = ((lane & d) == 0) == desc;
#pragma unroll
      for (int q = 0; q < Q; ++q) cx_lanes(s[q], i[q], d, first);
    }
  }
}

// One warp's running best for each of its Q queries: 32 E sorted entries
// per query, position e * 32 + lane in register e of that lane; the
// threshold, an entry (thr, thr_i) that a candidate must precede or be
// (the list's topk-th entry, or a better one from the seed): exact under
// the total order, so rows that tie the threshold's score are dropped too;
// the count of survivors waiting in the query's buffer (CAP entries in
// shared memory).  Thresholds and counts are the same in every lane.
template <int E, int Q>
struct Lists {
  float s[Q][E];
  int i[Q][E];
  float thr[Q];
  int thr_i[Q];
  int cnt[Q];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        s[q][e] = -INFINITY;
        i[q][e] = NONE;
      }
      thr[q] = -INFINITY;
      thr_i[q] = NONE;
      cnt[q] = 0;
    }
  }

  // Merge each query's 32 entries, sorted across the lanes, into its
  // list; the queries step together, as in sort32.
  __device__ __forceinline__ void merge(const float (&cs)[Q],
                                        const int (&ci)[Q], int lane) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float rs = __shfl_sync(FULL, cs[q], 31 - lane);
      const int ri = __shfl_sync(FULL, ci[q], 31 - lane);
      const bool take = precedes(rs, ri, s[q][E - 1], i[q][E - 1]);
      s[q][E - 1] = take ? rs : s[q][E - 1];
      i[q][E - 1] = take ? ri : i[q][E - 1];
    }
#pragma unroll
    for (int d = E / 2; d > 0; d >>= 1) {   // positions 32 d apart
#pragma unroll
      for (int e = 0; e < E; ++e) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if ((e & d) == 0) {   // resolved at compile time
            const float ts = s[q][e], us = s[q][e + d];
            const int ti = i[q][e], ui = i[q][e + d];
            const bool swap = precedes(us, ui, ts, ti);
            s[q][e] = swap ? us : ts;
            i[q][e] = swap ? ui : ti;
            s[q][e + d] = swap ? ts : us;
            i[q][e + d] = swap ? ti : ui;
          }
        }
      }
    }
#pragma unroll 1
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int q = 0; q < Q; ++q)
          cx_lanes(s[q][e], i[q][e], d, (lane & d) == 0);
    }
  }

  // Raise query q's threshold to the list's entry at position topk - 1,
  // if that entry precedes it.
  __device__ __forceinline__ void raise(int q, int topk) {
    const int e = (topk - 1) >> 5;
    float v = s[q][0];
    int x = i[q][0];
#pragma unroll
    for (int f = 1; f < E; ++f) {
      v = f == e ? s[q][f] : v;
      x = f == e ? i[q][f] : x;
    }
    v = __shfl_sync(FULL, v, (topk - 1) & 31);
    x = __shfl_sync(FULL, x, (topk - 1) & 31);
    const bool up = precedes(v, x, thr[q], thr_i[q]);
    thr[q] = up ? v : thr[q];
    thr_i[q] = up ? x : thr_i[q];
  }

  // Merge every query's buffered survivors, in rounds: each round sorts
  // the first 32 of every buffer across the lanes and merges them (the Q
  // networks step together), raises the thresholds, then drops what no
  // longer reaches them and compacts the rest of each buffer.  The fill of
  // a list takes two rounds.
  __device__ __forceinline__ void flush(float* bs, int* bi, int topk,
                                        int lane) {
    const unsigned below = (1u << lane) - 1u;
    __syncwarp();
    while (true) {
      bool more = false;
#pragma unroll
      for (int q = 0; q < Q; ++q) more |= cnt[q] > 0;
      if (!more) break;
      float cs[Q];
      int ci[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {   // the buffer's first 32, filtered
        const float v = bs[q * CAP + lane];
        const int x = bi[q * CAP + lane];
        const bool in = (lane < cnt[q]) & reaches(v, x, thr[q], thr_i[q]);
        cs[q] = in ? v : -INFINITY;
        ci[q] = in ? x : NONE;
      }
      sort32<Q>(cs, ci, lane);
      merge(cs, ci, lane);
#pragma unroll
      for (int q = 0; q < Q; ++q) raise(q, topk);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        int kept = 0;
        for (int e0 = 32; e0 < cnt[q]; e0 += 32) {
          const int e = e0 + lane;        // e < CAP: cnt <= CAP
          const float v = bs[q * CAP + e];
          const int x = bi[q * CAP + e];
          const bool keep =
              (e < cnt[q]) & reaches(v, x, thr[q], thr_i[q]);
          const unsigned mk = __ballot_sync(FULL, keep);
          if (keep) {   // to below e0: entries already read
            const int at = kept + __popc(mk & below);
            bs[q * CAP + at] = v;
            bi[q * CAP + at] = x;
          }
          kept += __popc(mk);
          __syncwarp();
        }
        cnt[q] = kept;
      }
    }
  }

  // Append each lane's entries (cs[r][q], cx[r]) that reach the
  // thresholds, where live[r], for the warp's first nq queries, to the
  // buffers; called by the whole warp.  One ballot per query finds the
  // lanes with a survivor; only those queries pay the per-row ballots and
  // counts.  Returns false, appending nothing, when a buffer might
  // overflow (N survivors per such lane, an upper bound): the caller
  // flushes and calls again (N * 32 <= CAP, so the second call fits).
  template <int N>
  __device__ __forceinline__ bool append(float* bs, int* bi,
                                         const float (&cs)[N][Q],
                                         const int (&cx)[N],
                                         const bool (&live)[N], int nq,
                                         int lane) {
    static_assert(N * 32 <= CAP, "append: one flush makes room");
    unsigned mq[Q];
    unsigned some = 0u;
    bool over = false;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      bool pass = false;
#pragma unroll
      for (int r = 0; r < N; ++r)
        pass |= (q < nq) & live[r] &
                reaches(cs[r][q], cx[r], thr[q], thr_i[q]);
      mq[q] = __ballot_sync(FULL, pass);
      some |= mq[q];
      over |= (mq[q] != 0u) & (cnt[q] + N * __popc(mq[q]) > CAP);
    }
    if (some == 0u) return true;
    if (over) return false;
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (mq[q] == 0u) continue;              // the same in every lane
      // the N ballots and counts are independent; only the slots add up
      unsigned m[N];
      int at[N + 1];
      at[0] = cnt[q];
#pragma unroll
      for (int r = 0; r < N; ++r)
        m[r] = __ballot_sync(FULL, (q < nq) & live[r] &
                                       reaches(cs[r][q], cx[r], thr[q],
                                               thr_i[q]));
#pragma unroll
      for (int r = 0; r < N; ++r) at[r + 1] = at[r] + __popc(m[r]);
#pragma unroll
      for (int r = 0; r < N; ++r) {
        if ((m[r] >> lane) & 1u) {
          const int slot = at[r] + __popc(m[r] & below);
          bs[q * CAP + slot] = cs[r][q];
          bi[q * CAP + slot] = cx[r];
        }
      }
      cnt[q] = at[N];
    }
    return true;
  }

  // append, flushing first when it does not fit.
  template <int N>
  __device__ __forceinline__ void offer(float* bs, int* bi,
                                        const float (&cs)[N][Q],
                                        const int (&cx)[N],
                                        const bool (&live)[N], int nq,
                                        int topk, int lane) {
    while (!this->template append<N>(bs, bi, cs, cx, live, nq, lane))
      flush(bs, bi, topk, lane);
  }

  // Query q's positions [0, topk) to s_out / i_out, empty slots as
  // (-inf, -1).
  __device__ __forceinline__ void write(int q, float* s_out, int* i_out,
                                        int topk, int lane) const {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int p = e * 32 + lane;
      if (p < topk) {
        s_out[p] = i[q][e] == NONE ? -INFINITY : s[q][e];
        i_out[p] = i[q][e] == NONE ? -1 : i[q][e];
      }
    }
  }
};

// Scores of rows lane + 32 r of a ring tile against the warp's Q queries.
template <bool VEC, int Q>
__device__ __forceinline__ void score(float (&acc)[R][Q], const float* tile,
                                      const float* vq, const Params& p,
                                      int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[r][q] = 0.f;
  const float* a0 = tile + lane * p.ks;
  if (VEC) {
    for (int c = 0; c < p.k; c += 4) {
      float4 a[R], v[Q];
#pragma unroll
      for (int r = 0; r < R; ++r)
        a[r] = *reinterpret_cast<const float4*>(a0 + 32 * r * p.ks + c);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        v[q] = *reinterpret_cast<const float4*>(vq + q * p.kv + c);
      // one column at a time over all R x Q scores: independent FMAs, each
      // score still summed in ascending c
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][q] = fmaf(v[q].x, a[r].x, acc[r][q]);
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][q] = fmaf(v[q].y, a[r].y, acc[r][q]);
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][q] = fmaf(v[q].z, a[r].z, acc[r][q]);
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][q] = fmaf(v[q].w, a[r].w, acc[r][q]);
    }
  } else {
    for (int c = 0; c < p.k; ++c) {
      float a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = a0[32 * r * p.ks + c];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float v = vq[q * p.kv + c];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][q] = fmaf(v, a[r], acc[r][q]);
      }
    }
  }
}

// The producer warp's copy of rows [row0, row0 + nr) of A into a ring
// tile.  VEC: 16-byte chunks row by row at stride ks; otherwise the tile's
// bytes as they lie (its start is 16-byte aligned: row0 is a multiple of
// TILE), the last partial chunk by 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void copy_tile(float* dst, long long row0, int nr,
                                          const Params& p, int lane) {
  const uint32_t d0 = smem_u32(dst);
  const float* src = p.A + row0 * p.k;
  if (VEC) {
    const int kc = p.k >> 2;                 // chunks per row
    const int step_r = 32 / kc, step_c = 32 % kc;
    int r = lane / kc, c = lane % kc;
    for (int f = lane; f < nr * kc; f += 32) {
      cp_async16(d0 + 4u * (r * p.ks + 4 * c),
                 src + (long long)r * p.k + 4 * c);
      r += step_r;
      c += step_c;
      if (c >= kc) {
        c -= kc;
        ++r;
      }
    }
  } else {
    const int m = nr * p.k;
    for (int f = 4 * lane; f + 4 <= m; f += 128)
      cp_async16(d0 + 4u * f, src + f);
    for (int f = (m & ~3) + lane; f < m; f += 32)
      cp_async4(d0 + 4u * f, src + f);
  }
}

// Stage 1: each consumer warp's best topk of its tiles of chunk
// blockIdx.y for its queries, into the partial lists.
template <int E, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    chunk_kernel(const __grid_constant__ Params p) {
  constexpr int Q = queries(E);
  extern __shared__ __align__(16) unsigned char smem[];
  const int qb = p.qg * Q;                     // queries of this CTA
  const int tile_f = TILE * p.ks;
  float* ring = reinterpret_cast<float*>(smem);
  float* vs = ring + STAGES * tile_f;          // [qb][kv]
  float* bsf = vs + qb * p.kv;                 // [WARPS][Q][CAP]
  int* bif = reinterpret_cast<int*>(bsf + WARPS * Q * CAP);
  const uint32_t bar = smem_u32(bif + WARPS * Q * CAP);
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (STAGES + s); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row warps: warp rw takes tiles rw, rw + rws, ...; rws <= STAGES keeps
  // each warp's tiles on its own slots, waited for in phase order
  const int rws = p.rws;
  const long long r0 = (long long)blockIdx.y * p.chunk_rows;
  const int rows = (int)min((long long)p.chunk_rows, (long long)p.n - r0);
  const int tiles = (rows + TILE - 1) / TILE;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), p.qg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WARPS) {
    // ---- producer: tile t into slot t % STAGES, once its last use ended
    for (int t = 0; t < tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) - 1) & 1);
      copy_tile<VEC>(ring + s * tile_f, r0 + (long long)t * TILE,
                     min(TILE, rows - t * TILE), p, lane);
      cp_async_arrive(full(s));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumers: this CTA's queries of V, zero-padded, then the tiles
  const int q0 = blockIdx.x * qb;
  for (int f = tid; f < qb * p.kv; f += 32 * WARPS) {
    const int q = f / p.kv, c = f - q * p.kv;
    vs[f] = (q0 + q < p.b && c < p.k) ? p.V[(long long)(q0 + q) * p.k + c]
                                      : 0.f;
  }
  consumers_sync();

  const int g = warp % p.qg, rw = warp / p.qg;
  if (rw >= rws) return;                       // idle: no group or rows
  const int wq = q0 + g * Q;                   // the warp's first query
  const int nq = max(0, min(Q, p.b - wq));
  const float* vq = vs + g * Q * p.kv;
  float* bs = bsf + warp * Q * CAP;
  int* bi = bif + warp * Q * CAP;
  Lists<E, Q> sel;
  sel.init();
  if (p.seed != nullptr) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (q < nq) {
        const long long at = (long long)(wq + q) * p.topk + p.topk - 1;
        sel.thr[q] = p.seed[at];
        sel.thr_i[q] = p.seed_i[at] < 0 ? NONE : p.seed_i[at];
      }
    }
  }

  for (int t = rw; t < tiles; t += rws) {
    const int s = t % STAGES;
    mbar_wait(full(s), (t / STAGES) & 1);
    float acc[R][Q];
    if (nq > 0) score<VEC, Q>(acc, ring + s * tile_f, vq, p, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    __syncwarp();
    if (nq == 0) continue;
    // most tiles hold no survivor: one compare per query of the lane's
    // best row, and one vote, reject them
    {
      bool any = false;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        float best = acc[0][q];
#pragma unroll
        for (int r = 1; r < R; ++r) best = fmaxf(best, acc[r][q]);
        any |= (q < nq) & (best >= sel.thr[q]);
      }
      if (!__any_sync(FULL, any)) continue;
    }
    int idx[R];
    bool live[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = t * TILE + 32 * r + lane;  // within the chunk
      idx[r] = (int)r0 + row;
      live[r] = row < rows;
    }
    // the tile's rows half by half, CAP at a time, through one flush site
    for (int h = 0; h < 2;) {
      float hv[R / 2][Q];
      int hx[R / 2];
      bool hl[R / 2];
#pragma unroll
      for (int r = 0; r < R / 2; ++r) {
        hx[r] = h ? idx[R / 2 + r] : idx[r];
        hl[r] = h ? live[R / 2 + r] : live[r];
#pragma unroll
        for (int q = 0; q < Q; ++q)
          hv[r][q] = h ? acc[R / 2 + r][q] : acc[r][q];
      }
      if (sel.template append<R / 2>(bs, bi, hv, hx, hl, nq, lane))
        ++h;
      else
        sel.flush(bs, bi, p.topk, lane);
    }
  }
  if (nq == 0) return;

  sel.flush(bs, bi, p.topk, lane);
  const long long list = (long long)blockIdx.y * rws + rw;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    if (q < nq) {
      const long long o = ((long long)(wq + q) * p.lists + list) * p.topk;
      sel.write(q, p.part_s + o, p.part_i + o, p.topk, lane);
    }
  }
}

// Stage 2: query blockIdx.x's best topk over its partial lists.
template <int E>
__global__ void __launch_bounds__(32 * WARPS)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_i,
             float* __restrict__ out_s, int* __restrict__ out_i, int lists,
             int topk, const float* __restrict__ seed,
             const int* __restrict__ seed_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bsf = reinterpret_cast<float*>(smem);    // [WARPS][CAP]
  int* bif = reinterpret_cast<int*>(bsf + WARPS * CAP);
  float* hs = reinterpret_cast<float*>(bif + WARPS * CAP);  // [WARPS-1][topk]
  int* hi = reinterpret_cast<int*>(hs + (WARPS - 1) * topk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long q = blockIdx.x;
  const long long total = (long long)lists * topk;
  const float* ps = part_s + q * total;
  const int* pi = part_i + q * total;
  float* bs = bsf + warp * CAP;
  int* bi = bif + warp * CAP;
  constexpr int N = CAP / 32;
  Lists<E, 1> sel;
  sel.init();
  // a first threshold: a full list's topk-th entry (its last) is preceded
  // by topk entries, so the result's topk-th entry precedes or equals it;
  // the best of them and of the seed's
  float fs = -INFINITY;
  int fi = NONE;
  if (seed != nullptr && seed_i[q * topk + topk - 1] >= 0) {
    fs = seed[q * topk + topk - 1];
    fi = seed_i[q * topk + topk - 1];
  }
  for (int l = lane; l < lists; l += 32) {
    const long long x = (long long)l * topk + topk - 1;
    const int xi = pi[x];
    const float xs = ps[x];
    const bool up = (xi >= 0) & precedes(xs, xi, fs, fi);
    fs = up ? xs : fs;
    fi = up ? xi : fi;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float os = __shfl_xor_sync(FULL, fs, d);
    const int oi = __shfl_xor_sync(FULL, fi, d);
    const bool up = precedes(os, oi, fs, fi);
    fs = up ? os : fs;
    fi = up ? oi : fi;
  }
  sel.thr[0] = fs;
  sel.thr_i[0] = fi;

  // warp w streams entries [e0, e1), N per lane at a time, the next N
  // loads in flight while these are offered
  const long long per = (total + WARPS * CAP - 1) / (WARPS * CAP) * CAP;
  const long long e0 = warp * per, e1 = min(total, e0 + per);
  float cs[2][N][1];
  int cx[2][N];
  auto load = [&](int h, long long e) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const long long x = e + 32 * r + lane;
      cs[h][r][0] = x < e1 ? ps[x] : -INFINITY;
      cx[h][r] = x < e1 ? pi[x] : -1;
    }
  };
  auto offer = [&](int h) {
    bool live[N];
#pragma unroll
    for (int r = 0; r < N; ++r) live[r] = cx[h][r] >= 0;
    sel.template offer<N>(bs, bi, cs[h], cx[h], live, 1, topk, lane);
  };
  if (e0 < e1) load(0, e0);
  for (long long e = e0; e < e1; e += 2 * CAP) {
    if (e + CAP < e1) load(1, e + CAP);
    offer(0);
    if (e + CAP >= e1) break;
    if (e + 2 * CAP < e1) load(0, e + 2 * CAP);
    offer(1);
  }
  sel.flush(bs, bi, topk, lane);
  if (warp > 0)
    sel.write(0, hs + (warp - 1) * topk, hi + (warp - 1) * topk, topk, lane);
  __syncthreads();
  if (warp != 0) return;
  const int held = (WARPS - 1) * topk;
  for (int e = 0; e < held; e += CAP) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const int x = e + 32 * r + lane;
      cs[0][r][0] = x < held ? hs[x] : -INFINITY;
      cx[0][r] = x < held ? hi[x] : -1;
    }
    offer(0);
  }
  sel.flush(bs, bi, topk, lane);
  sel.write(0, out_s + q * topk, out_i + q * topk, topk, lane);
}

template <int E>
cudaError_t launch(const Params& p, int qblocks, int chunks, float* out_s,
                   int* out_i, cudaStream_t stream) {
  constexpr int Q = queries(E);
  const size_t smem1 = 4 * ((size_t)STAGES * TILE * p.ks +
                            (size_t)p.qg * Q * p.kv +
                            2 * (size_t)WARPS * Q * CAP) +
                       16 * STAGES;
  const size_t smem2 =
      8 * ((size_t)WARPS * CAP + (size_t)(WARPS - 1) * p.topk);
  if (smem1 > (size_t)MAX_SMEM || smem2 > (size_t)MAX_SMEM)
    return cudaErrorInvalidValue;
  const bool vec = p.k % 4 == 0;
  if ((p.seed == nullptr) != (p.seed_i == nullptr))
    return cudaErrorInvalidValue;
  void (*k1)(const Params) =
      vec ? chunk_kernel<E, true> : chunk_kernel<E, false>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(merge_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  k1<<<dim3(qblocks, chunks), THREADS, smem1, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<E><<<p.b, 32 * WARPS, smem2, stream>>>(
      p.part_s, p.part_i, out_s, out_i, p.lists, p.topk, p.seed, p.seed_i);
  return cudaGetLastError();
}

}  // namespace stopk

// out (b, topk) = the best topk of V (b, k) @ A (n, k)^T per row, through
// the (b, lists, topk) scratch part, lists = chunks * row_warps.  The
// plan (kernels/score_topk.py plan): lists_e = E, the smallest of 1, 2,
// ..., 32 with 32 E >= topk; groups (a power of two <= 8) query groups of
// queries(E) queries per CTA; chunks of chunk_rows rows of A (a multiple
// of 128; the last chunk fewer).  A must be 16-byte aligned.  Returns the
// launches' cudaError_t; cudaErrorInvalidValue for arguments outside the
// limits or a plan that does not cover the work.  (seed, seed_i), both
// (b, topk), when not null, are this function's result over a subset of
// A's rows: each query's topk-th entry there, which the result's topk-th
// entry precedes or equals, is every list's first threshold.
extern "C" int repro_score_topk(const float* V, const float* A,
                                const float* seed, const int* seed_i,
                                float* part_s,
                                int* part_i, float* out_s, int* out_i, int b,
                                int n, int k, int topk, int lists_e,
                                int groups, int row_warps, int chunk_rows,
                                int chunks, void* stream) {
  int e = 1;
  while (32 * e < topk) e *= 2;
  if (b < 1 || n < 1 || k < 1 || k > stopk::MAX_K || topk < 1 ||
      topk > stopk::MAX_TOPK || lists_e != e || groups < 1 ||
      groups > stopk::WARPS || (groups & (groups - 1)) != 0 ||
      row_warps < 1 || row_warps > stopk::STAGES ||
      groups * row_warps > stopk::WARPS ||
      chunk_rows < stopk::TILE || chunk_rows % stopk::TILE != 0 ||
      chunks < 1 || chunks > 65535 ||
      (long long)(chunks - 1) * chunk_rows >= n ||
      (long long)chunks * chunk_rows < n ||
      (reinterpret_cast<uintptr_t>(A) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  const int q = stopk::queries(e);
  const long long qblocks = ((long long)(b + q - 1) / q + groups - 1) / groups;
  stopk::Params p{V, A, part_s, part_i, b, n, k, topk, groups, row_warps,
                  chunk_rows,
                  k % 4 == 0 ? ((k / 4) % 2 == 1 ? k : k + 4) : k,
                  (k + 3) / 4 * 4, chunks * row_warps, seed, seed_i};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qbl = (int)qblocks;
  switch (e) {
    case 1: return (int)stopk::launch<1>(p, qbl, chunks, out_s, out_i, st);
    case 2: return (int)stopk::launch<2>(p, qbl, chunks, out_s, out_i, st);
    case 4: return (int)stopk::launch<4>(p, qbl, chunks, out_s, out_i, st);
    case 8: return (int)stopk::launch<8>(p, qbl, chunks, out_s, out_i, st);
    case 16: return (int)stopk::launch<16>(p, qbl, chunks, out_s, out_i, st);
    default: return (int)stopk::launch<32>(p, qbl, chunks, out_s, out_i, st);
  }
}
