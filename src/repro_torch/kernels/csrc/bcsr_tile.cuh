// Pieces of the BCSR product kernel (bcsr_spmm.cu).
//
// Layout (core/sparse.py): stored blocks data[t][z] are (bs, bs) row-major
// float32; the blocks of block-row i are z in [row_ptr[i], row_ptr[i+1]),
// in column order.  The slice axis t = member * m + slice covers the r
// perturbed members of an ensemble; the B operands are indexed by member.
//
// One CTA owns one (t, block-row i) and has bs threads: thread a owns
// output row a of the block-row.  Each stored block is staged through
// shared memory in column strips of STRIP columns (all bs rows), padded
// to STRIP + 1 floats per row so that the row-wise walk (thread a reads
// ds[a][b]) is free of bank conflicts.  The operand's (bs, k) row tiles
// are staged zero-padded to KMAX columns, KMAX a compile-time bound >= k,
// so the inner loops are unrolled and the padding columns are computed
// and never stored.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bcsr {

constexpr int STRIP = 32;         // stored-block columns per staged strip
constexpr int DPAD = STRIP + 1;   // padded row length of a staged strip
constexpr int MAX_BS = 128;       // threads per CTA == bs
constexpr int MAX_K = 64;

struct Shape {
  int m;          // relation slices per member
  int nb;         // block rows (= block cols)
  int nnzb;       // stored blocks per slice
  int bs;         // block size (multiple of 32, <= MAX_BS)
  int k;          // rank (<= MAX_K)
  long long data_member_stride;  // floats between members' data; 0 = shared
  long long b_member_stride;     // floats between members' B; 0 = shared
};

// Copy a contiguous (bs, k) row tile of an operand into a (bs, KMAX)
// shared tile whose columns k..KMAX stay as they were (zeroed once).
template <int KMAX>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int bs, int k) {
  for (int f = threadIdx.x; f < bs * k; f += blockDim.x) {
    dst[(f / k) * KMAX + f % k] = __ldg(src + f);
  }
}

// Stage columns [s, s + STRIP) of a (bs, bs) block: coalesced float4 loads,
// eight threads per 128-byte row segment.
__device__ __forceinline__ void stage_strip(float* __restrict__ ds,
                                            const float* __restrict__ blk,
                                            int bs, int s) {
  constexpr int V = STRIP / 4;  // float4s per strip row
  for (int f = threadIdx.x; f < bs * V; f += blockDim.x) {
    const int row = f / V;
    const int c4 = f % V;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        blk + (long long)row * bs + s + c4 * 4));
    float* d = ds + row * DPAD + c4 * 4;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// acc[c] += sum_{b < STRIP} ds[a][b] * tile[s + b][c]  (the X @ B walk).
template <int KMAX>
__device__ __forceinline__ void row_times_tile(float (&acc)[KMAX],
                                               const float* __restrict__ ds,
                                               const float* __restrict__ tile,
                                               int a, int s) {
#pragma unroll 4
  for (int b = 0; b < STRIP; ++b) {
    const float d = ds[a * DPAD + b];
    const float4* t4 = reinterpret_cast<const float4*>(tile + (s + b) * KMAX);
#pragma unroll
    for (int c4 = 0; c4 < KMAX / 4; ++c4) {
      const float4 w = t4[c4];
      acc[4 * c4 + 0] = fmaf(d, w.x, acc[4 * c4 + 0]);
      acc[4 * c4 + 1] = fmaf(d, w.y, acc[4 * c4 + 1]);
      acc[4 * c4 + 2] = fmaf(d, w.z, acc[4 * c4 + 2]);
      acc[4 * c4 + 3] = fmaf(d, w.w, acc[4 * c4 + 3]);
    }
  }
}

// Dynamic shared memory of one CTA, in floats.
template <int KMAX>
constexpr int smem_floats(int bs) {
  return bs * DPAD + bs * KMAX;
}

// Dispatch a launcher templated on KMAX to the smallest bound >= k.
#define BCSR_DISPATCH_K(k, LAUNCH)      \
  do {                                  \
    if ((k) <= 4) {                     \
      LAUNCH(4);                        \
    } else if ((k) <= 8) {              \
      LAUNCH(8);                        \
    } else if ((k) <= 16) {             \
      LAUNCH(16);                       \
    } else if ((k) <= 32) {             \
      LAUNCH(32);                       \
    } else {                            \
      LAUNCH(64);                       \
    }                                   \
  } while (0)

}  // namespace bcsr
