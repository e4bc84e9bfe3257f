// fused_xa_xtb: (XA_t, XTB_t) = (X_t @ B1, X_t^T @ B2_t) for every slice t
// of a dense tensor, reading X once.
//
// Replaces the TPU kernel src/repro/kernels/fused_bilinear.py:fused_xa_xtb
// (Pallas grid (m, n1/bm, n2/bn) run in order, which keeps the whole
// (n2, k) XTB panel of a slice resident in VMEM and adds every tile into
// it; ops.py shrinks the tiles to exact divisors and panelizes n2 for
// VMEM).  Hopper runs CTAs in no order and has no VMEM panel, so:
//
//  * One CTA owns one (slice t, BM-row panel) and walks the panel's
//    columns in strips of STRIP.  Each strip of X is staged once in shared
//    memory (rows at a padded pitch of STRIP + 1 floats, so the row-wise
//    and the column-wise walk are both free of bank conflicts; the global
//    loads are coalesced 128-byte row segments, float4 when n2 % 4 == 0).
//    The next strip is loaded into registers while the current one is
//    multiplied.
//  * XA: thread a owns row a of the panel and accumulates its k outputs in
//    registers over all strips, then writes them once.  XA is
//    deterministic.
//  * XTB: each strip gives STRIP finished rows of X_t^T @ B2_t restricted
//    to the panel's rows.  Every warp sums its 32 rows (lane = column),
//    the warps reduce through shared memory, and the sum is added into
//    XTB[t] with fp32 atomicAdd: one atomic per output value per panel.
//    The wrapper allocates XTB with torch.zeros.  The order of the atomic
//    adds changes from run to run, so XTB is NOT deterministic at
//    rounding level; the checks' tolerances say so.  A deterministic
//    variant is on the roadmap.
//  * Ragged tails are masked: rows past n1 and columns past n2 are staged
//    as zeros and never stored.  Offsets are 64-bit (the sweep's X holds
//    8.6e9 values per member set).
//
// Operands are addressed by strides, so the member axis (t = member * m +
// slice) and a per-slice B2 that is the same for every slice (stride 0
// over m, as the distributed engine passes A^(i)) cost no copies.
//
// Bound on an H100: memory.  2k FMAs per 4-byte value of X is k flop per
// byte, below the fp32 ridge (~20 flop/byte) for every k <= 16; the floor
// is bytes(X) / 3.35 TB/s plus the factor reads and the two output writes.
// Reading X once for both products is the point.
#include <cuda_runtime.h>
#include <stdint.h>

namespace dense {

constexpr int BM = 256;           // panel rows per CTA == threads
constexpr int STRIP = 32;         // X columns per staged strip
constexpr int DPAD = STRIP + 1;   // padded row length of a staged strip
constexpr int WARPS = BM / 32;
constexpr int PER_THREAD = BM * STRIP / BM;  // staged floats per thread

struct Shape {
  int m;           // slices per member
  int n1, n2, k;
  long long x_member, x_slice;     // floats; rows of X are contiguous (n2)
  long long b1_member;             // floats; B1 is (n2, k) row-major
  long long b2_member, b2_slice;   // floats; rows of B2 are contiguous (k)
};

// Load strip [s, s + STRIP) of the panel's rows into registers, zeros
// outside (rows, n2).  VEC: eight threads per 128-byte row segment
// (float4); otherwise one warp per row segment.
template <bool VEC>
__device__ __forceinline__ void load_strip(float (&pre)[PER_THREAD],
                                           const float* __restrict__ xp,
                                           int rows, int n2, int s) {
  if (VEC) {
#pragma unroll
    for (int v = 0; v < PER_THREAD / 4; ++v) {
      const int f = threadIdx.x + v * BM;
      const int row = f >> 3;
      const int c = s + (f & 7) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < rows && c < n2) {
        x = __ldg(reinterpret_cast<const float4*>(xp + (long long)row * n2 +
                                                  c));
      }
      pre[4 * v + 0] = x.x;
      pre[4 * v + 1] = x.y;
      pre[4 * v + 2] = x.z;
      pre[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < PER_THREAD; ++v) {
      const int f = threadIdx.x + v * BM;
      const int row = f >> 5;
      const int c = s + (f & 31);
      pre[v] = (row < rows && c < n2) ? __ldg(xp + (long long)row * n2 + c)
                                      : 0.f;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store_strip(float* __restrict__ ds,
                                            const float (&pre)[PER_THREAD]) {
  if (VEC) {
#pragma unroll
    for (int v = 0; v < PER_THREAD / 4; ++v) {
      const int f = threadIdx.x + v * BM;
      float* d = ds + (f >> 3) * DPAD + (f & 7) * 4;
      d[0] = pre[4 * v + 0];
      d[1] = pre[4 * v + 1];
      d[2] = pre[4 * v + 2];
      d[3] = pre[4 * v + 3];
    }
  } else {
#pragma unroll
    for (int v = 0; v < PER_THREAD; ++v) {
      const int f = threadIdx.x + v * BM;
      ds[(f >> 5) * DPAD + (f & 31)] = pre[v];
    }
  }
}

// Dynamic shared memory of one CTA, in floats.
template <int KMAX>
constexpr int smem_floats() {
  return BM * DPAD + STRIP * KMAX + BM * KMAX + WARPS * STRIP * (KMAX + 1);
}

template <int KMAX, bool VEC>
__global__ void __launch_bounds__(BM)
fused_kernel(const float* __restrict__ X, const float* __restrict__ B1,
             const float* __restrict__ B2, float* __restrict__ xa,
             float* __restrict__ xtb, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  float* ds = smem;                      // [BM][DPAD]   the X strip
  float* tile1 = ds + BM * DPAD;         // [STRIP][KMAX] B1 rows of the strip
  float* tile2 = tile1 + STRIP * KMAX;   // [BM][KMAX]   B2_t rows of the panel
  float* red = tile2 + BM * KMAX;        // [WARPS][STRIP][KMAX + 1]

  const int t = blockIdx.y;
  const int member = t / sh.m;
  const int slice = t % sh.m;
  const int row0 = blockIdx.x * BM;
  const int rows = min(BM, sh.n1 - row0);
  const int a = threadIdx.x;
  const int warp = a / 32;
  const int lane = a % 32;
  const int k = sh.k;
  const int n2 = sh.n2;

  const float* xp = X + member * sh.x_member + slice * sh.x_slice +
                    (long long)row0 * n2;
  const float* b1 = B1 + member * sh.b1_member;
  const float* b2 = B2 + member * sh.b2_member + slice * sh.b2_slice +
                    (long long)row0 * k;
  float* xtb_t = xtb + (long long)t * n2 * k;

  // B2_t's panel rows, zero-padded to BM rows and KMAX columns
  for (int f = a; f < BM * KMAX; f += BM) {
    const int r = f / KMAX;
    const int c = f % KMAX;
    tile2[f] = (r < rows && c < k) ? __ldg(b2 + (long long)r * k + c) : 0.f;
  }

  float acc[KMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) acc[c] = 0.f;

  float pre[PER_THREAD];
  load_strip<VEC>(pre, xp, rows, n2, 0);
  for (int s = 0; s < n2; s += STRIP) {
    __syncthreads();  // the previous strip's readers are done
    store_strip<VEC>(ds, pre);
    for (int f = a; f < STRIP * KMAX; f += BM) {
      const int r = f / KMAX;
      const int c = f % KMAX;
      tile1[f] = (s + r < n2 && c < k)
                     ? __ldg(b1 + (long long)(s + r) * k + c) : 0.f;
    }
    __syncthreads();
    if (s + STRIP < n2) load_strip<VEC>(pre, xp, rows, n2, s + STRIP);

    // XA: acc[c] += sum_b X[a][s + b] * B1[s + b][c]
#pragma unroll 4
    for (int b = 0; b < STRIP; ++b) {
      const float d = ds[a * DPAD + b];
      const float4* w4 = reinterpret_cast<const float4*>(tile1 + b * KMAX);
#pragma unroll
      for (int c4 = 0; c4 < KMAX / 4; ++c4) {
        const float4 w = w4[c4];
        acc[4 * c4 + 0] = fmaf(d, w.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = fmaf(d, w.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = fmaf(d, w.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = fmaf(d, w.w, acc[4 * c4 + 3]);
      }
    }

    // XTB row s + lane: this warp's 32 panel rows
    float part[KMAX];
#pragma unroll
    for (int c = 0; c < KMAX; ++c) part[c] = 0.f;
#pragma unroll 4
    for (int r = 0; r < 32; ++r) {
      const int row = warp * 32 + r;
      const float d = ds[row * DPAD + lane];
      const float4* w4 = reinterpret_cast<const float4*>(tile2 + row * KMAX);
#pragma unroll
      for (int c4 = 0; c4 < KMAX / 4; ++c4) {
        const float4 w = w4[c4];
        part[4 * c4 + 0] = fmaf(d, w.x, part[4 * c4 + 0]);
        part[4 * c4 + 1] = fmaf(d, w.y, part[4 * c4 + 1]);
        part[4 * c4 + 2] = fmaf(d, w.z, part[4 * c4 + 2]);
        part[4 * c4 + 3] = fmaf(d, w.w, part[4 * c4 + 3]);
      }
    }
    float* mine = red + (warp * STRIP + lane) * (KMAX + 1);
#pragma unroll
    for (int c = 0; c < KMAX; ++c) mine[c] = part[c];
    __syncthreads();
    const int cols = min(STRIP, n2 - s);
    float* dst = xtb_t + (long long)s * k;
    for (int f = a; f < cols * k; f += BM) {
      const int col = f / k;
      const int c = f % k;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sum += red[(w * STRIP + col) * (KMAX + 1) + c];
      }
      atomicAdd(dst + f, sum);
    }
  }

  if (a < rows) {
    float* o = xa + ((long long)t * sh.n1 + row0 + a) * k;
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c < k) o[c] = acc[c];
    }
  }
}

template <int KMAX, bool VEC>
cudaError_t launch(const float* X, const float* B1, const float* B2,
                   float* xa, float* xtb, int T, Shape sh,
                   cudaStream_t stream) {
  const int smem = smem_floats<KMAX>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<KMAX, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sh.n1 + BM - 1) / BM, T);
  fused_kernel<KMAX, VEC><<<grid, BM, smem, stream>>>(X, B1, B2, xa, xtb, sh);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch_k(const float* X, const float* B1, const float* B2,
                     float* xa, float* xtb, int T, Shape sh, int vec,
                     cudaStream_t stream) {
  return vec ? launch<KMAX, true>(X, B1, B2, xa, xtb, T, sh, stream)
             : launch<KMAX, false>(X, B1, B2, xa, xtb, T, sh, stream);
}

}  // namespace dense

// xa (T, n1, k) = X_t @ B1[t / m];  xtb (T, n2, k) += X_t^T @ B2_t
// (xtb must arrive zeroed), t = member * m + slice, T = members * m.
// Strides are in floats; a member stride of 0 shares the operand across
// members, a B2 slice stride of 0 shares B2 across slices.  vec = 1 when
// n2 % 4 == 0 and every X row starts 16-byte aligned.  Returns the
// launch's cudaError_t.
extern "C" int repro_fused_xa_xtb(const float* X, const float* B1,
                                  const float* B2, float* xa, float* xtb,
                                  int T, int m, int n1, int n2, int k,
                                  long long x_member, long long x_slice,
                                  long long b1_member, long long b2_member,
                                  long long b2_slice, int vec,
                                  void* stream) {
  dense::Shape sh{m, n1, n2, k, x_member, x_slice, b1_member, b2_member,
                  b2_slice};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 4) return (int)dense::launch_k<4>(X, B1, B2, xa, xtb, T, sh, vec, st);
  if (k <= 8) return (int)dense::launch_k<8>(X, B1, B2, xa, xtb, T, sh, vec, st);
  if (k <= 16) return (int)dense::launch_k<16>(X, B1, B2, xa, xtb, T, sh, vec, st);
  if (k <= 32) return (int)dense::launch_k<32>(X, B1, B2, xa, xtb, T, sh, vec, st);
  return (int)dense::launch_k<64>(X, B1, B2, xa, xtb, T, sh, vec, st);
}
