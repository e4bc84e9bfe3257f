// mu_update_a: out = A * Num / (A @ S + eps) for every member, without
// writing A @ S to memory.
//
// Replaces the TPU kernel src/repro/kernels/mu_ratio.py:mu_update_a
// (Pallas grid (n / bm,) over row panels of A and Num with the whole
// (k, k) S resident, n % bm == 0 asserted).
//
// Bound on an H100: memory.  Each output reads one value of A and one of
// Num and writes one (12 bytes) for 2k + 2 flop, under the fp32 ridge for
// every k <= 64; the floor is 12 bytes per element over 3.35 TB/s (S is
// k * k floats per member besides).  The design moves each of those bytes
// once, in 16-byte transactions where the alignment allows, with two
// tiles per warp in flight:
//
//  * One thread per row of A.  A warp takes 32 consecutive rows of one
//    member at a time: 32 k contiguous floats of A and of Num, copied into
//    shared memory by cp.async, the next tile's copies issued before the
//    current one is computed (two buffers per warp, cp.async groups, no
//    registers held by data in flight).  Rows of k % 4 == 0 land at a
//    stride ks = k or k + 4 with ks / 4 odd, and the lane reads its row as
//    float4s without bank conflicts; other k copy the range as it lies
//    (16-byte chunks where it is aligned; rows of k = 5 floats are not),
//    read at stride k (conflict-free for odd k).
//  * The member's S (k <= 64, so at most 16 KB) is staged once per CTA,
//    its rows zero-padded to a multiple of 4, and read as float4
//    broadcasts.  The thread holds den[KMAX] in registers (KMAX = 4, 8,
//    16, 32, 64, the least >= k): den[c] = sum_j A[i, j] * S[j, c] in
//    ascending j with fmaf, in fp32 (the Pallas kernel's
//    preferred_element_type), then A[i, c] * Num[i, c] / (den[c] + eps) in
//    that order, with IEEE division (no fast-math flags in the build).
//    Masked columns of a padded state (A[:, c] == 0) come out as exact
//    zeros.  The results overwrite the row in shared memory and leave as
//    coalesced float4 stores.
//  * A grid-stride grid: blockIdx.y is the member, blockIdx.x walks its
//    32-row tiles with about CTAS_PER_SM CTAs per SM in all; row indices
//    inside a member are 32-bit, offsets 64-bit.  No barrier follows the
//    staging of S.
#include <cuda_runtime.h>
#include <stdint.h>

namespace mu {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_K = 64;
constexpr int CTAS_PER_SM = 12;

struct Args {
  const float* A;
  const float* num;
  const float* S;
  float* out;
  int n, k;
  int ks;                 // row stride of a shared tile, in floats
  long long a_member, num_member, s_member;
  float eps;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Floats [0, m) of src, rows of k, into a tile at row stride ks.
template <bool VEC>
__device__ __forceinline__ void copy_in(float* tile, const float* src, int m,
                                        int k, int ks, int lane) {
  const uint32_t d0 = smem_u32(tile);
  if (VEC && aligned16(src)) {            // 16-byte chunks, row by row
    const int kc = k >> 2, step_r = 32 / kc, step_c = 32 % kc;
    int r = lane / kc, c = lane % kc;
    for (int f = lane; f < m >> 2; f += 32) {
      cp_async16(d0 + 4u * (r * ks + 4 * c), src + 4 * f);
      r += step_r;
      c += step_c;
      if (c >= kc) {
        c -= kc;
        ++r;
      }
    }
  } else if (!VEC && aligned16(src)) {    // the range as it lies
    for (int f = 4 * lane; f + 4 <= m; f += 128)
      cp_async16(d0 + 4u * f, src + f);
    for (int f = (m & ~3) + lane; f < m; f += 32)
      cp_async4(d0 + 4u * f, src + f);
  } else {                                // element by element
    for (int f = lane; f < m; f += 32) {
      const int r = f / k;
      cp_async4(d0 + 4u * (r * ks + f - r * k), src + f);
    }
  }
}

// A tile's floats [0, m), rows of k at stride ks, out to dst.
template <bool VEC>
__device__ __forceinline__ void copy_out(float* dst, const float* tile, int m,
                                         int k, int ks, int lane) {
  if (aligned16(dst)) {
    const int kc = k >> 2;
    for (int f = lane; f < m >> 2; f += 32) {
      int at = 4 * f;
      if (VEC) {
        const int r = f / kc;
        at = r * ks + 4 * (f - r * kc);
      }
      reinterpret_cast<float4*>(dst)[f] =
          *reinterpret_cast<const float4*>(tile + at);
    }
    for (int f = (m & ~3) + lane; f < m; f += 32) dst[f] = tile[f];
  } else {
    for (int f = lane; f < m; f += 32) {
      const int r = f / k;
      dst[f] = tile[r * ks + f - r * k];
    }
  }
}

// The row at ar (A, then the output in place) and nr (Num).
template <int KMAX, bool VEC>
__device__ __forceinline__ void update_row(float* ar, const float* nr,
                                           const float* ss, int k, int kv,
                                           float eps) {
  float den[KMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) den[c] = 0.f;
  auto step = [&](float aj, int j) {
    const float4* sj = reinterpret_cast<const float4*>(ss + j * kv);
#pragma unroll
    for (int c4 = 0; c4 < KMAX / 4; ++c4) {
      if (4 * c4 < k) {
        const float4 s4 = sj[c4];
        den[4 * c4] = fmaf(aj, s4.x, den[4 * c4]);
        den[4 * c4 + 1] = fmaf(aj, s4.y, den[4 * c4 + 1]);
        den[4 * c4 + 2] = fmaf(aj, s4.z, den[4 * c4 + 2]);
        den[4 * c4 + 3] = fmaf(aj, s4.w, den[4 * c4 + 3]);
      }
    }
  };
  if (VEC) {
    for (int j = 0; j < k; j += 4) {
      const float4 a4 = *reinterpret_cast<const float4*>(ar + j);
      step(a4.x, j);
      step(a4.y, j + 1);
      step(a4.z, j + 2);
      step(a4.w, j + 3);
    }
#pragma unroll
    for (int c4 = 0; c4 < KMAX / 4; ++c4) {
      if (4 * c4 < k) {
        float4* o = reinterpret_cast<float4*>(ar + 4 * c4);
        const float4 a4 = *o;
        const float4 n4 = *reinterpret_cast<const float4*>(nr + 4 * c4);
        *o = make_float4(a4.x * n4.x / (den[4 * c4] + eps),
                         a4.y * n4.y / (den[4 * c4 + 1] + eps),
                         a4.z * n4.z / (den[4 * c4 + 2] + eps),
                         a4.w * n4.w / (den[4 * c4 + 3] + eps));
      }
    }
  } else {
    for (int j = 0; j < k; ++j) step(ar[j], j);
#pragma unroll
    for (int c = 0; c < KMAX; ++c)
      if (c < k) ar[c] = ar[c] * nr[c] / (den[c] + eps);
  }
}

template <int KMAX, bool VEC>
__global__ void __launch_bounds__(THREADS)
mu_update_a_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  const int k = a.k, ks = a.ks, kv = (k + 3) & ~3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile_f = 32 * ks;
  float* ss = sm;                                  // [k][kv]
  float* buf = sm + k * kv + warp * 4 * tile_f;    // [2][A, Num][32][ks]
  const long long member = blockIdx.y;
  const float* sg = a.S + member * a.s_member;
  for (int f = threadIdx.x; f < k * kv; f += THREADS) {
    const int j = f / kv, c = f - j * kv;
    ss[f] = c < k ? sg[j * k + c] : 0.f;
  }
  __syncthreads();

  const float* a_m = a.A + member * a.a_member;
  const float* n_m = a.num + member * a.num_member;
  float* o_m = a.out + member * (long long)a.n * k;
  const int tiles = (a.n + 31) >> 5;
  const int stride = gridDim.x * WARPS;
  auto issue = [&](int t, int st) {
    const int m = min(32, a.n - 32 * t) * k;
    const long long off = 32ll * t * k;
    float* ta = buf + st * 2 * tile_f;
    copy_in<VEC>(ta, a_m + off, m, k, ks, lane);
    copy_in<VEC>(ta + tile_f, n_m + off, m, k, ks, lane);
    cp_async_commit();
  };
  int t = blockIdx.x * WARPS + warp;
  if (t < tiles) issue(t, 0);
  for (int st = 0; t < tiles; t += stride, st ^= 1) {
    if (t + stride < tiles) {
      issue(t + stride, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int rows = min(32, a.n - 32 * t);
    float* ta = buf + st * 2 * tile_f;
    if (lane < rows)
      update_row<KMAX, VEC>(ta + lane * ks, ta + tile_f + lane * ks, ss, k,
                            kv, a.eps);
    __syncwarp();
    copy_out<VEC>(o_m + 32ll * t * k, ta, rows * k, k, ks, lane);
    __syncwarp();
  }
}

template <int KMAX, bool VEC>
cudaError_t launch(const Args& a, int members, cudaStream_t stream) {
  const int kv = (a.k + 3) & ~3;
  const int smem = 4 * (a.k * kv + WARPS * 4 * 32 * a.ks);
  cudaError_t err;
  if (smem > 48 * 1024) {   // above the default only from k = 23 on
    err = cudaFuncSetAttribute(mu_update_a_kernel<KMAX, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = (a.n + 31) / 32;
  long long grid = (tiles + WARPS - 1) / WARPS;
  const long long fill = (long long)sms * CTAS_PER_SM / members;
  if (grid > fill) grid = fill > 0 ? fill : 1;
  mu_update_a_kernel<KMAX, VEC>
      <<<dim3((unsigned)grid, (unsigned)members), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t launch(const Args& a, int members, cudaStream_t stream) {
  return a.k % 4 == 0 ? launch<KMAX, true>(a, members, stream)
                      : launch<KMAX, false>(a, members, stream);
}

}  // namespace mu

// out (members, n, k) = A * Num / (A @ S + eps), member by member.  A and
// Num have row-major (n, k) members at a_member / num_member floats apart;
// S is (k, k) row-major per member at s_member floats apart (0: shared).
// k <= 64.  Returns the launch's cudaError_t.
extern "C" int repro_mu_update_a(const float* A, const float* num,
                                 const float* S, float* out, int members,
                                 int n, int k, long long a_member,
                                 long long num_member, long long s_member,
                                 float eps, void* stream) {
  if (k < 1 || k > mu::MAX_K || n < 0 || members < 0 || members > 65535)
    return (int)cudaErrorInvalidValue;
  if (members == 0 || n == 0) return 0;
  const mu::Args a{A, num, S, out, n, k,
                   k % 4 == 0 ? ((k / 4) % 2 == 1 ? k : k + 4) : k,
                   a_member, num_member, s_member, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k <= 4) {
    err = mu::launch<4>(a, members, st);
  } else if (k <= 8) {
    err = mu::launch<8>(a, members, st);
  } else if (k <= 16) {
    err = mu::launch<16>(a, members, st);
  } else if (k <= 32) {
    err = mu::launch<32>(a, members, st);
  } else {
    err = mu::launch<64>(a, members, st);
  }
  return (int)err;
}
