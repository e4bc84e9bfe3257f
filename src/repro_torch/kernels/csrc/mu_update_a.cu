// mu_update_a: out = A * Num / (A @ S + eps) for every member, without
// writing A @ S to memory.
//
// Replaces the TPU kernel src/repro/kernels/mu_ratio.py:mu_update_a
// (Pallas grid (n / bm,) over row panels of A and Num with the whole
// (k, k) S resident, n % bm == 0 asserted).  Hopper needs no panels for
// this: the work is one output per thread.
//
//  * Block (x, member): THREADS consecutive elements of the member's
//    (n, k) output, row-major.  The member's S (k <= 64, so at most 16 KB)
//    is staged once per block in shared memory; every thread reads its
//    column of S from there.
//  * Thread e = (i, c): den = sum_j A[i, j] * S[j, c] in ascending j with
//    fmaf, in fp32 (the Pallas kernel's preferred_element_type), then
//    A[i, c] * Num[i, c] / (den + eps) in that order, with IEEE division
//    (no fast-math flags in the build).  Masked columns of a padded state
//    (A[:, c] == 0) come out as exact zeros.
//  * Any n: the last block masks its tail; offsets are 64-bit.
//
// Bound on an H100: memory.  Each output reads one value of A and one of
// Num and writes one (12 bytes) for 2k + 2 flop, under the fp32 ridge for
// every k <= 64; the floor is 12 bytes per element over 3.35 TB/s.  The
// neighbouring threads of one row read the same k values of A, which the
// L1 cache serves.
#include <cuda_runtime.h>
#include <limits.h>

namespace mu {

constexpr int THREADS = 256;
constexpr int MAX_K = 64;

__global__ void __launch_bounds__(THREADS)
mu_update_a_kernel(const float* __restrict__ A, const float* __restrict__ num,
                   const float* __restrict__ S, float* __restrict__ out,
                   int n, int k, long long a_member, long long num_member,
                   long long s_member, float eps) {
  __shared__ float s[MAX_K * MAX_K];
  const long long member = blockIdx.y;
  const float* sm = S + member * s_member;
  for (int f = threadIdx.x; f < k * k; f += THREADS) s[f] = sm[f];
  __syncthreads();

  const long long total = (long long)n * k;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const long long i = e / k;
  const int c = (int)(e - i * k);
  const float* a_row = A + member * a_member + i * k;
  float den = 0.f;
  for (int j = 0; j < k; ++j) den = fmaf(__ldg(a_row + j), s[j * k + c], den);
  const float a = __ldg(a_row + c);
  const float x = __ldg(num + member * num_member + e);
  out[member * total + e] = a * x / (den + eps);
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
  if (k < 1 || k > mu::MAX_K) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * k;
  const long long blocks = (total + mu::THREADS - 1) / mu::THREADS;
  if (members <= 0 || blocks <= 0) return 0;
  if (blocks > INT_MAX || members > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (unsigned)members);
  mu::mu_update_a_kernel<<<grid, mu::THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      A, num, S, out, n, k, a_member, num_member, s_member, eps);
  return (int)cudaGetLastError();
}
