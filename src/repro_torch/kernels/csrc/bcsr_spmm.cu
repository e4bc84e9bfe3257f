// bcsr_spmm: XA_t = X_t @ B for every slice t of a BCSR tensor.
//
// Replaces the TPU kernel src/repro/kernels/bcsr_spmm.py:bcsr_spmm (Pallas
// grid (m, nnzb) accumulating into a VMEM-resident (nb, bs, k) panel).
// Here one CTA owns one (t, block-row i): it walks the contiguous stored
// blocks z in [row_ptr[i], row_ptr[i+1]), stages B[cols[z]] and column
// strips of block z in shared memory, and accumulates its (bs, k) output
// rows in registers.  It writes every row once — an empty block-row
// writes zeros — so the output needs no pre-zeroing, and the order of
// every sum is fixed: the kernel is deterministic.
//
// Bound on an H100: memory.  At k <= 16 the kernel does ~2k flop per
// 4-byte stored value, far below the fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte), so the floor is bytes(stored blocks) /
// 3.35 TB/s plus the B reads and the output write.  Each stored value is
// read from device memory exactly once, with coalesced 16-byte loads.
#include "bcsr_tile.cuh"

namespace bcsr {

template <int KMAX>
__global__ void __launch_bounds__(MAX_BS)
spmm_kernel(const float* __restrict__ data, const int* __restrict__ row_ptr,
            const int* __restrict__ cols, const float* __restrict__ B,
            float* __restrict__ out, Shape sh) {
  extern __shared__ __align__(16) float smem[];
  float* ds = smem;                 // [bs][DPAD]
  float* tile = ds + sh.bs * DPAD;  // [bs][KMAX]

  const int i = blockIdx.x;
  const int t = blockIdx.y;
  const int member = t / sh.m;
  const int slice = t % sh.m;
  const int a = threadIdx.x;
  const long long blk = (long long)sh.bs * sh.bs;
  const long long n_pad = (long long)sh.nb * sh.bs;
  const float* dslice = data + member * sh.data_member_stride +
                        (long long)slice * sh.nnzb * blk;
  const float* b = B + member * sh.b_member_stride;

  for (int f = a; f < sh.bs * KMAX; f += blockDim.x) tile[f] = 0.f;

  float acc[KMAX];
#pragma unroll
  for (int c = 0; c < KMAX; ++c) acc[c] = 0.f;

  const int z0 = row_ptr[i];
  const int z1 = row_ptr[i + 1];
  for (int z = z0; z < z1; ++z) {
    __syncthreads();  // the previous block's readers are done with tile
    load_tile<KMAX>(tile, b + (long long)cols[z] * sh.bs * sh.k, sh.bs, sh.k);
    const float* blkp = dslice + (long long)z * blk;
    for (int s = 0; s < sh.bs; s += STRIP) {
      __syncthreads();  // tile loaded; the previous strip is consumed
      stage_strip(ds, blkp, sh.bs, s);
      __syncthreads();
      row_times_tile<KMAX>(acc, ds, tile, a, s);
    }
  }

  float* o = out + ((long long)t * n_pad + (long long)i * sh.bs + a) * sh.k;
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {
    if (c < sh.k) o[c] = acc[c];
  }
}

template <int KMAX>
cudaError_t launch_spmm(const float* data, const int* row_ptr, const int* cols,
                   const float* B, float* out, int T, Shape sh,
                   cudaStream_t stream) {
  const int smem = smem_floats<KMAX>(sh.bs) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spmm_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(sh.nb, T);
  spmm_kernel<KMAX><<<grid, sh.bs, smem, stream>>>(data, row_ptr, cols, B,
                                                   out, sh);
  return cudaGetLastError();
}

}  // namespace bcsr

// out (T, nb*bs, k) = X_t @ B[t / m] for t < T.  B is (members, nb*bs, k),
// zero-padded to nb*bs rows.  Returns the launch's cudaError_t.
extern "C" int repro_bcsr_spmm(const float* data, const int* row_ptr,
                               const int* cols, const float* B, float* out,
                               int T, int m, int nb, int nnzb, int bs, int k,
                               long long data_member_stride,
                               long long b_member_stride, void* stream) {
  bcsr::Shape sh{m, nb, nnzb, bs, k, data_member_stride, b_member_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
#define BCSR_LAUNCH_SPMM(KM) \
  err = bcsr::launch_spmm<KM>(data, row_ptr, cols, B, out, T, sh, st)
  BCSR_DISPATCH_K(k, BCSR_LAUNCH_SPMM);
#undef BCSR_LAUNCH_SPMM
  return (int)err;
}
