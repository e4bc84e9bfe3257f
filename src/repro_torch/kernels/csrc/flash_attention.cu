// flash_attention: softmax(s) @ v with s = (q @ k^T) * sm_scale, causal or
// not, with grouped KV heads (GQA), a query offset, and the (sq, skv)
// score matrix never written to memory.  This file is the fp32 path; bf16
// runs on the tensor cores in flash_attention_sm90.cu (the wrapper picks
// by dtype).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (Pallas grid (b*hq, sq/bq, skv/bk), the jk axis walked
// in order with (m, l, acc) in VMEM scratch, sq % bq == 0 and skv % bk ==
// 0 asserted).  Here the sequential jk axis is a loop inside the block:
//
//  * One CTA of 256 threads per (query tile of BQ = 64 rows, b*hq).  The
//    Q tile is staged once in shared memory; each key tile of BK = 64
//    keys is staged (K and V) in shared memory, converted to fp32.
//  * Thread (ty, tx) of a 16 x 16 layout owns query rows ty + 16 i
//    (i < 4): S columns tx + 16 j (j < 4) and O columns tx*DC .. tx*DC +
//    DC - 1 (DC = D / 16).  Its rows' (m, l) and (acc) live in registers
//    in fp32; a row's max and sum are reduced over the 16 lanes of a
//    half-warp with shuffles.  P goes through shared memory for P @ V.
//  * The arithmetic of the Pallas body, in its order: s in fp32 (fmaf,
//    ascending d), then * sm_scale; masked entries (q_offset + qi < kj,
//    and keys >= skv) set to -1e30, not -inf; m_cur = max(m_prev,
//    rowmax(s)), alpha = expf(m_prev - m_cur), p = expf(s - m_cur), l =
//    alpha * l + rowsum(p), acc = acc * alpha + (p cast to v's dtype) @ v;
//    out = acc / max(l, 1e-30) with IEEE division (no fast-math flags in
//    the build), cast to q's dtype.
//  * Causal key tiles wholly above the diagonal are skipped: in the
//    Pallas body they leave (m, l, acc) exactly as they were (alpha = 1,
//    p = 0), and key 0 is visible to every row when q_offset >= 0, so the
//    first tile is never fully masked.  The heaviest query tiles launch
//    first.
//  * GQA without copies: query head h reads KV head h / (hq / hkv), as
//    kv_map in the Pallas kernel.  Strides, not copies: every tensor is
//    addressed as (b, h, s, d) through its own (b, h, s) strides, so a
//    permuted (B, S, H, D) view needs no transpose.  Any sq and skv: tail
//    rows are not written, tail keys are masked.  Offsets are 64-bit.
//
// Bound on an H100: operations, 4 * b * hq * sq * skv * d flop (two
// products), about half of it when causal; the ridge is far below the
// work per byte (each query tile re-reads K and V, but K and V of one
// head fit in L2).  This first design runs both products on the fp32
// FMA pipes (67 TFLOP/s peak): float4 shared-memory reads keep it
// FMA-bound rather than bound by shared memory.  The repo keeps TF32 off,
// so fp32 stays off the tensor cores.
#include <cuda_runtime.h>

namespace fa {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int RM = BQ / 16;   // rows per thread
constexpr int CN = BK / 16;   // S columns per thread
constexpr int PP = BK + 4;    // P row pitch (floats)
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, sq, skv;
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
  int causal, q_offset;
  float sm_scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
constexpr int smem_floats() {
  return 2 * BQ * (D + 4) + BK * D + BQ * PP;
}

// DC consecutive floats of a shared-memory row, as wide loads.
template <int DC>
__device__ __forceinline__ void load_cols(const float* p, float (&r)[DC]) {
  if constexpr (DC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < DC; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      r[c] = t.x; r[c + 1] = t.y; r[c + 2] = t.z; r[c + 3] = t.w;
    }
  } else if constexpr (DC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x; r[1] = t.y;
  } else {
    r[0] = p[0];
  }
}

__device__ __forceinline__ float comp(const float4& t, int i) {
  return i == 0 ? t.x : i == 1 ? t.y : i == 2 ? t.z : t.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, D >= 128 ? 1 : 2)
flash_kernel(const Args a) {
  constexpr int DP = D + 4;     // Q/K row pitch: 16-byte rows, few conflicts
  constexpr int DC = D / 16;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [BQ][DP]
  float* sk = sq + BQ * DP;                     // [BK][DP]
  float* sv = sk + BK * DP;                     // [BK][D]
  float* sp = sv + BK * D;                      // [BQ][PP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const T* q = static_cast<const T*>(a.q) + b * a.qb + h * a.qh;
  const T* k = static_cast<const T*>(a.k) + b * a.kb + hk * a.kh;
  const T* v = static_cast<const T*>(a.v) + b * a.vb + hk * a.vh;
  T* o = static_cast<T*>(a.o) + b * a.ob + h * a.oh;
  const int q0 = iq * BQ;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D, qi = q0 + r;
    sq[r * DP + c] = qi < a.sq ? to_f(q[qi * a.qs + c]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][DC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kend = a.skv;
  if (a.causal) {
    const long long last = (long long)a.q_offset + min(q0 + BQ, a.sq) - 1;
    kend = (int)min((long long)a.skv, last + 1);
  }
  const int ntiles = (kend + BK - 1) / BK;

  for (int jt = 0; jt < ntiles; ++jt) {
    const int k0 = jt * BK;
    __syncthreads();  // the last tile's readers are done with sk, sv, sp
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D, kj = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kj < a.skv) {
        kx = to_f(k[kj * a.ks + c]);
        vx = to_f(v[kj * a.vs + c]);
      }
      sk[r * DP + c] = kx;
      sv[r * D + c] = vx;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      float4 qa[RM], kb[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * DP + c);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kb[j] = *reinterpret_cast<const float4*>(sk + (tx + 16 * j) * DP + c);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    float alpha[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const long long qpos = (long long)a.q_offset + q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool seen = kj < a.skv && (!a.causal || qpos >= kj);
        const float x = seen ? s[i][j] * a.sm_scale : NEG_INF;
        s[i][j] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, w));
      const float m_cur = fmaxf(m[i], rmax);
      alpha[i] = expf(m[i] - m_cur);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[i][j] - m_cur);
        rsum += p;
        sp[(ty + 16 * i) * PP + tx + 16 * j] = to_f(from_f<T>(p));
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, w);
      l[i] = __fadd_rn(__fmul_rn(alpha[i], l[i]), rsum);
      m[i] = m_cur;
    }
    __syncthreads();  // P complete

    float pv[RM][DC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) pv[i][c] = 0.f;
#pragma unroll 4
    for (int j = 0; j < BK; j += 4) {
      float4 pa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pa[i] = *reinterpret_cast<const float4*>(sp + (ty + 16 * i) * PP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vr[DC];
        load_cols<DC>(sv + (j + jj) * D + tx * DC, vr);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float p = comp(pa[i], jj);
#pragma unroll
          for (int c = 0; c < DC; ++c) pv[i][c] = fmaf(p, vr[c], pv[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha[i]), pv[i][c]);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = o + qi * a.os + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[c] = from_f<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.sq + BQ - 1) / BQ),
                  (unsigned)(batch * a.hq));
  flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int batch, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(a, batch, stream);
    case 32: return launch<T, 32>(a, batch, stream);
    case 64: return launch<T, 64>(a, batch, stream);
    case 128: return launch<T, 128>(a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fa

// out (b, hq, sq, d) = attention of q (b, hq, sq, d) over k, v (b, hkv,
// skv, d), all float32, each addressed through its (b, h, s) strides in
// elements with a unit d stride.  d in {16, 32, 64, 128}; hq % hkv == 0;
// q_offset >= 0; skv >= 1; b * hq <= 65535.  Returns the launch's
// cudaError_t (0 when sq or b is 0).
extern "C" int repro_flash_attention(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int sq, int skv, int d, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    int causal, int q_offset, float sm_scale, void* stream) {
  if (batch < 0 || sq < 0 || hq < 1 || hkv < 1 || hq % hkv || skv < 1 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  if ((long long)batch * hq > 65535) return (int)cudaErrorInvalidValue;
  fa::Args a{q,  k,  v,  o,  hq, hkv, sq, skv, qb,     qh,       qs,
             kb, kh, ks, vb, vh, vs,  ob, oh,  os, causal, q_offset, sm_scale};
  auto s = static_cast<cudaStream_t>(stream);
  return fa::dispatch<float>(a, batch, d, s);
}
