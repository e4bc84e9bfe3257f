// flash_attention_sm90: the bf16 path of flash_attention on Hopper's
// tensor cores.  softmax(s) @ v with s = (q @ k^T) * sm_scale, causal or
// not, grouped KV heads (GQA), a query offset, any sq and skv, and the
// (sq, skv) score matrix never written to memory.  The fp32 path stays on
// the FMA kernel of flash_attention.cu; the wrapper picks by dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:99
// flash_attention, which runs both products on the matrix unit in bf16
// with fp32 sums (preferred_element_type=float32).
//
// Bound on an H100: operations, 4 * b * hq * d * (visible (query, key)
// pairs) flop at 989 TFLOP/s (bf16 dense tensor cores); each query tile
// re-reads K and V, but one head's K and V fit in L2, so bytes are far
// below it.  What the design does about that bound:
//
//  * Tensor cores.  S = Q K^T is wgmma.mma_async m64n128k16 (bf16 in,
//    fp32 sums) with Q and K from shared memory, both K-major (d
//    contiguous).  O += P V is the register-A form: the fp32 S
//    accumulator, after the softmax, is packed in registers into bf16
//    pairs that are exactly wgmma's A fragment (the accumulator's n8
//    blocks 2kk and 2kk + 1 are k-step kk's A registers), and V is read
//    from shared memory as an MN-major B operand (keys are wgmma's K,
//    d is N and contiguous: imm-trans-b = 1).  P never touches shared
//    memory.
//  * A TMA ring.  One CTA per (128 query rows, b*hq): warpgroups 0 and 1
//    are consumers and own 64 query rows each; warpgroup 2 is the
//    producer, whose one thread loads Q once and then K and V tiles of
//    BK = 128 keys by TMA (4-D maps over (d, s, h, b) with the view's
//    strides) into a ring of STAGES buffers with full / empty mbarriers.
//    setmaxnreg moves registers from the producer (40) to the consumers
//    (232).  The two consumer warpgroups interleave: one's softmax runs
//    under the other's wgmma.
//  * Swizzle.  A tile's rows are d * 2 bytes: 32-, 64- and 128-byte
//    swizzle for d = 16, 32, 64; d = 128 is two 64-column halves, each
//    its own TMA box and 128-byte-swizzled region.  The wgmma
//    descriptors use the same swizzle; every region is 1024-byte aligned.
//  * Tiles: BQ = 128 (two warpgroups of 64 rows) and BK = 128 at every
//    d; 3 stages at d <= 64 (112 KB of shared memory at d = 64), 2 at
//    d = 128 (160 KB).  One CTA per SM.
//  * Online softmax in registers.  A row of the accumulator lies in the 4
//    threads of a quad: its max is reduced with two __shfl_xor_sync; the
//    row sum stays a per-thread partial (alpha is uniform over the quad)
//    and is reduced once at the end.
//  * Causal tiles: key tiles wholly above a query tile's diagonal are
//    skipped (key 0 is visible to every row, so no row's first tile is
//    fully masked), only tiles that cross the diagonal or skv are
//    masked, and the heaviest query tiles launch first (grid.y walks the
//    query tiles from the last; grid.x is b * hq).
//  * Ragged edges: TMA zero-fills rows past sq and skv; keys past skv are
//    masked to -1e30, rows past sq are not stored.
//
// Arithmetic, against the Pallas body: both products sum in fp32; s is
// scaled in fp32 by sm_scale * log2(e), so the softmax runs in exp2 (the
// scale folded into exp2: this bf16 kernel only), masked entries are
// -1e30; m_cur = max(m_prev, rowmax), alpha = exp2(m_prev - m_cur), p =
// exp2(s - m_cur); l = alpha * l + rowsum(p) from the fp32 p; acc = acc *
// alpha + (p rounded to bf16) @ v; out = acc / max(l, 1e-30) rounded to
// bf16.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fa90 {

constexpr int BQ = 128;            // query rows per CTA
constexpr int BK = 128;            // keys per tile
constexpr int CONSUMERS = 2;       // consumer warpgroups, 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int DBOX = D < 64 ? D : 64;   // columns per TMA box
  static constexpr int SW = DBOX * 2;            // swizzle span, bytes
  static constexpr int HALVES = D / DBOX;        // 2 at d = 128
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  // wgmma descriptor layout type: 1 = 128-, 2 = 64-, 3 = 32-byte swizzle
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

struct Args {
  void* o;
  int hq, hkv, sq, skv;
  long long ob, oh, os;
  int causal, q_offset;
  float scale_log2;   // sm_scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator registers across the async
// wgmma window.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define FA_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_F8(d, i) FA_F4(d, i), FA_F4(d, i + 4)
#define FA_F16(d, i) FA_F8(d, i), FA_F8(d, i + 8)
#define FA_F32(d, i) FA_F16(d, i), FA_F16(d, i + 16)
#define FA_F64(d, i) FA_F32(d, i), FA_F32(d, i + 32)

// S (64 x 128, fp32) (+)= A (64 x 16) B (128 x 16)^T, both K-major in
// shared memory.  scale_d = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_F64(d, 0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x N),
// B MN-major in shared memory (imm-trans-b = 1).
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
        "p, 1, 1, 1;\n}\n"
        : FA_F8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : FA_F16(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : FA_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
        "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, "
        "p, 1, 1, 1;\n}\n"
        : FA_F64(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Cfg<D>;
  constexpr int S = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq_s = base, sk_s = base + C::K_OFF, sv_s = base + C::V_OFF;
  const uint32_t bar = base + C::BAR_OFF;
  const uint32_t qfull = bar;
  auto fullk = [&](int s) { return bar + 8u * (1 + s); };
  auto fullv = [&](int s) { return bar + 8u * (1 + S + s); };
  auto empty = [&](int s) { return bar + 8u * (1 + 2 * S + s); };

  const int bh = blockIdx.x;
  const int b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  int kend = a.skv;
  if (a.causal) {
    const long long last = (long long)a.q_offset + min(q0 + BQ, a.sq) - 1;
    kend = (int)min((long long)a.skv, last + 1);
  }
  const int ntiles = (kend + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(fullk(s), 1);
      mbar_init(fullv(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * CONSUMERS) {
      mbar_expect_tx(qfull, C::Q_BYTES);
#pragma unroll
      for (int hf = 0; hf < C::HALVES; ++hf)
        tma_load(&tq, sq_s + hf * BQ * C::SW, qfull, hf * C::DBOX, q0, h, b);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % S;
        mbar_wait(empty(s), ((j / S) & 1) ^ 1);
        mbar_expect_tx(fullk(s), C::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < C::HALVES; ++hf)
          tma_load(&tk, sk_s + s * C::KV_BYTES + hf * BK * C::SW, fullk(s),
                   hf * C::DBOX, j * BK, hk, b);
        mbar_expect_tx(fullv(s), C::KV_BYTES);
#pragma unroll
        for (int hf = 0; hf < C::HALVES; ++hf)
          tma_load(&tv, sv_s + s * C::KV_BYTES + hf * BK * C::SW, fullv(s),
                   hf * C::DBOX, j * BK, hk, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;   // r1 = r0 + 8
    const long long qpos0 = (long long)a.q_offset + r0;
    const long long wg_first = (long long)a.q_offset + q0 + wg * 64;
    const uint32_t qa = sq_s + wg * 64 * C::SW;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float sc[64];
    mbar_wait(qfull, 0);

    for (int j = 0; j < ntiles; ++j) {
      const int s = j % S;
      const uint32_t ph = (j / S) & 1;
      const int k0 = j * BK;

      // S = Q K^T
      mbar_wait(fullk(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int hf = kk * 16 / C::DBOX;
        const uint32_t off = (kk * 16 % C::DBOX) * 2;
        const uint64_t da = desc(qa + hf * BQ * C::SW + off, 16, 8 * C::SW,
                                 C::LAYOUT);
        const uint64_t db = desc(sk_s + s * C::KV_BYTES + hf * BK * C::SW +
                                     off,
                                 16, 8 * C::SW, C::LAYOUT);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // online softmax, in log2 units
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] *= a.scale_log2;
      const bool mask = k0 + BK > a.skv ||
                        (a.causal && (long long)k0 + BK - 1 > wg_first);
      if (mask) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = k0 + (i / 4) * 8 + 2 * (lane & 3) + (i & 1);
          const long long qpos = qpos0 + 8 * ((i >> 1) & 1);
          if (key >= a.skv || (a.causal && key > qpos)) sc[i] = NEG_INF;
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
      }
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
      }
      const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int jn = 0; jn < 16; ++jn) {
        sc[4 * jn] = exp2f(sc[4 * jn] - mx0);
        sc[4 * jn + 1] = exp2f(sc[4 * jn + 1] - mx0);
        sc[4 * jn + 2] = exp2f(sc[4 * jn + 2] - mx1);
        sc[4 * jn + 3] = exp2f(sc[4 * jn + 3] - mx1);
        ls0 += sc[4 * jn] + sc[4 * jn + 1];
        ls1 += sc[4 * jn + 2] + sc[4 * jn + 3];
      }
      l0 = __fadd_rn(__fmul_rn(alpha0, l0), ls0);
      l1 = __fadd_rn(__fmul_rn(alpha1, l1), ls1);
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        o[4 * jn] *= alpha0;
        o[4 * jn + 1] *= alpha0;
        o[4 * jn + 2] *= alpha1;
        o[4 * jn + 3] *= alpha1;
      }
      // P as wgmma A fragments: k-step kk is accumulator blocks 2kk, 2kk+1
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V
      mbar_wait(fullv(s), ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc(sv_s + s * C::KV_BYTES + kk * 16 * C::SW,
                                 BK * C::SW, 8 * C::SW, C::LAYOUT);
        WgmmaRS<D>::run(o, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(s));
    }

#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, w);
      l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    }
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + b * a.ob +
                         h * a.oh;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      const int col = jn * 8 + 2 * (lane & 3);
      if (r0 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(out + r0 * a.os + col) =
            __floats2bfloat162_rn(o[4 * jn] / den0, o[4 * jn + 1] / den0);
      if (r0 + 8 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * a.os + col) =
            __floats2bfloat162_rn(o[4 * jn + 2] / den1,
                                  o[4 * jn + 3] / den1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map over (d, s, h, b) with the view's (s, h, b) strides in
// elements; boxes of (min(d, 64), rows, 1, 1), swizzled to the box's row
// width.  A size-1 axis gets the stride a contiguous tensor would have.
bool make_map(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
              int s, int h, int b, long long ss, long long sh, long long sb,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const long long st[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  cuuint64_t natural = (cuuint64_t)d * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)st[i] * 2 : natural;
    natural = strides[i] * dims[i + 1];
  }
  const int dbox = d < 64 ? d : 64;
  const cuuint32_t box[4] = {(cuuint32_t)dbox, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = dbox == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                : dbox == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                             : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const Args& a, int batch, cudaStream_t stream) {
  const int bytes = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(batch * a.hq),
                  (unsigned)((a.sq + BQ - 1) / BQ));
  flash_sm90<D><<<grid, THREADS, bytes, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace fa90

// out (b, hq, sq, d) bf16 = attention of q (b, hq, sq, d) over k, v (b,
// hkv, skv, d), all bfloat16, each addressed through its (b, h, s)
// strides in elements with a unit d stride.  d in {16, 32, 64, 128}; hq %
// hkv == 0; q_offset >= 0; skv >= 1; b * hq < 2^31; sq <= 65535 * 128.
// TMA: q, k and v 16-byte aligned, their strides on axes longer than 1
// multiples of 8 elements.  Returns the launch's cudaError_t (0 when sq or
// b is 0; cudaErrorInvalidValue for what it does not take, a tensor map
// that cuTensorMapEncodeTiled refuses included).
extern "C" int repro_flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int sq, int skv, int d, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    int causal, int q_offset, float sm_scale, void* stream) {
  if (batch < 0 || sq < 0 || hq < 1 || hkv < 1 || hq % hkv || skv < 1 ||
      q_offset < 0 || (d != 16 && d != 32 && d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  if ((long long)batch * hq > 0x7fffffffLL ||
      (sq + fa90::BQ - 1) / fa90::BQ > 65535)
    return (int)cudaErrorInvalidValue;
  fa90::EncodeTiled fn = fa90::encode_tiled();
  if (!fn) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!fa90::make_map(fn, &tq, q, d, sq, hq, batch, qs, qh, qb, fa90::BQ) ||
      !fa90::make_map(fn, &tk, k, d, skv, hkv, batch, ks, kh, kb, fa90::BK) ||
      !fa90::make_map(fn, &tv, v, d, skv, hkv, batch, vs, vh, vb, fa90::BK))
    return (int)cudaErrorInvalidValue;
  fa90::Args a{o,  hq, hkv, sq, skv, ob, oh, os, causal, q_offset,
               sm_scale * fa90::LOG2E};
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return fa90::launch<16>(tq, tk, tv, a, batch, s);
    case 32: return fa90::launch<32>(tq, tk, tv, a, batch, s);
    case 64: return fa90::launch<64>(tq, tk, tv, a, batch, s);
    default: return fa90::launch<128>(tq, tk, tv, a, batch, s);
  }
}
