// fused_xa_xtb: (XA_t, XTB_t) = (X_t @ B1, X_t^T @ B2_t) for every slice t
// of a dense tensor, reading X once, on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/fused_bilinear.py:fused_xa_xtb
// (Pallas grid (m, n1/bm, n2/bn) run in order, which keeps the whole
// (n2, k) XTB panel of a slice resident in VMEM and adds every tile into
// it).  Hopper runs CTAs in no order and has no VMEM panel.
//
// Bound on an H100: memory.  X, B1 and B2 read once and XA, XTB written
// once over 3.35 TB/s; X is nearly all of it (12.08 GB at the exascale
// share, 34.4 GB at the dense sweep).  What stands in the way is issue:
// the card streams ~0.84e12 values of X a second and its 132 SMs issue
// ~33e12 thread instructions, ~40 per value.  The FP32 FMA design this
// replaces spent ~45 per value at k <= 16 (2 x 16 FMAs padded to a power
// of two, 8 shared loads, staging, a reduction across warps), so it could
// not reach the bound.  This one spends ~11 per value at k <= 8 and ~15
// at k <= 16 (counted from the code below: per value 0.5 shared loads of
// X, 6 to split it for the two products, ~3 mma.sync and ~2 FADDs per 8
// columns of k):
//
//  * Tensor cores in split TF32 ("3xTF32").  Every value x of X, B1 and
//    B2 is split into hi = x rounded to tf32 as cvt.rna rounds and lo = x
//    - hi (exact; the tensor core reads its top 19 bits); each product is
//    lo.hi' + hi.lo' + hi.hi', which keeps fp32-level accuracy (lo.lo' is
//    below fp32's rounding).  The split is an integer add and mask, not
//    cvt.rna: cvt issues at a quarter of the FP32 rate, and two per value
//    held the kernel back on the H100.
//    mma.sync m16n8k8 tf32, k padded to a multiple of 8 (NT = ceil(k / 8)
//    n8 tiles).  The three products of one 8-deep k-step start from zero
//    in the tensor core and the result is added to the fp32 sum with an
//    FADD: the tensor core truncates each accumulation, and a chain of
//    16384 columns inside it loses ~1e-4 (numpy emulation,
//    tests/test_torch_fused_plan.py); one k-step at a time stays near
//    fp32's own rounding.
//  * Why mma.sync and not wgmma: tf32 wgmma takes its shared-memory
//    operands K-major only, and X^T (XTB's A operand) is MN-major in a
//    row-major tile; wgmma with X^T in registers needs the same register
//    fragments mma.sync takes.  At k <= 16 the mma count (0.09 per value
//    of X at k = 10) leaves the kernel bound by its bytes: 80-89% of the
//    bound at k = 4-10 (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3,
//    700.00 W).
//  * An asynchronous copy ring.  Persistent CTAs, one per SM, walk work
//    items (slice t, panel of PANEL rows, chunk of chunk_cols columns) in
//    a fixed order.  An item is streamed as tiles of 64 rows x 128
//    columns, column strip by column strip, the panel's 64-row bands
//    inside each strip.  A producer warp copies every tile into a ring of
//    STAGES shared-memory slots by TMA: four 2-D boxes of 64 rows x 32
//    columns (a 4-D tensor map over X's (n2, n1, m, members) strides, L2
//    evict-first), zeros outside the tensor, plus the band's B2
//    fragments by a 1-D bulk copy (L2 evict-last), completing on the
//    slot's full mbarrier; the consumers release the slot on its empty
//    mbarrier.  One bulk copy per 512-byte row segment instead (64 per
//    tile) could not stream X at the bound: the copies' count, not their
//    bytes, held it back.  Rows not 16-byte aligned (n2 % 4 != 0, or a
//    strided view) take a masked 4-byte cp.async path into the same
//    layout (zero-filled, cp.async.mbarrier.arrive.noinc).  The strip's
//    B1 fragments ride a ring of their own (B1SLOTS).
//  * Shared memory layout.  A box's rows are 128 bytes, its 16-byte quad
//    q of row r stored at q ^ (r % 8) (the TMA's 128-byte swizzle).  XA's
//    fragments are read row-wise (thread (g, t) of a warp reads quads 2t
//    and 2t + 1 of rows g and g + 8) and XTB's column-wise (thread (g, t)
//    reads quad mu(g) of rows t and t + 4); under the swizzle each 8-lane
//    phase of either LDS.128 pattern hits 8 distinct bank groups.  The
//    k-step's columns (XA) or rows (XTB) are permuted inside each
//    fragment so that a thread's values are whole quads; B1's and B2's
//    fragments are split and laid out in the same order by
//    split_operands, one LDS.128 per (k-step, n8 tile).
//  * No reduction across warps.  Of the 8 consumer warps, 4 compute XA
//    (warp a owns rows 16a.. of every band: its XA rows accumulate over
//    all the chunk's columns in its own registers, one set per band) and
//    4 compute XTB (warp x owns box x of every strip: its XTB columns
//    accumulate over all the panel's rows in its own registers).
//  * Fixed order, small workspace.  An item's XA rows are a partial over
//    its chunk and its XTB columns a partial over its panel; each goes to
//    its own slot of a workspace, (T, chunks, n1, k) and (T, panels, n2,
//    k), and reduce_parts sums the slots in order.  A single chunk (or
//    panel) writes XA (or XTB) itself.  XA and XTB are bit-identical
//    from call to call.  The wrapper (kernels/fused_bilinear.py, plan)
//    sizes panels and chunks so that the workspace's write and read stay
//    under 5% of X's bytes at k <= 10 on the sweep's and the exascale
//    share's shapes, and so that the items spread evenly over the 132
//    SMs, a single slice's too.
//
// Operands are addressed by strides (64-bit offsets), so the member axis
// (t = member * m + slice), a slice view of X and a B2 shared by every
// slice (stride 0 over m) cost no copies.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dense {

constexpr int WARPS = 8;                   // 4 XA warps, then 4 XTB warps
constexpr int THREADS = 32 * (WARPS + 1);  // + the producer warp
constexpr int BAND = 64;                   // rows of a staged tile
constexpr int STRIP = 128;                 // columns of a staged tile
constexpr int BOX = 32;                    // columns of one TMA box (128 B)
constexpr int BOXF = BAND * BOX;           // floats of one box
constexpr int SMEM_MAX = 232448;           // bytes a block can use
constexpr int ALIGN = 1024;                // the 128-byte swizzle's period

// Shared memory and tiling of the NT = ceil(k / 8) build, in floats.
template <int NT>
struct Cfg {
  static constexpr int NB = 16 / NT >= 1 ? 16 / NT : 1;  // bands per panel
  static constexpr int PANEL = BAND * NB;
  static constexpr int FRAG = NT * 32 * 4;     // one k-step's (hi, lo) frags
  static constexpr int XTILE = BAND * STRIP;  // STRIP / BOX boxes
  static constexpr int STAGE = XTILE + (BAND / 8) * FRAG;   // X + B2 band
  static constexpr int B1TILE = (STRIP / 8) * FRAG;
  static constexpr int B1SLOTS = NT <= 6 ? 2 : 1;
  static constexpr int BARS = 8 * (2 * 5 + 2 * 2);
  static constexpr int FIXED = 4 * B1SLOTS * B1TILE + BARS + ALIGN;  // bytes
  static constexpr int FIT = (SMEM_MAX - FIXED) / (4 * STAGE);
  static constexpr int STAGES = FIT < 5 ? FIT : 5;           // ring slots
  static constexpr int BYTES = FIXED + 4 * STAGES * STAGE;
  static_assert(STAGES >= 2, "the ring wants two slots");
  static_assert(BYTES <= SMEM_MAX, "over the 227 KB a block can use");
  static_assert(NB * NT <= 16, "XA keeps NB x NT x 4 sums in registers");
};

struct Params {
  const float* X;
  const float* b1s;       // split B1 fragments, per B1 group
  const float* b2s;       // split B2 fragments, per B2 group
  float* xa;              // (T, n1, k)
  float* xtb;             // (T, n2, k)
  float* xa_part;         // (T, chunks, n1, k), or null: one chunk
  float* xtb_part;        // (T, panels, n2, k), or null: one panel
  int T, m, n1, n2, k;
  long long x_member, x_slice;     // floats; X's rows are contiguous (n2)
  long long b1_group, b2_group;    // floats per group of b1s, b2s
  int b1_members;                  // B1 per member (else one group)
  int b2_members, b2_slices;       // B2 per member, per slice
  int panels, chunks, chunk_cols;
  int vec;                         // X by TMA (else 4-byte cp.async)
  int x_members;                   // X per member (else shared)
};

// ---- asynchronous copies and mbarriers -----------------------------------

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

// Wait until the phase of parity `parity` has completed.  A wait of ~2^35
// cycles (~20 s) can only be a fault: trap, so that the launch fails
// instead of hanging the card.
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
    if (done) return;
    if (start < 0)
      start = clock64();
    else if (clock64() - start > (1ll << 35))
      __trap();
  }
}

__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(p));
  return p;
}

// One contiguous global range into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// One (BOX, BAND) box of X at (column c0, row c1, slice c2, member c3)
// into shared memory, 128-byte swizzled, zeros outside the tensor.
__device__ __forceinline__ void tma_box(const CUtensorMap* map, uint32_t dst,
                                        uint32_t bar, int c0, int c1, int c2,
                                        int c3, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar), "l"(policy)
      : "memory");
}

// 4 bytes (or zeros when `size` is 0) into shared memory.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int size) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(size)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// A position in a ring of N slots: use number n takes slot n % N, in
// phase (n / N) & 1 of that slot's barriers.
template <int N>
struct Ring {
  uint32_t n = 0;
  __device__ __forceinline__ int slot() const { return n % N; }
  __device__ __forceinline__ uint32_t phase() const { return (n / N) & 1; }
};

// ---- split TF32 on the tensor cores --------------------------------------

// hi = x rounded to tf32 as cvt.rna.tf32.f32 rounds (10 mantissa bits,
// ties away from zero), by integer add and mask: cvt runs on a pipe a
// quarter as wide, and two cvts per value bounded the kernel.  lo = x -
// hi is exact; the tensor core reads its top 19 bits (toward zero).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d = a @ b + c, one m16n8k8 tf32 product.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1,
                                    const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// sum += lo.hi' + hi.lo' + hi.hi' for one k-step: the three products from
// zero in the tensor core, then one fp32 add per output.  f = the
// (b0 hi, b1 hi, b0 lo, b1 lo) fragment of B.
__device__ __forceinline__ void mma3(float (&sum)[4], const uint32_t (&hi)[4],
                                     const uint32_t (&lo)[4], float4 f) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4], u[4];
  mma(t, lo, __float_as_uint(f.x), __float_as_uint(f.y), zero);
  mma(u, hi, __float_as_uint(f.z), __float_as_uint(f.w), t);
  mma(t, hi, __float_as_uint(f.x), __float_as_uint(f.y), u);
#pragma unroll
  for (int i = 0; i < 4; ++i) sum[i] += t[i];
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// XA over one staged tile: rows 16a + (g, g + 8) of the band (x points at
// the warp's first row of box 0) times the strip's B1 fragments, into
// sum.  K-step s of box q pairs column 32q + 8t + 2s (+ 1) with k-index t
// (t + 4), so the thread's 8 values per row are quads 2t and 2t + 1,
// stored at quad ^ (row % 8) = quad ^ g.
template <int NT>
__device__ __forceinline__ void xa_tile(const float* __restrict__ x,
                                        const float* __restrict__ b1,
                                        float (&sum)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* r0 = x + g * BOX;
  const float* r1 = r0 + 8 * BOX;
  const int o0 = ((2 * t) ^ g) * 4, o1 = ((2 * t + 1) ^ g) * 4;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const float4 p0 = lds4(r0 + q * BOXF + o0), p1 = lds4(r0 + q * BOXF + o1);
    const float4 p2 = lds4(r1 + q * BOXF + o0), p3 = lds4(r1 + q * BOXF + o1);
    const float e0[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
    const float e1[8] = {p2.x, p2.y, p2.z, p2.w, p3.x, p3.y, p3.z, p3.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t hi[4], lo[4];
      split(e0[2 * s], hi[0], lo[0]);
      split(e1[2 * s], hi[1], lo[1]);
      split(e0[2 * s + 1], hi[2], lo[2]);
      split(e1[2 * s + 1], hi[3], lo[3]);
      const float* f = b1 + ((4 * q + s) * NT * 32 + lane) * 4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma3(sum[nt], hi, lo, lds4(f + nt * 128));
    }
  }
}

// XTB over one staged tile: the warp's 32 columns (x points at their box)
// times the band's B2 fragments, into sum[u] for the two m16 tiles u.
// Thread (g, t) reads quad mu(g) of rows 8ks + t and 8ks + t + 4 (stored
// at mu ^ t and mu ^ (t + 4)): m16 tile u takes its columns 4 mu(g) + 2u
// (m-index g) and + 1 (m-index g + 8).
template <int NT>
__device__ __forceinline__ void xtb_tile(const float* __restrict__ x,
                                         const float* __restrict__ b2,
                                         float (&sum)[2][NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int mu = (g >> 1) + 4 * (g & 1);
  const float* c = x + t * BOX;
  const int o0 = (mu ^ t) * 4, o1 = (mu ^ (t + 4)) * 4;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int ks = 4 * h + s;
      const float4 w0 = lds4(c + 8 * ks * BOX + o0);
      const float4 w1 = lds4(c + (8 * ks + 4) * BOX + o1);
      uint32_t hi[2][4], lo[2][4];
      split(w0.x, hi[0][0], lo[0][0]);
      split(w0.y, hi[0][1], lo[0][1]);
      split(w1.x, hi[0][2], lo[0][2]);
      split(w1.y, hi[0][3], lo[0][3]);
      split(w0.z, hi[1][0], lo[1][0]);
      split(w0.w, hi[1][1], lo[1][1]);
      split(w1.z, hi[1][2], lo[1][2]);
      split(w1.w, hi[1][3], lo[1][3]);
      const float* f = b2 + (ks * NT * 32 + lane) * 4;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 fb = lds4(f + nt * 128);
        mma3(sum[0][nt], hi[0], lo[0], fb);
        mma3(sum[1][nt], hi[1], lo[1], fb);
      }
    }
  }
}

// One work item's coordinates.
struct Item {
  int t, panel, chunk;
  int row0, nbv;          // first row, bands holding rows < n1
  int col0, nsv;          // first column, strips holding columns < n2
  const float* x;         // X_t
  int member, slice;
  int g1, g2;             // B1 and B2 groups
  __device__ Item(const Params& p, long long i, int panel_rows) {
    const long long per_t = (long long)p.panels * p.chunks;
    t = (int)(i / per_t);
    const int r = (int)(i - t * per_t);
    panel = r / p.chunks;
    chunk = r % p.chunks;
    row0 = panel * panel_rows;
    nbv = (min(panel_rows, p.n1 - row0) + BAND - 1) / BAND;
    col0 = chunk * p.chunk_cols;
    nsv = (min(p.chunk_cols, p.n2 - col0) + STRIP - 1) / STRIP;
    member = t / p.m;
    slice = t % p.m;
    x = p.X + member * p.x_member + slice * p.x_slice;
    g1 = p.b1_members ? member : 0;
    g2 = (p.b2_members ? member : 0) * (p.b2_slices ? p.m : 1) +
         (p.b2_slices ? slice : 0);
  }
};

// The producer warp's part of one tile: band rows [r0, r0 + BAND) and
// strip columns [c0, c0 + STRIP) of X_t into the slot's four boxes, zeros
// outside (n1, n2), and the band's B2 fragments behind them.  TMA when
// the rows are 16-byte aligned, else one masked 4-byte cp.async per value
// into the same swizzled layout.
__device__ __forceinline__ void fill_tile(const Params& p,
                                          const CUtensorMap* tx,
                                          const Item& it, float* slot,
                                          int xtile, const float* b2src,
                                          int b2bytes, int r0, int c0,
                                          uint32_t full, uint64_t stream,
                                          uint64_t keep, int lane) {
  const uint32_t dst = smem_u32(slot);
  if (p.vec) {
    if (lane == 0) {
      mbar_expect_tx(full, (uint32_t)(xtile * 4 + b2bytes));
      for (int q = 0; q < STRIP / BOX; ++q)
        tma_box(tx, dst + q * BOXF * 4, full, c0 + q * BOX, r0, it.slice,
                p.x_members ? it.member : 0, stream);
      bulk_load(dst + xtile * 4, b2src, b2bytes, full, keep);
    }
    return;
  }
  if (lane == 0) {
    mbar_expect_tx(full, (uint32_t)b2bytes);
    bulk_load(dst + xtile * 4, b2src, b2bytes, full, keep);
  }
  for (int r = 0; r < BAND; ++r) {
    const bool row_ok = r0 + r < p.n1;
    const float* src = it.x + (long long)(row_ok ? r0 + r : 0) * p.n2 + c0;
    for (int c = lane; c < STRIP; c += 32) {
      const bool ok = row_ok && c0 + c < p.n2;
      const int at = (c / BOX) * BOXF + r * BOX +
                     ((((c % BOX) / 4) ^ (r & 7)) * 4) + c % 4;
      cp_async4(dst + at * 4, ok ? src + c : it.x, ok ? 4 : 0);
    }
  }
  cp_async_arrive(full);
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
    fused_kernel(const __grid_constant__ CUtensorMap tx, const Params p) {
  using C = Cfg<NT>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // the ring's boxes start on the swizzle's 1024-byte period
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((ALIGN - smem_u32(smem_raw) % ALIGN) % ALIGN));  // [STAGES][STAGE]
  float* b1ring = ring + C::STAGES * C::STAGE;         // [B1SLOTS][B1TILE]
  const uint32_t bar = smem_u32(b1ring + C::B1SLOTS * C::B1TILE);
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (C::STAGES + s); };
  auto b1full = [&](int s) { return bar + 8u * (2 * C::STAGES + s); };
  auto b1empty = [&](int s) {
    return bar + 8u * (2 * C::STAGES + C::B1SLOTS + s);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      // TMA: one arrival with the bytes; cp.async: that, and one per lane
      mbar_init(full(s), p.vec ? 1 : 33);
      mbar_init(empty(s), WARPS);
    }
    for (int s = 0; s < C::B1SLOTS; ++s) {
      mbar_init(b1full(s), 1);
      mbar_init(b1empty(s), WARPS / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long items = (long long)p.T * p.panels * p.chunks;
  Ring<C::STAGES> xr;
  Ring<C::B1SLOTS> br;

  if (warp == WARPS) {
    // ---- producer: every copy, in the consumers' order
    const uint64_t stream = l2_policy(false), keep = l2_policy(true);
    for (long long i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it(p, i, C::PANEL);
      const float* b1g = p.b1s + it.g1 * p.b1_group;
      const float* b2g = p.b2s + it.g2 * p.b2_group;
      for (int s = 0; s < it.nsv; ++s) {
        const int c0 = it.col0 + s * STRIP;
        mbar_wait(b1empty(br.slot()), br.phase() ^ 1);
        if (lane == 0) {
          mbar_expect_tx(b1full(br.slot()), C::B1TILE * 4);
          bulk_load(smem_u32(b1ring + br.slot() * C::B1TILE),
                    b1g + (long long)(c0 / 8) * C::FRAG, C::B1TILE * 4,
                    b1full(br.slot()), keep);
        }
        ++br.n;
        for (int b = 0; b < it.nbv; ++b) {
          const int r0 = it.row0 + b * BAND;
          mbar_wait(empty(xr.slot()), xr.phase() ^ 1);
          fill_tile(p, &tx, it, ring + xr.slot() * C::STAGE, C::XTILE,
                    b2g + (long long)(r0 / 8) * C::FRAG,
                    (BAND / 8) * C::FRAG * 4, r0, c0, full(xr.slot()),
                    stream, keep, lane);
          ++xr.n;
        }
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  if (warp < WARPS / 2) {
    // ---- XA: rows 16a.. of every band, summed over the chunk's columns
    const int a = warp;
    for (long long i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it(p, i, C::PANEL);
      float sum[C::NB][NT][4];
#pragma unroll
      for (int b = 0; b < C::NB; ++b)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[b][nt][e] = 0.f;
      for (int s = 0; s < it.nsv; ++s) {
        mbar_wait(b1full(br.slot()), br.phase());
        const float* b1 = b1ring + br.slot() * C::B1TILE;
#pragma unroll
        for (int b = 0; b < C::NB; ++b) {
          if (b < it.nbv) {
            mbar_wait(full(xr.slot()), xr.phase());
            xa_tile<NT>(ring + xr.slot() * C::STAGE + 16 * a * BOX, b1,
                        sum[b], lane);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(xr.slot()));
            ++xr.n;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(b1empty(br.slot()));
        ++br.n;
      }
      float* out = p.xa_part
                       ? p.xa_part + ((long long)it.t * p.chunks + it.chunk) *
                                         p.n1 * p.k
                       : p.xa + (long long)it.t * p.n1 * p.k;
#pragma unroll
      for (int b = 0; b < C::NB; ++b) {
        if (b < it.nbv) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = it.row0 + b * BAND + 16 * a + g + 8 * h;
            if (row >= p.n1) continue;
            float* o = out + (long long)row * p.k;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int c = 8 * nt + 2 * t;
              if (c < p.k) o[c] = sum[b][nt][2 * h];
              if (c + 1 < p.k) o[c + 1] = sum[b][nt][2 * h + 1];
            }
          }
        }
      }
    }
  } else {
    // ---- XTB: columns 32x.. of every strip, summed over the panel's rows
    const int x = warp - WARPS / 2;
    const int mu = (g >> 1) + 4 * (g & 1);
    for (long long i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it(p, i, C::PANEL);
      float* out = p.xtb_part
                       ? p.xtb_part + ((long long)it.t * p.panels + it.panel) *
                                          p.n2 * p.k
                       : p.xtb + (long long)it.t * p.n2 * p.k;
      for (int s = 0; s < it.nsv; ++s) {
        float sum[2][NT][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sum[u][nt][e] = 0.f;
        for (int b = 0; b < it.nbv; ++b) {
          mbar_wait(full(xr.slot()), xr.phase());
          const float* slot = ring + xr.slot() * C::STAGE;
          xtb_tile<NT>(slot + x * BOXF, slot + C::XTILE, sum, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty(xr.slot()));
          ++xr.n;
        }
        const int col = it.col0 + s * STRIP + 32 * x + 4 * mu;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cc = col + 2 * u + h;
            if (cc >= p.n2) continue;
            float* o = out + (long long)cc * p.k;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int c = 8 * nt + 2 * t;
              if (c < p.k) o[c] = sum[u][nt][2 * h];
              if (c + 1 < p.k) o[c + 1] = sum[u][nt][2 * h + 1];
            }
          }
        }
      }
    }
  }
}

// B1's and B2's (hi, lo) fragments in the consumers' order, zero past n2
// (B1 rows), n1 (B2 rows) and k.  Group layout: [k-step][nt][lane][4] =
// (b0 hi, b1 hi, b0 lo, b1 lo) with n = 8 nt + g for lane (g, t); B1's
// k-step KS = 4Q + s holds rows 32Q + 8t + 2s and + 1, B2's k-step KS rows
// 8 KS + t and + 4.
struct SplitParams {
  const float* B1;
  const float* B2;
  float* b1s;
  float* b2s;
  int m, n1, n2, k, nt;
  int g1, g2;                       // groups
  int b2_slices;                    // B2 groups per member (1 or m)
  long long b1_member, b2_member, b2_slice;
  long long ks1, ks2;               // k-steps per group (n2p / 8, n1p / 8)
};

__global__ void __launch_bounds__(256) split_operands(const SplitParams a) {
  const long long per1 = a.ks1 * a.nt * 32, per2 = a.ks2 * a.nt * 32;
  const long long total1 = a.g1 * per1, total = total1 + a.g2 * per2;
  for (long long f = blockIdx.x * 256ll + threadIdx.x; f < total;
       f += (long long)gridDim.x * 256) {
    const bool one = f < total1;
    const long long e = one ? f : f - total1;
    const long long per = one ? per1 : per2;
    const int grp = (int)(e / per);
    const long long r = e - grp * per;
    const int lane = (int)(r % 32);
    const int nt = (int)(r / 32 % a.nt);
    const long long ks = r / (32 * a.nt);
    const int g = lane >> 2, t = lane & 3;
    const int n = 8 * nt + g;
    const float* src;
    long long row0, row1;
    int rows;
    if (one) {
      src = a.B1 + grp * a.b1_member;
      row0 = 32 * (ks / 4) + 8 * t + 2 * (ks % 4);
      row1 = row0 + 1;
      rows = a.n2;
    } else {
      src = a.B2 + grp / a.b2_slices * a.b2_member +
            grp % a.b2_slices * a.b2_slice;
      row0 = 8 * ks + t;
      row1 = row0 + 4;
      rows = a.n1;
    }
    const float v0 = (row0 < rows && n < a.k) ? src[row0 * a.k + n] : 0.f;
    const float v1 = (row1 < rows && n < a.k) ? src[row1 * a.k + n] : 0.f;
    uint32_t h0, l0, h1, l1;
    split(v0, h0, l0);
    split(v1, h1, l1);
    *reinterpret_cast<float4*>((one ? a.b1s : a.b2s) + e * 4) =
        make_float4(__uint_as_float(h0), __uint_as_float(h1),
                    __uint_as_float(l0), __uint_as_float(l1));
  }
}

// xa[t][e] = the sum over chunks c, in order, of xa_part[t][c][e]; xtb the
// same over panels.  A null part is skipped.
__global__ void __launch_bounds__(256)
reduce_parts(const float* __restrict__ xa_part, float* __restrict__ xa,
             const float* __restrict__ xtb_part, float* __restrict__ xtb,
             int T, long long na, long long nb, int chunks, int panels) {
  const long long ta = xa_part ? T * na : 0, tb = xtb_part ? T * nb : 0;
  for (long long f = blockIdx.x * 256ll + threadIdx.x; f < ta + tb;
       f += (long long)gridDim.x * 256) {
    const bool one = f < ta;
    const long long e = one ? f : f - ta;
    const long long per = one ? na : nb;
    const int parts = one ? chunks : panels;
    const long long t = e / per;
    const float* src = (one ? xa_part : xtb_part) + t * parts * per +
                       (e - t * per);
    float sum = 0.f;
    for (int c = 0; c < parts; ++c) sum += __ldg(src + c * per);
    (one ? xa : xtb)[e] = sum;
  }
}

inline int grid_for(long long total) {
  const long long blocks = (total + 255) / 256;
  return (int)(blocks < 8192 ? blocks : 8192);
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

// X as a 4-D fp32 map over (n2, n1, m, members) with its strides in
// floats (members 1 when X is shared by them); boxes of (32, 64, 1, 1),
// 128-byte swizzled, zeros out of bounds.  A size-1 axis gets the stride
// a contiguous tensor would have.
bool make_map(EncodeTiled fn, CUtensorMap* map, const Params& p) {
  const cuuint64_t dims[4] = {(cuuint64_t)p.n2, (cuuint64_t)p.n1,
                              (cuuint64_t)p.m,
                              (cuuint64_t)(p.x_members ? p.T / p.m : 1)};
  const long long st[3] = {p.n2, p.x_slice, p.x_member};
  cuuint64_t strides[3];
  cuuint64_t natural = (cuuint64_t)p.n2 * 4;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)st[i] * 4 : natural;
    natural = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {BOX, BAND, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
            const_cast<float*>(p.X), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT>
cudaError_t launch_main(const CUtensorMap& tx, const Params& p,
                        int panel_rows, int grid, cudaStream_t stream) {
  using C = Cfg<NT>;
  if (panel_rows != C::PANEL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::BYTES);
  if (err != cudaSuccess) return err;
  fused_kernel<NT><<<grid, THREADS, C::BYTES, stream>>>(tx, p);
  return cudaGetLastError();
}

}  // namespace dense

// xa (T, n1, k) = X_t @ B1[t / m];  xtb (T, n2, k) = X_t^T @ B2_t, both in
// a fixed order, t = member * m + slice, T = members * m.  b1s, b2s,
// xa_part and xtb_part are the sections of the workspace that
// kernels/fused_bilinear.py (plan) sizes: the split fragments of B1 (one
// group, or one per member when b1_member != 0) and of B2 (per member
// when b2_member != 0, times per slice when b2_slice != 0), each group
// padded to round_up(n2, 128) (B1) or round_up(n1, 64) (B2) rows; the
// chunk partials of XA and the panel partials of XTB (null for one chunk
// or one panel).  panel_rows must be this k's build (64 * max(1, 16 /
// ceil(k / 8))), chunk_cols a multiple of 128; grid CTAs walk the T *
// panels * chunks items.  Strides are in floats.  vec = 1 when n2 % 4 ==
// 0 and every X row starts 16-byte aligned.  Returns the first launch's
// failing cudaError_t, or 0.
extern "C" int repro_fused_xa_xtb(
    const float* X, const float* B1, const float* B2, float* xa, float* xtb,
    float* b1s, float* b2s, float* xa_part, float* xtb_part, int T, int m,
    int n1, int n2, int k, long long x_member, long long x_slice,
    long long b1_member, long long b2_member, long long b2_slice, int vec,
    int panel_rows, int chunk_cols, int grid, void* stream) {
  using namespace dense;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 64 || chunk_cols % STRIP || chunk_cols <= 0 ||
      panel_rows <= 0 || grid <= 0 || T <= 0 || n1 <= 0 || n2 <= 0)
    return (int)cudaErrorInvalidValue;
  const int nt = (k + 7) / 8;
  const int members = T / m;
  const int g1 = b1_member ? members : 1;
  const int b2_slices = b2_slice ? m : 1;
  const int g2 = (b2_member ? members : 1) * b2_slices;
  const long long ks1 = (n2 + STRIP - 1) / STRIP * (STRIP / 8);
  const long long ks2 = (n1 + BAND - 1) / BAND * (BAND / 8);
  SplitParams sp{B1, B2, b1s, b2s, m, n1, n2, k, nt, g1, g2, b2_slices,
                 b1_member, b2_member, b2_slice, ks1, ks2};
  split_operands<<<grid_for((g1 * ks1 + g2 * ks2) * nt * 32), 256, 0, st>>>(
      sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int panels = (n1 + panel_rows - 1) / panel_rows;
  const int chunks = (n2 + chunk_cols - 1) / chunk_cols;
  Params p{X, b1s, b2s, xa, xtb,
           chunks > 1 ? xa_part : nullptr, panels > 1 ? xtb_part : nullptr,
           T, m, n1, n2, k, x_member, x_slice,
           ks1 * nt * 128, ks2 * nt * 128,
           b1_member != 0, b2_member != 0, b2_slice != 0,
           panels, chunks, chunk_cols, vec, x_member != 0};
  CUtensorMap tx = {};
  if (vec) {
    EncodeTiled fn = encode_tiled();
    if (!fn) return (int)cudaErrorSymbolNotFound;
    if (!make_map(fn, &tx, p)) return (int)cudaErrorInvalidValue;
  }
  switch (nt) {
    case 1: err = launch_main<1>(tx, p, panel_rows, grid, st); break;
    case 2: err = launch_main<2>(tx, p, panel_rows, grid, st); break;
    case 3: err = launch_main<3>(tx, p, panel_rows, grid, st); break;
    case 4: err = launch_main<4>(tx, p, panel_rows, grid, st); break;
    case 5: err = launch_main<5>(tx, p, panel_rows, grid, st); break;
    case 6: err = launch_main<6>(tx, p, panel_rows, grid, st); break;
    case 7: err = launch_main<7>(tx, p, panel_rows, grid, st); break;
    default: err = launch_main<8>(tx, p, panel_rows, grid, st); break;
  }
  if (err != cudaSuccess || (chunks == 1 && panels == 1)) return (int)err;
  const long long na = (long long)n1 * k, nb = (long long)n2 * k;
  const long long total = (chunks > 1 ? T * na : 0) + (panels > 1 ? T * nb : 0);
  reduce_parts<<<grid_for(total), 256, 0, st>>>(p.xa_part, xa, p.xtb_part,
                                                xtb, T, na, nb, chunks, panels);
  return (int)cudaGetLastError();
}
