// bcsr_xa_xta: (XA_t, XTB_t) = (X_t @ B1, X_t^T @ B2) for every slice t of
// a BCSR tensor, reading each stored block once.
//
// Replaces the TPU kernel src/repro/kernels/bcsr_fused.py:bcsr_xa_xta
// (Pallas grid (m, nnzb) that accumulates both products into two
// VMEM-resident (nb, bs, k) panels, zeroed at z == 0).  Hopper runs CTAs in
// no order, so nothing carries from one grid step to the next: the work is
// cut into units, one per (slice t, block-row i), each walking its stored
// blocks z in [row_ptr[i], row_ptr[i+1]) in column order.
//
// Bound on an H100: memory.  ~4k flop per 4-byte stored value is far below
// the fp32 ridge at the sweep's k <= 8, so the floor is the stored blocks'
// bytes over 3.35 TB/s (plus the B reads and the two output writes).  What
// the design does about it:
//
//  * A copy ring.  Persistent CTAs, one per SM, each take a contiguous
//    range of units balanced by stored blocks (a binary search over
//    t * nnzb + row_ptr[i]).  One producer thread streams every stored
//    block as strips of up to 64 rows (32 KB at bs = 128, one contiguous
//    range) into a STAGES-deep ring with 1-D bulk copies
//    (cp.async.bulk ... mbarrier::complete_tx, L2 evict-first), so up to
//    160 KB per SM are in flight.  The block's B1 tile (B1[cols[z]], bs x
//    KC) rides a TILES-deep ring and the unit's B2 tile a 2-deep one (L2
//    evict-last: the factors stay in L2 while the stored blocks stream
//    past).  Eight consumer warps compute; full / empty mbarriers pass the
//    slots between them and the producer.
//  * Each stored value crosses shared memory once.  The copy engine writes
//    it; one consumer thread reads it once, as part of a float4, into
//    registers that feed both products.  Consumer thread (p, q) owns rows
//    p + 16 r of every block (r < bs / 16) and the 4-column chunks q and
//    q + 16; the 8 lanes of a quarter-warp read 8 consecutive chunks of one
//    row (128 contiguous bytes: no bank conflict).  Per row and chunk it
//    does XA[row] += d . B1[chunk's 4 rows] and XTB[chunk's 4 cols] += d *
//    B2[row]: KC FMAs per value for each product.
//  * Registers.  XA partials (8 rows x KC) stay in registers for the whole
//    unit and are reduced once at its end (shuffles over the 8 chunk lanes,
//    then the two chunk halves through shared memory, in a fixed order):
//    XA is deterministic and written once, zeros for an empty block-row.
//    The chunk passes run one after the other over the block's strips
//    (both held in the ring until the second pass), so only one pass's XTB
//    partials (4 cols x KC) are live: they cover the thread's rows of the
//    whole block and are reduced once per block and column: shuffles over
//    the 4 row lanes of a warp, then the 4 warps that share the chunk
//    through shared memory in a fixed order.  The block's finished (bs, KC)
//    X^T partial goes out to a workspace, (T, nnzb, bs, KC), one float4
//    store per 4 outputs, at the block's own place: no two CTAs write the
//    same bytes.
//  * XTB in a fixed order.  A second kernel (xtb_reduce_kernel), one CTA
//    per (slice, block-column j), sums j's partials in block-row order
//    (the transposed index col_ptr / col_z, built once per pattern by the
//    wrapper, core/sparse.py BCSR.col_index) and writes XTB's (bs, KC)
//    tile once; a block-column with no stored block gets zeros.  So XTB is
//    bit-identical from call to call, like XA.  The workspace costs one
//    write and one read of T * nnzb * bs * KC floats (0.8 GB at the
//    sweep's k = 5) on top of the stored blocks' 3.2 GB.  The wrapper pads
//    XTB's rows to a multiple of 4 columns so that every store is a vector
//    one.
//  * Swizzle.  The B tiles arrive by bulk copy too, so their shared layout
//    is the global one, fixed by the wrapper (kernels/bcsr_fused.py
//    operand_tiles): in each (bs, KC) row tile the 16-byte slot s lies at
//    s ^ ((s >> 3) & 7).  The 8 lanes of a quarter-warp reading their
//    chunks' B1 rows, and the 4 quarter-warps reading 4 rows of B2, then hit
//    distinct banks.  The XTB scratch uses the same swizzle.
//  * FP32 FMA only (no TF32: device.strict_fp32).  Two builds: KC = 4
//    columns (k <= 4) and KC = 8 (k >= 5); k > 8 runs the KC = 8 kernel once
//    per 8-column slice of B, reading the stored blocks ceil(k / 8) times.
#include <cuda_runtime.h>
#include <stdint.h>

namespace bcsr_xa {

constexpr int MAX_BS = 128;
constexpr int WARPS = 8;                     // consumer warps
constexpr int CONSUMERS = 32 * WARPS;        // 256
constexpr int THREADS = CONSUMERS + 32;      // + the producer warp
constexpr int STRIP = 64;                    // rows per ring slot
constexpr int STAGES = 5;                    // ring slots of stored data
constexpr int TILES = 3;                     // B1 tiles in flight
constexpr int RMAX = MAX_BS / 16;            // rows per consumer thread
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of one CTA, in bytes, for KC columns per slice.
template <int KC>
struct Smem {
  static constexpr int TILE = MAX_BS * KC * 4;                  // one B tile
  static constexpr int RING = 0;
  static constexpr int B1 = RING + STAGES * STRIP * MAX_BS * 4;
  static constexpr int B2 = B1 + TILES * TILE;
  static constexpr int XT = B2 + 2 * TILE;                     // 2 x 4 warps
  static constexpr int XA = XT + 2 * 4 * TILE;                 // 2 x (16, 8)
  static constexpr int BAR = XA + 2 * 16 * RMAX * KC * 4;
  static constexpr int NBAR = 2 * STAGES + 2 * TILES + 4;
  static constexpr int RANGE = BAR + 8 * NBAR;
  static constexpr int BYTES = RANGE + 16;
  static_assert(BYTES <= 232448, "over the 227 KB a block can use");
};

struct Params {
  const float* data;       // ([members,] m, nnzb, bs, bs)
  const int* row_ptr;      // (nb + 1)
  const int* cols;         // (nnzb)
  const float* b1;         // this k-slice's tiles, (members, nb * bs, KC)
  const float* b2;
  float* xa;               // (T, nb * bs, k)
  float* xtb;              // (T, nb * bs, kt)
  float* part;             // (T, nnzb, bs, KC): each block's X^T partial
  int T, m, nb, nnzb, bs;
  int k;                   // columns of xa (and its row stride)
  int kt;                  // row stride of xtb, a multiple of 4 >= k
  int k0, kn;              // this slice's first column and its width
  long long data_member_stride;   // floats; 0 = shared data
  long long b_member_stride;      // floats; 0 = shared operand
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// A position in a ring of N slots: use number n takes slot n % N, in
// phase (n / N) & 1 of that slot's barriers.
template <int N>
struct Ring {
  uint32_t n = 0;
  __device__ __forceinline__ int slot(uint32_t ahead = 0) const {
    return (n + ahead) % N;
  }
  __device__ __forceinline__ uint32_t phase(uint32_t ahead = 0) const {
    return ((n + ahead) / N) & 1;
  }
};

// The 16-byte slot where logical slot s of a tile lies.
__device__ __forceinline__ int swz(int s) { return s ^ ((s >> 3) & 7); }

__device__ __forceinline__ float4 tile_slot(const float* tile, int s) {
  return *reinterpret_cast<const float4*>(tile + 4 * swz(s));
}

// One step of a reduce-scatter over the lanes `mask` apart: of v[0, 2H),
// the lane with `mask` set keeps the upper half, the other the lower one,
// each summed with its partner's copy, into v[0, H).
template <int H, int N>
__device__ __forceinline__ void halve(float (&v)[N], int mask, int lane) {
  static_assert(2 * H <= N, "halve reads v[0, 2H)");
  const bool up = lane & mask;
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const float send = up ? v[e] : v[e + H];
    const float keep = up ? v[e + H] : v[e];
    v[e] = keep + __shfl_xor_sync(FULL, send, mask);
  }
}

// out[c0 .. c0 + 3] = x, for the columns below kn: a float4 when the row
// stride k allows it, else scalars.
__device__ __forceinline__ void store4(float* out, float4 x, int c0, int kn,
                                       int k) {
  if (c0 >= kn) return;
  if (k % 4 == 0) {
    *reinterpret_cast<float4*>(out + c0) = x;
    return;
  }
  const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c0 + e < kn) out[c0 + e] = v[e];
}

// Smallest unit u in [0, T * nb] whose first stored block
// t * nnzb + row_ptr[i] (u = t * nb + i) is at or past x.
__device__ long long first_unit(long long x, const Params& a) {
  long long lo = 0, hi = (long long)a.T * a.nb;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    const long long t = mid / a.nb;
    const long long c = t * a.nnzb + a.row_ptr[mid - t * a.nb];
    if (c >= x)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

template <int KC>
__global__ void __launch_bounds__(THREADS, 1) xa_xta_kernel(const Params a) {
  using S = Smem<KC>;
  constexpr int NH = KC / 4;             // 16-byte slots per tile row
  extern __shared__ __align__(128) uint8_t smem[];
  float* ring = reinterpret_cast<float*>(smem + S::RING);
  float* b1s = reinterpret_cast<float*>(smem + S::B1);
  float* b2s = reinterpret_cast<float*>(smem + S::B2);
  float* xts = reinterpret_cast<float*>(smem + S::XT);
  float* xas = reinterpret_cast<float*>(smem + S::XA);
  long long* range = reinterpret_cast<long long*>(smem + S::RANGE);
  const uint32_t bar = smem_u32(smem + S::BAR);
  auto dfull = [&](int s) { return bar + 8u * s; };
  auto dempty = [&](int s) { return bar + 8u * (STAGES + s); };
  auto tfull = [&](int s) { return bar + 8u * (2 * STAGES + s); };
  auto tempty = [&](int s) { return bar + 8u * (2 * STAGES + TILES + s); };
  auto ufull = [&](int s) { return bar + 8u * (2 * STAGES + 2 * TILES + s); };
  auto uempty = [&](int s) {
    return bar + 8u * (2 * STAGES + 2 * TILES + 2 + s);
  };
  constexpr int TILE_F = MAX_BS * KC;    // floats per tile slot

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(dfull(s), 1);
      mbar_init(dempty(s), WARPS);
    }
    for (int s = 0; s < TILES; ++s) {
      mbar_init(tfull(s), 1);
      mbar_init(tempty(s), WARPS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(ufull(s), 1);
      mbar_init(uempty(s), WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x == 32 || threadIdx.x == 64) {
    // this CTA's units: a contiguous range holding ~1/gridDim of the blocks
    const int c = blockIdx.x + (threadIdx.x == 64);
    const long long total = (long long)a.T * a.nnzb;
    range[threadIdx.x == 64] = c == (int)gridDim.x
                                   ? (long long)a.T * a.nb
                                   : first_unit(total * c / gridDim.x, a);
  }
  __syncthreads();
  const long long u_begin = range[0], u_end = range[1];
  const long long blk = (long long)a.bs * a.bs;
  const long long n_pad = (long long)a.nb * a.bs;
  const int nstrips = (a.bs + STRIP - 1) / STRIP;
  const uint32_t tile_bytes = (uint32_t)(a.bs * KC * 4);

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread issues every copy, in the consumers' order
    if (threadIdx.x != CONSUMERS) return;
    const uint64_t stream = l2_policy(false), keep = l2_policy(true);
    Ring<STAGES> dr;
    Ring<TILES> tr;
    Ring<2> ur;
    for (long long u = u_begin; u < u_end; ++u) {
      const int t = (int)(u / a.nb), i = (int)(u % a.nb);
      const int member = t / a.m, slice = t % a.m;
      const float* b1 = a.b1 + member * a.b_member_stride;
      const float* b2 = a.b2 + member * a.b_member_stride;
      const float* dt = a.data + member * a.data_member_stride +
                        (long long)slice * a.nnzb * blk;
      mbar_wait(uempty(ur.slot()), ur.phase() ^ 1);
      mbar_expect_tx(ufull(ur.slot()), tile_bytes);
      bulk_load(smem_u32(b2s + ur.slot() * TILE_F),
                b2 + (long long)i * a.bs * KC, tile_bytes, ufull(ur.slot()),
                keep);
      ++ur.n;
      const int z1 = a.row_ptr[i + 1];
      for (int z = a.row_ptr[i]; z < z1; ++z) {
        const int j = a.cols[z];
        mbar_wait(tempty(tr.slot()), tr.phase() ^ 1);
        mbar_expect_tx(tfull(tr.slot()), tile_bytes);
        bulk_load(smem_u32(b1s + tr.slot() * TILE_F),
                  b1 + (long long)j * a.bs * KC, tile_bytes,
                  tfull(tr.slot()), keep);
        ++tr.n;
        for (int st = 0; st < nstrips; ++st) {
          const int rows = min(STRIP, a.bs - st * STRIP);
          const uint32_t bytes = (uint32_t)(rows * a.bs * 4);
          mbar_wait(dempty(dr.slot()), dr.phase() ^ 1);
          mbar_expect_tx(dfull(dr.slot()), bytes);
          bulk_load(smem_u32(ring + dr.slot() * STRIP * MAX_BS),
                    dt + z * blk + (long long)st * STRIP * a.bs, bytes,
                    dfull(dr.slot()), stream);
          ++dr.n;
        }
      }
    }
    return;
  }

  // ---- consumers ----
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qlo = lane & 7, pl = lane >> 3;
  const int p = 4 * (w & 3) + pl;       // rows p + 16 r
  const int qhi = w >> 2;               // chunks qlo + 8 qhi (+ 16)
  const int chunks = a.bs / 4;          // a multiple of 8
  Ring<STAGES> dr;
  Ring<TILES> tr;
  Ring<2> ur;

  int nz0 = 0, nz1 = 0;                 // the next unit's blocks, loaded early
  if (u_begin < u_end) {
    const int i = (int)(u_begin % a.nb);
    nz0 = a.row_ptr[i];
    nz1 = a.row_ptr[i + 1];
  }
  for (long long u = u_begin; u < u_end; ++u) {
    const int t = (int)(u / a.nb), i = (int)(u % a.nb);
    const int z0 = nz0, z1 = nz1;
    if (u + 1 < u_end) {
      const int in = (int)((u + 1) % a.nb);
      nz0 = a.row_ptr[in];
      nz1 = a.row_ptr[in + 1];
    }
    float xa[RMAX][KC];
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) xa[r][c] = 0.f;
    mbar_wait(ufull(ur.slot()), ur.phase());
    const float* b2t = b2s + ur.slot() * TILE_F;

    for (int z = z0; z < z1; ++z) {
      mbar_wait(tfull(tr.slot()), tr.phase());
      const float* b1t = b1s + tr.slot() * TILE_F;
      // the block's strips take ring slots dr.slot(st), held through both
      // chunk passes

#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int q = qlo + 8 * qhi + 16 * s;
        const bool live = 8 * qhi + 16 * s < chunks;   // warp-uniform
        float xt[4][KC];
        float b1[4][KC];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < KC; ++c) xt[jj][c] = 0.f;
        if (live) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int h = 0; h < NH; ++h) {
              const float4 x = tile_slot(b1t, (4 * q + jj) * NH + h);
              b1[jj][4 * h] = x.x;
              b1[jj][4 * h + 1] = x.y;
              b1[jj][4 * h + 2] = x.z;
              b1[jj][4 * h + 3] = x.w;
            }
        }
#pragma unroll
        for (int st = 0; st < MAX_BS / STRIP; ++st) {
          if (st < nstrips) {
            if (s == 0) mbar_wait(dfull(dr.slot(st)), dr.phase(st));
            const float* strip = ring + dr.slot(st) * STRIP * MAX_BS;
            const int nr = min(STRIP, a.bs - st * STRIP) / 16;
#pragma unroll
            for (int rr = 0; rr < STRIP / 16; ++rr) {
              if (live && rr < nr) {
                const int row = p + 16 * rr;             // in the strip
                const float4 d4 = *reinterpret_cast<const float4*>(
                    strip + row * a.bs + 4 * q);
                const float d[4] = {d4.x, d4.y, d4.z, d4.w};
                float b2[KC];
#pragma unroll
                for (int h = 0; h < NH; ++h) {
                  const float4 x =
                      tile_slot(b2t, (st * STRIP + row) * NH + h);
                  b2[4 * h] = x.x;
                  b2[4 * h + 1] = x.y;
                  b2[4 * h + 2] = x.z;
                  b2[4 * h + 3] = x.w;
                }
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                  float acc = xa[4 * st + rr][c];
#pragma unroll
                  for (int jj = 0; jj < 4; ++jj) {
                    acc = fmaf(d[jj], b1[jj][c], acc);
                    xt[jj][c] = fmaf(d[jj], b2[c], xt[jj][c]);
                  }
                  xa[4 * st + rr][c] = acc;
                }
              }
            }
            if (s == 1) {
              __syncwarp();
              if (lane == 0) mbar_arrive(dempty(dr.slot(st)));
            }
          }
        }

        // this pass's XTB partials: the 4 row lanes (lane bits 3, 4) leave
        // column 4 q + pl in v[0, KC), written to this warp's scratch
        constexpr int V = 4 * KC;
        float v[V];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int c = 0; c < KC; ++c) v[jj * KC + c] = xt[jj][c];
        halve<V / 2>(v, 16, lane);
        halve<V / 4>(v, 8, lane);
        if (live) {
          float* scr = xts + ((tr.n & 1) * 4 + (w & 3)) * TILE_F;
          const int col = 4 * q + pl;
#pragma unroll
          for (int h = 0; h < NH; ++h)
            *reinterpret_cast<float4*>(scr + 4 * swz(col * NH + h)) =
                make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                            v[4 * h + 3]);
        }
      }
      dr.n += nstrips;
      __syncwarp();
      if (lane == 0) mbar_arrive(tempty(tr.slot()));

      // the 4 warps that share each chunk, in a fixed order, then one
      // vector store per 4 outputs into the block's workspace tile
      consumers_sync();
      const int sidx = threadIdx.x;            // (col, h) = divmod(sidx, NH)
      if (sidx < a.bs * NH && 4 * (sidx % NH) < a.kn) {
        const float* src = xts + (tr.n & 1) * 4 * TILE_F + 4 * swz(sidx);
        float4 sum = *reinterpret_cast<const float4*>(src);
#pragma unroll
        for (int ww = 1; ww < 4; ++ww) {
          const float4 x = *reinterpret_cast<const float4*>(src + ww * TILE_F);
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        *reinterpret_cast<float4*>(
            a.part + (((long long)t * a.nnzb + z) * a.bs + sidx / NH) * KC +
            4 * (sidx % NH)) = sum;
      }
      ++tr.n;              // also flips the XTB scratch buffer
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(uempty(ur.slot()));

    // XA epilogue: the 8 chunk lanes (lane bits 0-2) leave row p + 16 qlo
    // in v[0, KC); warps 4-7 hand theirs to warps 0-3 through shared memory.
    {
      constexpr int V = RMAX * KC;
      float v[V];
#pragma unroll
      for (int r = 0; r < RMAX; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) v[r * KC + c] = xa[r][c];
      halve<V / 2>(v, 4, lane);
      halve<V / 4>(v, 2, lane);
      halve<V / 8>(v, 1, lane);
      float* scr = xas + (((ur.n & 1) * 16 + p) * RMAX + qlo) * KC;
      if (qhi == 1) {
#pragma unroll
        for (int c = 0; c < KC; ++c) scr[c] = v[c];
      }
      consumers_sync();
      const int row = p + 16 * qlo;
      if (qhi == 0 && row < a.bs) {
        float* out = a.xa + ((long long)t * n_pad + (long long)i * a.bs +
                             row) * a.k + a.k0;
#pragma unroll
        for (int h = 0; h < NH; ++h)
          store4(out,
                 make_float4(v[4 * h] + scr[4 * h],
                             v[4 * h + 1] + scr[4 * h + 1],
                             v[4 * h + 2] + scr[4 * h + 2],
                             v[4 * h + 3] + scr[4 * h + 3]),
                 4 * h, a.kn, a.k);
      }
      ++ur.n;              // also flips the XA scratch buffer
    }
  }
}

// XTB[t][j-th block-column] = the sum of its blocks' partials in block-row
// order; zeros for a block-column with no stored block.  One CTA per (j, t);
// thread s holds row s / NH, float4 slot s % NH.
template <int KC>
__global__ void __launch_bounds__(MAX_BS * 2)
    xtb_reduce_kernel(const Params a, const int* __restrict__ col_ptr,
                      const int* __restrict__ col_z) {
  constexpr int NH = KC / 4;
  const int j = blockIdx.x, t = blockIdx.y, s = threadIdx.x;
  const int row = s / NH, h = s % NH;
  if (row >= a.bs || 4 * h >= a.kn) return;
  const long long tile = (long long)a.bs * KC;
  const float* base = a.part + (long long)t * a.nnzb * tile + row * KC + 4 * h;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  const int e1 = col_ptr[j + 1];
  for (int e = col_ptr[j]; e < e1; ++e) {
    const float4 x =
        __ldg(reinterpret_cast<const float4*>(base + col_z[e] * tile));
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  *reinterpret_cast<float4*>(
      a.xtb + ((long long)t * a.nb * a.bs + (long long)j * a.bs + row) * a.kt +
      a.k0 + 4 * h) = sum;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int KC>
cudaError_t launch(const Params& a, const int* col_ptr, const int* col_z,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      xa_xta_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<KC>::BYTES);
  if (err != cudaSuccess) return err;
  const long long units = (long long)a.T * a.nb;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = (int)(units < sms ? units : sms);
  xa_xta_kernel<KC><<<grid, THREADS, Smem<KC>::BYTES, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  xtb_reduce_kernel<KC>
      <<<dim3(a.nb, a.T), a.bs * (KC / 4), 0, stream>>>(a, col_ptr, col_z);
  return cudaGetLastError();
}

}  // namespace bcsr_xa

// xa (T, nb*bs, k) = X_t @ B1[t / m];  xtb (T, nb*bs, kt)[..., :k] =
// X_t^T @ B2[t / m] (kt is k rounded up to a multiple of 4), both in a fixed
// order.  part is a workspace of T * nnzb * bs * kc floats; col_ptr (nb + 1)
// and col_z (nnzb) the transposed index (the blocks of block-column j are
// col_z[col_ptr[j] .. col_ptr[j + 1]), in block-row order).  B1 and B2 arrive as the wrapper's tiles
// (kernels/bcsr_fused.py operand_tiles): (ceil(k / kc), members, nb*bs, kc),
// zero-padded, slots swizzled per (bs, kc) tile, k-slices b_slice_stride
// floats apart, members b_member_stride (0 = shared).  kc is 4 for k <= 4
// and 8 above; bs a multiple of 32 up to 128; 1 <= k <= 64; nnzb >= 1.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for what it does
// not take).
extern "C" int repro_bcsr_xa_xta(const float* data, const int* row_ptr,
                                 const int* cols, const int* col_ptr,
                                 const int* col_z, const float* B1,
                                 const float* B2, float* xa, float* xtb,
                                 float* part, int T, int m, int nb, int nnzb,
                                 int bs,
                                 int k, int kt, int kc,
                                 long long data_member_stride,
                                 long long b_member_stride,
                                 long long b_slice_stride, void* stream) {
  if (bs % 32 || bs < 32 || bs > bcsr_xa::MAX_BS || k < 1 || k > 64 ||
      kt != (k + 3) / 4 * 4 || kc != (k <= 4 ? 4 : 8) || T < 1 || m < 1 ||
      nb < 1 || nnzb < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int k0 = 0; k0 < k; k0 += kc) {
    const long long g = k0 / kc;
    bcsr_xa::Params a{data, row_ptr, cols, B1 + g * b_slice_stride,
                      B2 + g * b_slice_stride, xa, xtb, part, T, m, nb, nnzb,
                      bs, k, kt, k0, k - k0 < kc ? k - k0 : kc,
                      data_member_stride, b_member_stride};
    const cudaError_t err =
        kc == 4 ? bcsr_xa::launch<4>(a, col_ptr, col_z, st)
                : bcsr_xa::launch<8>(a, col_ptr, col_z, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
