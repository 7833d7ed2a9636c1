// The implicit-GEMM main loops shared by the stride-1 3x3 (dilated) conv
// kernels (fused_conv.cu, train_conv.cu): NHWC activations, HWIO weights,
// XLA SAME padding of `dilation` on each side.  Two loops compute the same
// arithmetic; `plan` (below) gives each call one of them by shape:
//
// - the Hopper loop (namespace hopper, at the end of this file): TMA loads
//   into a ring of stages kept in flight by one producer warp on mbarriers,
//   two consumer warpgroups running wgmma.  It takes f32 x with C a
//   multiple of 32 and K a multiple of 64 whose 128-pixel tiles are whole
//   image rows or whole parts of one row (W divides 128 and 128 / W
//   divides H, or 128 divides W): every 1/8-resolution tail site and rm2 /
//   rm3's f32 sites.
// - the mma.sync loop (MainLoop): cp.async ring, mma.sync.m16n8k8.  It
//   takes every other shape: the C = 3 stem, K <= 32, bf16 x, ragged
//   tiles.
//
// The rest of this comment describes the mma.sync loop; the Hopper loop's
// own comment says where it differs.
//
// Rows are output pixels (M = N*H*W), columns are output channels (K), the
// reduction runs over the 9*C rows of the HWIO weights seen as a [9*C, K]
// matrix.  One block of THREADS threads owns a BM-pixel x BN-channel output
// tile and walks the reduction in steps of BK rows.
//
// Math: split TF32 on the tensor cores.  Each f32 operand v is split as it
// is read from shared memory into hi = tf32(v) (round to nearest, ties
// away: cvt.rna's rounding, as two integer ops) and lo = v - hi truncated
// to TF32, and every 8-deep slice of the product is three
// mma.sync.m16n8k8 TF32 products, the small terms first: lo_a*hi_b,
// hi_a*lo_b, hi_a*hi_b.  They are summed from zero in the tensor core over
// one 32-deep step and then added to the f32 accumulator on the CUDA cores,
// because the tensor core truncates as it accumulates (see the loop).  The
// dropped lo_a*lo_b term and the truncation of lo are at most 2^-21 of each
// product, so the sum keeps f32-class accuracy -- on an H100 the error
// against an f64 conv is 0.2-1.6x the plain f32 conv's -- at an effective
// 495/3 = 165 TFLOP/s, 2.5x the card's f32 CUDA-core rate.  A bf16 x is
// exact in TF32 (lo_a = 0), so it takes two products.
//
// Loads: a ring of STAGES shared-memory stages filled by cp.async (16-byte
// cp.async.cg chunks of 4 f32 / 8 bf16 channels, zero-filled with src-size
// 0 where a tap falls outside the image or past M, so no padded copy of x is
// ever written).  The gather of step s+2 is in flight while step s runs its
// mma, with one barrier per step.  Shapes whose rows are not 16-byte
// aligned take narrow loads instead: x with C not a multiple of 4 (f32) / 8
// (bf16) is gathered by plain loads over the flattened (tap, channel)
// reduction -- so the C = 3 stem runs its 27 terms as one 32-deep step --
// and w with K not a multiple of 4 by 4-byte cp.async.
//
// Tiles: BM = 128 pixels, BK = 32 reduction rows, 8 warps, one of four
// channel widths picked per call (Tile128 / 64 / 32 / 16, pick_tile): the
// widest whose grid still covers the card's SMs, so K = 128 at M = 8192
// (64 blocks at 128 wide) runs 128 x 64 tiles, and K = 16 / 32 / 64 do not
// compute masked channels.  Shared tiles are padded (A [BM][BK + 8],
// B [BK][BN + 4]) so the fragment reads are free of bank conflicts.  With
// 128 x 128 tiles the ring is 3 x (128*40 + 32*132) * 4 B = 110 KB, one
// block per SM.
//
// Chosen by trying variants on an H100, each faster than the one before:
// hi and lo by integer ops rather than two cvt.rna; A read as adjacent
// pairs; one tensor-core sum per 32-deep step rather than per 8-deep slice,
// which also freed the registers that had spilled (217 a thread with the
// 128 x 128 tile).  Not kept: 16 warps of 32 x 32 (128 registers, slower)
// and a 4-stage ring (no clear gain for more shared memory).
//
// Determinism: each output is summed in one fixed order (no split-K, no
// atomics), so a run repeats bit for bit.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace conv_tile {

constexpr int THREADS = 256;  // 8 warps
constexpr int BM = 128;       // pixels per block
constexpr int BK = 32;        // reduction rows per step
constexpr int STAGES = 3;     // cp.async ring depth

// A channel-width configuration: BN channels per block, the 8 warps as
// WARPS_M x WARPS_N, each owning a WM x WN accumulator tile of MT x NT
// m16n8 fragments.
template <int BN_, int WARPS_M_, int WARPS_N_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = WARPS_N_;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static_assert(WARPS_M * WARPS_N * 32 == THREADS, "8 warps");
  static_assert(WM % 16 == 0 && WN % 8 == 0, "whole fragments");
};
using Tile128 = Tile<128, 2, 4>;  // 64 x 32 per warp
using Tile64 = Tile<64, 4, 2>;    // 32 x 32
using Tile32 = Tile<32, 4, 2>;    // 32 x 16
using Tile16 = Tile<16, 8, 1>;    // 16 x 16

enum TileId { kTile128, kTile64, kTile32, kTile16 };

// The channel width for an [m, k] output on a card of `sms` SMs: the
// narrowest tile that covers k up to 64; above that 128, unless 128-wide
// tiles leave SMs idle.
inline TileId pick_tile(int m, int k, int sms) {
  if (k <= 16) return kTile16;
  if (k <= 32) return kTile32;
  if (k <= 64) return kTile64;
  const long blocks128 =
      static_cast<long>((m + BM - 1) / BM) * ((k + 127) / 128);
  return blocks128 >= sms ? kTile128 : kTile64;
}

inline int tile_width(TileId t) {
  static constexpr int widths[] = {128, 64, 32, 16};
  return widths[t];
}

// The current device's SM count.
inline int device_sms() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

inline int m_tiles(int m) { return (m + BM - 1) / BM; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX>
__device__ __forceinline__ TX zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L2 only; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v = hi + lo (+ at most 2^-21 |v|), both TF32.  hi rounds to nearest,
// ties away (what cvt.rna.tf32.f32 computes, here in two integer ops on the
// bits); lo = v - hi is exact in f32 and is truncated to TF32.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xffffe000u;
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ------------------------------------------------------------- main loop
// Shared-memory layout and the loop itself for x of element type TX and
// channel-width configuration T.
template <typename TX, class T>
struct MainLoop {
  static constexpr int MT = T::MT;
  static constexpr int NT = T::NT;
  static constexpr int BN = T::BN;
  static constexpr int A_VEC = 16 / static_cast<int>(sizeof(TX));  // per chunk
  // padded row strides: A (BK + 8) elements, B (BN + 4) floats; rows stay
  // 16-byte aligned, and the fragment reads below hit 32 distinct banks
  static constexpr int A_LD = BK + 8;
  static constexpr int B_LD = BN + 4;
  static constexpr int A_STAGE = BM * A_LD;
  static constexpr int B_STAGE = BK * B_LD;
  static constexpr size_t A_BYTES = sizeof(TX) * STAGES * A_STAGE;
  static constexpr size_t SMEM_BYTES = A_BYTES + 4 * STAGES * B_STAGE;
  // 16-byte A chunks: chunks per row, rows per pass, passes
  static constexpr int A_CPR = BK / A_VEC;
  static constexpr int A_RPP = THREADS / A_CPR;
  static constexpr int A_ITERS = BM / A_RPP;
  // 16-byte B chunks, and 4-byte B elements
  static constexpr int B_CHUNKS = BK * BN / 4;
  static constexpr int B_ITERS = (B_CHUNKS + THREADS - 1) / THREADS;
  static constexpr int B_ELEMS = BK * BN / THREADS;
  static constexpr bool kBf16 = sizeof(TX) == 2;

  // The pixel row (of accumulator half 0: g, 1: g+8) and the first channel
  // column of a thread's fragments of m-tile mt / n-tile nt, relative to
  // the block's tile.
  static __device__ __forceinline__ int frag_row(int warp, int lane, int mt,
                                                 int half) {
    return (warp / T::WARPS_N) * T::WM + mt * 16 + (lane >> 2) + half * 8;
  }
  static __device__ __forceinline__ int frag_col(int warp, int lane, int nt) {
    return (warp % T::WARPS_N) * T::WN + nt * 8 + 2 * (lane & 3);
  }

  // Within each 8-deep slice the kernel numbers the reduction so that
  // fragment depth k = t + 4j lies in shared-memory column (or B row)
  // 2t + j: a thread's two A values of a row are adjacent (one 8-byte load,
  // 4-byte for bf16).  A and B use the same numbering, so every product
  // pairs the x and w of one reduction row; only the order of the 8
  // products within a slice differs from the natural numbering.
  //
  // The A fragment of rows row..row+15 of a slice, split: a0 (g, k t),
  // a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
  static __device__ __forceinline__ void load_a(const TX* as, int row, int k8,
                                                int t, uint32_t (&hi)[4],
                                                uint32_t (&lo)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v =
          to_f32(as[(row + (q & 1) * 8) * A_LD + k8 + 2 * t + (q >> 1)]);
      if (kBf16) {
        hi[q] = __float_as_uint(v);  // exact in TF32
      } else {
        split_tf32(v, hi[q], lo[q]);
      }
    }
  }

  // Accumulates the conv of the output tile at (pixel m0, channel n0) into
  // acc (zeroed here).  acc[mt][nt][q] is the m16n8 fragment layout: rows
  // g and g+8 (g = lane/4), columns 2t and 2t+1 (t = lane%4).  Called by all
  // THREADS threads; `smem` is the block's SMEM_BYTES of dynamic shared
  // memory.  Rows past M and channels past C accumulate exact zeros.
  static __device__ __forceinline__ void run(
      const TX* __restrict__ x, const float* __restrict__ w, int n_img, int h,
      int wd, int c, int k, int dil, int m0, int n0, unsigned char* smem,
      float (&acc)[MT][NT][4]) {
    TX* As = reinterpret_cast<TX*>(smem);
    float* Bs = reinterpret_cast<float*>(smem + A_BYTES);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int hw = h * wd;
    const int m_total = n_img * hw;
    const int rows = 9 * c;
    // 16-byte rows need aligned channel runs; otherwise the narrow paths
    const bool a_vec = c % A_VEC == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool b_vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    // vector A: steps of one tap x BK channels; narrow A: BK flat rows
    const int c_steps = (c + BK - 1) / BK;
    const int steps = a_vec ? 9 * c_steps : (rows + BK - 1) / BK;

    // this thread's A pixels (vector path): one 16-byte chunk per pass
    const int a_chunk = tid % A_CPR;
    int pix_img[A_ITERS], pix_y[A_ITERS], pix_x[A_ITERS];
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i) {
      const int m = m0 + tid / A_CPR + i * A_RPP;
      pix_img[i] = m < m_total ? m / hw : -1;
      const int rem = m < m_total ? m - pix_img[i] * hw : 0;
      pix_y[i] = rem / wd;
      pix_x[i] = rem - pix_y[i] * wd;
    }

    // Issue the loads of step s into ring stage `stage`.
    auto load = [&](int s, int stage) {
      TX* as = As + stage * A_STAGE;
      float* bs = Bs + stage * B_STAGE;
      int row0, row_end;  // the [9C, K] weight rows of this step
      if (a_vec) {
        const int tap = s / c_steps;
        const int c0 = (s - tap * c_steps) * BK;
        const int dy = (tap / 3 - 1) * dil;
        const int dx = (tap % 3 - 1) * dil;
        const int cc = c0 + a_chunk * A_VEC;
#pragma unroll
        for (int i = 0; i < A_ITERS; ++i) {
          const int iy = pix_y[i] + dy;
          const int ix = pix_x[i] + dx;
          const bool ok = pix_img[i] >= 0 && cc < c && iy >= 0 && iy < h &&
                          ix >= 0 && ix < wd;
          const TX* src =
              ok ? x + ((static_cast<size_t>(pix_img[i]) * h + iy) * wd + ix) *
                           c + cc
                 : x;
          cp_async16(as + (tid / A_CPR + i * A_RPP) * A_LD + a_chunk * A_VEC,
                     src, ok);
        }
        row0 = tap * c + c0;
        row_end = tap * c + c;
      } else {
        // flat rows r = tap*C + ch; one warp per pixel row, lane = column
        const int r = s * BK + lane;
        const int tap = r / c;
        const int ch = r - tap * c;
        const int dy = (tap / 3 - 1) * dil;
        const int dx = (tap % 3 - 1) * dil;
#pragma unroll 4
        for (int i = 0; i < BM * BK / THREADS; ++i) {
          const int row = warp + i * (THREADS / 32);
          const int m = m0 + row;
          TX v = zero_of<TX>();
          if (r < rows && m < m_total) {
            const int img = m / hw;
            const int rem = m - img * hw;
            const int iy = rem / wd + dy;
            const int ix = rem % wd + dx;
            if (iy >= 0 && iy < h && ix >= 0 && ix < wd)
              v = x[((static_cast<size_t>(img) * h + iy) * wd + ix) * c + ch];
          }
          as[row * A_LD + lane] = v;
        }
        row0 = s * BK;
        row_end = rows;
      }
      if (b_vec) {
#pragma unroll
        for (int i = 0; i < B_ITERS; ++i) {
          const int id = tid + i * THREADS;
          if (B_CHUNKS % THREADS == 0 || id < B_CHUNKS) {
            const int r = id / (BN / 4);
            const int n = n0 + (id % (BN / 4)) * 4;
            const bool ok = row0 + r < row_end && n < k;
            cp_async16(bs + r * B_LD + (id % (BN / 4)) * 4,
                       ok ? w + static_cast<size_t>(row0 + r) * k + n : w, ok);
          }
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < B_ELEMS; ++i) {
          const int id = tid + i * THREADS;
          const int r = id / BN;
          const int n = n0 + id % BN;
          const bool ok = row0 + r < row_end && n < k;
          cp_async4(bs + r * B_LD + id % BN,
                    ok ? w + static_cast<size_t>(row0 + r) * k + n : w, ok);
        }
      }
    };

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

    // prologue: steps 0 .. STAGES-2 in flight
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) load(s, s);
      cp_async_commit();
    }

    const int g = lane >> 2;
    const int t = lane & 3;
    const int a_row = (warp / T::WARPS_N) * T::WM + g;
    const int b_col = (warp % T::WARPS_N) * T::WN + g;
    for (int s = 0; s < steps; ++s) {
      // step s has landed (for this thread); the barrier makes it visible to
      // all and ends every read of the stage the next load overwrites
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (s + STAGES - 1 < steps)
        load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
      cp_async_commit();

      const TX* as = As + (s % STAGES) * A_STAGE;
      const float* bs = Bs + (s % STAGES) * B_STAGE;
      // The step's 32-deep product is summed from zero in the tensor core,
      // small terms first within each slice (lo_a*hi_b, hi_a*lo_b,
      // hi_a*hi_b), and then added to acc on the CUDA cores.  The tensor
      // core aligns and truncates (rounds toward zero) as it adds to its
      // accumulator; chaining every product into acc lost ~1 ulp of |acc|
      // per mma (2.5e-4 against an f64 conv at 512 -> 512 channels, 9x the
      // plain f32 conv's error on an H100).  Here it truncates only within
      // the step's partial sum, and acc takes round-to-nearest f32 adds.
      float part[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[mt][nt][q] = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < BK; k8 += 8) {
        uint32_t b_hi[NT][2], b_lo[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // b0 (k t, n g), b1 (k t+4, n g), in rows 2t and 2t+1
            split_tf32(bs[(k8 + 2 * t + q) * B_LD + b_col + nt * 8],
                       b_hi[nt][q], b_lo[nt][q]);
          }
        }
        uint32_t a_hi[MT][4], a_lo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          load_a(as, a_row + mt * 16, k8, t, a_hi[mt], a_lo[mt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (!kBf16) mma_tf32(part[mt][nt], a_lo[mt], b_hi[nt]);
            mma_tf32(part[mt][nt], a_hi[mt], b_lo[nt]);
            mma_tf32(part[mt][nt], a_hi[mt], b_hi[nt]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
    }
    cp_async_wait<0>();
  }
};

// Lets a kernel of the given instantiation take `bytes` of dynamic shared
// memory (above 48 KB this must be asked for before the launch).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ============================================================ Hopper loop
// The same conv, split-TF32 arithmetic and summation order by 32-deep
// steps as MainLoop, on Hopper's own instructions.
//
// Operands.  wgmma's .tf32 form takes both operands K-major (the reduction
// contiguous) and has no transpose; A may come from registers, B only from
// shared memory.  So:
// - B, the weights: the HWIO weights seen as [9C, K] are N-major.  A
//   pre-pass (split_weights_kernel) reads them once per call and writes
//   two K-major TF32 arrays [K, 9C], w_hi and w_lo, with split_tf32's
//   rounding; TMA loads a [BN channels x 32 reduction rows] box of each per
//   step with 128-byte swizzle, and wgmma reads them through descriptors.
//   The pre-pass runs every call (training changes the weights every step).
// - A, the activations: one 4-D tiled tensor map over x [N, H, W, C].  For
//   tap (dy, dx) of channel step c0 the producer loads the box of 32
//   channels x box_w columns x box_h rows at (c0, w0 + (dx-1)d,
//   h0 + (dy-1)d, n): 128 pixels of 128 bytes, swizzled.  Coordinates
//   outside the tensor read as zeros, which is exactly the SAME padding:
//   no padded copy of x, no predicate.  Each consumer thread reads its A
//   fragment from shared memory (four 4-byte loads per 8-deep slice, free
//   of bank conflicts under the swizzle), splits it into hi and lo in
//   registers, and hands both to wgmma as register operands.
//
// Work split.  384 threads: warpgroups 0 and 1 consume, each owning 64
// rows of the 128 x BN tile (BN = 128 or 64); warpgroup 2 produces, one
// thread of it issuing the TMA loads of a ring of STAGES stages (A 16 KB +
// B hi and lo 2 x BN x 128 B each; 48 KB at BN = 128) on a full / empty
// mbarrier pair per stage.  setmaxnreg gives the consumers 232 registers
// and leaves the producer 40.
//
// Each 8-deep slice is three wgmma.m64nBNk8.f32.tf32.tf32 products, small
// terms first: lo_a*hi_b, hi_a*lo_b, hi_a*hi_b.  As in MainLoop the tensor
// core truncates as it accumulates, so each 32-deep step is summed from
// zero into a step accumulator (scale-d = 0 on its first product) and then
// added to the f32 accumulator on the CUDA cores.  On an H100, chaining
// every product into one accumulator instead put the error against an f64
// conv at 9-13x the plain f32 conv's (0.2-0.4x with the step sums) for 3%
// less time.  The two accumulators are also why BN stops at 128: a 64 x
// 256 consumer tile would need 2 x 128 of the 232 registers.  Steps run
// tap-major, channel steps minor, as in MainLoop; no split-K, no atomics:
// a run repeats bit for bit.  On an H100 the two loops' sums came out bit
// for bit equal at every shape tried (a wgmma and an mma.sync of one
// 8-deep slice round alike, whatever the order of the slice's terms), so
// the conv + moments kernel also sums its moments in the mma.sync loop's
// order (train_conv.cu), and a shape gives the same bits on either loop.
namespace hopper {

constexpr int BM = 128;        // pixels per block: two warpgroups of 64 rows
constexpr int BK = 32;         // channels per step: one 128-byte row of f32
constexpr int STAGES = 4;      // ring depth
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int SWIZZLE = 1024;  // the 128-byte swizzle's period: stage alignment

// Shared-memory layout of a BN-wide tile: STAGES x (A, B hi, B lo), each
// buffer a multiple of SWIZZLE bytes, then the full and empty barriers;
// EXTRA_OFFSET is where a kernel's own scratch may start.  smem_bytes adds
// SWIZZLE so that the ring can be aligned inside the dynamic allocation.
template <int BN>
struct Layout {
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int BAR_OFFSET = STAGES * STAGE_BYTES;
  static constexpr int EXTRA_OFFSET = BAR_OFFSET + 2 * STAGES * 8;
  static constexpr size_t smem_bytes(size_t extra) {
    return SWIZZLE + EXTRA_OFFSET + extra;
  }
  static_assert(A_BYTES % SWIZZLE == 0 && B_BYTES % SWIZZLE == 0,
                "every buffer starts on the swizzle's period");
};

// ------------------------------------------------------------ PTX helpers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
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

// Spin until the phase of parity `parity` of barrier `bar` has completed.
// A wait past WAIT_LIMIT cycles of the SM clock (some 17 s) traps, so that
// a fault in the ring ends the kernel with an error instead of hanging the
// card.
constexpr long long WAIT_LIMIT = 1ll << 35;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = -1;
  for (uint32_t spins = 1;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins % 1024 == 0) {
      const long long now = clock64();
      if (start < 0) {
        start = now;
      } else if (now - start > WAIT_LIMIT) {
        __trap();
      }
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A K-major operand of 8-row groups 1024 bytes apart, rows of 128 bytes
// swizzled (TMA's CU_TENSOR_MAP_SWIZZLE_128B): start address, leading
// offset 16 B (unused by this layout), stride offset 1024 B, layout 128B.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(SWIZZLE >> 4) << 32) | (1ull << 62);
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

// A barrier of the consumer warpgroups alone (the producer's may have left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// Keeps the compiler from moving an accumulator register across the
// asynchronous wgmma that reads or writes it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// setmaxnreg: the producer warpgroup gives registers up, the consumers take
// them (both counts are fixed at compile time).
template <int N>
__device__ __forceinline__ void set_max_regs();

template <>
__device__ __forceinline__ void set_max_regs<PRODUCER_REGS>() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
template <>
__device__ __forceinline__ void set_max_regs<CONSUMER_REGS>() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// d (64 x N) = a (64 x 8, registers) * b (8 x N, shared memory through
// `desc`) + (accumulate ? d : 0), TF32 in, f32 out.  d[4j + q] is row
// 16 * (warp % 4) + lane / 4 + 8 * (q / 2), column 8j + 2 * (lane % 4) +
// q % 2; a[q] is row 16 * (warp % 4) + lane / 4 + 8 * (q % 2), depth
// lane % 4 + 4 * (q / 2).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(accumulate));
  }
};


// --------------------------------------------------------------- the loop
template <int BN>
struct Loop {
  using L = Layout<BN>;
  static constexpr int ACC = BN / 2;  // accumulator floats per thread

  // The shared ring, aligned to the swizzle's period.
  static __device__ __forceinline__ uint32_t ring_base(unsigned char* smem) {
    const uint32_t raw = smem_addr(smem);
    return (raw + SWIZZLE - 1) & ~static_cast<uint32_t>(SWIZZLE - 1);
  }
  static __device__ __forceinline__ uint32_t full_bar(uint32_t base, int s) {
    return base + L::BAR_OFFSET + 8 * s;
  }
  static __device__ __forceinline__ uint32_t empty_bar(uint32_t base, int s) {
    return base + L::BAR_OFFSET + 8 * (STAGES + s);
  }
  // generic pointers to the ring and to the kernel's scratch after the
  // barriers
  static __device__ __forceinline__ unsigned char* ring(unsigned char* smem) {
    return smem + (ring_base(smem) - smem_addr(smem));
  }
  static __device__ __forceinline__ unsigned char* extra(unsigned char* smem) {
    return ring(smem) + L::EXTRA_OFFSET;
  }

  // One thread initialises the barriers; all THREADS threads must call.
  static __device__ __forceinline__ void init(unsigned char* smem) {
    const uint32_t base = ring_base(smem);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full_bar(base, s), 1);
        mbar_init(empty_bar(base, s), CONSUMERS * 4);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // The producer thread: the loads of every step of the tile at pixel
  // (img, h0, w0), channel n0, in order, each into the next free stage.
  static __device__ __forceinline__ void produce(
      unsigned char* smem, const void* xmap, const void* hi_map,
      const void* lo_map, int c, int dil, int img, int h0, int w0, int n0) {
    const uint32_t base = ring_base(smem);
    const int c_steps = c / BK;
    const int steps = 9 * c_steps;
    for (int s = 0; s < steps; ++s) {
      const int stage = s % STAGES;
      const int round = s / STAGES;
      if (round > 0) mbar_wait(empty_bar(base, stage), (round - 1) & 1);
      const uint32_t full = full_bar(base, stage);
      mbar_expect_tx(full, L::STAGE_BYTES);
      const int tap = s / c_steps;
      const int c0 = (s - tap * c_steps) * BK;
      const int dy = (tap / 3 - 1) * dil;
      const int dx = (tap % 3 - 1) * dil;
      const uint32_t a = base + stage * L::STAGE_BYTES;
      tma_load_4d(a, xmap, full, c0, w0 + dx, h0 + dy, img);
      tma_load_2d(a + L::A_BYTES, hi_map, full, tap * c + c0, n0);
      tma_load_2d(a + L::A_BYTES + L::B_BYTES, lo_map, full, tap * c + c0,
                  n0);
    }
  }

  // The whole block's work for the tile at (blockIdx.x * BM pixels,
  // blockIdx.y * BN channels): the producer warpgroup loads, the consumer
  // warpgroups accumulate, then each consumer thread calls
  // epi(acc, row, col) with the pixel of its acc[0] (row g of its warp's 16;
  // acc[4j + 2 + q] is 8 rows further) and its channel (column 2t; acc[4j +
  // q] is column col + 8j + q).  All THREADS threads must call; one big
  // branch per role, as setmaxnreg needs.
  template <class Epilogue>
  static __device__ __forceinline__ void run(
      unsigned char* smem, const CUtensorMap* xmap, const CUtensorMap* hi_map,
      const CUtensorMap* lo_map, int h, int wd, int c, int dil,
      Epilogue&& epi) {
    init(smem);
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int wg = threadIdx.x / 128;
    if (wg == CONSUMERS) {
      set_max_regs<PRODUCER_REGS>();
      if (threadIdx.x == CONSUMERS * 128) {
        const int hw = h * wd;
        const int img = m0 / hw;
        const int rem = m0 - img * hw;
        produce(smem, xmap, hi_map, lo_map, c, dil, img, rem / wd, rem % wd,
                n0);
      }
    } else {
      set_max_regs<CONSUMER_REGS>();
      float acc[ACC];
      consume(smem, c, wg, acc);
      const int warp = (threadIdx.x >> 5) & 3;
      const int lane = threadIdx.x & 31;
      epi(acc, m0 + wg * 64 + warp * 16 + (lane >> 2), n0 + 2 * (lane & 3));
    }
  }

  // A consumer warpgroup (wg 0 or 1): accumulates its 64 rows of the tile
  // into acc (zeroed here) in the layout Wgmma documents.
  static __device__ __forceinline__ void consume(unsigned char* smem, int c,
                                                 int wg, float (&acc)[ACC]) {
    const uint32_t base = ring_base(smem);
    const float* stages = reinterpret_cast<const float*>(ring(smem));
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    // this thread's two A rows; both are g mod 8, so one swizzle for both
    const int row0 = wg * 64 + warp * 16 + g;
    const int steps = 9 * (c / BK);
    float part[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int stage = s % STAGES;
      mbar_wait(full_bar(base, stage), (s / STAGES) & 1);
      const float* as = stages + stage * (L::STAGE_BYTES / 4);
      // A: slice j's columns t and t+4 are 16-byte chunks 2j and 2j+1 of
      // the row, stored at chunk ^ (row % 8)
      uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = row0 + (q & 1) * 8;
          const int chunk = (2 * j + (q >> 1)) ^ g;
          split_tf32(as[row * BK + chunk * 4 + t], a_hi[j][q], a_lo[j][q]);
        }
      }
      const uint32_t b = base + stage * L::STAGE_BYTES + L::A_BYTES;
      const uint64_t d_hi = smem_desc(b);
      const uint64_t d_lo = smem_desc(b + L::B_BYTES);
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // slice j starts 32 bytes (2 descriptor units) into each B row
        Wgmma<BN>::mma(part, a_lo[j], d_hi + 2 * j, j > 0);
        Wgmma<BN>::mma(part, a_hi[j], d_lo + 2 * j, 1);
        Wgmma<BN>::mma(part, a_hi[j], d_hi + 2 * j, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(part);
      if (lane == 0) mbar_arrive(empty_bar(base, stage));
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] += part[i];
    }
  }
};

// ------------------------------------------------------- the host side
// cuTensorMapEncodeTiled, fetched from the driver at run time so that the
// library links against the runtime alone (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled f32 tensor map with 128-byte swizzle: `rank` dims innermost
// first, byte strides of dims 1.. (dims[0] is contiguous), the box.  Reads
// outside the tensor fill zeros.
inline cudaError_t encode(CUtensorMap* map, const void* ptr, int rank,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr),
      dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The three maps of one call: x [n, h, wd, c] in boxes of BK channels x
// box_w x box_h pixels, and w_hi / w_lo [k, 9c] in boxes of BK x bn.
struct Maps {
  CUtensorMap x, w_hi, w_lo;
};

inline cudaError_t make_maps(Maps* m, const void* x, const void* w_hi,
                             const void* w_lo, int n, int h, int wd, int c,
                             int k, int bn, int box_h, int box_w) {
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(c),
                            static_cast<cuuint64_t>(wd),
                            static_cast<cuuint64_t>(h),
                            static_cast<cuuint64_t>(n)};
  const cuuint64_t row = 4ull * c;
  const cuuint64_t xs[3] = {row, row * wd, row * wd * h};
  const cuuint32_t xb[4] = {BK, static_cast<cuuint32_t>(box_w),
                            static_cast<cuuint32_t>(box_h), 1};
  cudaError_t err = encode(&m->x, x, 4, xd, xs, xb);
  if (err != cudaSuccess) return err;
  const cuuint64_t wd2[2] = {9ull * c, static_cast<cuuint64_t>(k)};
  const cuuint64_t ws[1] = {36ull * c};
  const cuuint32_t wb[2] = {BK, static_cast<cuuint32_t>(bn)};
  err = encode(&m->w_hi, w_hi, 2, wd2, ws, wb);
  if (err != cudaSuccess) return err;
  return encode(&m->w_lo, w_lo, 2, wd2, ws, wb);
}

}  // namespace hopper

// w [rows = 9C, k] (HWIO seen as a matrix) -> w_hi, w_lo [k, rows], the
// K-major TF32 split of each weight (split_tf32): the Hopper loop's B.
// 32 x 32 tiles through shared memory, so both sides are coalesced.
constexpr int SPLIT_TILE = 32;
constexpr int SPLIT_ROWS = 8;  // thread rows of a 32 x 8 block

static __global__ void __launch_bounds__(SPLIT_TILE * SPLIT_ROWS)
split_weights_kernel(const float* __restrict__ w, float* __restrict__ w_hi,
                     float* __restrict__ w_lo, int rows, int k) {
  __shared__ float tile[SPLIT_TILE][SPLIT_TILE + 1];
  const int r0 = blockIdx.x * SPLIT_TILE;
  const int k0 = blockIdx.y * SPLIT_TILE;
  const int tx = threadIdx.x;
#pragma unroll
  for (int i = threadIdx.y; i < SPLIT_TILE; i += SPLIT_ROWS) {
    const int r = r0 + i;
    const int kk = k0 + tx;
    tile[i][tx] = r < rows && kk < k ? w[static_cast<size_t>(r) * k + kk] : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = threadIdx.y; i < SPLIT_TILE; i += SPLIT_ROWS) {
    const int kk = k0 + i;
    const int r = r0 + tx;
    if (kk < k && r < rows) {
      uint32_t hi, lo;
      split_tf32(tile[tx][i], hi, lo);
      const size_t o = static_cast<size_t>(kk) * rows + r;
      w_hi[o] = __uint_as_float(hi);
      w_lo[o] = __uint_as_float(lo);
    }
  }
}

inline cudaError_t split_weights(const void* w, void* w_hi, void* w_lo,
                                 int c, int k, cudaStream_t stream) {
  const int rows = 9 * c;
  const dim3 grid((rows + SPLIT_TILE - 1) / SPLIT_TILE,
                  (k + SPLIT_TILE - 1) / SPLIT_TILE);
  split_weights_kernel<<<grid, dim3(SPLIT_TILE, SPLIT_ROWS), 0, stream>>>(
      static_cast<const float*>(w), static_cast<float*>(w_hi),
      static_cast<float*>(w_lo), rows, k);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ plan
// Which loop a call takes, and its tile: the one place this is decided
// (mirrored for the CPU tests by mcmda_tpu_torch/kernels/conv_tile.py).
enum LoopId { kMmaSync = 0, kWgmma = 1 };

struct Plan {
  int loop;   // LoopId
  int bn;     // output channels per block
  int box_h;  // the Hopper loop's A box: image rows x columns (else 0)
  int box_w;
  int grid_x;  // pixel tiles
  int grid_y;  // channel tiles
};

inline Plan plan(int n, int h, int wd, int c, int k, bool x_bf16, int sms) {
  const int m = n * h * wd;
  Plan p{kMmaSync, 0, 0, 0, m_tiles(m), 0};
  const bool rows_fit = (hopper::BM % wd == 0 && h % (hopper::BM / wd) == 0) ||
                        wd % hopper::BM == 0;
  if (!x_bf16 && c % hopper::BK == 0 && k % 64 == 0 && rows_fit) {
    p.loop = kWgmma;
    p.box_w = wd < hopper::BM ? wd : hopper::BM;
    p.box_h = hopper::BM / p.box_w;
    // 128 wide unless that fills under 3/4 of the SMs, where 64-wide
    // tiles run twice the blocks in the same single wave
    const long blocks128 = static_cast<long>(m / hopper::BM) * (k / 128);
    p.bn = k % 128 == 0 && 4 * blocks128 >= 3L * sms ? 128 : 64;
    p.grid_x = m / hopper::BM;
  } else {
    p.bn = tile_width(pick_tile(m, k, sms));
  }
  p.grid_y = (k + p.bn - 1) / p.bn;
  return p;
}

// A Hopper-loop call's host work before its kernel: the three tensor maps
// (into `maps`), then the weight pre-pass into w_hi / w_lo on `stream`.
inline cudaError_t prepare_wgmma(hopper::Maps* maps, const void* x,
                                 const void* w, void* w_hi, void* w_lo, int n,
                                 int h, int wd, int c, int k, const Plan& p,
                                 cudaStream_t stream) {
  if (w_hi == nullptr || w_lo == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = hopper::make_maps(maps, x, w_hi, w_lo, n, h, wd, c,
                                            k, p.bn, p.box_h, p.box_w);
  if (err != cudaSuccess) return err;
  return split_weights(w, w_hi, w_lo, c, k, stream);
}

}  // namespace conv_tile
