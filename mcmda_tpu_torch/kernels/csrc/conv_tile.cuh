// The implicit-GEMM main loop shared by the stride-1 3x3 (dilated) conv
// kernels (fused_conv.cu, train_conv.cu): NHWC activations, HWIO weights,
// XLA SAME padding of `dilation` on each side done as a predicate.
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

// The channel width for an [m, k] output: the narrowest tile that covers
// k up to 64; above that 128, unless 128-wide tiles leave SMs idle.
inline TileId pick_tile(int m, int k) {
  if (k <= 16) return kTile16;
  if (k <= 32) return kTile32;
  if (k <= 64) return kTile64;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long blocks128 =
      static_cast<long>((m + BM - 1) / BM) * ((k + 127) / 128);
  return blocks128 >= sms ? kTile128 : kTile64;
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

}  // namespace conv_tile
