// The implicit-GEMM main loop shared by the stride-1 3x3 (dilated) conv
// kernels (fused_conv.cu, train_conv.cu): NHWC activations, HWIO weights,
// XLA SAME padding of `dilation` on each side done as a bounds test.
//
// Rows are output pixels (M = N*H*W), columns are output channels (K), the
// reduction runs over 9 taps x C.  One block of THREADS threads owns a
// BM-pixel x BN-channel output tile and walks the reduction in steps of one
// tap x BK input channels: each step gathers the shifted input tile (zero
// where the tap falls outside the image, so no padded copy of x is ever
// written) and the matching weight slice into shared memory, then every
// thread accumulates a TM x TN register tile from them, in f32 FMAs.  Ragged
// edges (C or K not a multiple of the tile, M not a multiple of BM) are
// masked, so every shape runs; rows past M and channels past C accumulate
// exact zeros.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace conv_tile {

constexpr int BM = 64;                                   // pixels per block
constexpr int BN = 64;                                   // channels per block
constexpr int BK = 16;                                   // reduction step
constexpr int TM = 4;                                    // pixels per thread
constexpr int TN = 4;                                    // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);           // 256
constexpr int A_ROWS = THREADS / BK;                     // 16 pixels per pass
constexpr int A_PASSES = BM / A_ROWS;                    // 4
constexpr int B_ROWS = THREADS / BN;                     // 4 channels per pass
constexpr int B_PASSES = BK / B_ROWS;                    // 4
constexpr int A_PAD = 4;  // keeps the transposed A stores off one bank

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// First pixel row / channel column of this thread's TM x TN register tile.
__device__ __forceinline__ int thread_row(int tid) {
  return (tid / (BN / TN)) * TM;
}
__device__ __forceinline__ int thread_col(int tid) {
  return (tid % (BN / TN)) * TN;
}

// Accumulates the conv of the output tile at (pixel m0, channel n0) into
// `acc` (zeroed here).  Called by all THREADS threads of the block, which
// provide the shared-memory staging tiles.
template <typename TX>
__device__ __forceinline__ void mainloop(
    const TX* __restrict__ x, const float* __restrict__ w, int n_img, int h,
    int wd, int c, int k, int dil, int m0, int n0,
    float (&As)[BK][BM + A_PAD], float (&Bs)[BK][BN], float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int hw = h * wd;
  const int m_total = n_img * hw;

  // A loader: 16 consecutive threads read 16 consecutive channels of one
  // pixel (NHWC keeps them contiguous), A_ROWS pixels per pass.
  const int a_c = tid % BK;
  const int a_r = tid / BK;
  int pix_img[A_PASSES], pix_y[A_PASSES], pix_x[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const int m = m0 + a_r + i * A_ROWS;
    if (m < m_total) {
      pix_img[i] = m / hw;
      const int rem = m - pix_img[i] * hw;
      pix_y[i] = rem / wd;
      pix_x[i] = rem - pix_y[i] * wd;
    } else {
      pix_img[i] = -1;
      pix_y[i] = 0;
      pix_x[i] = 0;
    }
  }
  // B loader: 64 consecutive threads read 64 consecutive output channels
  // of one (tap, input channel) row of the HWIO weights.
  const int b_n = tid % BN;
  const int b_r = tid / BN;

  const int tm = thread_row(tid);
  const int tn = thread_col(tid);

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = (tap / 3 - 1) * dil;
    const int dx = (tap % 3 - 1) * dil;
    for (int c0 = 0; c0 < c; c0 += BK) {
      const int ca = c0 + a_c;
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) {
        float v = 0.f;
        const int iy = pix_y[i] + dy;
        const int ix = pix_x[i] + dx;
        if (pix_img[i] >= 0 && ca < c && iy >= 0 && iy < h && ix >= 0 &&
            ix < wd) {
          v = to_f32(x[((static_cast<size_t>(pix_img[i]) * h + iy) * wd + ix) *
                           c + ca]);
        }
        As[a_c][a_r + i * A_ROWS] = v;
      }
      const int kb = n0 + b_n;
#pragma unroll
      for (int i = 0; i < B_PASSES; ++i) {
        const int cb = c0 + b_r + i * B_ROWS;
        Bs[b_r + i * B_ROWS][b_n] =
            (cb < c && kb < k)
                ? w[(static_cast<size_t>(tap) * c + cb) * k + kb]
                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][tm]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tn]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
}

}  // namespace conv_tile
