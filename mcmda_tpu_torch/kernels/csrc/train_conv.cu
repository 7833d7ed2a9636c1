// Stride-1 3x3 (dilated) conv writing z, plus the per-channel batch moments
// sum(z) and sum(z^2) that train-mode BN needs, NHWC f32 activations and
// HWIO f32 weights.
//
// Replaces: mcmda_tpu/kernels/train_conv.py, conv_stats_pallas (the Pallas
// TPU kernel behind blocks.residual_block_apply(train=True,
// fused_train=True)).  Computes what conv_stats_reference computes: z the
// SAME conv accumulated in f32, s[k] = sum over N,H,W of z, ss[k] = sum of
// z*z.  The normalize + residual + activation epilogue stays in plain
// PyTorch (conv_bn_act_train), as the JAX package leaves it to XLA.
//
// What bounds it on an H100: the rm4-rm6 tail (32x32 planes, 128-512 input
// channels, 256-512 output channels) is compute-bound, ~2*9*C FLOPs per
// output element against a few bytes, and this first version runs f32 FMAs
// on the CUDA cores (the card's f32 non-tensor-core rate is its ceiling).
// The moments add one pass over the tile while it is still in registers,
// so z is written once and never read back to reduce it.
//
// Design: the implicit GEMM of conv_tile.cuh (64-pixel x 64-channel tile per
// block).  Epilogue: store z; each thread sums its 4 rows per channel; the
// 16 row groups of the block are summed through shared memory in a fixed
// order into one partial (sum, sum of squares) per pixel tile and channel,
// written to a [m_tiles, 2, K] buffer.  A second small kernel sums the
// partials of each channel over the pixel tiles, again in a fixed order.
// No float atomics: a seeded run repeats bit for bit.  The TPU kernel
// instead carried the moments across its sequential batch grid in VMEM;
// blocks here run in no order, hence the second pass.

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

constexpr int ROW_GROUPS = BM / TM;  // 16 threads share each channel column
constexpr int REDUCE_THREADS = 128;

__global__ void __launch_bounds__(THREADS)
conv_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ z, float* __restrict__ partial,
                  int n_img, int h, int wd, int c, int k, int dil) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red_s[ROW_GROUPS][BN];
  __shared__ float red_ss[ROW_GROUPS][BN];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int m_total = n_img * h * wd;
  float acc[TM][TN];
  mainloop(x, w, n_img, h, wd, c, k, dil, m0, n0, As, Bs, acc);

  const int tid = threadIdx.x;
  const int tm = thread_row(tid);
  const int tn = thread_col(tid);
  // store z; rows past m_total hold exact zeros and add nothing below
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kk = n0 + tn + j;
      if (kk < k) z[static_cast<size_t>(m) * k + kk] = acc[i][j];
    }
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      s += acc[i][j];
      ss = fmaf(acc[i][j], acc[i][j], ss);
    }
    red_s[tm / TM][tn + j] = s;
    red_ss[tm / TM][tn + j] = ss;
  }
  __syncthreads();
  if (tid < BN && n0 + tid < k) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int g = 0; g < ROW_GROUPS; ++g) {
      s += red_s[g][tid];
      ss += red_ss[g][tid];
    }
    const size_t row = static_cast<size_t>(blockIdx.x) * 2;
    partial[row * k + n0 + tid] = s;
    partial[(row + 1) * k + n0 + tid] = ss;
  }
}

// s[k] = sum over pixel tiles t of partial[t][0][k], ss likewise from
// partial[t][1][k], summed in tile order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials_kernel(const float* __restrict__ partial,
                       float* __restrict__ s_out, float* __restrict__ ss_out,
                       int m_tiles, int k) {
  const int kk = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (kk >= k) return;
  float s = 0.f, ss = 0.f;
  for (int t = 0; t < m_tiles; ++t) {
    s += partial[(static_cast<size_t>(t) * 2) * k + kk];
    ss += partial[(static_cast<size_t>(t) * 2 + 1) * k + kk];
  }
  s_out[kk] = s;
  ss_out[kk] = ss;
}

}  // namespace

// Plain C entry point (bound with ctypes).  x [n,h,wd,c] f32, w [3,3,c,k]
// f32; writes z [n,h,wd,k], the scratch `partial` [ceil(n*h*wd/64), 2, k]
// and s, ss [k], all f32.  Launches both kernels on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int mcmda_conv_stats(const void* x, const void* w, void* z,
                                void* partial, void* s, void* ss, int n,
                                int h, int wd, int c, int k, int dil,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_tiles = (n * h * wd + BM - 1) / BM;
  const dim3 grid(m_tiles, (k + BN - 1) / BN);
  conv_stats_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(z), static_cast<float*>(partial), n, h, wd, c, k,
      dil);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(k + REDUCE_THREADS - 1) / REDUCE_THREADS,
                           REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(s),
      static_cast<float*>(ss), m_tiles, k);
  return static_cast<int>(cudaGetLastError());
}
