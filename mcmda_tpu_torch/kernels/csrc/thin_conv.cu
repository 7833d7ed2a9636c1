// SAME 3x3 stride-1 conv of a thin NHWC input (the segmenter's 3-channel
// stem) into a channels-first output.
//
// Replaces: mcmda_tpu/kernels/thin_conv.py, stem_conv_cf (the Pallas TPU
// kernel _fwd_kernel behind stem_conv_nhwc / stem_apply_cf).  Computes
//   y[n,k,h,w] = sum_{c,dy,dx} x[n, h+dy-1, w+dx-1, c] * w[dy,dx,c,k]
// with out-of-range input pixels read as 0 (SAME padding), x [N,H,W,C] f32,
// w [3,3,C,K] f32 (HWIO), y [N,K,H,W] f32.  The weight gradient and the
// BN + ReLU around it are plain PyTorch (the JAX package leaves them to XLA).
//
// What bounds it on an H100: memory.  At the main shape (N=8, 256x256,
// C=3, K=16) it reads 6.3 MB and writes 33.6 MB, ~12 us at 3.35 TB/s, for
// 0.45 GFLOP, ~7 us at the 67 TFLOP/s f32 rate; writing the output is most
// of the work.
//
// Design: one thread per output pixel.  The TPU kernel ran 27*K
// scalar-by-plane FMAs so that W filled its vector lanes; here a thread
// reads its 3x3xC neighbourhood straight from NHWC (SAME padding as a
// bounds test, no padded copy), keeps the K accumulators in registers and
// writes its K channel planes, neighbouring threads on neighbouring w, so
// every store of a warp is one coalesced 128-byte line.  The weights
// (C*9*K floats, copied in on the launch's stream) sit in constant memory:
// every thread of a warp reads the same weight at the same time, which the
// constant cache broadcasts, and with C a template argument (3, the stem)
// the loops unroll so that each FMA takes its weight as a constant-bank
// operand, with no load instruction (from shared memory every FMA would
// need a load of its own).  Products are summed in the order (dy, dx, c),
// each an FMA.  The weights are one copy per library, so launches on two
// streams must not overlap.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 16;
constexpr int MAX_K = 32;

__constant__ float c_w[9 * MAX_C * MAX_K];  // [3,3,C,K]

// C > 0: the input channel count, known at compile time; C == 0: c_rt.
template <int K, int C>
__global__ void __launch_bounds__(THREADS)
stem_conv_kernel(const float* __restrict__ x, float* __restrict__ y, int n,
                 int h, int wd, int c_rt) {
  const int c = C > 0 ? C : c_rt;
  const size_t plane = static_cast<size_t>(h) * wd;
  const size_t p = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= static_cast<size_t>(n) * plane) return;
  const int ni = static_cast<int>(p / plane);
  const int rem = static_cast<int>(p - static_cast<size_t>(ni) * plane);
  const int hi = rem / wd;
  const int wi = rem - hi * wd;

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  const float* xn = x + static_cast<size_t>(ni) * plane * c;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = hi + dy - 1;
    if (yy < 0 || yy >= h) continue;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int xx = wi + dx - 1;
      if (xx < 0 || xx >= wd) continue;
      const float* xp = xn + (static_cast<size_t>(yy) * wd + xx) * c;
      const float* wt = c_w + (dy * 3 + dx) * c * K;
#pragma unroll
      for (int ci = 0; ci < c; ++ci) {
        const float v = xp[ci];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = fmaf(v, wt[ci * K + k], acc[k]);
      }
    }
  }
  float* yo = y + static_cast<size_t>(ni) * K * plane + rem;
#pragma unroll
  for (int k = 0; k < K; ++k) yo[static_cast<size_t>(k) * plane] = acc[k];
}

template <int K>
int launch(const float* x, const float* w, float* y, int n, int h, int wd,
           int c, cudaStream_t stream) {
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_w, w, static_cast<size_t>(9) * c * K * sizeof(float), 0,
      cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t pixels = static_cast<size_t>(n) * h * wd;
  const unsigned blocks =
      static_cast<unsigned>((pixels + THREADS - 1) / THREADS);
  if (c == 3) {
    stem_conv_kernel<K, 3><<<blocks, THREADS, 0, stream>>>(x, y, n, h, wd, c);
  } else {
    stem_conv_kernel<K, 0><<<blocks, THREADS, 0, stream>>>(x, y, n, h, wd, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  x [n,h,wd,c] f32, w [3,3,c,k]
// f32 (device memory), y [n,k,h,wd] f32; k must be 8, 16 or 32 (the
// accumulators are registers), c at most 16 (the weights fit the constant
// bank).  Copies w and launches on `stream` without synchronising; returns
// the first CUDA error (cudaErrorInvalidValue for an unsupported c or k).
extern "C" int mcmda_stem_conv(const void* x, const void* w, void* y, int n,
                               int h, int wd, int c, int k, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 8: return launch<8>(xf, wf, yf, n, h, wd, c, s);
    case 16: return launch<16>(xf, wf, yf, n, h, wd, c, s);
    case 32: return launch<32>(xf, wf, yf, n, h, wd, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
