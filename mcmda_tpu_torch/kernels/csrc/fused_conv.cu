// Fused stride-1 3x3 (dilated) conv + folded eval-BN affine + optional
// residual add + activation, NHWC activations and HWIO weights.
//
// Replaces: mcmda_tpu/kernels/fused_conv.py, conv_bn_act_pallas (the Pallas
// TPU kernel behind segmenter.apply_fused_eval).  Computes exactly what
// conv_bn_act_reference computes off the TPU: for every output element the
// sum over 9 taps x C of x (zero outside the image, i.e. XLA SAME padding of
// `dilation` on each side) times w, accumulated in f32, then `* scale + bias`,
// `+ residual` when given, and relu / leaky relu (0.2) / none.  x and the
// residual may be f32 or bf16 and are widened to f32 on load; w, scale and
// bias are f32; the output is always f32.
//
// What bounds it on an H100: the serving path's heavy calls are the 1/8
// resolution tail (32x32 planes, 256-512 channels, 9*C up to 4608 terms per
// output), which is compute-bound: ~2*9*C FLOPs per output element against a
// few bytes.  This first version runs f32 FMAs on the CUDA cores, so its
// ceiling is the card's f32 (non-tensor-core) rate, not the bf16 tensor-core
// rate.
//
// Design: the implicit GEMM of conv_tile.cuh (64-pixel x 64-channel output
// tile per block, one tap x 16 input channels per reduction step, SAME
// padding as a bounds test).  The BN affine, residual and activation are
// applied to the registers before the single store, so the conv output
// never round-trips through device memory.  Unlike the TPU kernel there is
// no VMEM-sized K tiling or fits-in-VMEM gate: the tile is fixed and ragged
// edges (C=3 stem, K=16, M not a multiple of 64) are masked, so every shape
// runs.  wgmma / TMA / bf16 tensor-core payloads are later work.

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

enum Activation { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

template <typename TX, typename TR>
__global__ void __launch_bounds__(THREADS)
conv_bn_act_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, const TR* __restrict__ res,
                   float* __restrict__ out, int n_img, int h, int wd, int c,
                   int k, int dil, int act) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int m_total = n_img * h * wd;
  float acc[TM][TN];
  mainloop(x, w, n_img, h, wd, c, k, dil, m0, n0, As, Bs, acc);

  // epilogue: folded BN affine, residual, activation, one f32 store
  const int tm = thread_row(threadIdx.x);
  const int tn = thread_col(threadIdx.x);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kk = n0 + tn + j;
      if (kk >= k) continue;
      const size_t o = static_cast<size_t>(m) * k + kk;
      float y = acc[i][j] * scale[kk] + bias[kk];
      if (res != nullptr) y += to_f32(res[o]);
      if (act == kRelu) {
        y = fmaxf(y, 0.f);
      } else if (act == kLeakyRelu) {
        y = y >= 0.f ? y : 0.2f * y;
      }
      out[o] = y;
    }
  }
}

template <typename TX, typename TR>
void launch(const void* x, const void* w, const void* scale, const void* bias,
            const void* res, void* out, int n, int h, int wd, int c, int k,
            int dil, int act, cudaStream_t stream) {
  const int m_total = n * h * wd;
  const dim3 grid((m_total + BM - 1) / BM, (k + BN - 1) / BN);
  conv_bn_act_kernel<TX, TR><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const TR*>(res), static_cast<float*>(out), n, h, wd, c, k,
      dil, act);
}

}  // namespace

// Plain C entry point (bound with ctypes).  x_bf16 / res_bf16 select the
// element type of x and of the residual (0 = f32, 1 = bf16); res may be null.
// act: 0 none, 1 relu, 2 leaky relu (0.2).  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int mcmda_conv_bn_act(const void* x, int x_bf16, const void* w,
                                 const void* scale, const void* bias,
                                 const void* res, int res_bf16, void* out,
                                 int n, int h, int wd, int c, int k, int dil,
                                 int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (res_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, bias, res, out, n, h,
                                           wd, c, k, dil, act, s);
    } else {
      launch<__nv_bfloat16, float>(x, w, scale, bias, res, out, n, h, wd, c,
                                   k, dil, act, s);
    }
  } else {
    if (res_bf16) {
      launch<float, __nv_bfloat16>(x, w, scale, bias, res, out, n, h, wd, c,
                                   k, dil, act, s);
    } else {
      launch<float, float>(x, w, scale, bias, res, out, n, h, wd, c, k, dil,
                           act, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
