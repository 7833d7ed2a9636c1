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
// What bounds it on an H100: memory, with the load / store unit and the
// CUDA cores close behind.  At the main shape (N=8, 256x256, C=3, K=16) it
// reads 6.3 MB and writes 33.6 MB, ~12 us at 3.35 TB/s, for 0.45 GFLOP, ~7
// us at the 67 TFLOP/s f32 rate: writing the output is most of the work,
// every instruction that is not an FMA takes a scheduler slot from one, and
// every load of x that touches many cache lines takes the load / store
// unit's time from the stores.
//
// Design.  The TPU kernel ran 27*K scalar-by-plane FMAs so that W filled
// its vector lanes; here
// - a thread makes 4 adjacent pixels along W of all K channels, the 4*K
//   sums in registers: its 3 x 6 x C neighbourhood is read once for four
//   outputs, and each output channel's four values leave as one float4, a
//   warp writing 512 contiguous bytes of one channel plane (where W % 4 != 0
//   or y is not 16-byte aligned the same threads store their valid pixels
//   one by one);
// - the 9*C*K weights are loaded by every block from global memory (they
//   stay in L2) into shared memory once; one broadcast 128-bit read of four
//   k-weights then feeds 16 FMAs.  No launch copies anything or shares
//   state with another, so launches on different streams are independent;
// - a block walks over many tiles (BLOCKS_PER_SM blocks per SM cover the
//   card once): a thread's stores are not waited for, so one tile's output
//   drains while the next tile is computed, where a block per tile would
//   compute, then store, then end;
// - x comes through the read-only path.  At C = 3 with W % 4 == 0 and an
//   aligned x a thread's 18 floats of a row are five aligned 16-byte loads:
//   a third of the load instructions and of the cache lines they touch,
//   which measurably frees the load / store unit.  (Staging the block's
//   rows with their halo in shared memory by coalesced 16-byte loads was
//   slower on an H100: a barrier and an exposed load per tile.)  Every
//   other shape reads 4 bytes at a time: any C, any alignment;
// - SAME padding is a bounds test that reads 0, and the products are summed
//   in the order (dy, dx, c), each an FMA: an out-of-range tap adds
//   fma(0, w, acc) = acc, so y is what one-pixel-per-thread summation in
//   that order gives.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// the fastest block shape and grid of those timed on an H100
constexpr int BLOCK_X = 32;  // threads along W, each 4 pixels
constexpr int BLOCK_Y = 8;   // rows
constexpr int BLOCKS_PER_SM = 2;  // grid = SMs x this
constexpr int THREADS = BLOCK_X * BLOCK_Y;
constexpr int PX = 4;  // pixels per thread
constexpr int MAX_C = 16;

// C > 0: the input channel count, known at compile time; C == 0: c_rt.
// VECX (C == 3 only): x is read 16 bytes at a time, which needs wd % 4 == 0
// and x 16-byte aligned.  vec: y rows hold whole aligned float4s.
template <int K, int C, bool VECX>
__global__ void __launch_bounds__(THREADS)
stem_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, int n, int h, int wd, int c_rt,
                 int vec) {
  static_assert(!VECX || C == 3,
                "float4 reads of x are for the 3-channel stem");
  const int c = C > 0 ? C : c_rt;
  __shared__ __align__(16) float s_w[9 * (C > 0 ? C : MAX_C) * K];
  const int lx = threadIdx.x % BLOCK_X;
  const int ly = threadIdx.x / BLOCK_X;
  const size_t plane = static_cast<size_t>(h) * wd;
  const int tiles_x = (wd + BLOCK_X * PX - 1) / (BLOCK_X * PX);
  const int tiles_y = (h + BLOCK_Y - 1) / BLOCK_Y;
  const int tiles = n * tiles_y * tiles_x;

  for (int i = threadIdx.x; i < 9 * c * K; i += THREADS) s_w[i] = __ldg(w + i);
  __syncthreads();

  // a block walks over tiles (image, row block, column block): its stores
  // of one tile drain while it computes the next
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int ni = tile / (tiles_y * tiles_x);
    const int x0 = tile % tiles_x * BLOCK_X * PX;
    const int y0 = tile / tiles_x % tiles_y * BLOCK_Y;
    const int w0 = x0 + lx * PX;
    const int hi = y0 + ly;
    const float* xn = x + static_cast<size_t>(ni) * plane * c;
    if (w0 >= wd || hi >= h) continue;

    float acc[PX][K];
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
      for (int k = 0; k < K; ++k) acc[p][k] = 0.f;

#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = hi + dy - 1;
      // compile-time C: the row's 6 x C values (pixels w0-1 .. w0+4), 0
      // outside the image
      float xr[C > 0 ? 6 * C : 1];
      const float* row = nullptr;
      if (yy < 0 || yy >= h) continue;  // the next dy
      if constexpr (VECX) {
        // the 18 floats from pixel w0-1 on start 1 float into the five
        // aligned float4s from float 3*w0 - 4 of the row; each float4 lies
        // wholly inside or outside the row because wd % 4 == 0
        float q[20];
        const float4* sr = reinterpret_cast<const float4*>(
                               xn + static_cast<size_t>(yy) * wd * C) +
                           (C * w0 / 4 - 1);
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const int f = C * w0 - 4 + 4 * j;
          float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
          if (f >= 0 && f < wd * C) t = __ldg(sr + j);
          q[4 * j + 0] = t.x;
          q[4 * j + 1] = t.y;
          q[4 * j + 2] = t.z;
          q[4 * j + 3] = t.w;
        }
#pragma unroll
        for (int j = 0; j < 6 * C; ++j) xr[j] = q[j + 1];
      } else {
        row = xn + static_cast<size_t>(yy) * wd * c;
        if constexpr (C > 0) {
#pragma unroll
          for (int col = 0; col < 6; ++col) {
            const int xx = w0 + col - 1;
            const bool in = xx >= 0 && xx < wd;
#pragma unroll
            for (int ci = 0; ci < C; ++ci)
              xr[col * C + ci] = in ? __ldg(row + xx * C + ci) : 0.f;
          }
        }
      }
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int ci = 0; ci < (C > 0 ? C : c); ++ci) {
          float xv[PX];
#pragma unroll
          for (int p = 0; p < PX; ++p) {
            if constexpr (C > 0) {
              xv[p] = xr[(p + dx) * C + ci];
            } else {
              const int xx = w0 + p + dx - 1;
              xv[p] = xx >= 0 && xx < wd ? __ldg(row + xx * c + ci) : 0.f;
            }
          }
          const float4* wq = reinterpret_cast<const float4*>(
              s_w + ((dy * 3 + dx) * c + ci) * K);
#pragma unroll
          for (int kq = 0; kq < K / 4; ++kq) {
            const float4 wv = wq[kq];
#pragma unroll
            for (int p = 0; p < PX; ++p) {
              acc[p][4 * kq + 0] = fmaf(xv[p], wv.x, acc[p][4 * kq + 0]);
              acc[p][4 * kq + 1] = fmaf(xv[p], wv.y, acc[p][4 * kq + 1]);
              acc[p][4 * kq + 2] = fmaf(xv[p], wv.z, acc[p][4 * kq + 2]);
              acc[p][4 * kq + 3] = fmaf(xv[p], wv.w, acc[p][4 * kq + 3]);
            }
          }
        }
      }
    }

    float* yo = y + (static_cast<size_t>(ni) * K * h + hi) * wd + w0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (vec) {
        *reinterpret_cast<float4*>(yo + k * plane) =
            make_float4(acc[0][k], acc[1][k], acc[2][k], acc[3][k]);
      } else {
#pragma unroll
        for (int p = 0; p < PX; ++p)
          if (w0 + p < wd) yo[k * plane + p] = acc[p][k];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int K>
int launch(const float* x, const float* w, float* y, int n, int h, int wd,
           int c, cudaStream_t stream) {
  const long long tiles =
      static_cast<long long>(n) *
      ((h + BLOCK_Y - 1) / BLOCK_Y) *
      ((wd + BLOCK_X * PX - 1) / (BLOCK_X * PX));
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cover = static_cast<long long>(sms) * BLOCKS_PER_SM;
  const int grid = static_cast<int>(tiles < cover ? tiles : cover);
  const int vec = wd % 4 == 0 && aligned16(y) ? 1 : 0;
  if (c == 3 && wd % 4 == 0 && aligned16(x)) {
    stem_conv_kernel<K, 3, true>
        <<<grid, THREADS, 0, stream>>>(x, w, y, n, h, wd, c, vec);
  } else if (c == 3) {
    stem_conv_kernel<K, 3, false>
        <<<grid, THREADS, 0, stream>>>(x, w, y, n, h, wd, c, vec);
  } else {
    stem_conv_kernel<K, 0, false>
        <<<grid, THREADS, 0, stream>>>(x, w, y, n, h, wd, c, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  x [n,h,wd,c] f32, w [3,3,c,k]
// f32 (device memory), y [n,k,h,wd] f32; k must be 8, 16 or 32 (the sums
// are registers), c at most 16 (the weights' shared memory).  Launches on
// `stream` without synchronising; returns the first CUDA error
// (cudaErrorInvalidValue for an unsupported c or k).
extern "C" int mcmda_stem_conv(const void* x, const void* w, void* y, int n,
                               int h, int wd, int c, int k, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c < 1 || c > MAX_C || n < 1 || h < 1 || wd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 8: return launch<8>(xf, wf, yf, n, h, wd, c, s);
    case 16: return launch<16>(xf, wf, yf, n, h, wd, c, s);
    case 32: return launch<32>(xf, wf, yf, n, h, wd, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
