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
// What bounds it on an H100: the rm3-rm6 tail (32x32 planes, 128-512 input
// channels, 128-512 output channels) is compute-bound, ~2*9*C FLOPs per
// output element against a few bytes.  The conv runs in split TF32 on the
// tensor cores (conv_tile.cuh: three TF32 products per f32 product), so its
// ceiling is 495/3 = 165 TFLOP/s of f32-accurate work.  The moments add one
// pass over the accumulator fragments while they are in registers, so z is
// written once and never read back to reduce it.
//
// Design: the implicit GEMM of conv_tile.cuh, on the loop conv_tile::plan
// gives the shape: the Hopper loop (TMA + wgmma, after the weight pre-pass)
// for every site of the default stages (rm3's 128 -> 128, rm4-rm6), the
// mma.sync loop for the rest; both give the same bits.  Epilogue: store z
// (float2 per pair of adjacent channels); then the moments in a fixed order
// at every stage: each thread sums its rows per channel, warp shuffles combine
// the 8 row groups of a fragment, shared memory combines the warps of the
// block, and the block writes one partial (sum, sum of squares) per pixel
// tile and channel to a [m_tiles, 2, K] buffer.  A second small kernel sums
// the partials of each channel over the pixel tiles, again in a fixed order.
// No float atomics: a seeded run repeats bit for bit.  The TPU kernel
// instead carried the moments across its sequential batch grid in VMEM;
// blocks here run in no order, hence the second pass.

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

constexpr int REDUCE_THREADS = 128;

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
conv_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ z, float* __restrict__ partial,
                  int n_img, int h, int wd, int c, int k, int dil) {
  using L = MainLoop<float, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  // after the ring: per-warp-row column sums, [WARPS_M][BN] twice
  float* red_s = reinterpret_cast<float*>(smem + L::SMEM_BYTES);
  float* red_ss = red_s + T::WARPS_M * T::BN;

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * T::BN;
  const int m_total = n_img * h * wd;
  float acc[T::MT][T::NT][4];
  L::run(x, w, n_img, h, wd, c, k, dil, m0, n0, smem, acc);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool pairs = k % 2 == 0;
  // store z; rows past m_total hold exact zeros and add nothing below
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const int col = n0 + L::frag_col(warp, lane, nt);
    if (col >= k) continue;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + L::frag_row(warp, lane, mt, half);
        if (m >= m_total) continue;
        const size_t o = static_cast<size_t>(m) * k + col;
        const float y0 = acc[mt][nt][2 * half];
        const float y1 = acc[mt][nt][2 * half + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(z + o) = make_float2(y0, y1);
        } else {
          z[o] = y0;
          if (col + 1 < k) z[o + 1] = y1;
        }
      }
    }
  }
  // moments: this thread's rows (m-tiles, then g / g+8), then the 8 row
  // groups g of the warp by xor shuffles (lane = 4g + t; IEEE addition is
  // commutative, so every lane of a butterfly gets the same bits)
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v = acc[mt][nt][2 * half + j];
          s += v;
          ss = fmaf(v, v, ss);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (lane < 4) {
        const int wm = warp / T::WARPS_N;
        const int col = L::frag_col(warp, lane, nt) + j;
        red_s[wm * T::BN + col] = s;
        red_ss[wm * T::BN + col] = ss;
      }
    }
  }
  __syncthreads();
  // the warp rows of the block, in order: one partial per channel
  const int tid = threadIdx.x;
  if (tid < T::BN && n0 + tid < k) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int wm = 0; wm < T::WARPS_M; ++wm) {
      s += red_s[wm * T::BN + tid];
      ss += red_ss[wm * T::BN + tid];
    }
    const size_t row = static_cast<size_t>(blockIdx.x) * 2;
    partial[row * k + n0 + tid] = s;
    partial[(row + 1) * k + n0 + tid] = ss;
  }
}

// The Hopper loop's kernel (conv_tile::hopper).  z is stored from the
// wgmma accumulators; the moments are summed in the order in which the
// mma.sync loop's kernel above sums them for this shape, so that both
// loops give the same bits: the accumulator tile goes through shared memory
// (the ring, free once every consumer is past it), each warp row of the
// mma.sync tile (`tile_rows` pixel rows: Tile128's 64 or Tile64's 32) is
// summed per channel by its 8 row groups (rows g, g+8, ... in order), the
// groups meet by xor shuffles, and the warp rows in order.
template <int BN>
__global__ void __launch_bounds__(hopper::THREADS, 1)
conv_stats_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap hi_map,
                  const __grid_constant__ CUtensorMap lo_map,
                  float* __restrict__ z, float* __restrict__ partial, int h,
                  int wd, int c, int k, int dil, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Lp = hopper::Loop<BN>;
  constexpr int LD = BN + 4;  // tile row stride: conflict-free column reads
  Lp::run(smem, &xmap, &hi_map, &lo_map, h, wd, c, dil,
          [&](float (&acc)[Lp::ACC], int row, int col0) {
    float* tile = reinterpret_cast<float*>(Lp::ring(smem));
    // per-warp-row column sums, [BM / tile_rows][BN] twice
    float* red_s = reinterpret_cast<float*>(Lp::extra(smem));
    float* red_ss = red_s + hopper::BM / 16 * BN;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int m0 = blockIdx.x * hopper::BM;
    const int n0 = blockIdx.y * BN;
    hopper::consumer_sync();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 v =
            make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        *reinterpret_cast<float2*>(
            z + static_cast<size_t>(row + 8 * half) * k + col) = v;
        *reinterpret_cast<float2*>(
            tile + (row - m0 + 8 * half) * LD + col - n0) = v;
      }
    }
    hopper::consumer_sync();
    // one warp per (warp row, 4 channels): lane = 4 g + t
    const int warp_rows = hopper::BM / tile_rows;
    for (int u = tid >> 5; u < warp_rows * (BN / 4);
         u += hopper::CONSUMERS * 4) {
      const int wm = u / (BN / 4);
      const int cc = (u % (BN / 4)) * 4 + (lane & 3);
      float s = 0.f, ss = 0.f;
      for (int r = wm * tile_rows + (lane >> 2); r < (wm + 1) * tile_rows;
           r += 8) {
        const float v = tile[r * LD + cc];
        s += v;
        ss = fmaf(v, v, ss);
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (lane < 4) {
        red_s[wm * BN + cc] = s;
        red_ss[wm * BN + cc] = ss;
      }
    }
    hopper::consumer_sync();
    if (tid < BN) {
      float s = 0.f, ss = 0.f;
      for (int wm = 0; wm < warp_rows; ++wm) {
        s += red_s[wm * BN + tid];
        ss += red_ss[wm * BN + tid];
      }
      const size_t prow = static_cast<size_t>(blockIdx.x) * 2;
      partial[prow * k + n0 + tid] = s;
      partial[(prow + 1) * k + n0 + tid] = ss;
    }
  });
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

template <class T>
cudaError_t launch(const void* x, const void* w, void* z, void* partial,
                   int n, int h, int wd, int c, int k, int dil,
                   cudaStream_t stream) {
  auto kernel = conv_stats_kernel<T>;
  const size_t smem =
      MainLoop<float, T>::SMEM_BYTES + 2 * sizeof(float) * T::WARPS_M * T::BN;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(m_tiles(n * h * wd), (k + T::BN - 1) / T::BN);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(z), static_cast<float*>(partial), n, h, wd, c, k,
      dil);
  return cudaGetLastError();
}

// The Hopper loop: the tensor maps and the weight pre-pass, then the conv +
// moments.
template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, void* w_hi, void* w_lo,
                         void* z, void* partial, int n, int h, int wd, int c,
                         int k, int dil, const Plan& p, cudaStream_t stream) {
  hopper::Maps maps;
  cudaError_t err =
      prepare_wgmma(&maps, x, w, w_hi, w_lo, n, h, wd, c, k, p, stream);
  if (err != cudaSuccess) return err;
  auto kernel = conv_stats_kernel<BN>;
  const size_t smem = hopper::Layout<BN>::smem_bytes(
      2 * sizeof(float) * (hopper::BM / 16) * BN);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // the warp rows of the mma.sync tile this shape would take there
  const int tile_rows = pick_tile(n * h * wd, k, device_sms()) == kTile128
                            ? Tile128::WM
                            : Tile64::WM;
  kernel<<<dim3(p.grid_x, p.grid_y), hopper::THREADS, smem, stream>>>(
      maps.x, maps.w_hi, maps.w_lo, static_cast<float*>(z),
      static_cast<float*>(partial), h, wd, c, k, dil, tile_rows);
  return cudaGetLastError();
}

}  // namespace

// The number of pixel tiles, i.e. the rows of the `partial` scratch that
// mcmda_conv_stats needs for an output of m = n*h*wd pixels (both loops
// tile 128 pixels).
extern "C" int mcmda_conv_stats_partial_tiles(int m) { return m_tiles(m); }

// Plain C entry point (bound with ctypes).  x [n,h,wd,c] f32, w [3,3,c,k]
// f32; writes z [n,h,wd,k], the scratch `partial`
// [mcmda_conv_stats_partial_tiles(n*h*wd), 2, k] and s, ss [k], all f32.
// w_hi / w_lo are the Hopper loop's scratch, two f32 [k, 9c] arrays, needed
// where mcmda_conv_plan says loop 1 (else they may be null).  Launches its
// kernels on `stream` without synchronising and returns the first CUDA
// error (0 on success).
extern "C" int mcmda_conv_stats(const void* x, const void* w, void* w_hi,
                                void* w_lo, void* z, void* partial, void* s,
                                void* ss, int n, int h, int wd, int c, int k,
                                int dil, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = plan(n, h, wd, c, k, false, device_sms());
  cudaError_t err;
  if (p.loop == kWgmma) {
    err = p.bn == 128 ? launch_wgmma<128>(x, w, w_hi, w_lo, z, partial, n, h,
                                          wd, c, k, dil, p, st)
                      : launch_wgmma<64>(x, w, w_hi, w_lo, z, partial, n, h,
                                         wd, c, k, dil, p, st);
  } else {
    switch (p.bn) {
      case 16:
        err = launch<Tile16>(x, w, z, partial, n, h, wd, c, k, dil, st);
        break;
      case 32:
        err = launch<Tile32>(x, w, z, partial, n, h, wd, c, k, dil, st);
        break;
      case 64:
        err = launch<Tile64>(x, w, z, partial, n, h, wd, c, k, dil, st);
        break;
      default:
        err = launch<Tile128>(x, w, z, partial, n, h, wd, c, k, dil, st);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials_kernel<<<(k + REDUCE_THREADS - 1) / REDUCE_THREADS,
                           REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(s),
      static_cast<float*>(ss), m_tiles(n * h * wd), k);
  return static_cast<int>(cudaGetLastError());
}
