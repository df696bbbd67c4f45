// conv2d_com: direct convolution of one image (H, W, C) with weights
// (K, K, C, M) -> (H_out, W_out, M), with no im2col: the K*K kernel positions
// are K*K shifted (pixels, C) x (C, M) products summed into an f32
// accumulator, then ReLU or nothing, then one store in the input type.
//
// Replaces the Pallas TPU kernel repro.kernels.conv2d_com.conv2d_com
// (src/repro/kernels/conv2d_com.py:61, pallas_call at :98). On the TPU the
// grid is (H_out/bh, K*K) with the K*K axis sequential and the halo row
// blocks stacked by the wrapper; here one block owns an 8 x 8 pixel by 64
// channel output tile, loads its input halo tile into shared memory once per
// channel chunk, and re-slices it for every kernel position (the RIFM's
// in-buffer shift, paper §II-B): each input value is read from device memory
// once per block and reused K*K times. Padding, ragged tiles and channel
// tails are masked in the kernel.
//
// What bounds it on an H100: the VGG-16 layers carry 100-600 flop per byte,
// above the f32 ridge (20), so f32 FMA throughput bounds them; the first
// layer (C = 3) is bound by device-memory bandwidth.
// What the design does about it: each thread keeps 4 pixels x 4 channels in
// registers, so every shared-memory value feeds 4 FMAs. Left for later:
// larger register tiles, tensor cores for bf16, cp.async staging.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BH = 8, BW = 8;  // output pixels per block
constexpr int BMC = 64;        // output channels per block
constexpr int BC = 8;          // input channels per shared-memory chunk
constexpr int NT = 256;        // threads: 16 pixel groups x 16 channel groups

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Thread (tp, tc) owns pixels tp + 16*i and channels tc + 16*j (i, j < 4):
// a warp reads 16 consecutive weight words (no bank conflict) and two input
// words (broadcast), and its stores write 16 consecutive channels per pixel.
template <typename T>
__global__ void __launch_bounds__(NT)
conv2d_com_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                  int H, int W, int C, int K, int M, int stride, int pad, int Ho, int Wo,
                  int relu) {
  extern __shared__ float smem[];
  const int HH = (BH - 1) * stride + K, WW = (BW - 1) * stride + K;
  float* xs = smem;                    // [HH][WW][BC] input halo tile
  float* wsm = smem + HH * WW * BC;    // [K*K][BC][BMC] weight slice

  const int tiles_w = (Wo + BW - 1) / BW;
  const int oy0 = (blockIdx.x / tiles_w) * BH, ox0 = (blockIdx.x % tiles_w) * BW;
  const int m0 = blockIdx.y * BMC;
  const int iy0 = oy0 * stride - pad, ix0 = ox0 * stride - pad;
  const int tid = threadIdx.x, tc = tid % 16, tp = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int xoff[4];  // offset of each owned pixel's window corner in the halo tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    xoff[i] = ((p / BW) * stride * WW + (p % BW) * stride) * BC;
  }

  for (int c0 = 0; c0 < C; c0 += BC) {
    for (int e = tid; e < HH * WW * BC; e += NT) {
      const int c = e % BC, p = e / BC;
      const int iy = iy0 + p / WW, ix = ix0 + p % WW, gc = c0 + c;
      xs[e] = (iy >= 0 && iy < H && ix >= 0 && ix < W && gc < C)
                  ? to_f32(x[((long long)iy * W + ix) * C + gc])
                  : 0.f;
    }
    for (int e = tid; e < K * K * BC * BMC; e += NT) {
      const int m = e % BMC, r = e / BMC;
      const int c = r % BC, kp = r / BC;
      const int gc = c0 + c, gm = m0 + m;
      wsm[e] = (gc < C && gm < M) ? to_f32(w[((long long)kp * C + gc) * M + gm]) : 0.f;
    }
    __syncthreads();
    for (int kr = 0; kr < K; ++kr) {
      for (int kc = 0; kc < K; ++kc) {
        const float* wk = wsm + (kr * K + kc) * BC * BMC;
        const int shift = (kr * WW + kc) * BC;
#pragma unroll
        for (int c = 0; c < BC; ++c) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = xs[xoff[i] + shift + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = wk[c * BMC + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = tp + 16 * i;
    const int oy = oy0 + p / BW, ox = ox0 + p % BW;
    if (oy >= Ho || ox >= Wo) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + tc + 16 * j;
      if (m >= M) continue;
      float v = acc[i][j];
      if (relu) v = fmaxf(v, 0.f);
      out[((long long)oy * Wo + ox) * M + m] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int H, int W, int C, int K, int M,
           int stride, int pad, int Ho, int Wo, int relu, cudaStream_t stream) {
  const int HH = (BH - 1) * stride + K, WW = (BW - 1) * stride + K;
  const size_t smem = sizeof(float) * ((size_t)HH * WW * BC + (size_t)K * K * BC * BMC);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);  // 227 KB a block
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv2d_com_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(((Ho + BH - 1) / BH) * ((Wo + BW - 1) / BW), (M + BMC - 1) / BMC);
  conv2d_com_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), H, W, C, K, M,
      stride, pad, Ho, Wo, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. relu: 0 none, 1 ReLU. H_out and W_out are
// given by the caller, which allocated out. Returns cudaGetLastError() after
// the launch (or the error that kept it from launching).
extern "C" int repro_conv2d_com(const void* x, const void* w, void* out, int H, int W, int C,
                                int K, int M, int stride, int pad, int Ho, int Wo, int relu,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0 || C <= 0 || K <= 0 || M <= 0 || stride <= 0 || pad < 0 || Ho <= 0 ||
      Wo <= 0 || (M + BMC - 1) / BMC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(x, w, out, H, W, C, K, M, stride, pad, Ho, Wo, relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, out, H, W, C, K, M, stride, pad, Ho, Wo, relu, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
