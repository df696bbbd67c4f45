// com_matmul: tiled (M,K) @ (K,N) with an f32 accumulator and the fused ROFM
// epilogue  out = act(acc + bias) + residual,  one store in the input type.
//
// Replaces the Pallas TPU kernel repro.kernels.com_matmul.com_matmul
// (src/repro/kernels/com_matmul.py:69, pallas_call at :108) and its
// zero-padding wrapper com_matmul_padded (:123). The TPU kernel walks K as a
// sequential grid axis with the partial sum in a VMEM scratch; here one block
// owns an output tile and a loop inside the block walks K, the partial sums
// living in registers. Ragged edges are masked in the kernel, so nothing is
// padded on the host.
//
// What bounds it on an H100: the im2col GEMMs of the VGG convolutions carry
// 30-600 flop per byte, above the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20),
// so they are bound by f32 FMA throughput: strict f32 does not run on the
// tensor cores. The first conv (K = 27) and the B = 8 FC layers (each weight
// used 8 times) are bound by device-memory bandwidth.
// What the design does about it: each thread keeps a TM x TN block of outputs
// in registers and forms outer products from shared-memory tiles, so a value
// read from shared memory feeds TM or TN FMAs and a value read from device
// memory feeds BM or BN of them. A skinny-M tile (32 x 32) gives the FC layers
// enough blocks to stream their weights from all SMs.
// Left for later: TF32/bf16 wgmma, cp.async/TMA double buffering, split-K for
// the FC layers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_SILU:
      return v / (1.f + expf(-v));
    case ACT_GELU: {  // tanh form, as jax.nn.gelu by default
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    default:
      return v;
  }
}

// One block computes a BM x BN output tile with (BM/TM) x (BN/TN) threads.
// Thread (ty, tx) owns rows ty + i*TY and columns tx + j*TX: with TX = 16 a
// warp reads 16 consecutive words of the w tile (no bank conflict) and two
// neighbouring words of the x tile (broadcast), and its stores are coalesced.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
com_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, const T* __restrict__ res,
                  T* __restrict__ out, int M, int N, int K, int act) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  // x tile stored k-major; the +4 pad spreads a warp's transposing stores
  // over all 32 banks
  __shared__ float xs[BK][BM + 4];
  __shared__ float wsh[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int i = e / BK, kk = e % BK;
      const long long gm = m0 + i;
      const int gk = k0 + kk;
      xs[kk][i] = (gm < M && gk < K) ? to_f32(x[gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, j = e % BN;
      const int gk = k0 + kk, gn = n0 + j;
      wsh[kk][j] = (gk < K && gn < N) ? to_f32(w[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = wsh[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the epilogue of the last K step: Add (bias), Act, Bp (residual), one store
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += to_f32(bias[gn]);
      v = activate(v, act);
      if (res != nullptr) v += to_f32(res[gm * N + gn]);
      out[gm * N + gn] = from_f32<T>(v);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const void* w, const void* bias, const void* res, void* out,
            int M, int N, int K, int act, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  com_matmul_kernel<T, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out), M, N, K, act);
}

// The tile follows the shape: a skinny-M tile for the batch-sized FC
// products, a half-width tile where N <= 64, the full tile elsewhere.
template <typename T>
void dispatch(const void* x, const void* w, const void* bias, const void* res, void* out,
              int M, int N, int K, int act, cudaStream_t stream) {
  if (M <= 32)
    launch<T, 32, 32, 32, 2, 2>(x, w, bias, res, out, M, N, K, act, stream);
  else if (N <= 64)
    launch<T, 128, 64, 16, 8, 4>(x, w, bias, res, out, M, N, K, act, stream);
  else
    launch<T, 128, 128, 16, 8, 8>(x, w, bias, res, out, M, N, K, act, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 silu, 3 gelu (tanh).
// bias (N,) and res (M,N) may be null. Returns cudaGetLastError() after the
// launch, so a launch the device refused is reported to the caller.
extern "C" int repro_com_matmul(const void* x, const void* w, const void* bias, const void* res,
                                void* out, int M, int N, int K, int act, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0 || act < ACT_NONE || act > ACT_GELU ||
      (N + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    dispatch<float>(x, w, bias, res, out, M, N, K, act, s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(x, w, bias, res, out, M, N, K, act, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
