// conv2d_com: direct convolution of one image (H, W, C) with weights
// (K, K, C, M) -> (H_out, W_out, M), with no im2col in memory: the K*K kernel
// positions are K*K shifted (pixels, C) x (C, M) products summed into an f32
// accumulator, then ReLU or nothing, then one store in the input type.
//
// Replaces the Pallas TPU kernel repro.kernels.conv2d_com.conv2d_com
// (src/repro/kernels/conv2d_com.py:61, pallas_call at :98). On the TPU the
// grid is (H_out/bh, K*K) with the K*K axis sequential and the halo row
// blocks stacked by the wrapper, the input block held in VMEM.
//
// What bounds it on an H100: the VGG-16 layers carry 100-600 flop per byte,
// so the tensor cores (3xTF32 for float32) bound them; the first layer
// (C = 3) is bound by device-memory bandwidth.
// What the design does about it: an implicit GEMM on the shared tensor-core
// mainloop of com_mma.cuh. A block owns 8 x 16 output pixels x 64 output
// channels. Its K loop walks channel chunks of 32 (f32) or 64 (bf16)
// and, inside each chunk, the K*K kernel positions. The input halo tile of a
// chunk is copied once by cp.async and stays in shared memory, re-sliced for
// every (kr, kc) through per-thread pixel offsets (the RIFM's in-buffer
// shift, paper §II-B); the (chunk x 128) weight slice of each position
// streams through the ring. `nh` halo buffers let the next chunk's halo land
// while the current one is still read. Where the per-image grid leaves SMs
// idle (the 28 x 28 and 14 x 14 layers), the (chunk, position) loop is split
// and the ordered split-K pass of com_mma.cuh adds the slices and applies the
// ReLU. The launch plan is chosen in Python (kernels/conv2d_com.py:plan).
#include "com_mma.cuh"

namespace {

using namespace com;

constexpr int TH = 8, TW = 16;  // output pixels of a block: TH x TW = BM

// k-tiles of one channel chunk at one kernel position: 32 channels (f32) or
// 64 (bf16), so that two halo tiles and the weight ring fit two blocks an SM
template <typename T> using ConvLayout = Layout<T, sizeof(T) == 4 ? 32 : 64>;

template <typename T>
struct ConvTiles {
  using L = ConvLayout<T>;
  const T* x;
  const T* w;
  T* halo;  // nh buffers of [HH * WW][as]: pixel-major, channel-minor
  T* ring;  // stages slots of [BK][BS] weights
  int H, W, C, KS, M, stride;
  int iy0, ix0, m0, HH, WW, nh, kt_first, as;
  bool vec_x, vec_w;

  __device__ int halo_elems() const { return HH * WW * as; }
  __device__ int buffer(int kt) const {  // which halo buffer holds k-tile kt's chunk
    const int KK = KS * KS;
    return (kt / KK - kt_first / KK) % nh;
  }
  __device__ const T* a_tile(int kt, int) const {
    const int pos = kt % (KS * KS);
    return halo + buffer(kt) * halo_elems() + ((pos / KS) * WW + pos % KS) * as;
  }
  __device__ const T* b_tile(int slot) const { return ring + slot * L::B_ELEMS; }
  __device__ int row_off(int r) const {
    return ((r / TW) * stride * WW + (r % TW) * stride) * as;
  }

  __device__ void load(int kt, int slot) const {
    const int KK = KS * KS;
    const int pos = kt % KK, c0 = (kt / KK) * L::BK;
    const T zero = from_f32<T>(0.f);
    if (pos == 0 || kt == kt_first) {  // the chunk's halo tile, once
      T* hb = halo + buffer(kt) * halo_elems();
      if (vec_x) {
        constexpr int CPP = L::BK / L::CE;  // 16-byte copies a pixel
        for (int e = threadIdx.x; e < HH * WW * CPP; e += L::THREADS) {
          const int q = e / CPP, c = (e % CPP) * L::CE;
          const int iy = iy0 + q / WW, ix = ix0 + q % WW;
          const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && c0 + c < C;
          cp_async16(hb + q * as + c, ok ? x + ((long long)iy * W + ix) * C + c0 + c : x, ok);
        }
      } else {  // C not a multiple of the copy (the first layer's C = 3): 4-byte
                // copies, or element loads for bf16
        for (int e = threadIdx.x; e < HH * WW * L::BK; e += L::THREADS) {
          const int q = e / L::BK, c = e % L::BK;
          const int iy = iy0 + q / WW, ix = ix0 + q % WW;
          const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && c0 + c < C;
          const T* src = ok ? x + ((long long)iy * W + ix) * C + c0 + c : x;
          if constexpr (sizeof(T) == 4)
            cp_async4(hb + q * as + c, src, ok);
          else
            hb[q * as + c] = ok ? *src : zero;
        }
      }
    }
    T* Bs = ring + slot * L::B_ELEMS;
    const T* wp = w + (long long)pos * C * M;  // w[kr][kc] as (C, M)
    if (vec_w) {
      constexpr int CPR = L::BN / L::CE;
      for (int e = threadIdx.x; e < L::BK * CPR; e += L::THREADS) {
        const int c = e / CPR, j = (e % CPR) * L::CE;
        const bool ok = c0 + c < C && m0 + j < M;
        cp_async16(Bs + c * L::BS + j, ok ? wp + (long long)(c0 + c) * M + m0 + j : w, ok);
      }
    } else {
      for (int e = threadIdx.x; e < L::BK * L::BN; e += L::THREADS) {
        const int c = e / L::BN, j = e % L::BN;
        Bs[c * L::BS + j] = (c0 + c < C && m0 + j < M) ? wp[(long long)(c0 + c) * M + m0 + j] : zero;
      }
    }
  }
};

__host__ __device__ inline int halo_h(int KS, int stride) { return (TH - 1) * stride + KS; }
__host__ __device__ inline int halo_w(int KS, int stride) { return (TW - 1) * stride + KS; }
// halo buffers so that a chunk's halo is never overwritten while read: the
// copy of chunk c + nh starts stages - 1 k-tiles before chunk c + nh begins
inline int halo_buffers(int KS, int stages) { return (stages - 2) / (KS * KS) + 2; }

// The halo's pixel stride (elements) and the block's shared memory: pixels
// padded by 8 elements (conflict-free 8-byte fragment loads), or in float32
// by 4 where that does not fit (a 5 x 5 kernel at stride 2: two-way
// conflicts); -1 where neither fits.
template <typename T>
long long conv_smem(int KS, int stride, int stages, int* as) {
  using L = ConvLayout<T>;
  const long long pixels = (long long)halo_h(KS, stride) * halo_w(KS, stride);
  for (int pad = 8; pad >= 4; pad -= 4) {
    if (pad == 4 && sizeof(T) != 4) break;  // bf16 rows stay 16-byte aligned
    const long long bytes = (long long)sizeof(T) * (halo_buffers(KS, stages) * pixels * (L::BK + pad) +
                                                    (long long)stages * L::B_ELEMS);
    if (bytes <= SMEM_LIMIT) {
      *as = L::BK + pad;
      return bytes;
    }
  }
  return -1;
}

// grid (pixel tiles, M tiles, splits); split z owns k-tiles [z kps, (z + 1) kps)
// of the (chunk, position) sequence
template <typename T>
__global__ void __launch_bounds__(ConvLayout<T>::THREADS, ConvLayout<T>::MIN_BLOCKS)
conv2d_com_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                  float* __restrict__ ws, int H, int W, int C, int KS, int M, int stride, int pad,
                  int Ho, int Wo, int relu, int stages, int nh, int as, int kps, int vec_x,
                  int vec_w) {
  using L = ConvLayout<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tiles_w = (Wo + TW - 1) / TW;
  const int oy0 = (blockIdx.x / tiles_w) * TH, ox0 = (blockIdx.x % tiles_w) * TW;
  const int HH = halo_h(KS, stride), WW = halo_w(KS, stride);
  const int KT = ((C + L::BK - 1) / L::BK) * KS * KS;
  const int kt0 = blockIdx.z * kps;
  const int nkt = min(kps, KT - kt0);
  T* halo = reinterpret_cast<T*>(smem_raw);
  ConvTiles<T> p{x, w, halo, halo + nh * HH * WW * as, H, W, C, KS, M, stride,
                     oy0 * stride - pad, ox0 * stride - pad, (int)blockIdx.y * L::BN, HH, WW, nh,
                     kt0, as, vec_x != 0, vec_w != 0};
  float acc[L::MT][L::NT][4];
  mainloop<T, L::BK>(p, kt0, nkt, stages, acc);
  store_acc<T, L::BK>(
      acc,
      [&](int r) -> long long {
        const int oy = oy0 + r / TW, ox = ox0 + r % TW;
        return oy < Ho && ox < Wo ? (long long)oy * Wo + ox : -1;
      },
      (int)blockIdx.y * L::BN, M, (long long)Ho * Wo, (const T*)nullptr, (const T*)nullptr, out, ws,
      relu ? ACT_RELU : ACT_NONE);
}

template <typename T>
int launch(const T* x, const T* w, T* out, float* ws, int H, int W, int C, int KS, int M,
           int stride, int pad, int Ho, int Wo, int relu, int stages, int splits, int kps,
           cudaStream_t stream) {
  using L = ConvLayout<T>;
  const int KT = ((C + L::BK - 1) / L::BK) * KS * KS;
  if (stages < 2 || stages > 4 || kps <= 0 || (long long)splits * kps < KT ||
      (splits - 1) * kps >= KT)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nh = halo_buffers(KS, stages);
  int as = 0;
  const long long smem = conv_smem<T>(KS, stride, stages, &as);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(conv2d_com_kernel<T>, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_x = C % L::CE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = M % L::CE == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(((Ho + TH - 1) / TH) * ((Wo + TW - 1) / TW), (M + L::BN - 1) / L::BN, splits);
  conv2d_com_kernel<T><<<grid, L::THREADS, (int)smem, stream>>>(
      x, w, out, splits > 1 ? ws : nullptr, H, W, C, KS, M, stride, pad, Ho, Wo, relu, stages, nh,
      as, kps, vec_x, vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(splitk_reduce<T>(ws, splits, (long long)Ho * Wo, M, nullptr, nullptr,
                                           out, relu ? ACT_RELU : ACT_NONE, stream));
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, float* ws, int H, int W, int C, int K,
             int M, int stride, int pad, int Ho, int Wo, int relu, int stages, int splits,
             int kps, cudaStream_t s) {
  const T *xt = static_cast<const T*>(x), *wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  return launch<T>(xt, wt, ot, ws, H, W, C, K, M, stride, pad, Ho, Wo, relu, stages, splits,
                       kps, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. relu: 0 none, 1 ReLU. H_out and W_out are
// given by the caller, which allocated out. The launch plan
// (kernels/conv2d_com.py:plan): `stages` weight-ring slots, and the (chunk,
// position) k-tiles cut into `splits` slices of `kps` k-tiles, each split writing f32 partials into ws
// [splits][H_out * W_out][M] (null when splits = 1) that a second kernel sums
// in order before the ReLU. Returns cudaGetLastError() after the launches
// (or the error that kept them from launching).
extern "C" int repro_conv2d_com(const void* x, const void* w, void* out, void* ws, int H, int W,
                                int C, int K, int M, int stride, int pad, int Ho, int Wo,
                                int relu, int dtype, int stages, int splits, int kps,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || W <= 0 || C <= 0 || K <= 0 || M <= 0 || stride <= 0 || pad < 0 || Ho <= 0 ||
      Wo <= 0 || (M + 63) / 64 > 65535 || splits < 1 || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0)
    return dispatch<float>(x, w, out, wsf, H, W, C, K, M, stride, pad, Ho, Wo, relu, stages, splits,
                           kps, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, wsf, H, W, C, K, M, stride, pad, Ho, Wo, relu,
                                   stages, splits, kps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
