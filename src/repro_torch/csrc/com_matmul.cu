// com_matmul: (M,K) @ (K,N) with an f32 accumulator and the fused ROFM
// epilogue  out = act(acc + bias) + residual,  one store in the input type.
//
// Replaces the Pallas TPU kernel repro.kernels.com_matmul.com_matmul
// (src/repro/kernels/com_matmul.py:69, pallas_call at :108) and its
// zero-padding wrapper com_matmul_padded (:123). The TPU kernel walks K as a
// sequential grid axis with the partial sum in a VMEM scratch; here a loop
// inside the block walks K (or a slice of it), the partial sums living in
// registers. Ragged edges are masked in the kernel, so nothing is padded.
//
// What bounds it on an H100: the im2col GEMMs of the VGG convolutions carry
// 30-600 flop per byte. At three TF32 passes the tensor cores give ~165
// TFLOP/s of f32-accurate work against 3.35 TB/s, a ridge near 50 flop/byte,
// so the large products are bound by the tensor cores and the first conv
// (K = 27) by memory. The B = 8 FC layers (each weight used 8 times) are
// bound by device-memory bandwidth.
// What the design does about it (the launch plan is chosen in Python,
// kernels/com_matmul.py:plan):
// * M > 32: the shared tensor-core mainloop of com_mma.cuh (3xTF32 for
//   float32, bf16 MMA for bfloat16) on 128 x 64 block tiles, two an SM, fed
//   by a cp.async ring; where the tiles alone leave SMs idle (the 28 x 28 and
//   14 x 14 layers), K is split and a second pass sums the slices in a fixed
//   order.
// * M <= 32 (the FC layers): tensor cores do not pay at M = 8. Each block
//   streams one K-slice x 128-column panel of w with 16-byte loads (8-byte for
//   bfloat16) and FMAs it against x in f32; K is split so that every SM holds
//   several blocks, and the same ordered second pass sums the slices.
#include "com_mma.cuh"

namespace {

using namespace com;

// ---- M > 32: the tensor-core path -----------------------------------------------

// k-tiles of 64: against 32, half the barriers and promotions a product
// (float32 then takes a ring of two, to keep two blocks an SM)
template <typename T> using GemmLayout = Layout<T, 64>;

template <typename T>
struct GemmTiles {
  using L = GemmLayout<T>;
  const T* x;
  const T* w;
  T* smem;
  long long m0;
  int n0, M, N, K;
  bool vec_x, vec_w;

  __device__ T* a_slot(int slot) const { return smem + slot * (L::A_ELEMS + L::B_ELEMS); }
  __device__ const T* a_tile(int, int slot) const { return a_slot(slot); }
  __device__ const T* b_tile(int slot) const { return a_slot(slot) + L::A_ELEMS; }
  __device__ int row_off(int r) const { return r * L::AS; }

  __device__ void load(int kt, int slot) const {
    const int k0 = kt * L::BK;
    T* As = a_slot(slot);
    T* Bs = As + L::A_ELEMS;
    const T zero = from_f32<T>(0.f);
    if (vec_x) {
      constexpr int CPR = L::BK / L::CE;  // 16-byte copies a row
      for (int c = threadIdx.x; c < BM * CPR; c += L::THREADS) {
        const int r = c / CPR, kk = (c % CPR) * L::CE;
        const long long gm = m0 + r;
        const bool ok = gm < M && k0 + kk < K;
        cp_async16(As + r * L::AS + kk, ok ? x + gm * K + k0 + kk : x, ok);
      }
    } else {  // unaligned rows (K = 27): 4-byte copies, or element loads for bf16
      for (int e = threadIdx.x; e < BM * L::BK; e += L::THREADS) {
        const int r = e / L::BK, kk = e % L::BK;
        const long long gm = m0 + r;
        const bool ok = gm < M && k0 + kk < K;
        if constexpr (sizeof(T) == 4)
          cp_async4(As + r * L::AS + kk, ok ? x + gm * K + k0 + kk : x, ok);
        else
          As[r * L::AS + kk] = ok ? x[gm * K + k0 + kk] : zero;
      }
    }
    if (vec_w) {
      constexpr int CPR = L::BN / L::CE;
      for (int c = threadIdx.x; c < L::BK * CPR; c += L::THREADS) {
        const int kk = c / CPR, j = (c % CPR) * L::CE;
        const bool ok = k0 + kk < K && n0 + j < N;
        cp_async16(Bs + kk * L::BS + j, ok ? w + (long long)(k0 + kk) * N + n0 + j : w, ok);
      }
    } else {
      for (int e = threadIdx.x; e < L::BK * L::BN; e += L::THREADS) {
        const int kk = e / L::BN, j = e % L::BN;
        Bs[kk * L::BS + j] =
            (k0 + kk < K && n0 + j < N) ? w[(long long)(k0 + kk) * N + n0 + j] : zero;
      }
    }
  }
};

// grid (M tiles, N tiles, splits); split z owns k-tiles [z kps, (z + 1) kps)
template <typename T>
__global__ void __launch_bounds__(GemmLayout<T>::THREADS, GemmLayout<T>::MIN_BLOCKS)
com_matmul_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ out,
                      float* __restrict__ ws, int M, int N, int K, int act, int stages, int kps,
                      int vec_x, int vec_w) {
  using L = GemmLayout<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * L::BN;
  const int KT = (K + L::BK - 1) / L::BK;
  const int kt0 = blockIdx.z * kps;
  const int nkt = min(kps, KT - kt0);
  GemmTiles<T> p{x, w, reinterpret_cast<T*>(smem_raw), m0, n0, M, N, K, vec_x != 0,
                     vec_w != 0};
  float acc[L::MT][L::NT][4];
  mainloop<T, L::BK>(p, kt0, nkt, stages, acc);
  store_acc<T, L::BK>(
      acc, [&](int r) -> long long { return m0 + r < M ? m0 + r : -1; }, n0, N, M, bias, res,
      out, ws, act);
}

template <typename T>
int launch_mma(const T* x, const T* w, const T* bias, const T* res, T* out, float* ws, int M,
               int N, int K, int act, int stages, int splits, int kchunk, cudaStream_t stream) {
  using L = GemmLayout<T>;
  const int KT = (K + L::BK - 1) / L::BK;
  if (stages < 2 || stages > 4 || kchunk <= 0 || kchunk % L::BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int kps = kchunk / L::BK;
  if ((long long)splits * kps < KT || (K > 0 && (splits - 1) * kps >= KT))
    return static_cast<int>(cudaErrorInvalidValue);  // every split owns k-tiles
  const int smem = stages * (L::A_ELEMS + L::B_ELEMS) * (int)sizeof(T);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(com_matmul_mma_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_x = K % L::CE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = N % L::CE == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((M + BM - 1) / BM, (N + L::BN - 1) / L::BN, splits);
  com_matmul_mma_kernel<T><<<grid, L::THREADS, smem, stream>>>(
      x, w, bias, res, out, splits > 1 ? ws : nullptr, M, N, K, act, stages, kps, vec_x, vec_w);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(splitk_reduce<T>(ws, splits, M, N, bias, res, out, act, stream));
}

// ---- M <= 32: the streaming path -------------------------------------------------

constexpr int NTHREADS = 256;         // 8 warps
constexpr int SK_COLS = 128;          // a block's panel of w
constexpr int SK_CG = SK_COLS / 4;    // 32 column groups of 4 (one warp)
constexpr int SK_KG = NTHREADS / SK_CG;  // 8 k groups (one a warp)

// Four consecutive elements of row k of w, columns n..n+3 (masked past N).
__device__ __forceinline__ void load4(const float* p, int n, int N, bool vec, float* v) {
  if (vec && n + 3 < N) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = n + c < N ? __ldg(p + c) : 0.f;
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, int N, bool vec, float* v) {
  if (vec && n + 3 < N) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo), v[1] = __high2float(lo), v[2] = __low2float(hi),
    v[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = n + c < N ? __bfloat162float(p[c]) : 0.f;
  }
}

constexpr int SK_SUB = 256;           // K rows whose x a block stages at a time

// grid (N panels, splits). Thread (kg, cg) owns columns 4 cg..4 cg + 3 of
// the panel and rows kg, kg + 8, ... of the block's K-slice; a warp reads
// 512 consecutive bytes of one w row, 8 rows in flight, and takes x from
// shared memory (staged SK_SUB rows at a time, one broadcast word a row m).
// The 8 k groups' sums meet in shared memory and are added in kg order.
template <typename T, int MT>
__global__ void __launch_bounds__(NTHREADS, MT <= 8 ? 2 : 1)
com_matmul_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, const T* __restrict__ res,
                         T* __restrict__ out, float* __restrict__ ws, int M, int N, int K, int act,
                         int kchunk, int vec) {
  // x rows [MT][SK_SUB] while streaming, then the k groups' sums [SK_KG][8][SK_COLS]
  __shared__ __align__(16) float sh[SK_KG * 8 * SK_COLS];
  static_assert(MT * SK_SUB <= SK_KG * 8 * SK_COLS, "x slice fits the buffer");
  const int cg = threadIdx.x % SK_CG, kg = threadIdx.x / SK_CG;
  const int n = blockIdx.x * SK_COLS + cg * 4;
  const int k0 = blockIdx.y * kchunk, k1 = min(K, k0 + kchunk);
  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  for (int r0 = k0; r0 < k1; r0 += SK_SUB) {
    const int r1 = min(k1, r0 + SK_SUB);
    __syncthreads();  // the previous rows' x is no longer read
    for (int e = threadIdx.x; e < MT * SK_SUB; e += NTHREADS) {
      const int m = e / SK_SUB, j = e % SK_SUB;
      sh[e] = (m < M && r0 + j < r1) ? to_f32(x[(long long)m * K + r0 + j]) : 0.f;
    }
    __syncthreads();
    if (n >= N) continue;
    constexpr int U = 8;  // w rows in flight a thread
    int k = r0 + kg;
    for (; k + (U - 1) * SK_KG < r1; k += U * SK_KG) {
      float wv[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
        load4(w + (long long)(k + u * SK_KG) * N + n, n, N, vec != 0, wv[u]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const float xv = sh[m * SK_SUB + k - r0 + u * SK_KG];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wv[u][c], acc[m][c]);
          }
        }
      }
    }
    for (; k < r1; k += SK_KG) {
      float wv[4];
      load4(w + (long long)k * N + n, n, N, vec != 0, wv);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < M) {
          const float xv = sh[m * SK_SUB + k - r0];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wv[c], acc[m][c]);
        }
      }
    }
  }
  float(*red)[8][SK_COLS] = reinterpret_cast<float(*)[8][SK_COLS]>(sh);
  float* slice = ws == nullptr ? nullptr : ws + (long long)blockIdx.y * M * N;
#pragma unroll
  for (int mc = 0; mc < MT; mc += 8) {
    __syncthreads();  // x (or the previous rows' sums) is no longer read
#pragma unroll
    for (int mm = 0; mm < 8; ++mm)
      *reinterpret_cast<float4*>(&red[kg][mm][cg * 4]) =
          make_float4(acc[mc + mm][0], acc[mc + mm][1], acc[mc + mm][2], acc[mc + mm][3]);
    __syncthreads();
    for (int e = threadIdx.x; e < 8 * SK_COLS; e += NTHREADS) {
      const int m = mc + e / SK_COLS, col = e % SK_COLS;
      const int gn = blockIdx.x * SK_COLS + col;
      if (m >= M || gn >= N) continue;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < SK_KG; ++q) v += red[q][e / SK_COLS][col];
      if (slice != nullptr)
        slice[(long long)m * N + gn] = v;
      else
        out[(long long)m * N + gn] = from_f32<T>(finish(v, m, gn, N, bias, res, act));
    }
  }
}

template <typename T>
int launch_skinny(const T* x, const T* w, const T* bias, const T* res, T* out, float* ws, int M,
                  int N, int K, int act, int splits, int kchunk, cudaStream_t stream) {
  if (M > 32 || kchunk <= 0 || (long long)splits * kchunk < K ||
      (K > 0 && (long long)(splits - 1) * kchunk >= K))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T)) == 0;
  const dim3 grid((N + SK_COLS - 1) / SK_COLS, splits);
  float* slices = splits > 1 ? ws : nullptr;
  if (M <= 8)
    com_matmul_skinny_kernel<T, 8><<<grid, NTHREADS, 0, stream>>>(x, w, bias, res, out, slices, M,
                                                                  N, K, act, kchunk, vec);
  else
    com_matmul_skinny_kernel<T, 32><<<grid, NTHREADS, 0, stream>>>(x, w, bias, res, out, slices,
                                                                   M, N, K, act, kchunk, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(splitk_reduce<T>(ws, splits, M, N, bias, res, out, act, stream));
}

template <typename T>
int dispatch(const void* x, const void* w, const void* bias, const void* res, void* out,
             float* ws, int M, int N, int K, int act, int path, int stages, int splits,
             int kchunk, cudaStream_t s) {
  const T *xt = static_cast<const T*>(x), *wt = static_cast<const T*>(w),
          *bt = static_cast<const T*>(bias), *rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (path == 1) return launch_skinny<T>(xt, wt, bt, rt, ot, ws, M, N, K, act, splits, kchunk, s);
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma<T>(xt, wt, bt, rt, ot, ws, M, N, K, act, stages, splits, kchunk, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 none, 1 relu, 2 silu, 3 gelu (tanh).
// bias (N,) and res (M,N) may be null. The launch plan (kernels/com_matmul.py:
// plan): path 0 = tensor-core tiles of 128 x 64 with `stages` ring slots, 1 =
// the M <= 32 streaming path; K is cut into `splits` slices of `kchunk`
// elements, each split writing f32 partials into ws [splits][M][N] (ws may be
// null when splits = 1), and a second kernel sums them in order and applies
// the epilogue. Returns cudaGetLastError() after the launches, so a launch the
// device refused is reported to the caller.
extern "C" int repro_com_matmul(const void* x, const void* w, const void* bias, const void* res,
                                void* out, void* ws, int M, int N, int K, int act, int dtype,
                                int path, int stages, int splits, int kchunk,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0 || act < ACT_NONE || act > ACT_GELU || splits < 1 ||
      splits > 65535 || (splits > 1 && ws == nullptr) || (N + 63) / 64 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0)
    return dispatch<float>(x, w, bias, res, out, wsf, M, N, K, act, path, stages, splits,
                           kchunk, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, bias, res, out, wsf, M, N, K, act, path, stages, splits,
                                   kchunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
