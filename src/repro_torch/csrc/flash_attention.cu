// flash_attention: online-softmax attention forward, GQA, causal (top-left)
// or not, for q (B, Sq, H, hd) and k, v (B, Skv, KVH, hd) in float32 or
// bfloat16; out (B, Sq, H, hd) in q's type.
//
// Replaces the Pallas TPU kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py:64, pallas_call at :87) and its GQA
// wrapper flash_attention_gqa (:106). The TPU kernel walks the KV blocks as
// the innermost, sequential grid axis with (acc, m, l) in VMEM scratch, and
// its wrapper transposes to (B*H, S, hd) and repeats every KV head G = H/KVH
// times in device memory. Here one block owns one (b, h, 64-row q tile) and
// a loop inside the block walks the 64-row KV tiles, (acc, m, l) in registers and
// shared memory. The block reads q, k and v in their (B, S, heads, hd) layout
// through strides and reads KV head h / G itself, so nothing is transposed or
// repeated. The Pallas kernel needs S to be a multiple of its block; here
// ragged Sq and Skv are masked in the kernel, since prompts have any length.
//
// The arithmetic follows the Pallas kernel: q is cast to f32 and then scaled
// by 1/sqrt(hd); scores, the running max m, the running sum l and the
// accumulator are f32; l is clamped at 1e-30 before the division; the result
// is cast once to q's type. The causal mask is top-left, k_pos <= q_pos, and
// KV tiles that lie wholly above the diagonal are skipped.
//
// What bounds it on an H100: a causal prefill of S tokens does 4*hd*H*S^2/2
// flop on 4*S*(H + 2*KVH)*hd bytes (f32), far above the ridge for S >= 128,
// so the bound is operations. This first version uses f32 FMAs on the CUDA
// cores (67 TFLOP/s peak), not the tensor cores (989 TFLOP/s bf16): each
// thread keeps an 8 x (BKV/16) block of scores and an 8 x (hd/16) block of
// the accumulator in registers and forms both products from shared-memory
// tiles. At batch-1 prefill the grid is small (H * ceil(S/64) blocks: 18 at
// S = 128 for smollm), so short prompts leave most of the 132 SMs idle.
// Left for later: mma.sync/wgmma, cp.async/TMA double buffering, splitting
// the KV loop of a short prompt over more blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;   // q rows a block
constexpr int BKV = 64;  // k/v rows a tile
constexpr int NT = 128;  // threads a block: 16 columns x 8 rows of threads
static_assert(NT == 2 * BQ, "the softmax pass gives each q row two threads");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  // q tile, k tile, v tile (rows padded to HD + 1), score tile (rows padded to
  // BKV + 1), and the per-row m, l and rescale factor
  return sizeof(float) * ((size_t)(BQ + 2 * BKV) * (HD + 1) + (size_t)BQ * (BKV + 1) + 3 * BQ);
}

// Thread (ty, tx) = (tid / 16, tid % 16) owns q rows ty + 8 i (i < 8), score
// columns tx + 16 j and output columns tx + 16 j. The +1 row padding puts the
// 16 k rows a warp reads at one d on 16 different banks.
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ out, int Sq, int Skv, int H, int KVH, int causal,
                       float scale) {
  constexpr int LD = HD + 1;
  constexpr int LS = BKV + 1;
  constexpr int RI = BQ / 8;
  constexpr int CJ = BKV / 16;
  constexpr int DJ = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][LD]
  float* ks = qs + BQ * LD;       // [BKV][LD]
  float* vs = ks + BKV * LD;      // [BKV][LD]
  float* ss = vs + BKV * LD;      // [BQ][LS]: scores, then probabilities
  float* row_m = ss + BQ * LS;    // [BQ] running max
  float* row_l = row_m + BQ;      // [BQ] running sum
  float* row_a = row_l + BQ;      // [BQ] this tile's rescale of acc

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * BQ;
  const long long q_pos_stride = (long long)H * HD;    // one position of q / out
  const long long kv_pos_stride = (long long)KVH * HD;  // one position of k / v
  const T* qb = q + (long long)b * Sq * q_pos_stride + (long long)h * HD;
  const T* kb = k + (long long)b * Skv * kv_pos_stride + (long long)kvh * HD;
  const T* vb = v + (long long)b * Skv * kv_pos_stride + (long long)kvh * HD;
  T* ob = out + (long long)b * Sq * q_pos_stride + (long long)h * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    const int gq = q0 + r;
    qs[r * LD + d] = gq < Sq ? to_f32(qb[gq * q_pos_stride + d]) * scale : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_tiles = (Skv + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);  // skip tiles above the diagonal

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the last tile's readers of ks, vs and ss are done
    for (int e = tid; e < BKV * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const int gk = k0 + r;
      const bool in = gk < Skv;
      ks[r * LD + d] = in ? to_f32(kb[gk * kv_pos_stride + d]) : 0.f;
      vs[r * LD + d] = in ? to_f32(vb[gk * kv_pos_stride + d]) : 0.f;
    }
    __syncthreads();

    // scores S = (q * scale) k^T of this tile, masked to -inf
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RI], kk[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qs[(ty + 8 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 8 * i, gq = q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j, gk = k0 + c;
        const bool keep = gk < Skv && (!causal || gk <= gq);
        ss[r * LS + c] = keep ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, two neighbouring threads a row, half the columns each
    {
      const int r = tid >> 1;
      float* srow = ss + r * LS + (tid & 1) * (BKV / 2);
      float mx = -INFINITY;
      for (int c = 0; c < BKV / 2; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      // a row with nothing unmasked yet keeps exp() finite: p = 0, alpha = 1
      const float m_safe = fmaxf(m_new, -1e30f);
      float sum = 0.f;
      for (int c = 0; c < BKV / 2; ++c) {
        const float p = expf(srow[c] - m_safe);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = expf(fmaxf(m_old, -1e30f) - m_safe);
      __syncwarp();  // both threads of the row have read row_m[r]
      if ((tid & 1) == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P v
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = row_a[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ss[(ty + 8 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // the last row_l writes are visible

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 8 * i, gq = q0 + r;
    if (gq >= Sq) continue;
    const float l = fmaxf(row_l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[gq * q_pos_stride + tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv, int H,
           int KVH, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static_assert(smem <= 232448, "the tiles exceed a block's 227 KB of shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KVH, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
              int H, int KVH, int hd, int causal, float scale, cudaStream_t stream) {
  if (hd == 64) return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KVH, causal, scale, stream);
  if (hd == 128) return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KVH, causal, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd: 64 or 128. causal: 0 or 1. scale:
// 1/sqrt(hd) as float32. q, k, v and out are contiguous. Returns cudaGetLastError() after the launch (or the error
// that kept it from launching).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int B, int Sq, int Skv, int H, int KVH, int hd,
                                     int causal, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, Sq, Skv, H, KVH, hd, causal, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KVH, hd, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
