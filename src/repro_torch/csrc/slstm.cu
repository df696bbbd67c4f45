// slstm_fused: the sLSTM recurrence of xLSTM over gate pre-activations
// gx (B, S, 4, D) in float32 or bfloat16 with block-diagonal recurrent
// weights R (4, H, hd, hd) in float32 (D = H * hd). Writes h (B, S, D) in
// gx's type and the final state c, n, h, m, each float32 (B, H, hd).
//
// Replaces the Pallas TPU kernel repro.kernels.slstm.slstm_fused
// (src/repro/kernels/slstm.py:70, pallas_call at :84, body :26-67). The TPU
// kernel keeps all of R (4 MiB f32 for xlstm-350m) and the (c, n, h, m)
// state in VMEM and walks the sequence as a sequential grid axis of chunks.
// Here the heads are independent (R is block-diagonal, the gating is
// elementwise), so one block owns one (batch row, head) and persists over
// the whole sequence, a loop inside it taking the place of the sequential
// grid axis. Each step has two phases, split by __syncthreads:
//   1. products: worker (jg, ks) forms, for the VEC hidden units j of its
//      group jg and the k of its slice ks, the partial sums
//      sum_k h[k] * R[q, head, k, j] of all four gates q, reading R rows as
//      float4 (VEC = 4), and leaves them in shared memory;
//   2. gating: thread j < hd adds gx[b, t, q, head*hd + j] to the KS
//      partial sums of each gate, applies the cell to its own float32
//      (c, n, m) in registers, writes h[j] to shared memory for the next
//      step and to h_out in gx's type.
// Any S >= 1 (the Pallas kernel's S % chunk == 0 is a VMEM detail) and any
// hd <= 1024 (VEC = 1 where hd % 4 or R's address is not 16-byte aligned).
//
// The arithmetic is repro.models.xlstm._slstm_cell's in float32: the running
// max m starts at -1e30, c, n and h at zero; the forget gate's log-sigmoid
// is taken in the stable form min(x, 0) - log1p(exp(-|x|)) (the Pallas body's
// -log1p(exp(-x)) overflows for x < -88); n is clamped at 1e-6. The recurrent
// sums are taken slice by slice, then over the slices in order.
//
// What bounds it on an H100: a step does 8*hd^2 flop per (row, head) and
// reads that head's f32 R, 16*hd^2 bytes (1 MiB at hd 256), which does not
// fit in a block's 227 KB of shared memory. This first version streams R
// from L2 every step (all heads' R, 4 MiB, stays resident in the 50 MB L2),
// so a step is bound by one SM's L2 bandwidth and latency; the split of the
// k loop over KS slices (up to 512 workers) keeps many loads in flight. A
// batch-1 prefill fills only B*H = 4 of the 132 SMs: a sequential
// recurrence. Left for later: a thread-block cluster per (row, head) holding
// R in distributed shared memory (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_HD = 1024;    // one gating thread a hidden unit
constexpr int MAX_WORKERS = 512;  // product threads a block (jg x ks)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// grid (H, B). Shared memory: h (hd floats), then the partial sums
// part[ks][q][j] (KS * 4 * hd floats). Threads tid < JG * KS are workers
// (jg = tid % JG, ks = tid / JG, JG = hd / VEC); threads tid < hd gate unit
// j = tid.
template <typename T, int VEC>
__global__ void __launch_bounds__(MAX_HD) slstm_kernel(
    const T* __restrict__ gx, const float* __restrict__ R, T* __restrict__ h_out,
    float* __restrict__ c_fin, float* __restrict__ n_fin, float* __restrict__ h_fin,
    float* __restrict__ m_fin, int S, int H, int hd, int KS) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;
  float* part = smem + ((hd + 3) & ~3);  // 16-byte aligned
  const int head = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int D = H * hd, JG = hd / VEC;
  const bool worker = tid < JG * KS, owner = tid < hd;
  const int jg = tid % JG, ks = tid / JG, j0 = jg * VEC;
  const int k_per = (hd + KS - 1) / KS;
  const int k_lo = min(hd, ks * k_per), k_hi = min(hd, k_lo + k_per);
  const size_t q_stride = (size_t)H * hd * hd;  // R[q] to R[q + 1]
  const float* R_lo = R + ((size_t)head * hd + k_lo) * hd + j0;  // R[0, head, k_lo, j0]
  float* my_part = part + (size_t)ks * 4 * hd + j0;
  const T* g_row = gx + (size_t)b * S * 4 * D + (size_t)head * hd + tid;
  T* h_row = h_out + (size_t)b * S * D + (size_t)head * hd + tid;

  float c = 0.0f, n = 0.0f, h = 0.0f, m = -1e30f;
  if (owner) hs[tid] = 0.0f;
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    float g[4];
    if (owner) {  // issued before the products, so their latency overlaps
      const T* gt = g_row + (size_t)t * 4 * D;
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = to_f32(gt[q * D]);
    }
    if (worker) {
      float acc[4][VEC];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[q][v] = 0.0f;
      const float* r = R_lo;
#pragma unroll 2
      for (int k = k_lo; k < k_hi; ++k, r += hd) {
        const float hk = hs[k];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (VEC == 4) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(r + q * q_stride));
            acc[q][0] = fmaf(hk, w.x, acc[q][0]);
            acc[q][1] = fmaf(hk, w.y, acc[q][1]);
            acc[q][2] = fmaf(hk, w.z, acc[q][2]);
            acc[q][3] = fmaf(hk, w.w, acc[q][3]);
          } else {
            acc[q][0] = fmaf(hk, __ldg(r + q * q_stride), acc[q][0]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(my_part + q * hd) =
              make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
        } else {
          my_part[q * hd] = acc[q][0];
        }
      }
    }
    __syncthreads();  // every partial sum is written; nobody reads h any more
    if (owner) {
      float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) rs[q] += part[((size_t)s * 4 + q) * hd + tid];
      }
      const float it = g[0] + rs[0], ft = g[1] + rs[1], zt = g[2] + rs[2], ot = g[3] + rs[3];
      const float logf = log_sigmoid(ft);
      const float m_new = fmaxf(logf + m, it);
      const float i = expf(it - m_new);
      const float f = expf(logf + m - m_new);
      c = f * c + i * tanhf(zt);
      n = f * n + i;
      h = (1.0f / (1.0f + expf(-ot))) * c / fmaxf(n, 1e-6f);
      m = m_new;
      hs[tid] = h;
      h_row[(size_t)t * D] = from_f32<T>(h);
    }
    __syncthreads();  // this step's h is whole, and the partial sums are read
  }
  if (owner) {
    const size_t s = ((size_t)b * H + head) * hd + tid;
    c_fin[s] = c;
    n_fin[s] = n;
    h_fin[s] = h;
    m_fin[s] = m;
  }
}

template <typename T>
int launch(const void* gx, const float* R, void* h_out, float* c, float* n, float* h, float* m,
           int B, int S, int H, int hd, cudaStream_t stream) {
  const bool vec4 = hd % 4 == 0 && (reinterpret_cast<uintptr_t>(R) & 15) == 0;
  const int JG = vec4 ? hd / 4 : hd;
  // k slices of at least 8 rows, at most MAX_WORKERS workers
  const int KS = max(1, min(MAX_WORKERS / JG, hd / 8));
  const int threads = (max(JG * KS, hd) + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (((hd + 3) & ~3) + (size_t)KS * 4 * hd);  // <= 36 KB
  if (vec4)
    slstm_kernel<T, 4><<<dim3(H, B), threads, smem, stream>>>(
        static_cast<const T*>(gx), R, static_cast<T*>(h_out), c, n, h, m, S, H, hd, KS);
  else
    slstm_kernel<T, 1><<<dim3(H, B), threads, smem, stream>>>(
        static_cast<const T*>(gx), R, static_cast<T*>(h_out), c, n, h, m, S, H, hd, KS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (gx and h_out); R and the four state
// outputs are float32. All are contiguous. 1 <= hd <= 1024. Returns
// cudaGetLastError() after the launch (or the error that kept it from
// launching).
extern "C" int repro_slstm(const void* gx, const float* R, void* h_out, float* c, float* n,
                           float* h, float* m, int B, int S, int H, int hd, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > MAX_HD || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(gx, R, h_out, c, n, h, m, B, S, H, hd, s);
  if (dtype == 1) return launch<__nv_bfloat16>(gx, R, h_out, c, n, h, m, B, S, H, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
