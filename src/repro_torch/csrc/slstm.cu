// slstm_fused: the sLSTM recurrence of xLSTM over gate pre-activations
// gx (B, S, 4, D) in float32 or bfloat16 with block-diagonal recurrent
// weights R (4, H, hd, hd) in float32 (D = H * hd). Writes h (B, S, D) in
// gx's type and the final state c, n, h, m, each float32 (B, H, hd); on
// request (the cluster path) also the per-step state its backward reads.
// slstm_bwd: that backward, the gate gradients dg (B, S, 4, D) in float32
// (see "the backward" below).
//
// Replaces the Pallas TPU kernel repro.kernels.slstm.slstm_fused
// (src/repro/kernels/slstm.py:70, pallas_call at :84, body :26-67). The TPU
// kernel keeps all of R (4 MiB f32 for xlstm-350m) and the (c, n, h, m)
// state in VMEM and walks the sequence as a sequential grid axis of chunks.
// Here the heads are independent (R is block-diagonal, the gating is
// elementwise), so each (batch row, head) is walked by its own blocks, a loop
// inside them taking the place of the sequential grid axis. Any S >= 1 (the
// Pallas kernel's S % chunk == 0 is a VMEM detail).
//
// The arithmetic is repro.models.xlstm._slstm_cell's in float32: the running
// max m starts at -1e30, c, n and h at zero; the forget gate's log-sigmoid
// is taken in the stable form min(x, 0) - log1p(exp(-|x|)) (the Pallas body's
// -log1p(exp(-x)) overflows for x < -88); n is clamped at 1e-6; h is rounded
// to gx's type only where it is written out.
//
// What bounds it on an H100: a step does 8*hd^2 flop per (row, head) on that
// head's f32 R, 16*hd^2 bytes (1 MiB at hd 256), and the steps are
// sequential: a batch-1 prefill is S dependent steps on B*H = 4 heads. R
// does not fit one SM (228 KB of shared memory, 256 KB of registers), so a
// single block must stream it from L2 at every step (9.7 us a step at hd 256,
// one SM's L2 bandwidth). Two paths, chosen by shape in Python
// (kernels/slstm.py:plan):
// * cluster (the rule): a thread-block cluster of C CTAs per (row, head),
//   C the smallest power of two <= 8 whose CTA slice of R fits (8 at hd 256:
//   128 KB a CTA). CTA r owns hidden units [r U, (r + 1) U), U = hd / C, and
//   loads R's columns of those units for all four gates and all k ONCE,
//   before the time loop, into registers (64 a thread at hd 256, 512
//   threads). R in shared memory was tried and was slower: a step then
//   reads 128 KB of shared memory an SM (PERF.md has both times).
//   Thread (unit j, gate q, k slice ks) sums h[k] R[q, k, j] over its k; the
//   k slices meet by warp shuffles, and the 4 KS lanes of each gate of a unit
//   sit in one warp, so every lane of the unit's group forms the cell. Each
//   CTA reads the whole h_t from its own shared buffer hs[t % 2] and writes
//   its units' h_{t+1} into hs[(t + 1) % 2] of every CTA of the cluster
//   (distributed shared memory), then one barrier.cluster arrive.release /
//   wait.acquire ends the step: double-buffered h makes one barrier a step
//   enough. The gate pre-activations do not depend on the recurrence and are
//   loaded 4 steps ahead into registers. A step is bounded by the cluster
//   barrier, the DSMEM stores and the cell's latency, not by bytes.
// * stream (hd whose R cannot fit the registers of eight CTAs, hd > 256): one block per
//   (row, head) streams R from L2 every step, the k loop split over up to 512
//   workers whose partial sums meet in shared memory, two __syncthreads a
//   step.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_HD = 1024;    // one gating thread a hidden unit
constexpr int SAVED_ROWS = 7;   // per step: i, f, z, o pre-activations, c, n, m
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

// ---- the stream path --------------------------------------------------------------

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


// ---- the cluster path -------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int GX_AHEAD = 4;  // steps of gate pre-activations loaded ahead

// grid (C, H, B), clusters of (C, 1, 1): CTA r = blockIdx.x of the cluster of
// (b, head). Thread tid = (j * 4 + q) * KS + ks owns gate q of unit
// jg = r U + j and the k of slice ks: k = 4 (KS m + ks) + e, m < KPT / 4,
// e < 4 (the four ks of a warp read four neighbouring float4 of h). Shared
// memory: hs[2][HP] (HP = KS KPT >= hd, zero past hd).
// saved: null, or the per-step state (B, S, SAVED_ROWS, D) float32: the four
// gate pre-activations after + R h, then c, n, m.
template <typename T, int KPT>
__global__ void __launch_bounds__(512, 1) slstm_cluster_kernel(
    const T* __restrict__ gx, const float* __restrict__ R, T* __restrict__ h_out,
    float* __restrict__ c_fin, float* __restrict__ n_fin, float* __restrict__ h_fin,
    float* __restrict__ m_fin, float* __restrict__ saved, int S, int H, int hd, int KS) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int U = hd / C, HP = KS * KPT, NT = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ks = tid % KS, q = (tid / KS) % 4, j = tid / (4 * KS);
  const int jg = rank * U + j, D = H * hd;
  const int grp = 4 * KS;                   // lanes of one unit: 4 gates x KS
  const int base = lane - lane % grp, li = lane % grp;
  float* hs = smem;

  // this thread's R, once: R[q, head, k, jg] for its k (0 past hd)
  float r[KPT];
  const float* Rq = R + ((size_t)q * H + head) * hd * hd + jg;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int k = 4 * (KS * (i / 4) + ks) + i % 4;
    r[i] = k < hd ? __ldg(Rq + (size_t)k * hd) : 0.f;
  }
  for (int i = tid; i < 2 * HP; i += NT) hs[i] = 0.f;
  // every CTA's h buffers are zero before any CTA writes into them
  cluster.sync();

  const bool lead = ks == 0;  // adds gx to its gate's sum
  const T* gp = gx + (size_t)b * S * 4 * D + (size_t)q * D + (size_t)head * hd + jg;
  float ring[GX_AHEAD];
#pragma unroll
  for (int u = 0; u < GX_AHEAD; ++u)
    ring[u] = lead && u < S ? to_f32(gp[(size_t)u * 4 * D]) : 0.f;
  float c = 0.f, n = 0.f, h = 0.f, m = -1e30f;
  T* ho = h_out + (size_t)b * S * D + (size_t)head * hd + jg;

  for (int t0 = 0; t0 < S; t0 += GX_AHEAD) {
#pragma unroll
    for (int u = 0; u < GX_AHEAD; ++u) {
      const int t = t0 + u;
      if (t >= S) break;
      float acc[4] = {ring[u], 0.f, 0.f, 0.f};
      ring[u] = lead && t + GX_AHEAD < S ? to_f32(gp[(size_t)(t + GX_AHEAD) * 4 * D]) : 0.f;
      const float4* h4 = reinterpret_cast<const float4*>(hs + (t & 1) * HP);
#pragma unroll
      for (int mm = 0; mm < KPT / 4; ++mm) {
        const float4 hv = h4[KS * mm + ks];
        acc[0] = fmaf(hv.x, r[4 * mm], acc[0]);
        acc[1] = fmaf(hv.y, r[4 * mm + 1], acc[1]);
        acc[2] = fmaf(hv.z, r[4 * mm + 2], acc[2]);
        acc[3] = fmaf(hv.w, r[4 * mm + 3], acc[3]);
      }
      float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      for (int off = 1; off < KS; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // the unit's four gates, in every lane of its group
      const float it = __shfl_sync(0xffffffffu, sum, base);
      const float ft = __shfl_sync(0xffffffffu, sum, base + KS);
      const float zt = __shfl_sync(0xffffffffu, sum, base + 2 * KS);
      const float ot = __shfl_sync(0xffffffffu, sum, base + 3 * KS);
      const float logf = log_sigmoid(ft);
      const float m_new = fmaxf(logf + m, it);
      const float ig = expf(it - m_new);
      const float fg = expf(logf + m - m_new);
      c = fg * c + ig * tanhf(zt);
      n = fg * n + ig;
      h = (1.0f / (1.0f + expf(-ot))) * c / fmaxf(n, 1e-6f);
      m = m_new;
      if (saved != nullptr) {  // the same arithmetic either way: h's bits do not change
        float* sp = saved + ((size_t)b * S + t) * SAVED_ROWS * D + (size_t)head * hd + jg;
        for (int w = li; w < SAVED_ROWS; w += grp)
          sp[(size_t)w * D] = w == 0 ? it : w == 1 ? ft : w == 2 ? zt : w == 3 ? ot
                              : w == 4 ? c : w == 5 ? n : m;
      }
      float* nxt = hs + ((t + 1) & 1) * HP + jg;
      for (int dst = li; dst < C; dst += grp) *cluster.map_shared_rank(nxt, dst) = h;
      if (li == 0) ho[(size_t)t * D] = from_f32<T>(h);
      // h_{t+1} is whole in every CTA, and every CTA is done reading h_t
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    }
  }
  if (li == 0) {
    const size_t st = ((size_t)b * H + head) * hd + jg;
    c_fin[st] = c;
    n_fin[st] = n;
    h_fin[st] = h;
    m_fin[st] = m;
  }
}

// A cluster launch of C CTAs a (row, head), clusters of (C, 1, 1).
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int C, int H, int B, int threads, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(C, H, B);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename Kernel, typename... Args>
int launch_ex(const ClusterLaunch& l, Kernel kernel, Args... args) {
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The forward's threads a CTA, or 0 where (C, KS, kpt) is not a plan the
// kernel takes; its kernel for kpt (one of 8, 16, 32, 64), or null; its
// shared memory (h twice, <= 4 KB).
inline int cluster_threads(int hd, int C, int KS, int kpt) {
  if (C < 1 || C > 8 || hd % C || KS < 1 || KS > 8 || 32 % (4 * KS) || (long long)KS * kpt < hd)
    return 0;
  const int threads = 4 * (hd / C) * KS;
  return threads > 512 || threads % 32 ? 0 : threads;
}

template <typename T>
auto cluster_kernel(int kpt) {
  using K = decltype(&slstm_cluster_kernel<T, 8>);
  switch (kpt) {
    case 8: return K(&slstm_cluster_kernel<T, 8>);
    case 16: return K(&slstm_cluster_kernel<T, 16>);
    case 32: return K(&slstm_cluster_kernel<T, 32>);
    case 64: return K(&slstm_cluster_kernel<T, 64>);
    default: return K(nullptr);
  }
}

inline size_t cluster_smem(int KS, int kpt) { return sizeof(float) * 2 * (size_t)KS * kpt; }

template <typename T>
int launch_cluster(const void* gx, const float* R, void* h_out, float* c, float* n, float* h,
                   float* m, float* saved, int B, int S, int H, int hd, int C, int KS, int kpt,
                   cudaStream_t stream) {
  const int threads = cluster_threads(hd, C, KS, kpt);
  const auto kernel = cluster_kernel<T>(kpt);
  if (threads == 0 || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterLaunch l(C, H, B, threads, cluster_smem(KS, kpt), stream);
  return launch_ex(l, kernel, static_cast<const T*>(gx), R, static_cast<T*>(h_out), c, n, h, m,
                   saved, S, H, hd, KS);
}

// step t's saved state of one unit (t < 0: the zero initial state, m = -1e30)
__device__ __forceinline__ void load_saved(const float* sv, size_t row, int D, int t,
                                           float (&v)[SAVED_ROWS]) {
#pragma unroll
  for (int k = 0; k < SAVED_ROWS; ++k)
    v[k] = t >= 0 ? sv[(size_t)t * row + (size_t)k * D] : (k == SAVED_ROWS - 1 ? -1e30f : 0.f);
}

// ---- the backward ------------------------------------------------------------------
//
// The gradient of h with respect to the gate pre-activations, dg (B, S, 4,
// D) float32, from the per-step state the forward saved and dh (B, S, D) in
// gx's type: the reverse recurrence of kernels/ref.py:slstm_bwd_ref (the
// running max m held constant, which is exact there; its docstring derives
// the step). There is no Pallas kernel to replace: the reference
// differentiates the lax.scan of repro.models.xlstm._slstm_cell
// (src/repro/models/xlstm.py:200-245). dR = sum over (b, t) of h_{t-1}^T dg_t
// is one plain product outside the kernel (kernels/ref.py:slstm_dr).
//
// What bounds it: like the forward, the S sequential steps, each
// dh_t = dh[t] + sum_{q, m} R[q, j, m] dg_{t+1}[q, m], a 4 hd-term sum per
// unit. The same cluster as the forward's (C CTAs a (row, head), CTA r owning
// units [r U, (r + 1) U)), with R's ROWS of its units in registers:
// thread (unit j, slice s) of P slices holds R[q, jg, m] for its KPT terms
// e = q hd + m = 4 (P mm + s) + u (mm < KPT / 4, u < 4; zero past 4 hd), the P
// slices of a unit in one warp meeting by shuffles, every lane of the unit
// then forming the cell's backward. Each step the CTA sends its 4 U gate
// gradients to every CTA of the cluster (distributed shared memory,
// double-buffered, four times the forward's exchange) and one barrier.cluster
// ends the step. The saved state is loaded two steps ahead. No atomics: the
// result does not depend on the schedule.
template <typename T, int KPT>
__global__ void __launch_bounds__(512, 1) slstm_bwd_cluster_kernel(
    const float* __restrict__ saved, const float* __restrict__ R, const T* __restrict__ dh,
    float* __restrict__ dg, int S, int H, int hd, int P) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int U = hd / C, E = P * KPT, NT = blockDim.x;
  const int tid = threadIdx.x, s = tid % P, j = tid / P;
  const int jg = rank * U + j, D = H * hd;
  float* dgs = smem;  // [2][E]: dg_{t+1} by e = q hd + m, zero past 4 hd

  // this thread's R, once: R[q, head, jg, m] for its e
  float r[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int e = 4 * (P * (i / 4) + s) + i % 4;
    const int q = e / hd, mo = e % hd;
    r[i] = e < 4 * hd ? __ldg(R + (((size_t)q * H + head) * hd + jg) * hd + mo) : 0.f;
  }
  for (int i = tid; i < 2 * E; i += NT) dgs[i] = 0.f;
  // every CTA's buffers are zero (dg_S = 0) before any CTA writes into them
  cluster.sync();

  const size_t row = (size_t)SAVED_ROWS * D;  // saved's step stride
  const float* sv = saved + (size_t)b * S * row + (size_t)head * hd + jg;
  const T* dhp = dh + (size_t)b * S * D + (size_t)head * hd + jg;
  float* dgp = dg + (size_t)b * S * 4 * D + (size_t)head * hd + jg;
  float cur[SAVED_ROWS], prv[SAVED_ROWS];
  load_saved(sv, row, D, S - 1, cur);
  load_saved(sv, row, D, S - 2, prv);
  float dh_cur = to_f32(dhp[(size_t)(S - 1) * D]);
  float dc = 0.f, dn = 0.f, f_next = 0.f;  // dc_{t+1}, dn_{t+1}, f_{t+1}

  for (int t = S - 1, u = 0; t >= 0; --t, ++u) {
    float nxt[SAVED_ROWS];
    load_saved(sv, row, D, t - 2, nxt);
    const float dh_nxt = t >= 1 ? to_f32(dhp[(size_t)(t - 1) * D]) : 0.f;
    // R dg_{t+1}: this slice's terms, then the unit's P slices by shuffles
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* d4 = reinterpret_cast<const float4*>(dgs + (u & 1) * E);
#pragma unroll
    for (int mm = 0; mm < KPT / 4; ++mm) {
      const float4 v = d4[P * mm + s];
      acc[0] = fmaf(v.x, r[4 * mm], acc[0]);
      acc[1] = fmaf(v.y, r[4 * mm + 1], acc[1]);
      acc[2] = fmaf(v.z, r[4 * mm + 2], acc[2]);
      acc[3] = fmaf(v.w, r[4 * mm + 3], acc[3]);
    }
    float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    for (int off = 1; off < P; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float dht = dh_cur + sum;
    // the cell's backward, m held constant (kernels/ref.py:slstm_bwd_ref)
    const float it = cur[0], ft = cur[1], zt = cur[2], ot = cur[3];
    const float c = cur[4], n = cur[5], m = cur[6];
    const float ig = expf(it - m);
    const float fg = expf(log_sigmoid(ft) + prv[6] - m);
    const float tz = tanhf(zt);
    const float so = 1.0f / (1.0f + expf(-ot));
    dc = dht * so / n + dc * f_next;
    dn = -dht * so * c / (n * n) + dn * f_next;
    const float d_i = (dc * tz + dn) * ig;
    const float d_f = (dc * prv[4] + dn * prv[5]) * fg * (1.0f / (1.0f + expf(ft)));
    const float d_z = dc * ig * (1.0f - tz * tz);
    const float d_o = dht * (c / n) * so * (1.0f - so);
    f_next = fg;
    // dg_t into every CTA's other buffer, and out
    float* nb = dgs + ((u + 1) & 1) * E + jg;
    for (int w = s; w < 4 * C; w += P) {
      const int q = w & 3;
      *cluster.map_shared_rank(nb + q * hd, w >> 2) = q == 0 ? d_i : q == 1 ? d_f
                                                      : q == 2 ? d_z : d_o;
    }
    for (int q = s; q < 4; q += P)
      dgp[(size_t)t * 4 * D + (size_t)q * D] = q == 0 ? d_i : q == 1 ? d_f : q == 2 ? d_z : d_o;
#pragma unroll
    for (int k = 0; k < SAVED_ROWS; ++k) {
      cur[k] = prv[k];
      prv[k] = nxt[k];
    }
    dh_cur = dh_nxt;
    // dg_t is whole in every CTA, and every CTA is done reading dg_{t+1}
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// The backward's threads a CTA, or 0 where (C, P, kpt) is not a plan the
// kernel takes; its kernel for kpt, or null; its shared memory (dg twice,
// <= 16 KB).
inline int bwd_threads(int hd, int C, int P, int kpt) {
  if (C < 1 || C > 8 || hd % C || P < 1 || P > 32 || 32 % P || (long long)P * kpt < 4LL * hd)
    return 0;
  const int threads = (hd / C) * P;
  return threads > 512 || threads % 32 ? 0 : threads;
}

template <typename T>
auto bwd_kernel(int kpt) {
  using K = decltype(&slstm_bwd_cluster_kernel<T, 8>);
  switch (kpt) {
    case 8: return K(&slstm_bwd_cluster_kernel<T, 8>);
    case 16: return K(&slstm_bwd_cluster_kernel<T, 16>);
    case 32: return K(&slstm_bwd_cluster_kernel<T, 32>);
    case 64: return K(&slstm_bwd_cluster_kernel<T, 64>);
    default: return K(nullptr);
  }
}

inline size_t bwd_smem(int P, int kpt) { return sizeof(float) * 2 * (size_t)P * kpt; }

template <typename T>
int launch_bwd(const float* saved, const float* R, const void* dh, float* dg, int B, int S,
               int H, int hd, int C, int P, int kpt, cudaStream_t stream) {
  const int threads = bwd_threads(hd, C, P, kpt);
  const auto kernel = bwd_kernel<T>(kpt);
  if (threads == 0 || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterLaunch l(C, H, B, threads, bwd_smem(P, kpt), stream);
  return launch_ex(l, kernel, saved, R, static_cast<const T*>(dh), dg, S, H, hd, P);
}

// How many clusters of a forward (backward = 0) or backward cluster launch
// the card runs at once.
template <typename T>
int max_clusters(int backward, int B, int H, int hd, int C, int slices, int kpt, int* clusters) {
  if (backward) {
    const int threads = bwd_threads(hd, C, slices, kpt);
    const auto kernel = bwd_kernel<T>(kpt);
    if (threads == 0 || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const ClusterLaunch l(C, H, B, threads, bwd_smem(slices, kpt), nullptr);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg));
  }
  const int threads = cluster_threads(hd, C, slices, kpt);
  const auto kernel = cluster_kernel<T>(kpt);
  if (threads == 0 || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterLaunch l(C, H, B, threads, cluster_smem(slices, kpt), nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (gx and h_out); R and the four state
// outputs are float32. All are contiguous. The launch plan
// (kernels/slstm.py:plan): path 0 = cluster, with C CTAs a (row, head), KS k
// slices and kpt k a thread (one of 8, 16, 32, 64), R in registers; path 1
// = stream (1 <= hd <= 1024; C, KS, kpt unused). saved: null, or (cluster
// path only) the per-step state (B, S, 7, D) float32 for the backward.
// Returns cudaGetLastError() after the launch (or the error that kept it
// from launching).
extern "C" int repro_slstm(const void* gx, const float* R, void* h_out, float* c, float* n,
                           float* h, float* m, float* saved, int B, int S, int H, int hd,
                           int dtype, int path, int C, int KS, int kpt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > MAX_HD || B > 65535 || H > 65535 ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    if (dtype == 0)
      return launch_cluster<float>(gx, R, h_out, c, n, h, m, saved, B, S, H, hd, C, KS, kpt, st);
    return launch_cluster<__nv_bfloat16>(gx, R, h_out, c, n, h, m, saved, B, S, H, hd, C, KS,
                                         kpt, st);
  }
  if (path != 1 || saved != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(gx, R, h_out, c, n, h, m, B, S, H, hd, st);
  return launch<__nv_bfloat16>(gx, R, h_out, c, n, h, m, B, S, H, hd, st);
}

// The backward (kernels/slstm.py:plan_bwd): saved (B, S, 7, D) and R float32,
// dh (B, S, D) in dtype (0 = float32, 1 = bfloat16), dg (B, S, 4, D) float32
// written; a cluster of C CTAs a (row, head), P slices a unit (a power of two
// <= 32), kpt terms a thread.
extern "C" int repro_slstm_bwd(const float* saved, const float* R, const void* dh, float* dg,
                               int B, int S, int H, int hd, int dtype, int C, int P, int kpt,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > MAX_HD || B > 65535 || H > 65535 ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_bwd<float>(saved, R, dh, dg, B, S, H, hd, C, P, kpt, st);
  return launch_bwd<__nv_bfloat16>(saved, R, dh, dg, B, S, H, hd, C, P, kpt, st);
}

// Writes to clusters how many clusters of the cluster path's forward
// (backward = 0; slices = KS) or backward (1; slices = P) launch of this plan
// the card runs at once on the current device (cudaOccupancyMaxActiveClusters;
// no launch). Returns the CUDA error code.
extern "C" int repro_slstm_clusters(int backward, int B, int H, int hd, int dtype, int C,
                                    int slices, int kpt, int* clusters) {
  if (B <= 0 || H <= 0 || hd <= 0 || hd > MAX_HD || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return max_clusters<float>(backward, B, H, hd, C, slices, kpt, clusters);
  return max_clusters<__nv_bfloat16>(backward, B, H, hd, C, slices, kpt, clusters);
}
