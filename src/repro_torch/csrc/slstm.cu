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

#include "com_mma.cuh"  // the 3xTF32 split and mma.sync of the backward

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
// What bounds it: the S sequential steps, each
// dh_t[j, n] = dh[t][j, n] + sum_{q, m} R[q, j, m] dg_{t+1}[q, m, n],
// a 4 hd-term sum for every unit j and batch row n. The rows of a batch
// share each head's R, so one cluster of C CTAs walks a head for a GROUP of
// up to 8 rows (grid (C, H, ceil(B / 8)); at xlstm-350m's train shape 4
// clusters, one wave) and the step's product is a matrix product on the
// tensor cores: A = R's rows of the CTA's U = 16 MT units (M), B = the
// group's dg_{t+1} (N = 8 rows, zero columns past B), K = 4 hd terms.
// * mma.sync.m16n8k8 in 3xTF32 (csrc/com_mma.cuh's saturating split, small
//   terms first), each k-tile on a fresh accumulator added to an f32 sum in
//   registers: float32 sums over 2048 dependent steps hold the f32 gate,
//   plain TF32 would not. wgmma is not used: its tiles are 64 rows tall and
//   a CTA owns 16 units.
// * A in registers for the whole sequence, big and small halves: 8 MT KT
//   registers a thread. Warp w of 16 sums k-tiles [w KT, (w + 1) KT). At hd
//   256, C = 16 CTAs of U = 16 units, KT = 8: 64 registers of R a thread
//   (16-CTA clusters are non-portable and asked for before the launch and
//   the occupancy query; 7 are resident, so the 4 of the train shape run in
//   one wave). Measured with scripts/slstm_bwd_probe.py (H100, 700 W; the
//   step's product alone): 0.64 us a step with 16 units a CTA; with 32 (an
//   8-CTA cluster) 1.27 with the small halves in shared memory, 1.42 with
//   both halves in registers (spilling), 1.80 splitting R every step.
// * K order: k-tile kt holds the 4 gates of units 2 kt and 2 kt + 1, k slot
//   kk of the MMA standing for position p = 2 (kk % 4) + kk / 4 = 4 u + q. In
//   the B fragment layout dgs[kt][n][p] a (unit, row)'s four gate gradients
//   are then one aligned float4, and a thread's two B elements of a k-tile
//   one float2 (2 lane): conflict-free.
// * The warps' partial tiles meet in shared memory in a fixed order: thread
//   quarter qq of a (unit, row) cell adds warps [qq 16 / TPC, ...) in order,
//   then the TPC = 4 / MT threads of the cell by an xor butterfly. No
//   atomics: two calls give the same bits.
// * The exchange: each (unit, row) cell writes its float4 into its CTA's
//   slice of a global buffer (L2); after a __syncthreads one thread copies
//   the slice into the same place of every CTA's double buffer by one
//   cp.async.bulk .multicast::cluster, completing on each CTA's mbarrier of
//   that buffer, which expects C slices a phase (32 KB a CTA a step at hd
//   256). No barrier.cluster: a CTA overwrites a buffer only after it has
//   every CTA's next slice, which each CTA sends after reading that buffer.
//   Step floors (the exchange alone, 16-CTA clusters of 8 rows, H100 700 W,
//   scripts/slstm_bwd_probe.py): 0.98 us this way; 1.76 reading the owners'
//   buffers (DSMEM loads) after a barrier.cluster, 1.82 with an mbarrier flag
//   an owner in place of the barrier, 2.89 writing every CTA's buffer, 1.78
//   sending each slice by cp.async.bulk to each CTA; the barrier.cluster
//   alone 0.77. This way the floor is the same (0.97-1.01 us) for 16- and
//   8-CTA clusters and for groups of 4 rows in twice the clusters, so the
//   product decides: 16 units a CTA, 16-CTA clusters.
// * The saved state streams into a ring of 4 steps in shared memory by
//   cp.async, 3 steps ahead; dh in registers 2 steps ahead; the cell's
//   factors that do not depend on the recurrence are computed a step ahead,
//   off the step's critical path.
constexpr int BWD_ROWS = 8;      // batch rows a cluster: the MMA's N
constexpr int BWD_WARPS = 16;    // warps a CTA, each summing KT k-tiles of 8 terms
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int RING = 4;          // steps of saved state in shared memory
constexpr int AHEAD = RING - 1;  // ... loaded this many steps ahead
constexpr int MAX_BWD_CLUSTER = 16;

// Shared memory of a backward CTA with MT m-tiles and KT k-tiles a warp, in
// floats: dg twice ([k-tile][row][8]), the warps' partial tiles
// ([warp][row][unit], rows padded for conflict-free stores), the ring of
// saved state ([step][field][row][unit]).
__host__ __device__ constexpr int bwd_dg_floats(int KT) { return BWD_WARPS * KT * 64; }
__host__ __device__ constexpr int bwd_part_floats(int MT) {
  return BWD_ROWS * (16 * MT + 4) + 2;
}
__host__ __device__ constexpr int bwd_ring_floats(int MT) {
  return SAVED_ROWS * BWD_ROWS * 16 * MT;
}
__host__ __device__ constexpr int bwd_smem_floats(int MT, int KT) {
  return 2 * bwd_dg_floats(KT) + BWD_WARPS * bwd_part_floats(MT) + RING * bwd_ring_floats(MT);
}

// The exchange's mbarriers and copies.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(com::smem_u32(bar)));
}
// one arrival on bar, whose phase then also waits for `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   com::smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = com::smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(a), "r"(parity) : "memory");
}
// `bytes` from global src to dst's offset in the shared memory of every CTA
// of the cluster, each completing them on its mbarrier at bar's offset
__device__ __forceinline__ void multicast(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar, int C) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(com::smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(com::smem_u32(bar)), "h"(static_cast<uint16_t>((1u << C) - 1)) : "memory");
}

// xbuf: the exchange in global memory, [cluster][2][DG] floats
template <typename T, int MT, int KT>
__global__ void __launch_bounds__(BWD_THREADS, 1) slstm_bwd_mma_kernel(
    const float* __restrict__ saved, const float* __restrict__ R, const T* __restrict__ dh,
    float* __restrict__ dg, float* __restrict__ xbuf, int B, int S, int H, int hd) {
  constexpr int U = 16 * MT, TPC = 4 / MT, UP = U + 4, F = BWD_ROWS * U;
  constexpr int DG = bwd_dg_floats(KT), PS = bwd_part_floats(MT), RS = bwd_ring_floats(MT);
  extern __shared__ __align__(16) float smem[];
  float* dgs = smem;                      // [2][DG]
  float* part = smem + 2 * DG;            // [BWD_WARPS][PS]
  float* ring = part + BWD_WARPS * PS;    // [RING][RS]
  __shared__ __align__(8) uint64_t full[2];  // dg buffer b has landed
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = blockIdx.x, head = blockIdx.y, grp = blockIdx.z;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int D = H * hd;
  // this CTA's slice of a dg buffer: the k-tiles of its units, [kt0, kt0 +
  // nkt) (none past the buffer's 16 KT); every CTA receives all of them
  constexpr int KTILES = BWD_WARPS * KT;
  const int kt0 = rank * U / 2, nkt = max(0, min(U / 2, KTILES - kt0));
  const uint32_t phase_bytes = 256u * min(C * U / 2, KTILES);
  float* xg = xbuf + ((size_t)grp * H + head) * 2 * DG;

  // A, once: this warp's fragments of R's rows, R[q, head, jg, m] (0 past hd)
  uint32_t ab[MT][KT][4], as[MT][KT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int m = 2 * (w * KT + j) + (tq >> 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // (row g or g + 8, gate 2 (tq % 2) or + 1)
        const int jg = rank * U + 16 * mt + g + 8 * (e & 1), q = 2 * (tq & 1) + (e >> 1);
        const float x =
            jg < hd && m < hd ? __ldg(R + (((size_t)q * H + head) * hd + jg) * hd + m) : 0.f;
        ab[mt][j][e] = com::tf32_big(x);
        as[mt][j][e] = com::tf32_small(x, ab[mt][j][e]);
      }
    }
  for (int i = tid; i < 2 * DG; i += BWD_THREADS) dgs[i] = 0.f;  // dg_S = 0, and past C U units
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&full[1], phase_bytes);  // the buffer read at step 1
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros before any copy
  // every CTA's buffers and mbarriers are ready before any CTA copies into them
  cluster.sync();

  // this thread's cell: unit i of the CTA, row n of the group
  const int cell = tid / TPC, qq = tid % TPC, i = cell % U, n = cell / U;
  const int jg = rank * U + i, b = grp * BWD_ROWS + n;
  const bool valid = jg < hd && b < B;
  const size_t row = (size_t)SAVED_ROWS * D;  // saved's step stride
  const float* sv = saved + (size_t)b * S * row + (size_t)head * hd + jg;
  const T* dhp = dh + (size_t)b * S * D + (size_t)head * hd + jg;
  float* dgp = dg + (size_t)b * S * 4 * D + (size_t)head * hd + jg;
  // step x's state of this cell into its ring slot (the cell's TPC threads
  // share the 7 fields); one cp.async group a step, empty or not
  auto load_state = [&](int x) {
    if (valid && x >= 0) {
      float* dst = ring + (x & (RING - 1)) * RS + n * U + i;
      for (int k = qq; k < SAVED_ROWS; k += TPC)
        com::cp_async4(dst + k * F, sv + (size_t)x * row + (size_t)k * D, true);
    }
    com::cp_async_commit();
  };
  // dh in its own type, converted where it is used: a bfloat16 conversion
  // right after the load would wait for it
  auto load_dh = [&](int x) { return valid && x >= 0 ? dhp[(size_t)x * D] : from_f32<T>(0.f); };
  // step x's factors of the cell's backward, which do not depend on the
  // reverse recurrence (kernels/ref.py:slstm_bwd_ref; m held constant), from
  // the ring slots of steps x and x - 1: computed a step ahead, off the
  // step's critical path
  struct Factors { float dc_dh, dn_dh, tz, ig, c_prev, n_prev, f_ft, z_dc, o_dh, fg; };
  auto factors = [&](int x) {
    const float* cs = ring + (x & (RING - 1)) * RS + n * U + i;
    const float it = cs[0], ft = cs[F], zt = cs[2 * F], ot = cs[3 * F];
    const float c = cs[4 * F], nt = cs[5 * F], m = cs[6 * F];
    Factors f;
    f.c_prev = 0.f, f.n_prev = 0.f;
    float m_prev = -1e30f;
    if (x > 0) {
      const float* ps = ring + ((x - 1) & (RING - 1)) * RS + n * U + i;
      f.c_prev = ps[4 * F], f.n_prev = ps[5 * F], m_prev = ps[6 * F];
    }
    f.ig = expf(it - m);
    f.fg = expf(log_sigmoid(ft) + m_prev - m);
    f.tz = tanhf(zt);
    const float so = 1.0f / (1.0f + expf(-ot));
    f.dc_dh = so / nt;
    f.dn_dh = -so * c / (nt * nt);
    f.f_ft = f.fg * (1.0f / (1.0f + expf(ft)));
    f.z_dc = f.ig * (1.0f - f.tz * f.tz);
    f.o_dh = (c / nt) * so * (1.0f - so);
    return f;
  };
  for (int a = 0; a < AHEAD; ++a) load_state(S - 1 - a);
  com::cp_async_wait(AHEAD - 2);  // steps S - 1 and S - 2 have landed
  __syncthreads();
  Factors fa = factors(S - 1);
  T dh0 = load_dh(S - 1), dh1 = load_dh(S - 2);
  float dc = 0.f, dn = 0.f, f_next = 0.f;  // dc_{t+1}, dn_{t+1}, f_{t+1}

  for (int t = S - 1, u = 0; t >= 0; --t, ++u) {
    load_state(t - AHEAD);
    const T dh2 = load_dh(t - 2);
    // dg_{t+1} has landed: buffer u % 2, its ((u - 1) / 2)-th phase
    if (u > 0) mbar_wait(&full[u & 1], ((u - 1) >> 1) & 1);
    // R dg_{t+1} over this warp's k-tiles
    const float* bsrc = dgs + (u & 1) * DG + w * KT * 64 + 2 * lane;
    float sum[MT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(bsrc + j * 64);
      uint32_t bb[2] = {com::tf32_big(v.x), com::tf32_big(v.y)};
      const uint32_t bs[2] = {com::tf32_small(v.x, bb[0]), com::tf32_small(v.y, bb[1])};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float d[4];
        com::mma_tf32<true>(d, ab[mt][j], bs);
        com::mma_tf32(d, as[mt][j], bb);
        com::mma_tf32(d, ab[mt][j], bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][e] = j == 0 ? d[e] : sum[mt][e] + d[e];
      }
    }
    // the warp's partial tile: C element (unit 16 mt + g + 8 (e / 2), row 2 tq + e % 2)
    float* pw = part + w * PS;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pw[(2 * tq + (e & 1)) * UP + 16 * mt + g + 8 * (e >> 1)] = sum[mt][e];
    com::cp_async_wait(AHEAD - 2);  // this thread's copies down to step t - 2 have landed
    __syncthreads();                // every partial tile and every copy

    // the cell's R dg_{t+1}: its quarter's warps in order, then the quarters
    const float* pc = part + qq * (BWD_WARPS / TPC) * PS + n * UP + i;
    float acc = pc[0];
#pragma unroll
    for (int v = 1; v < BWD_WARPS / TPC; ++v) acc += pc[v * PS];
#pragma unroll
    for (int off = 1; off < TPC; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const float dht = to_f32(dh0) + acc;
    // the cell's backward on this step's factors
    dc = dht * fa.dc_dh + dc * f_next;
    dn = dht * fa.dn_dh + dn * f_next;
    const float4 d4 = make_float4((dc * fa.tz + dn) * fa.ig,
                                  (dc * fa.c_prev + dn * fa.n_prev) * fa.f_ft, dc * fa.z_dc,
                                  dht * fa.o_dh);
    f_next = fa.fg;
    // dg_t: this CTA's slice of the global buffer (zero for padding cells),
    // then one copy of the slice into every CTA's other buffer
    const int nb = (u + 1) & 1;
    if (qq == 0 && (jg >> 1) < KTILES) {
      *reinterpret_cast<float4*>(xg + nb * DG + (jg >> 1) * 64 + n * 8 + (jg & 1) * 4) =
          valid ? d4 : make_float4(0.f, 0.f, 0.f, 0.f);
      asm volatile("fence.proxy.async.global;\n" ::: "memory");  // visible to the copy
    }
    // the slice is whole; the reads of dg_{t+1}, the partial tiles and the
    // ring slot that the next step's copies overwrite are done
    __syncthreads();
    if (tid == 0 && u + 1 < S) {
      if (u + 2 < S) mbar_expect(&full[u & 1], phase_bytes);  // its next phase
      if (nkt > 0)
        multicast(dgs + nb * DG + kt0 * 64, xg + nb * DG + kt0 * 64, 256u * nkt, &full[nb], C);
    }
    if (valid)  // out, after the copy is on its way
      for (int q = qq; q < 4; q += TPC)
        dgp[((size_t)t * 4 + q) * D] = q == 0 ? d4.x : q == 1 ? d4.y : q == 2 ? d4.z : d4.w;
    if (t > 0) fa = factors(t - 1);
    dh0 = dh1;
    dh1 = dh2;
  }
  // a CTA leaves after every CTA has received its last copies
  cluster.sync();
}

// The step floor of a backward launch: the same grid, clusters, threads and
// shared memory, each step only the exchange: every (unit, row) cell of
// `rows` rows writes its float4 into the CTA's slice of the global buffer,
// one copy multicasts the slice into every CTA, the warps wait for their
// buffer and read their k-tiles' fragments. Times what a step costs before
// any arithmetic.
__global__ void __launch_bounds__(BWD_THREADS, 1) slstm_bwd_floor_kernel(int S, int hd, int MT,
                                                                         int KT, int rows,
                                                                         float* xbuf,
                                                                         float* sink) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, U = 16 * MT, DG = BWD_WARPS * KT * 64, rank = blockIdx.x;
  const int tpc = 4 / MT, cell = threadIdx.x / tpc, qq = threadIdx.x % tpc;
  const int i = cell % U, n = cell / U, jg = rank * U + i;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, KTILES = BWD_WARPS * KT;
  const int kt0 = rank * U / 2, nkt = max(0, min(U / 2, KTILES - kt0));
  const uint32_t phase_bytes = 256u * min(C * U / 2, KTILES);
  const float4 d4 = jg < hd && n < rows ? make_float4(jg, n, 1.f, 2.f) : make_float4(0, 0, 0, 0);
  float* xg = xbuf + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * 2 * DG;
  for (int k = threadIdx.x; k < 2 * DG; k += BWD_THREADS) smem[k] = 0.f;
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&full[1], phase_bytes);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  cluster.sync();
  float acc = 0.f;
  for (int u = 0; u < S; ++u) {
    if (u > 0) mbar_wait(&full[u & 1], ((u - 1) >> 1) & 1);
    for (int j = 0; j < KT; ++j) {
      const float2 v =
          *reinterpret_cast<const float2*>(smem + (u & 1) * DG + (w * KT + j) * 64 + 2 * lane);
      acc += v.x + v.y;
    }
    const int nb = (u + 1) & 1;
    if (qq == 0 && (jg >> 1) < KTILES) {
      *reinterpret_cast<float4*>(xg + nb * DG + (jg >> 1) * 64 + n * 8 + (jg & 1) * 4) = d4;
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0 && u + 1 < S) {
      if (u + 2 < S) mbar_expect(&full[u & 1], phase_bytes);
      if (nkt > 0)
        multicast(smem + nb * DG + kt0 * 64, xg + nb * DG + kt0 * 64, 256u * nkt, &full[nb], C);
    }
  }
  cluster.sync();
  if (acc < 0.f) sink[0] = acc;  // never (every value is >= 0): keeps the loads
}

// The backward kernel for (MT, KT), or null: the tilings it is built for.
template <typename T>
auto bwd_kernel(int mt, int kt) {
  using K = decltype(&slstm_bwd_mma_kernel<T, 1, 8>);
  if (mt == 1 && kt == 8) return K(&slstm_bwd_mma_kernel<T, 1, 8>);
  if (mt == 2 && kt == 4) return K(&slstm_bwd_mma_kernel<T, 2, 4>);
  if (mt == 4 && kt == 2) return K(&slstm_bwd_mma_kernel<T, 4, 2>);
  if (mt == 4 && kt == 1) return K(&slstm_bwd_mma_kernel<T, 4, 1>);
  return K(nullptr);
}

// Whether (C, MT, KT) covers hd: C CTAs of 16 MT units, 16 KT k-tiles of
// two units each.
inline bool bwd_plan_ok(int hd, int C, int mt, int kt) {
  return (C == 1 || C == 2 || C == 4 || C == 8 || C == MAX_BWD_CLUSTER) && 16 * mt * C >= hd &&
         32 * kt >= hd;
}

inline size_t bwd_smem(int mt, int kt) { return sizeof(float) * bwd_smem_floats(mt, kt); }

// A backward kernel's (or its floor's) attributes, set before its launch or
// occupancy query: its shared memory above 48 KB and, past 8 CTAs, the
// non-portable cluster size.
template <typename Kernel>
int bwd_attributes(Kernel kernel, int C, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return static_cast<int>(err);
}

inline int bwd_groups(int B) { return (B + BWD_ROWS - 1) / BWD_ROWS; }

template <typename T>
int launch_bwd(const float* saved, const float* R, const void* dh, float* dg, float* xbuf, int B,
               int S, int H, int hd, int C, int mt, int kt, cudaStream_t stream) {
  const auto kernel = bwd_kernel<T>(mt, kt);
  if (!bwd_plan_ok(hd, C, mt, kt) || kernel == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(mt, kt);
  const int err = bwd_attributes(kernel, C, smem);
  if (err != 0) return err;
  const ClusterLaunch l(C, H, bwd_groups(B), BWD_THREADS, smem, stream);
  return launch_ex(l, kernel, saved, R, static_cast<const T*>(dh), dg, xbuf, B, S, H, hd);
}

// How many clusters of a forward (backward = 0) or backward cluster launch
// the card runs at once.
template <typename T>
int max_clusters(int backward, int B, int H, int hd, int C, int a, int b, int* clusters) {
  if (backward) {
    const auto kernel = bwd_kernel<T>(a, b);
    if (!bwd_plan_ok(hd, C, a, b) || kernel == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = bwd_smem(a, b);
    const int err = bwd_attributes(kernel, C, smem);
    if (err != 0) return err;
    const ClusterLaunch l(C, H, bwd_groups(B), BWD_THREADS, smem, nullptr);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg));
  }
  const int threads = cluster_threads(hd, C, a, b);
  const auto kernel = cluster_kernel<T>(b);
  if (threads == 0 || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterLaunch l(C, H, B, threads, cluster_smem(a, b), nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg));
}

inline int launch_bwd_floor(float* xbuf, int B, int S, int H, int hd, int C, int mt, int kt,
                            int rows, cudaStream_t stream) {
  if (!bwd_plan_ok(hd, C, mt, kt) || (mt != 1 && mt != 2 && mt != 4) || rows < 1 ||
      rows > BWD_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(mt, kt);
  const int err = bwd_attributes(slstm_bwd_floor_kernel, C, smem);
  if (err != 0) return err;
  const ClusterLaunch l(C, H, bwd_groups(B), BWD_THREADS, smem, stream);
  return launch_ex(l, slstm_bwd_floor_kernel, S, hd, mt, kt, rows, xbuf,
                   static_cast<float*>(nullptr));
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
// written, xbuf the exchange's scratch (H ceil(B / 8) 2 (16 kt 64) floats,
// no initial value); a cluster of C CTAs (1, 2, 4, 8 or 16) a (head, group
// of 8 rows), mt m-tiles of 16 units a CTA and kt k-tiles of 8 terms a warp
// (the (mt, kt) of bwd_kernel).
extern "C" int repro_slstm_bwd(const float* saved, const float* R, const void* dh, float* dg,
                               float* xbuf, int B, int S, int H, int hd, int dtype, int C, int mt,
                               int kt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > MAX_HD || bwd_groups(B) > 65535 ||
      H > 65535 || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_bwd<float>(saved, R, dh, dg, xbuf, B, S, H, hd, C, mt, kt, st);
  return launch_bwd<__nv_bfloat16>(saved, R, dh, dg, xbuf, B, S, H, hd, C, mt, kt, st);
}

// The step floor of that launch: S steps of its exchange for `rows` rows a
// group (1 to 8), no arithmetic (kernels/slstm.py:bwd_step_floor); xbuf as
// repro_slstm_bwd's.
extern "C" int repro_slstm_bwd_floor(float* xbuf, int B, int S, int H, int hd, int C, int mt,
                                     int kt, int rows, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || bwd_groups(B) > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_floor(xbuf, B, S, H, hd, C, mt, kt, rows, static_cast<cudaStream_t>(stream));
}

// Writes to clusters how many clusters of the cluster path's forward
// (backward = 0; a, b = KS, kpt) or backward (1; a, b = mt, kt) launch of
// this plan the card runs at once on the current device
// (cudaOccupancyMaxActiveClusters; no launch). Returns the CUDA error code.
extern "C" int repro_slstm_clusters(int backward, int B, int H, int hd, int dtype, int C, int a,
                                    int b, int* clusters) {
  if (B <= 0 || H <= 0 || hd <= 0 || hd > MAX_HD || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return max_clusters<float>(backward, B, H, hd, C, a, b, clusters);
  return max_clusters<__nv_bfloat16>(backward, B, H, hd, C, a, b, clusters);
}
