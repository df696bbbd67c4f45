// The designs that the sLSTM backward (src/repro_torch/csrc/slstm.cu, "the
// backward") turned down, as kernels that time one part of a step each;
// built and timed by scripts/slstm_bwd_probe.py beside the kernel's own step
// floor (repro_slstm_bwd_floor: the exchange through L2 and a multicast
// copy). This file includes the kernel's source for its helpers; the port
// never builds it.
//
// * probe_floor_push: the exchange by writing instead of reading. Each
//   (unit, row) cell stores its float4 into the buffer of every CTA of the
//   cluster (distributed shared memory stores), then one barrier.cluster;
//   the warps read their B fragments from their own CTA.
// * probe_floor_bulk: the exchange by the copy engine (cp.async.bulk of each
//   CTA's slice to every other CTA, completing on the receiver's mbarrier),
//   with no barrier.cluster.
// * probe_floor_flags: the pull exchange with an mbarrier a buffer and
//   owner in every CTA in place of the barrier.cluster: an owner arrives
//   remotely once its slice is written, a warp waits for its owner alone.
// * probe_floor_pull: the exchange by DSMEM loads: each warp reads its
//   k-tiles from the CTA that owns them after a barrier.cluster.
// * probe_floor_rs: the exchange of a reduce-scatter design (R's columns,
//   partial dh tiles sent to their units' CTA: 8 KB a CTA a step, not 32).
// * probe_product: the step's product alone (B loads and split, the 3xTF32
//   MMAs, the partial tiles, one __syncthreads), no exchange and no cell, for
//   the register budgets of an 8-CTA cluster at hd 256 (32 units a CTA, two
//   m-tiles) against the 16-CTA cluster's (one m-tile):
//     variant 0: 16 units, R's big and small halves in registers (the kernel's)
//     variant 1: 32 units, both halves in registers (128 registers of R)
//     variant 2: 32 units, R in registers as float32, split again every step
//     variant 3: 32 units, big halves in registers, small halves in shared
//                memory (128 KB a CTA)
#include "../src/repro_torch/csrc/slstm.cu"

namespace {

__global__ void __launch_bounds__(BWD_THREADS, 1) floor_push_kernel(int S, int hd, int MT, int KT,
                                                                    int rows) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, U = 16 * MT, DG = BWD_WARPS * KT * 64;
  const int tpc = 4 / MT, cell = threadIdx.x / tpc, qq = threadIdx.x % tpc;
  const int i = cell % U, n = cell / U, jg = blockIdx.x * U + i;
  const bool valid = jg < hd && n < rows;
  const float4 d4 = make_float4(jg, n, 1.f, 2.f);
  cluster.sync();
  for (int u = 0; u < S; ++u) {
    if (valid) {
      float* nb = smem + ((u + 1) & 1) * DG + (jg >> 1) * 64 + n * 8 + (jg & 1) * 4;
      for (int dst = qq; dst < C; dst += tpc)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(nb, dst)) = d4;
    }
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// The exchange of a reduce-scatter design (R's columns of the CTA's units
// in registers, each warp's 16-unit partial tile sent to the CTA owning those
// units, summed there): every thread stores its two float2 of the tile into
// CTA w % C, then the barrier.cluster. 8 KB a CTA a step at 8 rows.
__global__ void __launch_bounds__(BWD_THREADS, 1) floor_rs_kernel(int S) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float2 v = make_float2(w, lane);
  cluster.sync();
  for (int u = 0; u < S; ++u) {
    float* nb = smem + ((u + 1) & 1) * 16 * 128 + blockIdx.x * 128 + 4 * lane;
    float2* dst = reinterpret_cast<float2*>(cluster.map_shared_rank(nb, w % C));
    dst[0] = v;
    dst[1] = v;
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// The exchange by the copy engine: each CTA writes its slice locally, then
// one thread sends it to every other CTA with cp.async.bulk (shared::cta to
// shared::cluster), completing on the receiver's mbarrier of that buffer
// (expect_tx of the C - 1 slices); no barrier.cluster. Double buffering is
// enough: a CTA overwrites a peer's buffer only after receiving that peer's
// next slice, which the peer sends after reading the buffer.
__global__ void __launch_bounds__(BWD_THREADS, 1) floor_bulk_kernel(int S, int hd, int MT, int KT,
                                                                    int rows, float* sink) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, U = 16 * MT, DG = BWD_WARPS * KT * 64, rank = blockIdx.x;
  const int tpc = 4 / MT, cell = threadIdx.x / tpc, qq = threadIdx.x % tpc;
  const int i = cell % U, n = cell / U, jg = rank * U + i;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool valid = jg < hd && n < rows && qq == 0;
  const float4 d4 = make_float4(jg, n, 1.f, 2.f);
  const int slice = U / 2 * 64;  // floats of one CTA's units in a buffer
  const uint32_t bytes = 4u * slice;
  for (int k = threadIdx.x; k < 2 * DG; k += BWD_THREADS) smem[k] = 0.f;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(com::smem_u32(&full[b])));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the phase of buffer 1, read at step 1
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     com::smem_u32(&full[1])), "r"(bytes * (C - 1)) : "memory");
  }
  cluster.sync();
  float acc = 0.f;
  for (int u = 0; u < S; ++u) {
    if (u > 0) {  // this step's buffer is whole
      const uint32_t bar = com::smem_u32(&full[u & 1]), parity = ((u - 1) >> 1) & 1;
      uint32_t done = 0;
      while (!done)
        asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
    for (int j = 0; j < KT; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(smem + (u & 1) * DG + (w * KT + j) * 64 +
                                                        2 * lane);
      acc += v.x + v.y;
    }
    float* nb = smem + ((u + 1) & 1) * DG;
    if (valid)
      *reinterpret_cast<float4*>(nb + (jg >> 1) * 64 + n * 8 + (jg & 1) * 4) = d4;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0 && u + 1 < S) {  // the last step's slices are read by nobody
      // the next phase of the buffer read two steps on
      if (u + 2 < S)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                         com::smem_u32(&full[u & 1])), "r"(bytes * (C - 1)) : "memory");
      const uint32_t src = com::smem_u32(nb + rank * slice);
      const uint32_t bar = com::smem_u32(&full[(u + 1) & 1]);
      for (int d = 1; d < C; ++d) {
        const int dst = (rank + d) % C;
        uint32_t rdst, rbar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rdst) : "r"(src), "r"(dst));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rbar) : "r"(bar), "r"(dst));
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], "
            "%2, [%3];\n" ::"r"(rdst), "r"(src), "r"(bytes), "r"(rbar) : "memory");
      }
    }
  }
  cluster.sync();
  if (acc < 0.f) sink[0] = acc;
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
                 "[%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// The pull exchange (each warp reads its k-tiles from their owner) with
// flags in place of the barrier.cluster: each CTA holds an mbarrier a
// buffer and owner; an owner, its slice written, arrives (release,
// cluster scope) on that mbarrier of every CTA, and a warp waits only for
// its owner's. One cluster.sync at the end keeps every CTA's buffers alive.
__global__ void __launch_bounds__(BWD_THREADS, 1) floor_flags_kernel(int S, int hd, int MT, int KT,
                                                                     int rows, float* sink) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t ready[2][MAX_BWD_CLUSTER];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, U = 16 * MT, DG = BWD_WARPS * KT * 64, rank = blockIdx.x;
  const int tpc = 4 / MT, cell = threadIdx.x / tpc, qq = threadIdx.x % tpc;
  const int i = cell % U, n = cell / U, jg = rank * U + i;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, owner = min(2 * KT * w / U, C - 1);
  const bool valid = jg < hd && n < rows && qq == 0;
  const float4 d4 = make_float4(jg, n, 1.f, 2.f);
  for (int k = threadIdx.x; k < 2 * DG; k += BWD_THREADS) smem[k] = 0.f;
  if (threadIdx.x < 2 * MAX_BWD_CLUSTER)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
        com::smem_u32(&ready[threadIdx.x / MAX_BWD_CLUSTER][threadIdx.x % MAX_BWD_CLUSTER])));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  cluster.sync();
  const float* bown = cluster.map_shared_rank(smem + w * KT * 64 + 2 * lane, owner);
  float acc = 0.f;
  for (int u = 0; u < S; ++u) {
    if (u > 0) mbar_wait_cluster(com::smem_u32(&ready[u & 1][owner]), ((u - 1) >> 1) & 1);
    for (int j = 0; j < KT; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(bown + (u & 1) * DG + j * 64);
      acc += v.x + v.y;
    }
    if (valid)
      *reinterpret_cast<float4*>(smem + ((u + 1) & 1) * DG + (jg >> 1) * 64 + n * 8 +
                                 (jg & 1) * 4) = d4;
    __syncthreads();
    if (threadIdx.x < C && u + 1 < S) {
      uint32_t rbar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(rbar) : "r"(com::smem_u32(&ready[(u + 1) & 1][rank])), "r"(threadIdx.x));
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(rbar)
                   : "memory");
    }
  }
  cluster.sync();
  if (acc < 0.f) sink[0] = acc;
}

// The exchange by reading: each cell writes its float4 into its own CTA's
// buffer and arrives on the barrier.cluster; after the wait each warp reads
// its k-tiles' fragments from the CTA that owns their units (distributed
// shared memory loads).
__global__ void __launch_bounds__(BWD_THREADS, 1) floor_pull_kernel(int S, int hd, int MT, int KT,
                                                                    int rows, float* sink) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, U = 16 * MT, DG = BWD_WARPS * KT * 64;
  const int tpc = 4 / MT, cell = threadIdx.x / tpc, qq = threadIdx.x % tpc;
  const int i = cell % U, n = cell / U, jg = blockIdx.x * U + i;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool valid = jg < hd && n < rows && qq == 0;
  const float4 d4 = make_float4(jg, n, 1.f, 2.f);
  for (int k = threadIdx.x; k < 2 * DG; k += BWD_THREADS) smem[k] = 0.f;
  cluster.sync();
  const float* bown =
      cluster.map_shared_rank(smem + w * KT * 64 + 2 * lane, min(2 * KT * w / U, C - 1));
  float acc = 0.f;
  for (int u = 0; u < S; ++u) {
    if (u > 0) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    for (int j = 0; j < KT; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(bown + (u & 1) * DG + j * 64);
      acc += v.x + v.y;
    }
    if (valid)
      *reinterpret_cast<float4*>(smem + ((u + 1) & 1) * DG + (jg >> 1) * 64 + n * 8 +
                                 (jg & 1) * 4) = d4;
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  if (acc < 0.f) sink[0] = acc;
}

template <int MT, int KT, int MODE>
__global__ void __launch_bounds__(BWD_THREADS, 1) product_kernel(int S, float* sink) {
  constexpr int U = 16 * MT, UP = U + 4, DG = BWD_WARPS * KT * 64, PS = BWD_ROWS * UP + 2;
  extern __shared__ __align__(16) float smem[];
  float* dgs = smem;
  float* part = smem + 2 * DG;
  uint4* small_s = reinterpret_cast<uint4*>(part + BWD_WARPS * PS);  // MODE 2: [MT KT][threads]
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g = lane >> 2, tq = lane & 3;
  float r[MT][KT][4];
  uint32_t ab[MODE == 1 ? 1 : MT][KT][4], as[MODE == 0 ? MT : 1][KT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = 0.01f * (((tid * 7 + mt * 131 + j * 17 + e * 3) % 97) - 48);
        if constexpr (MODE == 1) {
          r[mt][j][e] = x;
        } else {
          ab[mt][j][e] = com::tf32_big(x);
          const uint32_t sm = com::tf32_small(x, ab[mt][j][e]);
          if constexpr (MODE == 0) as[mt][j][e] = sm;
          else reinterpret_cast<uint32_t*>(&small_s[(mt * KT + j) * BWD_THREADS + tid])[e] = sm;
        }
      }
  for (int k = tid; k < 2 * DG; k += BWD_THREADS) dgs[k] = 0.001f * (k % 101);
  __syncthreads();
  for (int u = 0; u < S; ++u) {
    const float* bsrc = dgs + (u & 1) * DG + w * KT * 64 + 2 * lane;
    float sum[MT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(bsrc + j * 64);
      uint32_t bb[2] = {com::tf32_big(v.x), com::tf32_big(v.y)};
      const uint32_t bs[2] = {com::tf32_small(v.x, bb[0]), com::tf32_small(v.y, bb[1])};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t big[4], sm[4];
        if constexpr (MODE == 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            big[e] = com::tf32_big(r[mt][j][e]);
            sm[e] = com::tf32_small(r[mt][j][e], big[e]);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) big[e] = ab[mt][j][e];
          if constexpr (MODE == 0) {
#pragma unroll
            for (int e = 0; e < 4; ++e) sm[e] = as[mt][j][e];
          } else {
            const uint4 s4 = small_s[(mt * KT + j) * BWD_THREADS + tid];
            sm[0] = s4.x, sm[1] = s4.y, sm[2] = s4.z, sm[3] = s4.w;
          }
        }
        float d[4];
        com::mma_tf32<true>(d, big, bs);
        com::mma_tf32(d, sm, bb);
        com::mma_tf32(d, big, bb);
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][e] = j == 0 ? d[e] : sum[mt][e] + d[e];
      }
    }
    float* pw = part + w * PS;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pw[(2 * tq + (e & 1)) * UP + 16 * mt + g + 8 * (e >> 1)] = sum[mt][e];
    __syncthreads();
  }
  if (tid == 0) sink[blockIdx.x] = part[0];
}

template <int MT, int KT, int MODE>
int launch_product(int ctas, int S, float* sink, cudaStream_t stream) {
  constexpr int U = 16 * MT;
  size_t smem = sizeof(float) * (2 * BWD_WARPS * KT * 64 + BWD_WARPS * (BWD_ROWS * (U + 4) + 2));
  if (MODE == 2) smem += 16 * MT * KT * BWD_THREADS;
  smem = smem < 120 * 1024 ? 120 * 1024 : smem;  // one CTA an SM, as the kernel
  auto kernel = product_kernel<MT, KT, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<ctas, BWD_THREADS, smem, stream>>>(S, sink);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_floor_push(int B, int S, int H, int hd, int C, int mt, int kt, int rows,
                                void* stream) {
  if (!bwd_plan_ok(hd, C, mt, kt) || (mt != 1 && mt != 2 && mt != 4) || rows < 0 ||
      rows > BWD_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(mt, kt);
  const int err = bwd_attributes(floor_push_kernel, C, smem);
  if (err != 0) return err;
  const ClusterLaunch l(C, H, bwd_groups(B), BWD_THREADS, smem,
                        static_cast<cudaStream_t>(stream));
  return launch_ex(l, floor_push_kernel, S, hd, mt, kt, rows);
}

extern "C" int probe_floor_bulk(int B, int S, int H, int hd, int C, int mt, int kt, int rows,
                                void* stream) {
  if (!bwd_plan_ok(hd, C, mt, kt) || (mt != 1 && mt != 2 && mt != 4) || rows < 1 ||
      rows > BWD_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(mt, kt);
  const int err = bwd_attributes(floor_bulk_kernel, C, smem);
  if (err != 0) return err;
  const ClusterLaunch l(C, H, bwd_groups(B), BWD_THREADS, smem,
                        static_cast<cudaStream_t>(stream));
  return launch_ex(l, floor_bulk_kernel, S, hd, mt, kt, rows, static_cast<float*>(nullptr));
}

extern "C" int probe_floor_flags(int B, int S, int H, int hd, int C, int mt, int kt, int rows,
                                 void* stream) {
  if (!bwd_plan_ok(hd, C, mt, kt) || (mt != 1 && mt != 2 && mt != 4) || rows < 1 ||
      rows > BWD_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(mt, kt);
  const int err = bwd_attributes(floor_flags_kernel, C, smem);
  if (err != 0) return err;
  const ClusterLaunch l(C, H, bwd_groups(B), BWD_THREADS, smem,
                        static_cast<cudaStream_t>(stream));
  return launch_ex(l, floor_flags_kernel, S, hd, mt, kt, rows, static_cast<float*>(nullptr));
}

extern "C" int probe_floor_pull(int B, int S, int H, int hd, int C, int mt, int kt, int rows,
                                void* stream) {
  if (!bwd_plan_ok(hd, C, mt, kt) || (mt != 1 && mt != 2 && mt != 4) || rows < 1 ||
      rows > BWD_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_smem(mt, kt);
  const int err = bwd_attributes(floor_pull_kernel, C, smem);
  if (err != 0) return err;
  const ClusterLaunch l(C, H, bwd_groups(B), BWD_THREADS, smem,
                        static_cast<cudaStream_t>(stream));
  return launch_ex(l, floor_pull_kernel, S, hd, mt, kt, rows, static_cast<float*>(nullptr));
}

// rows 0: the barrier.cluster alone
extern "C" int probe_floor_rs(int C, int H, int S, void* stream) {
  const size_t smem = bwd_smem(1, 8);
  const int err = bwd_attributes(floor_rs_kernel, C, smem);
  if (err != 0) return err;
  const ClusterLaunch l(C, H, 1, BWD_THREADS, smem, static_cast<cudaStream_t>(stream));
  return launch_ex(l, floor_rs_kernel, S);
}

extern "C" int probe_product(int variant, int ctas, int S, float* sink, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_product<1, 8, 0>(ctas, S, sink, st);
    case 1: return launch_product<2, 8, 0>(ctas, S, sink, st);
    case 2: return launch_product<2, 8, 1>(ctas, S, sink, st);
    case 3: return launch_product<2, 8, 2>(ctas, S, sink, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
