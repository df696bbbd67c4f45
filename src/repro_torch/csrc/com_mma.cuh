// com_mma.cuh: the tensor-core mainloop that com_matmul.cu and conv2d_com.cu
// share, and the pieces around it (epilogue, deterministic split-K reduce).
//
// A block of 8 warps (32 x 32 each) computes a BM x BN = 128 x 64 tile of
// C = A B over a range of k-tiles of BK, two blocks an SM:
//
// * B (the weights, (K, N) row-major) streams through a ring of `stages`
//   shared-memory slots filled by 16-byte cp.async.cg copies, so the next
//   tiles' copies are in flight while the current tile's MMAs run. B rows are
//   padded by 4 (f32) or 8 (bf16) elements, so fragment loads hit 32
//   distinct banks.
// * A is read through per-thread row offsets into shared memory: for the
//   matmul an [BM][BK + pad] slot of the same ring, for the convolution the
//   input halo tile of a channel chunk, re-sliced for every kernel position
//   (the RIFM's in-buffer shift). Rows are padded by 8 elements:
//   conflict-free fragment loads and ldmatrix.
// * float32 runs 3xTF32 on mma.sync.m16n8k8: each fragment element x is split
//   into big = x rounded to TF32 and small = x - big (read as TF32), and
//   acc += small*big' + big*small' + big*big' (small terms first; small*small
//   dropped). The fast split (four instructions an element) turns an inf, a
//   NaN or an |x| within half a TF32 ulp of FLT_MAX into a NaN product; a
//   block whose sums come out non-finite runs its k range again with the
//   saturating split, which carries those operands as the plain product does
//   (see tf32_big). Where the fast split is finite the two agree bit for bit. The tensor cores add into the accumulator without rounding to
//   nearest, so each k-tile's MMAs run on a fresh accumulator that is then
//   added to an f32 register sum (the promotion that Hopper's FP8 GEMMs use):
//   the truncation then acts on one k-tile's partial sum, not on the whole
//   dot product. bfloat16 runs mma.sync.m16n8k16 with ldmatrix (.trans for
//   the row-major weights) and an f32 accumulator.
// * Split-K writes f32 partials to a workspace [splits][rows][N]; a second
//   kernel sums the slices in a fixed order and applies the epilogue: no
//   atomics, so two calls give the same bits.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// 1: promote the float32 MMA accumulator into the register sum after every
// k-tile; 0: accumulate in the MMA alone (only to measure what promotion
// buys: scripts/com_mma_probe.py builds it so)
#ifndef COM_PROMOTE
#define COM_PROMOTE 1
#endif

namespace com {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3 };

constexpr int BM = 128;
constexpr int SMEM_LIMIT = 232448;  // 227 KB a block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The activations with the fast exponential and division (no slow-path
// calls in the kernels' epilogues); exp's argument is capped at 80 so that the
// divisor stays below 2^126, where __fdividef is exact to a few ulp.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_SILU:
      return __fdividef(v, 1.f + __expf(fminf(-v, 80.f)));
    case ACT_GELU: {  // tanh form, as jax.nn.gelu by default
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      const float u = 2.f * c * (v + 0.044715f * v * v * v);
      const float tanh_half_u = 1.f - __fdividef(2.f, 1.f + __expf(fminf(u, 80.f)));
      return 0.5f * v * (1.f + tanh_half_u);
    }
    default:
      return v;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The ROFM epilogue: Add (bias), Act, Bp (residual) on the f32 sum of
// element (r, n) of a row-major (rows, N) output.
template <typename T>
__device__ __forceinline__ float finish(float v, long long r, int n, int N, const T* bias,
                                        const T* res, int act) {
  if (bias != nullptr) v += to_f32(bias[n]);
  v = activate(v, act);
  if (res != nullptr) v += to_f32(res[r * N + n]);
  return v;
}

// ---- the tile geometry ------------------------------------------------------

// Row padding (elements) of the A and B tiles in shared memory, so that the
// fragment loads of a warp hit distinct banks.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int A = 8, B = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int A = 8, B = 8; };

// A 128 x 64 block tile over k-tiles of BK_ (a multiple of the MMA's k).
template <typename T, int BK_> struct Layout {
  static constexpr int BK = BK_;
  static constexpr int BN = 64;
  static constexpr int AS = BK + Pad<T>::A;      // A row stride: [rows][AS]
  static constexpr int BS = BN + Pad<T>::B;      // B row stride: [BK][BS]
  static constexpr int A_ELEMS = BM * AS;
  static constexpr int B_ELEMS = BK * BS;
  static constexpr int CE = 16 / sizeof(T);      // elements in a 16-byte copy
  // 8 warps of 32 x 32 (4 x 2), two blocks an SM: 16 warps, each within 128
  // registers (the tile's accumulators, their promoted sums and one k8
  // step's fragments). A 128 x 128 tile of 16 such warps, one block an SM,
  // measured slower over the VGG-16 products: one barrier stalls all 16.
  static constexpr int WTM = 32, WTN = 32;
  static constexpr int WARPS_M = BM / WTM;
  static constexpr int WARPS_N = BN / WTN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int MT = WTM / 16;            // m16 tiles a warp
  static constexpr int NT = WTN / 8;             // n8 tiles a warp
  static_assert(BK % (sizeof(T) == 4 ? 8 : 16) == 0, "whole MMA k steps");
};

// ---- PTX wrappers -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; zero-fill where !pred (src must still be a
// valid address, so callers pass the tensor's base then).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 16 : 0));
}
// 4-byte copy (cp.async.ca), zero-fill where !pred: rows that are not
// 16-byte aligned (K = 27, C = 3) in float32.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most n groups are pending (n < 4: the ring has at most 4 slots)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

// x = big + small, the fast split: big is x rounded to TF32 (half a TF32 ulp
// added; the MMA reads only the 19 high bits of a TF32 operand, so its
// truncation rounds half away from zero, as cvt.rna does), small = x - big
// exactly in f32, read by the MMA truncated to TF32. A fragment register
// holds x + half an ulp, from which both follow: the big operand as it is,
// small in three instructions. For |x| >= 0x7F7FF000 (inf, NaN, the top
// half ulp below FLT_MAX) the add carries into the exponent and the products
// come out NaN: the caller detects that and takes the saturating split.
__device__ __forceinline__ uint32_t tf32_big_fast(float x) { return __float_as_uint(x) + 0x1000u; }
__device__ __forceinline__ uint32_t tf32_small_fast(uint32_t big) {
  return __float_as_uint(__uint_as_float(big - 0x1000u) - __uint_as_float(big & 0xFFFFE000u));
}

// The saturating split: big is x rounded to TF32 and saturated at the
// largest finite TF32, TF32_MAX (cvt.rna.satfinite: x clamped to
// +-TF32_MAX, then half an ulp added), small = x - big, from x itself.
// * |x| near FLT_MAX: big = TF32_MAX, small = x - TF32_MAX, exact;
// * x = +-inf: big = +-TF32_MAX, small = +-inf, so that small x big' and
//   big x big' carry the infinity with the right sign and big x small' stays
//   finite (inf x 0 = NaN, where small' is 0, is never formed); inf x inf
//   comes out inf;
// * x = NaN: big = -TF32_MAX, small = NaN: the sum is NaN.
// (A pass-through big = x, small = 0 would form inf x small', NaN or -inf
// for an x' whose small is 0 or of the other sign.)
constexpr float TF32_MAX = 3.40116213e38f;  // 0x7F7FE000
__device__ __forceinline__ uint32_t tf32_big(float x) {
  return __float_as_uint(fminf(fmaxf(x, -TF32_MAX), TF32_MAX)) + 0x1000u;
}
__device__ __forceinline__ uint32_t tf32_small(float x, uint32_t big) {
  return __float_as_uint(x - __uint_as_float(big & 0xFFFFE000u));
}
// An 8-byte shared-memory load the compiler may not merge with an earlier
// load of the same address: the split reloads x for its small half rather
// than keeping x in registers.
__device__ __forceinline__ float2 lds_f2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(smem_u32(p)));
  return v;
}

// d = a b + d, or with FRESH d = a b (no accumulator to read)
template <bool FRESH = false>
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  if constexpr (FRESH)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ---- one warp, one k-tile -----------------------------------------------------
// Fragment layouts of mma.sync (g = lane / 4, t = lane % 4): A element (row
// g or g + 8, k slot t or t + 4), B element (k slot t or t + 4, column g),
// C element (g or g + 8, 2t or 2t + 1). The sum runs over k in any order, so
// k slots t and t + 4 take k = 2t and 2t + 1: a thread's two A elements of a
// row are adjacent and come in one 8-byte load. `aoff[i][h]` is the offset
// of row wm0 + 16 i + g + 8 h of A.

// With FRESH the first MMA of each accumulator overwrites it (a promoted
// k-tile starts from zero without clearing registers).
// With SAFE the saturating split, else the fast one.
template <int MT, int NT, int BS, int BK, bool FRESH, bool SAFE>
__device__ __forceinline__ void warp_ktile(float (&acc)[MT][NT][4], const float* A,
                                           const int (&aoff)[MT][2], const float* B, int wn0,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < BK; ks += 8) {
    uint32_t a[MT][4], b[NT][2], small[MT > NT / 2 ? MT * 4 : NT * 2];
    float bx[SAFE ? NT : 1][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bp = B + (ks + 2 * t) * BS + wn0 + j * 8 + g;
      if constexpr (SAFE) {
        bx[j][0] = bp[0], bx[j][1] = bp[BS];
        b[j][0] = tf32_big(bx[j][0]);
        b[j][1] = tf32_big(bx[j][1]);
      } else {
        b[j][0] = tf32_big_fast(bp[0]);
        b[j][1] = tf32_big_fast(bp[BS]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const float2 lo = *reinterpret_cast<const float2*>(A + aoff[i][0] + ks + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(A + aoff[i][1] + ks + 2 * t);
      if constexpr (SAFE) {
        a[i][0] = tf32_big(lo.x), a[i][1] = tf32_big(hi.x);
        a[i][2] = tf32_big(lo.y), a[i][3] = tf32_big(hi.y);
      } else {
        a[i][0] = tf32_big_fast(lo.x), a[i][1] = tf32_big_fast(hi.x);
        a[i][2] = tf32_big_fast(lo.y), a[i][3] = tf32_big_fast(hi.y);
      }
    }
    // three passes over the MT x NT accumulators, so that consecutive MMAs
    // never wait on each other: big x small', small x big', big x big'. Each
    // pass's small terms live only through that pass (the saturating split
    // reloads A for its small halves: it needs x, and registers are scarce).
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (SAFE) {
        small[2 * j] = tf32_small(bx[j][0], b[j][0]);
        small[2 * j + 1] = tf32_small(bx[j][1], b[j][1]);
      } else {
        small[2 * j] = tf32_small_fast(b[j][0]);
        small[2 * j + 1] = tf32_small_fast(b[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (FRESH && ks == 0)
          mma_tf32<true>(acc[i][j], a[i], &small[2 * j]);
        else
          mma_tf32(acc[i][j], a[i], &small[2 * j]);
      }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if constexpr (SAFE) {
        const float2 lo = lds_f2(A + aoff[i][0] + ks + 2 * t);
        const float2 hi = lds_f2(A + aoff[i][1] + ks + 2 * t);
        small[0] = tf32_small(lo.x, a[i][0]), small[1] = tf32_small(hi.x, a[i][1]);
        small[2] = tf32_small(lo.y, a[i][2]), small[3] = tf32_small(hi.y, a[i][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) small[c] = tf32_small_fast(a[i][c]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], small, b[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], a[i], b[j]);
  }
}

// bf16: `aoff[i][0]` is the offset of row wm0 + 16 i + (lane % 16), the row
// whose address this lane gives ldmatrix.
template <int MT, int NT, int BS, int BK, bool FRESH, bool SAFE>
__device__ __forceinline__ void warp_ktile(float (&acc)[MT][NT][4], const __nv_bfloat16* A,
                                           const int (&aoff)[MT][2], const __nv_bfloat16* B,
                                           int wn0, int lane) {
  static_assert(NT % 2 == 0, "ldmatrix.x4.trans loads two n8 tiles");
#pragma unroll
  for (int ks = 0; ks < BK; ks += 16) {
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) ldsm_x4(a[i], A + aoff[i][0] + ks + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      ldsm_x4_trans(r, B + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * BS + wn0 +
                           (j + (lane >> 4)) * 8);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
}

// ---- the block mainloop -------------------------------------------------------
// P provides: load(kt, slot) issues the copies of k-tile kt into ring slot
// `slot` (no commit); a_tile(kt, slot) and b_tile(slot) are the operands of
// k-tile kt; row_off(r) is the offset of A's block row r from a_tile.
// `acc` receives the sum over k-tiles [kt0, kt0 + nkt).

template <typename T, int BK, bool SAFE, class P>
__device__ __forceinline__ void mainloop_pass(P& p, int kt0, int nkt, int stages,
                                              float (&acc)[Layout<T, BK>::MT][Layout<T, BK>::NT][4]) {
  using L = Layout<T, BK>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / L::WARPS_N) * L::WTM, wn0 = (warp % L::WARPS_N) * L::WTN;
  int aoff[L::MT][2];
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      aoff[i][0] = p.row_off(wm0 + i * 16 + (lane >> 2));
      aoff[i][1] = p.row_off(wm0 + i * 16 + (lane >> 2) + 8);
    } else {
      aoff[i][0] = p.row_off(wm0 + i * 16 + (lane & 15));
      aoff[i][1] = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < nkt) p.load(kt0 + s, s);
    cp_async_commit();
  }
  int slot = 0, next = stages - 1;
  float part[L::MT][L::NT][4];  // the MMA accumulator between promotions (float32)
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait(stages - 2);  // k-tile i has landed (this thread's copies)
    __syncthreads();            // everyone's copies; everyone is done with i - 1
    if (i + stages - 1 < nkt) p.load(kt0 + i + stages - 1, next);
    cp_async_commit();
    if constexpr (std::is_same<T, float>::value && COM_PROMOTE) {
      warp_ktile<L::MT, L::NT, L::BS, BK, true, SAFE>(part, p.a_tile(kt0 + i, slot), aoff, p.b_tile(slot),
                                            wn0, lane);
#pragma unroll
      for (int a = 0; a < L::MT; ++a)
#pragma unroll
        for (int b = 0; b < L::NT; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][b][c] += part[a][b][c];
    } else {
      warp_ktile<L::MT, L::NT, L::BS, BK, false, SAFE>(acc, p.a_tile(kt0 + i, slot), aoff, p.b_tile(slot),
                                             wn0, lane);
    }
    slot = slot + 1 == stages ? 0 : slot + 1;
    next = next + 1 == stages ? 0 : next + 1;
  }
  cp_async_wait(0);
}

// The mainloop: the fast split; float32 blocks whose sums are not all finite
// (an inf, NaN or near-overflow operand makes the fast split's products NaN)
// run their k range again with the saturating split. One block-wide vote at
// the end is all the fast path pays.
template <typename T, int BK, class P>
__device__ __forceinline__ void mainloop(P& p, int kt0, int nkt, int stages,
                                         float (&acc)[Layout<T, BK>::MT][Layout<T, BK>::NT][4]) {
  mainloop_pass<T, BK, false>(p, kt0, nkt, stages, acc);
  if constexpr (std::is_same<T, float>::value) {
    float sum = 0.f;  // NaN or inf if any sum is (or, harmlessly, if the total overflows)
#pragma unroll
    for (int i = 0; i < Layout<T, BK>::MT; ++i)
#pragma unroll
      for (int j = 0; j < Layout<T, BK>::NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sum += acc[i][j][c];
    // the barrier also ends every warp's reads of the ring before the rerun
    if (__syncthreads_or(!isfinite(sum))) mainloop_pass<T, BK, true>(p, kt0, nkt, stages, acc);
  }
}

// The block's accumulators out: row r of the block tile goes to output row
// row_index(r) (negative: masked). With `ws` the raw f32 sums go to slice
// blockIdx.z of the workspace [splits][rows][N]; without, the epilogue is
// applied and the result stored once in T.
template <typename T, int BK, class RowFn>
__device__ __forceinline__ void store_acc(
    const float (&acc)[Layout<T, BK>::MT][Layout<T, BK>::NT][4], RowFn row_index, int n0, int N,
    long long rows, const T* bias, const T* res, T* out, float* ws, int act) {
  using L = Layout<T, BK>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / L::WARPS_N) * L::WTM, wn0 = (warp % L::WARPS_N) * L::WTN;
  const int g = lane >> 2, t = lane & 3;
  float* slice = ws == nullptr ? nullptr : ws + (long long)blockIdx.z * rows * N;
#pragma unroll
  for (int i = 0; i < L::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __syncwarp();  // one row's loads and stores at a time: few registers live
      const long long r = row_index(wm0 + i * 16 + g + 8 * h);
      if (r < 0) continue;
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const int n = n0 + wn0 + j * 8 + 2 * t;  // even: a thread's two columns are a pair
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (N % 2 == 0 && n + 1 < N) {  // one 8-byte (f32) or 4-byte (bf16) store
          if (slice != nullptr)
            *reinterpret_cast<float2*>(slice + r * N + n) = make_float2(v0, v1);
          else
            store2(out + r * N + n, finish(v0, r, n, N, bias, res, act),
                   finish(v1, r, n + 1, N, bias, res, act));
          continue;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (n + c >= N) continue;
          const float v = c == 0 ? v0 : v1;
          if (slice != nullptr)
            slice[r * N + n + c] = v;
          else
            out[r * N + n + c] = from_f32<T>(finish(v, r, n + c, N, bias, res, act));
        }
      }
    }
  }
}

// The second pass of split-K: out = epilogue(sum of the slices, in slice order).
template <typename T>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, int splits, long long rows, int N,
                     const T* __restrict__ bias, const T* __restrict__ res, T* __restrict__ out,
                     int act) {
  const long long total = rows * N;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += ws[s * total + e];
    out[e] = from_f32<T>(finish(v, e / N, (int)(e % N), N, bias, res, act));
  }
}

template <typename T>
cudaError_t splitk_reduce(const float* ws, int splits, long long rows, int N, const T* bias,
                          const T* res, T* out, int act, cudaStream_t stream) {
  const long long total = rows * N;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  splitk_reduce_kernel<T><<<blocks, 256, 0, stream>>>(ws, splits, rows, N, bias, res, out, act);
  return cudaGetLastError();
}

// Let a kernel use more than 48 KB of dynamic shared memory (set on each
// launch: the attribute belongs to the current device).
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace com
