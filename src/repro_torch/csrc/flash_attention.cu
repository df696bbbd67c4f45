// flash_attention: online-softmax attention forward, GQA, causal (top-left)
// or not, for q (B, Sq, H, hd) and k, v (B, Skv, KVH, hd) in float32 or
// bfloat16, hd 32, 64 or 128; out (B, Sq, H, hd) in q's type and, when
// asked (training), each row's log-sum-exp (B, H, Sq) in float32. Its
// backward (dq, dk, dv from that lse) is the second half of this file.
//
// Replaces the Pallas TPU kernel repro.kernels.flash_attention.flash_attention
// (src/repro/kernels/flash_attention.py:64, pallas_call at :87, body :24-61)
// and its GQA wrapper flash_attention_gqa (:106). The TPU kernel walks the KV
// blocks as the innermost, sequential grid axis with (acc, m, l) in VMEM
// scratch, and its wrapper transposes to (B*H, S, hd) and repeats every KV
// head G = H/KVH times in device memory. Here a block owns one (b, h, 64-row
// q tile) and a loop inside it walks a range of 64-row KV tiles; q, k and v
// are read in their (B, S, heads, hd) layout, query head h reading KV head
// h / G in place, and ragged Sq and Skv are masked in the kernel.
//
// The arithmetic is the Pallas kernel's: scores, the running max m, the
// running sum l and the accumulator are f32; the softmax scale is applied to
// the f32 scores (the Pallas kernel scales f32 q first: the two differ by f32
// rounding, where scaling bf16 q would round it again); masked scores are
// NEG_INF = -1e30 (a key past Skv, which the Pallas kernel never has, is
// -inf); l is clamped at 1e-30; the result is rounded once to q's type.
//
// What bounds it on an H100: a causal prefill of S tokens does about
// 4*hd*H*S^2/2 flop on 2*es*(H + KVH)*S*hd bytes: operations, at 989 TFLOP/s
// in bf16. What the design does about it:
// * Both products run on the tensor cores, mma.sync (FA2's layout: each of
//   the 4 warps owns 16 q rows, the scores stay in registers and become the
//   A operand of PV without leaving them).
//   - bfloat16: m16n8k16 with ldmatrix fragments (.trans for V). P is split
//     into bf16 hi + mid + lo, all three against the same V fragment: a
//     single bf16 P errs by up to 2^-9 of sum|p v| on an output element
//     whose sum cancels, more than one bf16 rounding of the result; hi + lo
//     (~16 bits) pass that check but round the output otherwise than the
//     f32 plain version often enough that smollm-135m's 30 bf16 layers carry
//     it to prefill logits over 2e-2 of max from the plain attention's;
//     hi + mid + lo keep ~24 bits, f32's.
//   - float32: 3xTF32 on m16n8k8 with com_mma.cuh's saturating split. QK^T
//     is promoted every 64 of hd.
//   In both, each KV tile's PV runs on a fresh accumulator that is added to
//   the f32 acc after the alpha rescale: the tensor cores truncate what they
//   add into their accumulator, and an unpromoted sum drifts (com_mma.cuh).
// * K and V tiles come through a two-slot cp.async ring: tile t + 1 loads
//   while tile t computes; KV tiles wholly above the causal diagonal are
//   skipped.
// * Short prompts leave most SMs idle (B*H*ceil(S/64) blocks: 18 at
//   smollm's S = 128). The launch plan (kernels/flash_attention.py:plan)
//   splits the KV range of each q tile over `splits` blocks; each writes its
//   unnormalised f32 acc and its (m, l) to a workspace, and a second kernel
//   combines the splits in split order, so two calls give the same bits.
// * The G query heads of a KV head are not packed into one block: each block
//   reads its KV head's tiles, the G reads of a tile meet in L2, and the grid
//   stays G times larger for short prompts.
#include <cuda.h>
#include <math.h>

#include "com_mma.cuh"

namespace {

using namespace com;

constexpr int BQ = 64;        // q rows a block (16 a warp)
constexpr int BKV = 64;       // k/v rows a tile
constexpr int THREADS = 128;  // 4 warps
constexpr int STAGES = 2;     // K/V ring slots
constexpr float NEG_INF = -1e30f;

// Shared-memory geometry. Rows are padded so that a warp's fragment loads
// hit distinct banks: bf16 by 8 elements (ldmatrix rows 16 bytes apart in
// bank), f32 q and k by 8 (float2 loads of rows g, columns 2t), f32 v by 4
// (scalar loads down a column, rows 2t).
template <typename T, int HD>
struct FL {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int QS = HD + 8;                 // q and k row stride
  static constexpr int VS = HD + (F32 ? 4 : 8);     // v row stride
  static constexpr int Q_ELEMS = BQ * QS;
  static constexpr int K_ELEMS = BKV * QS;
  static constexpr int STAGE = K_ELEMS + BKV * VS;
  static constexpr int SMEM = (Q_ELEMS + STAGES * STAGE) * (int)sizeof(T);
  static constexpr int CE = 16 / sizeof(T);         // elements a 16-byte copy
  static_assert(SMEM <= SMEM_LIMIT, "the tiles exceed a block's shared memory");
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* ws_acc;   // [splits][B][H][Sq][HD] unnormalised acc (splits > 1)
  float2* ws_ml;   // [splits][B][H][Sq] (m, l)
  float* lse;      // [B][H][Sq] log-sum-exp of the scaled scores, or null
  int B, Sq, Skv, H, KVH, causal, splits;
  float scale;
};

// rows [r0, r0 + 64) of one head of a (B, S, heads, HD) tensor into a
// [64][ld] tile; rows past S are zero-filled
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* head0, long long row_stride,
                                          int r0, int S) {
  constexpr int CPR = HD / FL<T, HD>::CE;  // 16-byte copies a row
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR, e = (c % CPR) * FL<T, HD>::CE;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * ld + e, ok ? head0 + (long long)(r0 + r) * row_stride + e : head0, ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x, y) = hi + mid + lo, each a bf16 pair: ~24 bits of each value, as
// many as f32 keeps
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;  // exact
  __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = *reinterpret_cast<uint32_t*>(&h);
  mid = *reinterpret_cast<uint32_t*>(&m);
  lo = pack_bf16(rx - mf.x, ry - mf.y);
}

// ---- QK^T: s[j] (n8 tile j of the 64 keys) for the warp's 16 rows ----------

// bf16: q and k fragments by ldmatrix (q reloaded every tile: registers
// go to the accumulators)
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[8][4], const __nv_bfloat16* Qw,
                                        const __nv_bfloat16* Ks, int lane) {
  constexpr int QS = FL<__nv_bfloat16, HD>::QS;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t qf[4];
    ldsm_x4(qf, Qw + (lane & 15) * QS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t r[4];
      ldsm_x4(r, Ks + (8 * (j + (lane >> 4)) + (lane & 7)) * QS + kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[j], qf, r);
      mma_bf16(s[j + 1], qf, r + 2);
    }
  }
}

// f32: 3xTF32, q from shared memory, promoted every 64 of hd (a fresh MMA
// accumulator a chunk, added to s)
template <int HD>
__device__ __forceinline__ void qk_tile_f32(float (&s)[8][4], const float* Qw, const float* Ks,
                                            int lane) {
  constexpr int QS = FL<float, HD>::QS;
  constexpr int CHUNK = HD < 64 ? HD : 64;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int d0 = 0; d0 < HD; d0 += CHUNK) {
    float part[8][4];
#pragma unroll
    for (int kk = d0; kk < d0 + CHUNK; kk += 8) {
      // k slots t and t + 4 take d = kk + 2t and kk + 2t + 1 in both operands
      uint32_t a[4], as[4], b[8][2], bs[8][2];
      const float2 lo = *reinterpret_cast<const float2*>(Qw + g * QS + kk + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(Qw + (g + 8) * QS + kk + 2 * t);
      a[0] = tf32_big(lo.x), a[1] = tf32_big(hi.x), a[2] = tf32_big(lo.y), a[3] = tf32_big(hi.y);
      as[0] = tf32_small(lo.x, a[0]), as[1] = tf32_small(hi.x, a[1]);
      as[2] = tf32_small(lo.y, a[2]), as[3] = tf32_small(hi.y, a[3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(Ks + (8 * j + g) * QS + kk + 2 * t);
        b[j][0] = tf32_big(kv.x), b[j][1] = tf32_big(kv.y);
        bs[j][0] = tf32_small(kv.x, b[j][0]), bs[j][1] = tf32_small(kv.y, b[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (kk == d0)
          mma_tf32<true>(part[j], a, bs[j]);
        else
          mma_tf32(part[j], a, bs[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(part[j], as, b[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(part[j], a, b[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = d0 == 0 ? part[j][c] : s[j][c] + part[j][c];
  }
}

// ---- PV ------------------------------------------------------------------------

// bf16: pv = P V on a fresh accumulator, P split into hi + mid + lo (the
// smaller terms first). The d tiles go in groups of up to 8: a group's V
// fragments are loaded first, then each pass runs over the group, so that
// consecutive MMAs never wait on each other.
template <int HD>
__device__ __forceinline__ void pv_tile(float (&pv)[HD / 8][4], const float (&p)[8][4],
                                        const __nv_bfloat16* Vs, int lane) {
  constexpr int VS = FL<__nv_bfloat16, HD>::VS;
  constexpr int JG = HD / 8 < 8 ? HD / 8 : 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) pv[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    // the C fragments of score tiles 2kk, 2kk + 1 are the A fragment of k16 step kk
    uint32_t part[3][4];  // lo, mid, hi
    split_bf16(p[2 * kk][0], p[2 * kk][1], part[2][0], part[1][0], part[0][0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], part[2][1], part[1][1], part[0][1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], part[2][2], part[1][2], part[0][2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], part[2][3], part[1][3], part[0][3]);
#pragma unroll
    for (int j0 = 0; j0 < HD / 8; j0 += JG) {
      uint32_t v[JG][2];
#pragma unroll
      for (int j = 0; j < JG; j += 2)
        ldsm_x4_trans(&v[j][0], Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VS +
                                    8 * (j0 + j + (lane >> 4)));
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int j = 0; j < JG; ++j) mma_bf16(pv[j0 + j], part[pass], v[j]);
    }
  }
}

// f32: pv = P V by 3xTF32 on a fresh accumulator (k slots t, t + 4 take keys
// 2t, 2t + 1 of each k8 step, so the score C fragment is the A fragment as it
// stands); d tiles in groups of four, so that consecutive MMAs are independent
template <int HD>
__device__ __forceinline__ void pv_tile_f32(float (&pv)[HD / 8][4], const float (&p)[8][4],
                                            const float* Vs, int lane) {
  constexpr int VS = FL<float, HD>::VS;
  constexpr int JG = HD / 8 < 4 ? HD / 8 : 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BKV / 8; ++kk) {
    uint32_t a[4], as[4];
    const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a[c] = tf32_big(pa[c]);
      as[c] = tf32_small(pa[c], a[c]);
    }
    const float* v0 = Vs + (kk * 8 + 2 * t) * VS + g;
#pragma unroll
    for (int j0 = 0; j0 < HD / 8; j0 += JG) {
      uint32_t b[JG][2], bs[JG][2];
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        const float x0 = v0[8 * (j0 + j)], x1 = v0[VS + 8 * (j0 + j)];
        b[j][0] = tf32_big(x0), b[j][1] = tf32_big(x1);
        bs[j][0] = tf32_small(x0, b[j][0]), bs[j][1] = tf32_small(x1, b[j][1]);
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        if (kk == 0)
          mma_tf32<true>(pv[j0 + j], a, bs[j]);
        else
          mma_tf32(pv[j0 + j], a, bs[j]);
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) mma_tf32(pv[j0 + j], as, b[j]);
#pragma unroll
      for (int j = 0; j < JG; ++j) mma_tf32(pv[j0 + j], a, b[j]);
    }
  }
}

// ---- the kernel ----------------------------------------------------------------
// grid (q tiles, H, B * splits); the longest causal q tiles start first.
// Split s of a q tile with n KV tiles walks tiles [s * ceil(n / splits), ...).
// bf16 at hd <= 64 fits four blocks an SM within 128 registers a thread
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 2 && HD <= 64 ? 4 : 1)
flash_attention_kernel(const Args args) {
  using L = FL<T, HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + L::Q_ELEMS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Sq = args.Sq, Skv = args.Skv, H = args.H;
  const int split = blockIdx.z % args.splits, b = blockIdx.z / args.splits;
  const int qt = args.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, kvh = h / (H / args.KVH);
  const int q0 = qt * BQ;
  const long long q_row = (long long)H * HD, kv_row = (long long)args.KVH * HD;
  const T* qh = static_cast<const T*>(args.q) + (long long)b * Sq * q_row + (long long)h * HD;
  const T* kh = static_cast<const T*>(args.k) + (long long)b * Skv * kv_row + (long long)kvh * HD;
  const T* vh = static_cast<const T*>(args.v) + (long long)b * Skv * kv_row + (long long)kvh * HD;

  int n_tiles = (Skv + BKV - 1) / BKV;
  if (args.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);  // tiles that touch k <= q
  const int per = (n_tiles + args.splits - 1) / args.splits;
  const int t0 = min(n_tiles, split * per), t1 = min(n_tiles, t0 + per);

  // rows g and g + 8 of the warp's 16: running max, this thread's share of
  // the running sum (its 16 columns a tile; summed over the quad at the end)
  const int r_lo = q0 + warp * 16 + g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;

  if (t1 > t0) {
    load_tile<T, HD>(Qs, L::QS, qh, q_row, q0, Sq);
    load_tile<T, HD>(ring, L::QS, kh, kv_row, t0 * BKV, Skv);
    load_tile<T, HD>(ring + L::K_ELEMS, L::VS, vh, kv_row, t0 * BKV, Skv);
    cp_async_commit();
  }
  for (int it = t0; it < t1; ++it) {
    const int slot = (it - t0) & 1;
    cp_async_wait(0);  // tile it (and q) landed: this thread's copies
    __syncthreads();   // everyone's; everyone is done with tile it - 1's slot
    if (it + 1 < t1) {
      T* nxt = ring + (slot ^ 1) * L::STAGE;
      load_tile<T, HD>(nxt, L::QS, kh, kv_row, (it + 1) * BKV, Skv);
      load_tile<T, HD>(nxt + L::K_ELEMS, L::VS, vh, kv_row, (it + 1) * BKV, Skv);
    }
    cp_async_commit();
    const T* Ks = ring + slot * L::STAGE;
    const T* Vs = Ks + L::K_ELEMS;

    float s[8][4];
    if constexpr (L::F32)
      qk_tile_f32<HD>(s, Qs + warp * 16 * L::QS, Ks, lane);
    else
      qk_tile<HD>(s, Qs + warp * 16 * L::QS, Ks, lane);

    // scale, mask, online softmax (row g: c = 0, 1; row g + 8: c = 2, 3)
    const int k0 = it * BKV;
    const bool edge = k0 + BKV > Skv || (args.causal && k0 + BKV - 1 > q0 + warp * 16);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[j][c] * args.scale;
        if (edge) {
          const int col = k0 + 8 * j + 2 * t + (c & 1), row = r_lo + 8 * (c >> 1);
          if (col >= Skv)
            x = -INFINITY;
          else if (args.causal && col > row)
            x = NEG_INF;
        }
        s[j][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float pr = expf(s[j][c] - m[c >> 1]);
        s[j][c] = pr;
        l[c >> 1] += pr;
      }

    // acc = acc * alpha + P V, the tile's P V on a fresh MMA accumulator
    // (promoted: the tensor cores truncate what they add into it)
    float pv[HD / 8][4];
    if constexpr (L::F32)
      pv_tile_f32<HD>(pv, s, Vs, lane);
    else
      pv_tile<HD>(pv, s, Vs, lane);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] = o[j][c] * alpha[c >> 1] + pv[j][c];
  }
  cp_async_wait(0);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (args.splits == 1) {
    T* oh = static_cast<T*>(args.out) + (long long)b * Sq * q_row + (long long)h * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      if (row >= Sq) continue;
      const float lc = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        store2(oh + row * q_row + 8 * j + 2 * t, o[j][2 * r] / lc, o[j][2 * r + 1] / lc);
      // m is in the scaled-score domain already (x = s * scale, p = exp(x - m))
      if (args.lse != nullptr && t == 0)
        args.lse[((long long)b * H + h) * Sq + row] = fmaxf(m[r], NEG_INF) + logf(lc);
    }
    return;
  }
  // a split's partial: unnormalised acc and (m, l); a split with no tiles
  // writes m = -inf, l = 0, acc = 0, which the combine weighs by 0
  const long long base = ((long long)split * args.B + b) * H * Sq + (long long)h * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
    const bool empty = t1 <= t0;
    float* wa = args.ws_acc + (base + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(wa + 8 * j + 2 * t) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
    if (t == 0) args.ws_ml[base + row] = make_float2(empty ? -INFINITY : m[r], l[r]);
  }
}

// The second pass of a split launch: for each (row, d), the splits' partials
// in split order, each weighed by exp(m_s - max m).
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_combine_kernel(const float* __restrict__ ws_acc, const float2* __restrict__ ws_ml,
                     T* __restrict__ out, float* __restrict__ lse, int splits, int B, int H,
                     int Sq) {
  const long long rows = (long long)B * H * Sq;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * HD) return;
  const long long row = e / HD;  // (b * H + h) * Sq + q
  const int d = (int)(e % HD);
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ws_ml[s * rows + row].x);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 ml = ws_ml[s * rows + row];
    const float w = expf(ml.x - mx);
    l += w * ml.y;
    acc += w * ws_acc[(s * rows + row) * HD + d];
  }
  const int q = (int)(row % Sq);
  const long long bh = row / Sq;
  const int h = (int)(bh % H);
  const long long b = bh / H;
  out[((b * Sq + q) * H + h) * HD + d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0) lse[row] = fmaxf(mx, NEG_INF) + logf(fmaxf(l, 1e-30f));
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  using L = FL<T, HD>;
  cudaError_t err = allow_smem(flash_attention_kernel<T, HD>, L::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B * a.splits);
  flash_attention_kernel<T, HD><<<grid, THREADS, L::SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const long long total = (long long)a.B * a.H * a.Sq * HD;
  flash_combine_kernel<T, HD><<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      a.ws_acc, a.ws_ml, static_cast<T*>(a.out), a.lse, a.splits, a.B, a.H, a.Sq);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int hd, cudaStream_t stream) {
  if (hd == 32) return launch<T, 32>(a, stream);
  if (hd == 64) return launch<T, 64>(a, stream);
  if (hd == 128) return launch<T, 128>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hd: 32, 64 or 128. causal: 0 or 1.
// scale: 1/sqrt(hd) as float32. q, k, v and out are contiguous and 16-byte
// aligned. splits (kernels/flash_attention.py:plan): the KV range of each q
// tile is cut into that many blocks; with splits > 1, ws_acc holds
// splits*B*H*Sq*hd floats and ws_ml splits*B*H*Sq float pairs, and a second
// kernel combines them. lse: null (serving), or B*H*Sq floats that receive
// each row's log-sum-exp of the scaled scores, max(m, -1e30) + log(l), the
// backward's input; out is the same either way. Returns cudaGetLastError()
// after the launches (or the error that kept one from launching).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     void* ws_acc, void* ws_ml, void* lse, int B, int Sq,
                                     int Skv, int H, int KVH, int hd, int causal, float scale,
                                     int dtype, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0 || H > 65535 || splits < 1 ||
      (long long)B * splits > 65535 || (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, static_cast<float*>(ws_acc), static_cast<float2*>(ws_ml),
               static_cast<float*>(lse), B, Sq, Skv, H, KVH, causal, splits, scale};
  if (dtype == 0) return launch_hd<float>(a, hd, s);
  if (dtype == 1) return launch_hd<__nv_bfloat16>(a, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the backward ----------------------------------------------------------------
// dq, dk, dv of out = softmax(scale * q k^T) v from (q, k, v, out, lse, dout):
// the model's attention gradient, the custom_vjp backward _flash_vjp_bwd of
// src/repro/models/attention.py:159 (the Pallas forward has no backward). As
// there, the weights are recomputed from the saved lse, p = exp(scale * s -
// lse), and never stored:
//   delta = rowsum(dout * out), dv = p^T dout, ds = p * (dout v^T - delta),
//   dq = scale * ds k, dk = scale * ds^T q (summed over the G query heads of
//   each KV head).
// Three launches: delta (one warp a row, a kernel of its own), then
// * dK/dV: a block per (b, KV head, key tile) walks the G query heads of its
//   KV head and, for each, the 64-row q tiles that see its keys (causal: from
//   the diagonal down). s^T = k q^T and dp^T = v dout^T come out with the
//   keys as rows, so p^T and ds^T are the A operands of dv += p^T dout and
//   dk += ds^T q as they stand. dk and dv stay in registers (f32) over the
//   whole walk: GQA is summed inside the block, with no atomics, so two
//   calls give the same bits;
// * dQ: a block per (b, head, q tile) walks the 64-key tiles up to the
//   diagonal: s = q k^T, dp = dout v^T, dq += ds k.
//
// What bounds it on an H100: 5 products of 2 * hd flop per unmasked (q, k)
// pair and head (s, dp, dv, dk, dq), 2.5 times the forward's 2, against the
// bytes of q, k, v, out, dout, lse read and dq, dk, dv written once: the
// operations, at 989 TFLOP/s in bfloat16. Having no atomics costs s and dp
// formed twice, once in each kernel: 7 products where the bound counts 5. A
// fused kernel would add an f32 dq tile of atomics per (key tile, q tile)
// pair (about 0.6 GB of L2 traffic at the train shape) and need ordered
// semaphores to keep its bits.
//
// bfloat16, the train path (flash_bwd_*_wgmma_kernel): built for Hopper.
// * All five products on wgmma, bf16 in and f32 accumulated, one warpgroup
//   of 64 rows a block (two warpgroups of 64 rows sharing each walked tile
//   measured slower, PERF.md). s^T, dp^T (dK/dV) and s, dp (dQ) read both operands K-major
//   from shared memory; the accumulating products take p^T, ds^T or ds as A
//   from registers (an f32 accumulator's fragments are, for a 16-bit A, the
//   A fragments as they stand) and dout, q or k as an MN-major B (the
//   descriptor's transpose bit).
// * p and ds are rounded once to bf16 (dp - delta and the exp in f32):
//   7 MMA passes a pair, as the published FlashAttention backwards and
//   SDPA's round them. A split into three bf16 terms (hi + mid + lo, as the
//   forward's P) would give f32-grade p and ds at 4 + 3 x 3 = 13 passes,
//   which the backward's 2e-2 gate does not need.
// * The walked tiles (q, dout and the lse / delta rows for dK/dV; k, v for
//   dQ) come by TMA into a ring of WT<HD>::STAGES slots, completed on
//   mbarriers and started by one thread; the block's own tiles load once.
//   Tiles are 64 rows of 64-column panels with the 128-byte swizzle that
//   TMA writes and wgmma reads (hd 128: two panels), hd 32 one
//   64-byte-swizzled panel. The tensor maps are encoded on the host for
//   each call and passed as __grid_constant__ parameters. TMA zero-fills
//   rows past S; the masks on the ragged edge and the causal diagonal stay
//   in the kernel. A prep kernel writes delta and lse * log2(e) on rows
//   padded to 64, so that every 64-float box starts aligned.
// * The dK/dV walk issues step it + 1's s^T and dp^T right behind step
//   it's dv and dk products. ptxas serializes the walk's wgmma (C7515: p
//   and ds are written into the accumulators' registers while a group is
//   in flight), so the products do not overlap as issued; the walk still
//   measured 0.311 against 0.413 ms unpipelined (PERF.md). Why it is
//   faster was not checked. Writing p and ds to
//   registers of their own lifts the warning but costs 45 registers and
//   measured slower, as did the same order in dQ.
// * The accumulators hold dk, dv and dq over the whole walk, unpromoted:
//   an f32 sum every 8 steps changed no error (PERF.md).
// float32 keeps the mma.sync kernels below: 3xTF32 on [64][hd + 8]
// tiles through a two-slot cp.async ring, each tile's product promoted from a
// fresh accumulator (wgmma's tf32 wants a K-major B, which dv, dk and dq do
// not have): 7 products of three TF32 passes, 21 a pair.
namespace {

using namespace com;

// shared-memory geometry of the float32 backward: every tile [64][hd + 8];
// the dK/dV kernel holds its K and V tiles and two slots of (q, dout) tiles
// and of the (lse, delta) rows; the dQ kernel its q and dout tiles and two
// slots of (k, v) tiles
template <typename T, int HD>
struct BL {
  static constexpr int LD = HD + 8;
  static constexpr int TILE = 64 * LD;
  static constexpr int SMEM_DKDV = 6 * TILE * (int)sizeof(T) + 2 * 2 * 64 * (int)sizeof(float);
  static constexpr int SMEM_DQ = 6 * TILE * (int)sizeof(T);
  static_assert(SMEM_DKDV <= SMEM_LIMIT, "the tiles exceed a block's shared memory");
};

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B][H][Sq]
  const float* delta;  // [B][H][Sq]
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, H, KVH, causal;
  float scale;
};

// delta[b][h][q] = sum_d dout * out (f32), one warp a (b, q, h) row
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int B, int Sq, int H) {
  const long long rows = (long long)B * Sq * H;
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float acc = 0.f;
#pragma unroll
  for (int e = lane; e < HD; e += 32) acc += to_f32(out[row * HD + e]) * to_f32(dout[row * HD + e]);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bq = row / H;
    const int qi = (int)(bq % Sq);
    const long long b = bq / Sq;
    delta[(b * H + h) * Sq + qi] = acc;
  }
}

// s (16 x 64) = A (the warp's 16 rows) B^T (64 rows), both [rows][LD]
template <typename T, int HD>
__device__ __forceinline__ void bwd_qk(float (&s)[8][4], const T* Aw, const T* Bs, int lane) {
  static_assert(sizeof(T) == 4, "the bfloat16 backward runs on wgmma");
  qk_tile_f32<HD>(s, Aw, Bs, lane);
}

// acc (16 x HD) += P (16 x 64, C fragments) V (64 rows x HD, [rows][LD]),
// promoted as the forward's PV: for each group of d tiles, this tile's
// product runs on a fresh MMA accumulator and is then added to acc in f32
// (the tensor cores truncate what they add into their accumulator, and the
// dK/dV walk adds up to G * Sq / 64 tiles). The A fragments are formed again
// for every group, so that a group's temporary is all the registers it costs.
// By 3xTF32, as the forward's pv_tile_f32 (k slots t, t + 4 take rows 2t,
// 2t + 1 of each k8 step)
template <int HD, int LD>
__device__ __forceinline__ void pv_acc(float (&acc)[HD / 8][4], const float (&p)[8][4],
                                       const float* Vs, int lane) {
  constexpr int JG = HD / 8 < 4 ? HD / 8 : 4;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j0 = 0; j0 < HD / 8; j0 += JG) {
    float t[JG][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t a[4], as[4];
      const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a[c] = tf32_big(pa[c]);
        as[c] = tf32_small(pa[c], a[c]);
      }
      const float* v0 = Vs + (kk * 8 + 2 * t4) * LD + g;
      uint32_t b[JG][2], bs[JG][2];
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        const float x0 = v0[8 * (j0 + j)], x1 = v0[LD + 8 * (j0 + j)];
        b[j][0] = tf32_big(x0), b[j][1] = tf32_big(x1);
        bs[j][0] = tf32_small(x0, b[j][0]), bs[j][1] = tf32_small(x1, b[j][1]);
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        if (kk == 0)
          mma_tf32<true>(t[j], a, bs[j]);
        else
          mma_tf32(t[j], a, bs[j]);
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) mma_tf32(t[j], as, b[j]);
#pragma unroll
      for (int j = 0; j < JG; ++j) mma_tf32(t[j], a, b[j]);
    }
#pragma unroll
    for (int j = 0; j < JG; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j0 + j][c] += t[j][c];
  }
}

template <typename T, int HD>
__device__ __forceinline__ void bwd_pv(float (&acc)[HD / 8][4], const float (&p)[8][4],
                                       const T* Vs, int lane) {
  pv_acc<HD, BL<T, HD>::LD>(acc, p, Vs, lane);
}

// 64 f32 values from row r0 of a [rows] vector into dst, zero past `n`
__device__ __forceinline__ void load_row64(float* dst, const float* src, int r0, int n, int c) {
  const bool ok = r0 + c < n;
  cp_async4(dst + c, ok ? src + r0 + c : src, ok);
}

// grid (KV tiles, KVH, B): the first key tiles (the longest causal walks) start first
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const BwdArgs a) {
  using L = BL<T, HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + L::TILE;
  T* ring = Vs + L::TILE;                                   // [2][q tile, dout tile]
  float* stats = reinterpret_cast<float*>(ring + 4 * L::TILE);  // [2][lse 64, delta 64]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, G = a.H / a.KVH;
  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BKV;
  const long long q_row = (long long)H * HD, kv_row = (long long)a.KVH * HD;
  const T* kh = static_cast<const T*>(a.k) + (long long)b * Skv * kv_row + (long long)kvh * HD;
  const T* vh = static_cast<const T*>(a.v) + (long long)b * Skv * kv_row + (long long)kvh * HD;
  const T* qb = static_cast<const T*>(a.q) + (long long)b * Sq * q_row;
  const T* ob = static_cast<const T*>(a.dout) + (long long)b * Sq * q_row;
  const int nq = (Sq + BQ - 1) / BQ;
  // causal (top-left): q tile i has a row >= k0 from i = kt on
  const int i0 = a.causal ? min(nq, kt) : 0;
  const int per_head = nq - i0, n_it = G * per_head;

  auto load_stage = [&](int it, int slot) {
    const int h = kvh * G + it / per_head, q0 = (i0 + it % per_head) * BQ;
    T* Qs = ring + slot * 2 * L::TILE;
    load_tile<T, HD>(Qs, LD, qb + (long long)h * HD, q_row, q0, Sq);
    load_tile<T, HD>(Qs + L::TILE, LD, ob + (long long)h * HD, q_row, q0, Sq);
    const long long row0 = ((long long)b * H + h) * Sq;
    const int c = threadIdx.x;  // 128 threads: 64 lse and 64 delta values
    if (c < 64)
      load_row64(stats + slot * 128, a.lse + row0, q0, Sq, c);
    else
      load_row64(stats + slot * 128 + 64, a.delta + row0, q0, Sq, c - 64);
  };

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;

  if (n_it > 0) {
    load_tile<T, HD>(Ks, LD, kh, kv_row, k0, Skv);
    load_tile<T, HD>(Vs, LD, vh, kv_row, k0, Skv);
    load_stage(0, 0);
    cp_async_commit();
  }
  const int key_lo = k0 + warp * 16 + g;  // this thread's rows: key_lo, key_lo + 8
  for (int it = 0; it < n_it; ++it) {
    const int slot = it & 1;
    cp_async_wait(0);  // this thread's copies of stage it landed
    __syncthreads();   // everyone's; everyone is done with stage it - 1's slot
    if (it + 1 < n_it) load_stage(it + 1, slot ^ 1);
    cp_async_commit();
    const T* Qs = ring + slot * 2 * L::TILE;
    const T* dOs = Qs + L::TILE;
    const float* lse_s = stats + slot * 128;
    const float* del_s = lse_s + 64;
    const int q0 = (i0 + it % per_head) * BQ;

    // p^T = exp(scale * k q^T - lse): rows keys, columns q
    float s[8][4];
    bwd_qk<T, HD>(s, Ks + warp * 16 * LD, Qs, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1), qq = q0 + col, key = key_lo + 8 * (c >> 1);
        const bool keep = qq < Sq && key < Skv && !(a.causal && key > qq);
        s[j][c] = keep ? expf(s[j][c] * a.scale - lse_s[col]) : 0.f;
      }
    bwd_pv<T, HD>(dv, s, dOs, lane);  // dv += p^T dout

    // ds^T = p^T * (v dout^T - delta)
    float dp[8][4];
    bwd_qk<T, HD>(dp, Vs + warp * 16 * LD, dOs, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[j][c] = s[j][c] * (dp[j][c] - del_s[8 * j + 2 * t + (c & 1)]);
    bwd_pv<T, HD>(dk, dp, Qs, lane);  // dk += ds^T q
  }
  cp_async_wait(0);

  T* dkh = static_cast<T*>(a.dk) + (long long)b * Skv * kv_row + (long long)kvh * HD;
  T* dvh = static_cast<T*>(a.dv) + (long long)b * Skv * kv_row + (long long)kvh * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      store2(dkh + key * kv_row + 8 * j + 2 * t, dk[j][2 * r] * a.scale,
             dk[j][2 * r + 1] * a.scale);
      store2(dvh + key * kv_row + 8 * j + 2 * t, dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// grid (q tiles, H, B): the longest causal q tiles start first
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const BwdArgs a) {
  using L = BL<T, HD>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + L::TILE;
  T* ring = dOs + L::TILE;  // [2][k tile, v tile]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H;
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / a.KVH);
  const int q0 = qt * BQ;
  const long long q_row = (long long)H * HD, kv_row = (long long)a.KVH * HD;
  const T* qh = static_cast<const T*>(a.q) + (long long)b * Sq * q_row + (long long)h * HD;
  const T* oh = static_cast<const T*>(a.dout) + (long long)b * Sq * q_row + (long long)h * HD;
  const T* kh = static_cast<const T*>(a.k) + (long long)b * Skv * kv_row + (long long)kvh * HD;
  const T* vh = static_cast<const T*>(a.v) + (long long)b * Skv * kv_row + (long long)kvh * HD;

  int n_tiles = (Skv + BKV - 1) / BKV;
  if (a.causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);

  // rows r_lo and r_lo + 8 of the warp's 16
  const int r_lo = q0 + warp * 16 + g;
  const long long row0 = ((long long)b * H + h) * Sq;
  float lse[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    lse[r] = row < Sq ? a.lse[row0 + row] : 0.f;
    del[r] = row < Sq ? a.delta[row0 + row] : 0.f;
  }
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;

  load_tile<T, HD>(Qs, LD, qh, q_row, q0, Sq);
  load_tile<T, HD>(dOs, LD, oh, q_row, q0, Sq);
  if (n_tiles > 0) {
    load_tile<T, HD>(ring, LD, kh, kv_row, 0, Skv);
    load_tile<T, HD>(ring + L::TILE, LD, vh, kv_row, 0, Skv);
  }
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it & 1;
    cp_async_wait(0);
    __syncthreads();
    if (it + 1 < n_tiles) {
      T* nxt = ring + (slot ^ 1) * 2 * L::TILE;
      load_tile<T, HD>(nxt, LD, kh, kv_row, (it + 1) * BKV, Skv);
      load_tile<T, HD>(nxt + L::TILE, LD, vh, kv_row, (it + 1) * BKV, Skv);
    }
    cp_async_commit();
    const T* Ks = ring + slot * 2 * L::TILE;
    const T* Vt = Ks + L::TILE;
    const int k0 = it * BKV;

    // p = exp(scale * q k^T - lse): rows q, columns keys
    float s[8][4];
    bwd_qk<T, HD>(s, Qs + warp * 16 * LD, Ks, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * j + 2 * t + (c & 1), row = r_lo + 8 * (c >> 1);
        const bool keep = row < Sq && key < Skv && !(a.causal && key > row);
        s[j][c] = keep ? expf(s[j][c] * a.scale - lse[c >> 1]) : 0.f;
      }
    // ds = p * (dout v^T - delta); dq += ds k
    float dp[8][4];
    bwd_qk<T, HD>(dp, dOs + warp * 16 * LD, Vt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[j][c] = s[j][c] * (dp[j][c] - del[c >> 1]);
    bwd_pv<T, HD>(dq, dp, Ks, lane);
  }
  cp_async_wait(0);

  T* dqh = static_cast<T*>(a.dq) + (long long)b * Sq * q_row + (long long)h * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(dqh + row * q_row + 8 * j + 2 * t, dq[j][2 * r] * a.scale,
             dq[j][2 * r + 1] * a.scale);
  }
}

template <typename T, int HD>
int launch_bwd(const BwdArgs& a, const void* out, float* delta, cudaStream_t stream) {
  using L = BL<T, HD>;
  const long long rows = (long long)a.B * a.Sq * a.H;
  flash_bwd_delta_kernel<T, HD><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(a.dout), delta, a.B, a.Sq, a.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_bwd_dkdv_kernel<T, HD>, L::SMEM_DKDV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((a.Skv + BKV - 1) / BKV, a.KVH, a.B);
  flash_bwd_dkdv_kernel<T, HD><<<grid_kv, THREADS, L::SMEM_DKDV, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_bwd_dq_kernel<T, HD>, L::SMEM_DQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, HD><<<grid_q, THREADS, L::SMEM_DQ, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_hd(const BwdArgs& a, const void* out, float* delta, int hd, cudaStream_t stream) {
  if (hd == 32) return launch_bwd<T, 32>(a, out, delta, stream);
  if (hd == 64) return launch_bwd<T, 64>(a, out, delta, stream);
  if (hd == 128) return launch_bwd<T, 128>(a, out, delta, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the bfloat16 backward: wgmma and TMA ------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// One 64-row bf16 tile of head dim HD in shared memory, as TMA writes it and
// wgmma reads it: 64-column panels (hd 128: two) of 64 rows x 128 bytes in
// the 128-byte swizzle; hd 32 one panel of 64 rows x 64 bytes in the 64-byte
// swizzle. Every panel starts on a 1024-byte boundary.
template <int HD>
struct WT {
  static constexpr int PANEL_COLS = HD < 64 ? HD : 64;
  static constexpr int PANELS = HD / PANEL_COLS;
  static constexpr int ROW_BYTES = 2 * PANEL_COLS;
  static constexpr int PANEL_BYTES = 64 * ROW_BYTES;
  static constexpr int BYTES = PANELS * PANEL_BYTES;
  static constexpr uint64_t LAYOUT = HD < 64 ? 2 : 1;  // descriptor swizzle: 64 or 128 bytes
  static constexpr int STAGES = HD <= 64 ? 3 : 2;      // ring slots
};

// Shared memory of the bf16 blocks, byte offsets from a 1024-aligned base:
// * dK/dV: the block's K tiles, its V tiles, the ring of (q, dout) tile
//   pairs, the ring's (lse2, delta) rows (64 floats each), the mbarriers;
// * dQ: the block's q tiles, its dout tiles, the ring of (k, v) tile pairs,
//   the mbarriers.
// Mbarrier 0 completes the block's own tiles, mbarrier 1 + s ring slot s.
// SMEM_* add the 1024 bytes that aligning the base may skip.
template <int HD>
struct BwdSmem {
  using L = WT<HD>;
  static constexpr int STAGES = L::STAGES;
  static constexpr int RING = 2 * L::BYTES;
  static constexpr int STATS = RING + STAGES * 2 * L::BYTES;
  static constexpr int BARS_DKDV = STATS + STAGES * 512;
  static constexpr int BARS_DQ = STATS;
  static constexpr int SMEM_DKDV = BARS_DKDV + 8 * (1 + STAGES) + 1024;
  static constexpr int SMEM_DQ = BARS_DQ + 8 * (1 + STAGES) + 1024;
  static_assert(SMEM_DKDV <= SMEM_LIMIT, "the tiles exceed a block's shared memory");
};

// The tensor maps of one call: q, dout (B, Sq, H, hd) and k, v (B, Skv, KVH,
// hd) in boxes of one panel x 64 rows of one head; the prep kernel's lse2
// and delta rows (B * H, SqP) in boxes of 64.
struct BwdMaps {
  CUtensorMap q, dout, k, v, lse2, delta;
};

// The bf16 walk's row statistics, one warp a (b, q, h) row of the padded
// length SqP = 64 * ceil(Sq / 64): delta = sum_d dout * out and lse2 = lse *
// log2(e) (the exp is taken as exp2), both [B][H][SqP] in ws, delta first;
// rows past Sq are 0. TMA reads them in boxes of 64 from row starts that are
// 256-byte aligned (a box must start 16-byte aligned in device memory, which
// rows of Sq floats are not for every Sq).
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ out,
                      const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                      float* __restrict__ ws, int B, int Sq, int SqP, int H) {
  const long long rows = (long long)B * SqP * H;
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int h = (int)(row % H);
  const long long bq = row / H;
  const int qi = (int)(bq % SqP);
  const long long b = bq / SqP;
  float acc = 0.f;
  if (qi < Sq) {
    const long long src = ((b * Sq + qi) * H + h) * HD;
#pragma unroll
    for (int e = lane; e < HD; e += 32) acc += to_f32(out[src + e]) * to_f32(dout[src + e]);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    const long long dst = (b * H + h) * SqP + qi;
    ws[dst] = acc;
    ws[rows + dst] = qi < Sq ? lse[(b * H + h) * Sq + qi] * LOG2E : 0.f;
  }
}

// ---- PTX: mbarriers, TMA, wgmma -----------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// this thread's arrival, and `bytes` more to come by TMA, on `bar`
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `phase` of `bar` to complete. A phase that
// never completes (a byte count that TMA does not deliver) traps after
// ~2^24 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
    if (done) return;
    if (n == (1u << 24)) __trap();
  }
}

// A 64-row tile of head `head` from row `row` of batch row `b` of a (B, S,
// heads, HD) tensor, panel by panel, completing on `bar`; rows past S read
// as zeros
template <int HD>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, int head, int row,
                                         int b, uint32_t bar) {
#pragma unroll
  for (int p = 0; p < WT<HD>::PANELS; ++p)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst + p * WT<HD>::PANEL_BYTES),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(p * WT<HD>::PANEL_COLS), "r"(head),
        "r"(row), "r"(b)
        : "memory");
}
// 64 floats from column x of row y of a (rows, SqP) map (lse2, delta)
__device__ __forceinline__ void tma_row64(uint32_t dst, const CUtensorMap* map, int x, int y,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | layout << 62;
}
// K-major operand: the tile's rows are M (or N), its head dim K; k16 step kk
// starts 32 bytes further into its panel's rows (the swizzle acts on the
// address), 8-row groups 8 rows apart
template <int HD>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  using L = WT<HD>;
  const int k = 16 * kk;
  return wg_desc(tile + (k / L::PANEL_COLS) * L::PANEL_BYTES + (k % L::PANEL_COLS) * 2, 16,
                 8 * L::ROW_BYTES, L::LAYOUT);
}
// MN-major operand (B of the accumulating products, transposed): the tile's
// rows are K (16 a step), its head dim N; panels one swizzle atom apart
// along N (LBO), 8-row groups along K (SBO)
template <int HD>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  using L = WT<HD>;
  return wg_desc(tile + 16 * kk * L::ROW_BYTES, L::PANEL_BYTES, 8 * L::ROW_BYTES, L::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the compiler may neither read an accumulator before its wait nor move it
// across one
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define WG_D16(i) WG_D4(i), WG_D4((i) + 4), WG_D4((i) + 8), WG_D4((i) + 12)
#define WG_D32(i) WG_D16(i), WG_D16((i) + 16)
#define WG_D64(i) WG_D32(i), WG_D32((i) + 32)

// d (64 x 64, f32) = A B^T (acc = 0) or d + A B^T, both operands K-major in
// shared memory. d's layout: warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8 (g = lane / 4); d[4 j + c] is column 8 j + 2 (lane % 4) +
// (c & 1) of row 16 w + g + 8 (c >> 1).
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N, f32) += A B: A (64 x 16, bf16) from registers, B MN-major in
// shared memory (the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 128, "wgmma_rs: N is a head dim, 32, 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// The A operand (k16 steps kk = 0..3) of a product from a 64 x 64 f32
// accumulator, each value rounded once to bf16: for a 16-bit A, step kk's
// fragment is the accumulator's column tiles 2 kk and 2 kk + 1 as they stand
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// s = A1 B1^T and dp = A2 B2^T (64 x 64 each, K-major tiles of head dim HD),
// two commit groups, s first
template <int HD>
__device__ __forceinline__ void s_dp_products(float (&s)[32], float (&dp)[32], uint32_t a1,
                                              uint32_t b1, uint32_t a2, uint32_t b2) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss64(s, kmajor<HD>(a1, kk), kmajor<HD>(b1, kk), kk);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss64(dp, kmajor<HD>(a2, kk), kmajor<HD>(b2, kk), kk);
  wgmma_commit();
}

// The shared-window address of the dynamic shared memory rounded up to 1024
// bytes (the swizzled panels' alignment)
__device__ __forceinline__ uint32_t smem_base(const unsigned char* raw) {
  return (smem_u32(raw) + 1023) & ~1023u;
}

// grid (key blocks, KVH, B): the first key blocks (the longest causal walks) start first
template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using L = WT<HD>;
  using M = BwdSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const float* stats =
      reinterpret_cast<const float*>(smem_raw + (base - smem_u32(smem_raw)) + M::STATS);
  const uint32_t bars = base + M::BARS_DKDV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H, G = a.H / a.KVH;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * 64;
  const int nq = (Sq + 63) / 64;
  // causal (top-left): q tile i has a row >= k0 from i = k0 / 64 on
  const int i0 = a.causal ? min(nq, k0 / 64) : 0;
  const int per_head = nq - i0, n_it = G * per_head;

  // thread 0: the q and dout tiles and the lse and delta rows of step it
  auto load_step = [&](int it, int slot) {
    const int h = kvh * G + it / per_head, q0 = (i0 + it % per_head) * 64;
    const uint32_t bar = bars + 8 * (1 + slot), dst = base + M::RING + slot * 2 * L::BYTES;
    mbar_expect(bar, 2 * L::BYTES + 512);
    tma_tile<HD>(dst, &maps.q, h, q0, b, bar);
    tma_tile<HD>(dst + L::BYTES, &maps.dout, h, q0, b, bar);
    tma_row64(base + M::STATS + slot * 512, &maps.lse2, q0, b * H + h, bar);
    tma_row64(base + M::STATS + slot * 512 + 256, &maps.delta, q0, b * H + h, bar);
  };
  if (tid == 0) {
    for (int i = 0; i <= M::STAGES; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_it > 0) {
    mbar_expect(bars, 2 * L::BYTES);
    tma_tile<HD>(base, &maps.k, kvh, k0, b, bars);
    tma_tile<HD>(base + L::BYTES, &maps.v, kvh, k0, b, bars);
    for (int i = 0; i < M::STAGES && i < n_it; ++i) load_step(i, i);
  }

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t Kt = base, Vt = base + L::BYTES;
  const int key_lo = k0 + 16 * warp + g;  // this thread's keys: key_lo, key_lo + 8
  const float sl2 = a.scale * LOG2E;
  // s^T = k q^T and dp^T = v dout^T (rows keys, columns q) of step it, started
  // at the end of step it - 1, behind its dv and dk products
  float s[32], dp[32];
  auto ring = [&](int it) { return base + M::RING + (it % M::STAGES) * 2 * L::BYTES; };
  auto s_dp = [&](int it) {
    mbar_wait(bars + 8 * (1 + it % M::STAGES), (it / M::STAGES) & 1);
    s_dp_products<HD>(s, dp, Kt, ring(it), Vt, ring(it) + L::BYTES);
  };
  if (n_it > 0) {
    mbar_wait(bars, 0);
    s_dp(0);
  }
  for (int it = 0; it < n_it; ++it) {
    const int slot = it % M::STAGES;
    const uint32_t Qt = ring(it), dOt = Qt + L::BYTES;
    const float* l2_s = stats + slot * 128;
    const float* del_s = l2_s + 64;
    const int q0 = (i0 + it % per_head) * 64;
    wgmma_wait<1>();  // s^T
    keep(s);

    // p^T = exp(scale s^T - lse), 0 where masked; dv += p^T dout
    const bool edge = q0 + 64 > Sq || k0 + 64 > Skv || (a.causal && k0 + 63 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(l2_s + 8 * j + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = exp2f(s[4 * j + c] * sl2 - ((c & 1) ? l.y : l.x));
        if (edge) {
          const int qq = q0 + 8 * j + 2 * t + (c & 1), key = key_lo + 8 * (c >> 1);
          if (qq >= Sq || key >= Skv || (a.causal && key > qq)) p = 0.f;
        }
        s[4 * j + c] = p;
      }
    }
    uint32_t pa[4][4];
    to_a(pa, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dv, pa[kk], mnmajor<HD>(dOt, kk));
    wgmma_commit();

    // ds^T = p^T * (dp^T - delta); dk += ds^T q
    wgmma_wait<1>();
    keep(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(del_s + 8 * j + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dp[4 * j + c] = s[4 * j + c] * (dp[4 * j + c] - ((c & 1) ? d.y : d.x));
    }
    uint32_t da[4][4];
    to_a(da, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dk, da[kk], mnmajor<HD>(Qt, kk));
    wgmma_commit();
    if (it + 1 < n_it) {
      s_dp(it + 1);
      wgmma_wait<2>();  // this step's dv and dk products, not the next step's s^T, dp^T
    } else {
      wgmma_wait<0>();
    }
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && it + M::STAGES < n_it) load_step(it + M::STAGES, slot);
  }
  keep(dv);
  keep(dk);

  const long long kv_row = (long long)a.KVH * HD;
  __nv_bfloat16* dkh =
      static_cast<__nv_bfloat16*>(a.dk) + (long long)b * Skv * kv_row + (long long)kvh * HD;
  __nv_bfloat16* dvh =
      static_cast<__nv_bfloat16*>(a.dv) + (long long)b * Skv * kv_row + (long long)kvh * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_lo + 8 * r;
    if (key >= Skv) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      store2(dkh + key * kv_row + 8 * j + 2 * t, dk[4 * j + 2 * r] * a.scale,
             dk[4 * j + 2 * r + 1] * a.scale);
      store2(dvh + key * kv_row + 8 * j + 2 * t, dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// grid (q blocks, H, B): the longest causal q blocks start first
template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ BwdMaps maps, const BwdArgs a) {
  using L = WT<HD>;
  using M = BwdSmem<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t bars = base + M::BARS_DQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int Sq = a.Sq, Skv = a.Skv, H = a.H;
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / a.KVH);
  const int q0 = qt * 64;
  int n_tiles = (Skv + 63) / 64;
  if (a.causal) n_tiles = min(n_tiles, qt + 1);

  // thread 0: the k and v tiles of step it
  auto load_step = [&](int it, int slot) {
    const uint32_t bar = bars + 8 * (1 + slot), dst = base + M::RING + slot * 2 * L::BYTES;
    mbar_expect(bar, 2 * L::BYTES);
    tma_tile<HD>(dst, &maps.k, kvh, 64 * it, b, bar);
    tma_tile<HD>(dst + L::BYTES, &maps.v, kvh, 64 * it, b, bar);
  };
  if (tid == 0) {
    for (int i = 0; i <= M::STAGES; ++i) mbar_init(bars + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect(bars, 2 * L::BYTES);
    tma_tile<HD>(base, &maps.q, h, q0, b, bars);
    tma_tile<HD>(base + L::BYTES, &maps.dout, h, q0, b, bars);
    for (int i = 0; i < M::STAGES && i < n_tiles; ++i) load_step(i, i);
  }

  const int r_lo = q0 + 16 * warp + g;  // this thread's rows: r_lo, r_lo + 8
  // the prep kernel's rows, zero past Sq: delta, then lse2 at rows further
  const int SqP = (Sq + 63) / 64 * 64;
  const long long rows = (long long)a.B * H * SqP, row0 = ((long long)b * H + h) * SqP;
  float l2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    del[r] = row < Sq ? a.delta[row0 + row] : 0.f;
    l2[r] = row < Sq ? a.delta[rows + row0 + row] : 0.f;
  }
  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  const uint32_t Qt = base, dOt = base + L::BYTES;
  const float sl2 = a.scale * LOG2E;
  mbar_wait(bars, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it % M::STAGES;
    mbar_wait(bars + 8 * (1 + slot), (it / M::STAGES) & 1);
    const uint32_t Kt = base + M::RING + slot * 2 * L::BYTES, Vt = Kt + L::BYTES;
    const int k0 = 64 * it;

    // s = q k^T and dp = dout v^T: rows q, columns keys
    float s[32], dp[32];
    s_dp_products<HD>(s, dp, Qt, Kt, dOt, Vt);
    wgmma_wait<1>();
    keep(s);

    // p = exp(scale s - lse), 0 where masked
    const bool edge = k0 + 64 > Skv || q0 + 64 > Sq || (a.causal && k0 + 63 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = exp2f(s[4 * j + c] * sl2 - l2[c >> 1]);
        if (edge) {
          const int key = k0 + 8 * j + 2 * t + (c & 1), row = r_lo + 8 * (c >> 1);
          if (row >= Sq || key >= Skv || (a.causal && key > row)) p = 0.f;
        }
        s[4 * j + c] = p;
      }

    // ds = p * (dp - delta); dq += ds k
    wgmma_wait<0>();
    keep(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[4 * j + c] = s[4 * j + c] * (dp[4 * j + c] - del[c >> 1]);
    uint32_t da[4][4];
    to_a(da, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<HD>(dq, da[kk], mnmajor<HD>(Kt, kk));
    wgmma_commit();
    wgmma_wait<0>();
    keep(dq);
    __syncthreads();  // every warp is done with the slot
    if (tid == 0 && it + M::STAGES < n_tiles) load_step(it + M::STAGES, slot);
  }

  const long long q_row = (long long)H * HD;
  __nv_bfloat16* dqh =
      static_cast<__nv_bfloat16*>(a.dq) + (long long)b * Sq * q_row + (long long)h * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      store2(dqh + row * q_row + 8 * j + 2 * t, dq[4 * j + 2 * r] * a.scale,
             dq[4 * j + 2 * r + 1] * a.scale);
  }
}

// ---- the host side of the bf16 launch: tensor maps --------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (so the
// library needs no -lcuda); null where it is missing
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, S, heads, HD) bf16 tensor in boxes of one panel x 1 head x 64 rows x
// 1 batch row, swizzled as WT<HD> lays a panel out
template <int HD>
bool map_rows(CUtensorMap* m, const void* base, int B, int S, int heads) {
  const cuuint64_t dims[4] = {HD, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * HD, 2ull * HD * heads, 2ull * HD * heads * S};
  const cuuint32_t box[4] = {WT<HD>::PANEL_COLS, 1, 64, 1}, step[4] = {1, 1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        HD < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (rows, SqP) floats in boxes of 64 of one row
bool map_stats(CUtensorMap* m, const void* base, long long rows, int SqP) {
  const cuuint64_t dims[2] = {(cuuint64_t)SqP, (cuuint64_t)rows}, strides[1] = {4ull * SqP};
  const cuuint32_t box[2] = {64, 1}, step[2] = {1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ws: the prep kernel's 2 * B * H * SqP floats (delta, then lse2)
template <int HD>
int launch_bwd_wgmma(BwdArgs a, const void* out, float* ws, cudaStream_t stream) {
  using M = BwdSmem<HD>;
  const int SqP = (a.Sq + 63) / 64 * 64;
  const long long rows = (long long)a.B * a.H * SqP;
  if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
  a.delta = ws;
  BwdMaps m;
  if (!map_rows<HD>(&m.q, a.q, a.B, a.Sq, a.H) || !map_rows<HD>(&m.dout, a.dout, a.B, a.Sq, a.H) ||
      !map_rows<HD>(&m.k, a.k, a.B, a.Skv, a.KVH) || !map_rows<HD>(&m.v, a.v, a.B, a.Skv, a.KVH) ||
      !map_stats(&m.delta, ws, (long long)a.B * a.H, SqP) ||
      !map_stats(&m.lse2, ws + rows, (long long)a.B * a.H, SqP))
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_prep_kernel<HD><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(a.dout), a.lse, ws,
      a.B, a.Sq, SqP, a.H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_bwd_dkdv_wgmma_kernel<HD>, M::SMEM_DKDV);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((a.Skv + 63) / 64, a.KVH, a.B);
  flash_bwd_dkdv_wgmma_kernel<HD><<<grid_kv, 128, M::SMEM_DKDV, stream>>>(m, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(flash_bwd_dq_wgmma_kernel<HD>, M::SMEM_DQ);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((a.Sq + 63) / 64, a.H, a.B);
  flash_bwd_dq_wgmma_kernel<HD><<<grid_q, 128, M::SMEM_DQ, stream>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_wgmma_hd(const BwdArgs& a, const void* out, float* delta, int hd,
                        cudaStream_t stream) {
  if (hd == 32) return launch_bwd_wgmma<32>(a, out, delta, stream);
  if (hd == 64) return launch_bwd_wgmma<64>(a, out, delta, stream);
  if (hd == 128) return launch_bwd_wgmma<128>(a, out, delta, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The backward of repro_flash_attention. q, out, dout, dq: (B, Sq, H, hd);
// k, v, dk, dv: (B, Skv, KVH, hd), all of one dtype (0 = float32, 1 =
// bfloat16), contiguous and 16-byte aligned; lse: the forward's (B, H, Sq)
// floats; delta: workspace (written here first) of B*H*Sq floats for
// float32, 2*B*H*SqP floats for bfloat16 (SqP = 64 * ceil(Sq / 64): delta
// and lse * log2(e), rows padded). hd, causal and scale as in the forward.
// Returns cudaGetLastError() after the three launches (or the error that
// kept one from launching).
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int B,
                                         int Sq, int Skv, int H, int KVH, int hd, int causal,
                                         float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KVH <= 0 || H % KVH != 0 || H > 65535 || B > 65535 ||
      lse == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  dq, dk, dv, B, Sq, Skv, H, KVH, causal, scale};
  float* d = static_cast<float*>(delta);
  if (dtype == 0) return launch_bwd_hd<float>(a, out, d, hd, s);
  if (dtype == 1) return launch_bwd_wgmma_hd(a, out, d, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
