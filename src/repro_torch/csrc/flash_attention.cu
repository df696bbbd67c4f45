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
// * dK/dV: a block per (b, KV head, 64-key tile) walks the G query heads of
//   its KV head and, for each, the q tiles that see its keys (causal: from
//   the diagonal down), with (q, dout, lse, delta) tiles through a two-slot
//   cp.async ring. Each warp owns 16 keys: s^T = k q^T and dp^T = v dout^T
//   come out with the keys as rows, so p^T and ds^T are A fragments as they
//   stand for dv += p^T dout and dk += ds^T q (the forward's QK^T and PV
//   tiles). dk and dv stay in registers (f32) over the whole walk, each
//   tile's product promoted into them from a fresh MMA accumulator: GQA is
//   summed inside the block, with no atomics, so two calls give the same
//   bits;
// * dQ: a block per (b, head, 64-row q tile) walks the key tiles up to the
//   diagonal: s = q k^T, dp = dout v^T, dq += ds k.
// The products are the forward's: bfloat16 on m16n8k16 (p and ds split into
// hi + mid + lo), float32 on 3xTF32; every tile row has stride hd + 8.
//
// What bounds it on an H100: 5 products of 2 * hd flop per unmasked (q, k)
// pair and head (s, dp, dv, dk, dq), 2.5 times the forward's 2, against the
// bytes of q, k, v, out, dout, lse read and dq, dk, dv written once: the
// operations, at 989 TFLOP/s in bfloat16. What the design does about it:
// every product runs on the tensor cores and the S x S weights never reach
// device memory; the price of having no atomics is that s and dp are formed
// twice (once in each kernel), 7 products where 5 would do, and the bfloat16
// split of p and ds triples the three accumulating products (15 MMA passes
// where the bound counts 5). No wgmma, no TMA: a later redesign.
namespace {

using namespace com;

// shared-memory geometry of the backward: every tile [64][hd + 8]; the dK/dV
// kernel holds its K and V tiles and two slots of (q, dout) tiles and of the
// (lse, delta) rows; the dQ kernel its q and dout tiles and two slots of
// (k, v) tiles
template <typename T, int HD>
struct BL {
  static constexpr bool F32 = sizeof(T) == 4;
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
  if constexpr (sizeof(T) == 4)
    qk_tile_f32<HD>(s, Aw, Bs, lane);
  else
    qk_tile<HD>(s, Aw, Bs, lane);
}

// acc (16 x HD) += P (16 x 64, C fragments) V (64 rows x HD, [rows][LD]),
// promoted as the forward's PV: for each group of d tiles, this tile's
// product runs on a fresh MMA accumulator and is then added to acc in f32
// (the tensor cores truncate what they add into their accumulator, and the
// dK/dV walk adds up to G * Sq / 64 tiles). The A fragments are formed again
// for every group, so that a group's temporary is all the registers it costs.
// bf16: P split into hi + mid + lo, as the forward's pv_tile splits it.
template <int HD, int LD>
__device__ __forceinline__ void pv_acc(float (&acc)[HD / 8][4], const float (&p)[8][4],
                                       const __nv_bfloat16* Vs, int lane) {
  constexpr int JG = HD / 8 < 8 ? HD / 8 : 8;
#pragma unroll
  for (int j0 = 0; j0 < HD / 8; j0 += JG) {
    float t[JG][4];
#pragma unroll
    for (int j = 0; j < JG; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) t[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t part[3][4];  // lo, mid, hi
      split_bf16(p[2 * kk][0], p[2 * kk][1], part[2][0], part[1][0], part[0][0]);
      split_bf16(p[2 * kk][2], p[2 * kk][3], part[2][1], part[1][1], part[0][1]);
      split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], part[2][2], part[1][2], part[0][2]);
      split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], part[2][3], part[1][3], part[0][3]);
      uint32_t v[JG][2];
#pragma unroll
      for (int j = 0; j < JG; j += 2)
        ldsm_x4_trans(&v[j][0], Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    8 * (j0 + j + (lane >> 4)));
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int j = 0; j < JG; ++j) mma_bf16(t[j], part[pass], v[j]);
    }
#pragma unroll
    for (int j = 0; j < JG; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j0 + j][c] += t[j][c];
  }
}

// f32: the same by 3xTF32, as the forward's pv_tile_f32 (k slots t, t + 4
// take rows 2t, 2t + 1 of each k8 step)
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

}  // namespace

// The backward of repro_flash_attention. q, out, dout, dq: (B, Sq, H, hd);
// k, v, dk, dv: (B, Skv, KVH, hd), all of one dtype (0 = float32, 1 =
// bfloat16), contiguous and 16-byte aligned; lse: the forward's (B, H, Sq)
// floats; delta: B*H*Sq floats of workspace (written here first). hd, causal
// and scale as in the forward. Returns cudaGetLastError() after the three
// launches (or the error that kept one from launching).
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
  if (dtype == 1) return launch_bwd_hd<__nv_bfloat16>(a, out, d, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
