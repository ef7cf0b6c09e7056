// K3 — BC7 winner-refine with the analytic moment ladder (LADDER_MOMENT)
// or an exact perturbation ladder (LADDER_FULL, LADDER_LIGHT), one launch
// per mode in scope over that mode's blocks.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc7_refine_pallas /
// _bc7_refine_kernel (its _k_refine_2sub and _k_refine_45uni passes, built
// on _k_moment_subset_dyn and _k_perturb_subset_dyn, and _k_refine_subsets
// for mode 6, with n_sub = 3 for modes 0 and 2). Plain twin:
// bc67._bc7_refine_plain (refine_bc7_words; bit m of the mode mask puts
// mode m in scope).
// Each block unpacks its own winner from its words, moves its endpoints
// with the indices fixed, re-assigns indices once and re-emits where the
// exact error drops:
//   - kMoment: the quadratic-model argmin of a joint {-1, 0, +1}^2 q-step
//     move per channel (_moment_channels_t);
//   - kExact: the exact ladder (_perturb_channels_t): per round, channel,
//     endpoint, delta and sign a +-delta q step is kept where the
//     channel's exact fixed-index error drops (strict `<`); rounds and
//     deltas are launch arguments, so LADDER_FULL (2, (2, 1)) and
//     LADDER_LIGHT (1, (1,)) share one instance. The re-assignment's
//     indices stand only where they beat the ladder's own error.
// The errors are integer sums of squares in f32 (times alpha_weight),
// taken in pixel order, so the words equal the plain twin's word for
// word. alpha_weight scales the alpha channel's squared error (the rotated
// one under modes 4/5) in the ladders, the acceptance bar and the
// re-assignment; the weighted instance (W) runs where it is not 1.0.
//
// The launcher (bc7_refine.cu) runs a bucket pass, bc7_mode_buckets,
// which copies the words to the output and appends each in-scope block's
// index to its mode's list (one atomic per warp and mode), then launches
// bc7_refine_mode_kernel<M, L, W> once per mode in scope, on its list.
// Modes 0 and 2 are two more buckets. A block is read and written only by
// its own mode's launch, so the order of the launches, and the order
// inside a bucket, do not move a word. Sources: bc7_refine_<M>.cu builds
// mode M's four instances (both ladders, both weights).
//
// Bound: compute. A block reads 80 bytes and writes 16, against a few
// thousand integer and f32 operations for its one mode (tens of thousands
// under LADDER_FULL: every probe is a 16-pixel palette error). A single
// kernel with a branch per mode ran every branch of a warp's mixed modes
// one after another and held the largest branch's registers (255, with
// spills); bucketing gives each warp one mode and each instance its own
// register count. Pixels stay packed as RGBA8 words.
#pragma once

#include <cstring>

#include "bc7_common.cuh"

namespace bc7 {

enum Ladder { kMoment = 0, kExact = 1 };

// an exact ladder's launch arguments: its rounds, and its deltas one byte
// each, low byte first (a zero byte ends the list)
struct ExactLadder {
  int rounds;
  int deltas;
};

// Analytic single-step endpoint move of one subset (_moment_channels_t,
// bc67.py:817). q0/q1 move in place; returns the pre-move fixed-index
// error, channel wch's squares weighted by aw (W). wk_rgb / wk_a: palette
// weights of the color and alpha indices.
template <int M, bool W>
__device__ __forceinline__ float moment_move(const uint32_t pix[16],
                                             unsigned msk, int q0[4],
                                             int q1[4], int p0, int p1,
                                             const int wk_rgb[16],
                                             const int wk_a[16], float aw,
                                             int wch) {
  const int p1u = shared_p(M) ? p0 : p1;
  float err0 = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (prec(M, c) == 0) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float d = (float)(px_at(pix, i, c) - 255);
        float d2 = d * d;
        if (W && c == wch) d2 = d2 * aw;
        s = s + (((msk >> i) & 1u) ? d2 : 0.0f);
      }
      err0 = err0 + s;
      continue;
    }
    const int* wk = c < 3 ? wk_rgb : wk_a;
    const int maxq = (1 << prec(M, c)) - 1;
    const int u0c = unquant_channel<M>(q0[c], p0, c);
    const int u1c = unquant_channel<M>(q1[c], p1u, c);
    float s = 0.0f, saa = 0.0f, sab = 0.0f, sbb = 0.0f, sra = 0.0f,
          srb = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool in = (msk >> i) & 1u;
      const int pal = ((64 - wk[i]) * u0c + wk[i] * u1c + 32) >> 6;
      const float r = (float)(px_at(pix, i, c) - pal);
      const float a = (float)(64 - wk[i]) * (1.0f / 64.0f);
      const float b = (float)wk[i] * (1.0f / 64.0f);
      float r2 = r * r;
      if (W && c == wch) r2 = r2 * aw;
      s = s + (in ? r2 : 0.0f);
      saa = saa + (in ? a * a : 0.0f);
      sab = sab + (in ? a * b : 0.0f);
      sbb = sbb + (in ? b * b : 0.0f);
      sra = sra + (in ? r * a : 0.0f);
      srb = srb + (in ? r * b : 0.0f);
    }
    err0 = err0 + s;

    // exact unquantized steps of a ±1 q move (0 at the field rail)
    const int q0p = min(q0[c] + 1, maxq), q0m = max(q0[c] - 1, 0);
    const int q1p = min(q1[c] + 1, maxq), q1m = max(q1[c] - 1, 0);
    const float d0p = (float)(unquant_channel<M>(q0p, p0, c) - u0c);
    const float d0m = (float)(unquant_channel<M>(q0m, p0, c) - u0c);
    const float d1p = (float)(unquant_channel<M>(q1p, p1u, c) - u1c);
    const float d1m = (float)(unquant_channel<M>(q1m, p1u, c) - u1c);

    float best = 0.0f;
    int bq0 = q0[c], bq1 = q1[c];
    const int steps[3] = {0, 1, -1};
#pragma unroll
    for (int j0 = 0; j0 < 3; ++j0) {
#pragma unroll
      for (int j1 = 0; j1 < 3; ++j1) {
        if (j0 == 0 && j1 == 0) continue;
        const float e0 = steps[j0] == 0 ? 0.0f : (steps[j0] > 0 ? d0p : d0m);
        const float e1 = steps[j1] == 0 ? 0.0f : (steps[j1] > 0 ? d1p : d1m);
        const float de = e0 * e0 * saa + e1 * e1 * sbb + 2.0f * e0 * e1 * sab
                       - 2.0f * (e0 * sra + e1 * srb);
        if (de < best) {
          best = de;
          bq0 = steps[j0] == 0 ? q0[c] : (steps[j0] > 0 ? q0p : q0m);
          bq1 = steps[j1] == 0 ? q1[c] : (steps[j1] > 0 ? q1p : q1m);
        }
      }
    }
    q0[c] = bq0;
    q1[c] = bq1;
  }
  return err0;
}

// Exact fixed-index error of channel c of the pixels in msk with
// endpoints (u0c, u1c) and palette weights wk (_perturb_channels_t's
// cherr, bc67.py:752); channel wch's squares weighted by aw (W)
template <bool W>
__device__ __forceinline__ float channel_err(const uint32_t pix[16],
                                             unsigned msk, int c, int u0c,
                                             int u1c, const int wk[16],
                                             float aw, int wch) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int pal = ((64 - wk[i]) * u0c + wk[i] * u1c + 32) >> 6;
    const float r = (float)(px_at(pix, i, c) - pal);
    float r2 = r * r;
    if (W && c == wch) r2 = r2 * aw;
    s = s + (((msk >> i) & 1u) ? r2 : 0.0f);
  }
  return s;
}

// The exact perturbation ladder of one subset (_perturb_channels_t,
// bc67.py:728): q0/q1 move in place; returns the pre-ladder fixed-index
// error and sets err_l to the ladder's final one. The loop order is the
// twin's: round -> channel -> endpoint -> delta -> sign.
template <int M, bool W>
__device__ __forceinline__ float perturb_move(
    const uint32_t pix[16], unsigned msk, int q0[4], int q1[4], int p0,
    int p1, const int wk_rgb[16], const int wk_a[16], float aw, int wch,
    const ExactLadder& lad, float& err_l) {
  const int p1u = shared_p(M) ? p0 : p1;
  float ch[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int* wk = c < 3 ? wk_rgb : wk_a;
    if (prec(M, c) == 0)          // decodes as 255: a constant term
      ch[c] = channel_err<W>(pix, msk, c, 255, 255, wk, aw, wch);
    else
      ch[c] = channel_err<W>(pix, msk, c, unquant_channel<M>(q0[c], p0, c),
                             unquant_channel<M>(q1[c], p1u, c), wk, aw,
                             wch);
  }
  float err0 = ch[0] + ch[1];
  err0 = err0 + ch[2];
  err0 = err0 + ch[3];
#pragma unroll 1
  for (int r = 0; r < lad.rounds; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (prec(M, c) == 0) continue;
      const int* wk = c < 3 ? wk_rgb : wk_a;
      const int maxq = (1 << prec(M, c)) - 1;
      float base = ch[c];
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        int& row = which ? q1[c] : q0[c];
        const int pbit = which ? p1u : p0;
        const int other_u = which ? unquant_channel<M>(q0[c], p0, c)
                                  : unquant_channel<M>(q1[c], p1u, c);
#pragma unroll 1
        for (int j = 0; j < 4; ++j) {
          const int d = (lad.deltas >> (8 * j)) & 0xFF;
          if (d == 0) break;
#pragma unroll
          for (int sg = 0; sg < 2; ++sg) {
            const int qt = min(max(row + (sg ? -d : d), 0), maxq);
            const int ut = unquant_channel<M>(qt, pbit, c);
            const float e =
                which ? channel_err<W>(pix, msk, c, other_u, ut, wk, aw, wch)
                      : channel_err<W>(pix, msk, c, ut, other_u, wk, aw,
                                       wch);
            if (e < base) {
              row = qt;
              base = e;
            }
          }
        }
      }
      ch[c] = base;
    }
  }
  err_l = ch[0] + ch[1];
  err_l = err_l + ch[2];
  err_l = err_l + ch[3];
  return err0;
}

// The ladder's move of one subset with the indices fixed: q0/q1 move in
// place; returns the pre-move error and sets err_l to the ladder's own
// fixed-index error (+inf under kMoment, which every finite re-assignment
// error beats)
template <int M, int L, bool W>
__device__ __forceinline__ float ladder_move(
    const uint32_t pix[16], unsigned msk, int q0[4], int q1[4], int p0,
    int p1, const int wk_rgb[16], const int wk_a[16], float aw, int wch,
    const ExactLadder& lad, float& err_l) {
  if constexpr (L == kMoment) {
    err_l = INFINITY;
    return moment_move<M, W>(pix, msk, q0, q1, p0, p1, wk_rgb, wk_a, aw,
                             wch);
  } else {
    return perturb_move<M, W>(pix, msk, q0, q1, p0, p1, wk_rgb, wk_a, aw,
                              wch, lad, err_l);
  }
}

// Modes 1/3/7 (two subsets), 6 (one) and 0/2 (three) (_refine_mode_subsets,
// bc67.py:1685)
template <int M, int L, bool W>
__device__ __forceinline__ void refine_subsets(const uint32_t pix[16],
                                               const Bits128& w, float aw,
                                               const ExactLadder& lad,
                                               Bits128& out, float& err_new,
                                               float& err_old) {
  constexpr int P = index_prec(M);
  constexpr int NS = parts(M) + 1;
  int pos = M + 1;
  const int shape = NS >= 2 ? (int)get_bits(w, pos, partition_bits(M)) : 0;
  pos += partition_bits(M);
  int q0[NS][4], q1[NS][4], p0[NS], p1[NS], idx[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 2 * NS; ++e) {
      int v = 0;
      if (prec(M, c)) {
        v = get_bits(w, pos, prec(M, c));
        pos += prec(M, c);
      }
      if (e & 1) q1[e >> 1][c] = v; else q0[e >> 1][c] = v;
    }
  }
  int pb[p_bits(M) > 0 ? p_bits(M) : 1];       // mode 2 has no p bits
#pragma unroll
  for (int j = 0; j < p_bits(M); ++j) pb[j] = get_bits(w, pos + j, 1);
  pos += p_bits(M);
#pragma unroll
  for (int sub = 0; sub < NS; ++sub) {
    if constexpr (p_bits(M) == 0) {
      p0[sub] = p1[sub] = 0;
    } else {
      p0[sub] = shared_p(M) ? pb[sub] : pb[2 * sub];
      p1[sub] = shared_p(M) ? pb[sub] : pb[2 * sub + 1];
    }
  }
  const int anchor = NS == 2 ? c_pa2[shape] & 0xF
                             : (NS == 3 ? c_pa3[shape] & 0xF : 0);
  const int anchor3 = NS == 3 ? c_pa3[shape] >> 4 : 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n =
        P - ((i == 0 || i == anchor || (NS == 3 && i == anchor3)) ? 1 : 0);
    idx[i] = get_bits(w, pos, n);
    pos += n;
  }

  const unsigned m1 = NS == 2 ? subset1_mask(shape) : 0u;
  unsigned msk3[3] = {0u, 0u, 0u};
  if constexpr (NS == 3) subset_masks3(shape, msk3);
  int wk[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) wk[i] = pal_weight<1 << P>(idx[i]);
  err_new = 0.0f;
  err_old = 0.0f;
#pragma unroll
  for (int sub = 0; sub < NS; ++sub) {
    const unsigned msk = NS == 3 ? msk3[sub] : (sub ? m1 : (~m1 & 0xFFFFu));
    int q0t[4], q1t[4], u0[4], u1[4], it[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q0t[c] = q0[sub][c];
      q1t[c] = q1[sub][c];
    }
    float err_l;
    const float err0 = ladder_move<M, L, W>(pix, msk, q0t, q1t, p0[sub],
                                            p1[sub], wk, wk, aw, 3, lad,
                                            err_l);
    unquantize_endpoints<M>(q0t, q1t, p0[sub], p1[sub], u0, u1);
    float err_t = assign_indices<P, 0, 4, W>(pix, u0, u1, msk, it, aw);
    bool keep = true;
    if constexpr (L == kExact) {
      keep = err_t < err_l;
      err_t = fminf(err_t, err_l);
    }
    if (err_t < err0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        q0[sub][c] = q0t[c];
        q1[sub][c] = q1t[c];
      }
      if (keep) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if ((msk >> i) & 1u) idx[i] = it[i];
      }
    }
    err_new = err_new + fminf(err_t, err0);
    err_old = err_old + err0;
  }
  if constexpr (NS == 2) {
    anchor_swaps_2sub<P>(shape, m1, q0, q1, p0, p1, idx);
  } else if constexpr (NS == 3) {
    anchor_swaps_3sub<P>(shape, msk3, q0, q1, p0, p1, idx);
  } else if (idx[0] & (1 << (P - 1))) {
    // one subset: the anchor is pixel 0 (BC6HBC7.cpp:3181-3194)
#pragma unroll
    for (int c = 0; c < 4; ++c) swap_ints(q0[0][c], q1[0][c]);
    swap_ints(p0[0], p1[0]);
#pragma unroll
    for (int i = 0; i < 16; ++i) idx[i] = (1 << P) - 1 - idx[i];
  }
  out = emit_block<M>(shape, 0, 0, q0, q1, p0, p1, idx, nullptr);
}

// Modes 4/5 (_refine_mode45, bc67.py:1765)
template <int M, int L, bool W>
__device__ __forceinline__ void refine_45(const uint32_t pix[16],
                                          const Bits128& w, float aw,
                                          const ExactLadder& lad,
                                          Bits128& out, float& err_new,
                                          float& err_old) {
  constexpr int P1 = index_prec(M), P2 = index_prec2(M);
  int pos = M + 1;
  const int rot = get_bits(w, pos, 2);
  pos += 2;
  const int im = get_bits(w, pos, index_mode_bits(M));
  pos += index_mode_bits(M);
  int q0[1][4], q1[1][4], p0[1] = {0}, p1[1] = {0};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q0[0][c] = get_bits(w, pos, prec(M, c));
    pos += prec(M, c);
    q1[0][c] = get_bits(w, pos, prec(M, c));
    pos += prec(M, c);
  }
  int w1[16], w2[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = P1 - (i == 0 ? 1 : 0);
    w1[i] = get_bits(w, pos, n);
    pos += n;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = P2 - (i == 0 ? 1 : 0);
    w2[i] = get_bits(w, pos, n);
    pos += n;
  }
  uint32_t prp[16];
  rotate_pixels(pix, rot, prp);
  const int wch = rot ? rot - 1 : 3;     // the true alpha, rotated

  const bool im0 = im == 0;
  int cidx[16], aidx[16], wkc[16], wka[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    cidx[i] = im0 ? w1[i] : w2[i];
    aidx[i] = im0 ? w2[i] : w1[i];
    wkc[i] = im0 ? pal_weight<1 << P1>(cidx[i]) : pal_weight<1 << P2>(cidx[i]);
    wka[i] = im0 ? pal_weight<1 << P2>(aidx[i]) : pal_weight<1 << P1>(aidx[i]);
  }
  int q0t[4], q1t[4], u0[4], u1[4], ct[16], at[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    q0t[c] = q0[0][c];
    q1t[c] = q1[0][c];
  }
  float err_l;
  const float err0 = ladder_move<M, L, W>(prp, 0xFFFFu, q0t, q1t, 0, 0, wkc,
                                          wka, aw, wch, lad, err_l);
  unquantize_endpoints<M>(q0t, q1t, 0, 0, u0, u1);
  float err_t;
  if (im0) {
    err_t = assign_indices<P1, 0, 3, W>(prp, u0, u1, 0xFFFFu, ct, aw, wch);
    err_t = err_t
          + assign_indices<P2, 3, 4, W>(prp, u0, u1, 0xFFFFu, at, aw, wch);
  } else {
    err_t = assign_indices<P2, 0, 3, W>(prp, u0, u1, 0xFFFFu, ct, aw, wch);
    err_t = err_t
          + assign_indices<P1, 3, 4, W>(prp, u0, u1, 0xFFFFu, at, aw, wch);
  }
  bool keep = true;
  if constexpr (L == kExact) {
    keep = err_t < err_l;
    err_t = fminf(err_t, err_l);
  }
  if (err_t < err0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q0[0][c] = q0t[c];
      q1[0][c] = q1t[c];
    }
    if (keep) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        cidx[i] = ct[i];
        aidx[i] = at[i];
      }
    }
  }
  err_new = fminf(err_t, err0);
  err_old = err0;

#pragma unroll
  for (int i = 0; i < 16; ++i) {
    w1[i] = im0 ? cidx[i] : aidx[i];
    w2[i] = im0 ? aidx[i] : cidx[i];
  }
  anchor_swaps_45<P1, P2>(im0, w1, w2, q0[0], q1[0]);
  out = emit_block<M>(0, rot, im, q0, q1, p0, p1, w1, w2);
}

// A K3 launch's arguments: the winner words, their copy (words_out, the
// launcher's output, already holding words_in), the mode buckets of the
// bucket pass (lists [8, NB], counts [8]) and the ladder (exact: an exact
// ladder, else LADDER_MOMENT)
struct RefineArgs {
  const int32_t* px;
  const uint32_t* words_in;
  uint32_t* words_out;
  const int32_t* lists;
  const int32_t* counts;
  int nb;
  float aw;
  bool exact;
  ExactLadder lad;
  cudaStream_t stream;
};

// Mode M's refine over its bucket: thread t takes the bucket's t-th block
// (the bucket pass put its index there) and re-emits it where its error
// drops. Every block of a warp has mode M, so the warp runs one mode's
// code, and the instance holds only that mode's registers. The bucket's
// size stays on the device: threads past it exit.
template <int M, int L, bool W>
__global__ void __launch_bounds__(kThreads)
    bc7_refine_mode_kernel(const int32_t* __restrict__ px,
                           const uint32_t* __restrict__ words_in,
                           uint32_t* __restrict__ words_out,
                           const int32_t* __restrict__ list,
                           const int32_t* __restrict__ count, int nb,
                           float aw, ExactLadder lad) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= *count) return;
  const int b = list[t];
  const Bits128 w = load_words(words_in, nb, b);
  uint32_t pix[16];
  load_pixels(px, nb, b, pix);
  Bits128 nw = w;
  float err_new = 0.0f, err_old = 0.0f;
  if constexpr (M == 4 || M == 5)
    refine_45<M, L, W>(pix, w, aw, lad, nw, err_new, err_old);
  else
    refine_subsets<M, L, W>(pix, w, aw, lad, nw, err_new, err_old);
  if (err_new < err_old) store_words(words_out, nb, b, nw);
}

template <int M, int L, bool W>
int launch_refine_instance(const RefineArgs& a) {
  const int grid = (a.nb + kThreads - 1) / kThreads;
  bc7_refine_mode_kernel<M, L, W><<<grid, kThreads, 0, a.stream>>>(
      a.px, a.words_in, a.words_out, a.lists + (size_t)M * a.nb,
      a.counts + M, a.nb, a.aw, a.lad);
  return (int)cudaGetLastError();
}

// Mode M's launcher: the ladder's instance, weighted where alpha_weight
// is not 1.0
template <int M>
int launch_refine_mode(const RefineArgs& a) {
  if (a.exact)
    return a.aw != 1.0f ? launch_refine_instance<M, kExact, true>(a)
                        : launch_refine_instance<M, kExact, false>(a);
  return a.aw != 1.0f ? launch_refine_instance<M, kMoment, true>(a)
                      : launch_refine_instance<M, kMoment, false>(a);
}

// The per-mode launchers, each built from a source of its own
// (bc7_refine_<M>.cu) so that the instances compile in parallel
int launch_refine_mode_0(const RefineArgs& a);
int launch_refine_mode_1(const RefineArgs& a);
int launch_refine_mode_2(const RefineArgs& a);
int launch_refine_mode_3(const RefineArgs& a);
int launch_refine_mode_4(const RefineArgs& a);
int launch_refine_mode_5(const RefineArgs& a);
int launch_refine_mode_6(const RefineArgs& a);
int launch_refine_mode_7(const RefineArgs& a);

}  // namespace bc7
