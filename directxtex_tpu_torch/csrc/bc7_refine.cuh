// K3 — BC7 winner-refine, one thread per 4x4 block, with the analytic
// moment ladder (LADDER_MOMENT) or an exact perturbation ladder
// (LADDER_FULL, LADDER_LIGHT).
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc7_refine_pallas /
// _bc7_refine_kernel (its _k_refine_2sub and _k_refine_45uni passes, built
// on _k_moment_subset_dyn and _k_perturb_subset_dyn, and _k_refine_subsets
// for mode 6). Plain twin: bc67._bc7_refine_plain (refine_bc7_words over
// modes 1, 3, 4, 5, 6, 7; bit m of the mode mask puts mode m in scope).
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
// The TPU ran both unified family passes on every lane; here a thread
// branches to its own mode's pass only. The errors are integer sums of
// squares in f32 (times alpha_weight), taken in pixel order, so the words
// equal the plain twin's word for word. alpha_weight scales the alpha
// channel's squared error (the rotated one under modes 4/5) in the
// ladders, the acceptance bar and the re-assignment; the weighted
// instance (W) runs where it is not 1.0. Sources: bc7_refine.cu builds the
// moment instances (mode 6 only in the instance launched with mode-mask
// bit 6, so the default tier's instance keeps its code), and
// bc7_refine_ladder.cu the exact-ladder instance.
//
// Bound: compute. A block reads 80 bytes and writes 16, against a few
// thousand integer and f32 operations for its one mode (tens of thousands
// under LADDER_FULL: every probe is a 16-pixel palette error). The design
// keeps pixels packed as RGBA8 words and leaves the block's words
// untouched (one copy) where the mode is out of scope or the error does
// not drop.
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

// Modes 1/3/7 (two subsets) and 6 (one) (_refine_mode_subsets,
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
  const int shape = NS == 2 ? (int)get_bits(w, pos, 6) : 0;
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
  int pb[p_bits(M)];
#pragma unroll
  for (int j = 0; j < p_bits(M); ++j) pb[j] = get_bits(w, pos + j, 1);
  pos += p_bits(M);
#pragma unroll
  for (int sub = 0; sub < NS; ++sub) {
    p0[sub] = shared_p(M) ? pb[sub] : pb[2 * sub];
    p1[sub] = shared_p(M) ? pb[sub] : pb[2 * sub + 1];
  }
  const int anchor = NS == 2 ? c_pa2[shape] & 0xF : 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = P - ((i == 0 || i == anchor) ? 1 : 0);
    idx[i] = get_bits(w, pos, n);
    pos += n;
  }

  const unsigned m1 = NS == 2 ? subset1_mask(shape) : 0u;
  int wk[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) wk[i] = pal_weight<1 << P>(idx[i]);
  err_new = 0.0f;
  err_old = 0.0f;
#pragma unroll
  for (int sub = 0; sub < NS; ++sub) {
    const unsigned msk = sub ? m1 : (~m1 & 0xFFFFu);
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

// M6: mode 6 in scope (the maxq tier's refine); the exact-ladder instance
// always has it
template <int L, bool W, bool M6>
__global__ void __launch_bounds__(kThreads)
    bc7_refine_kernel(const int32_t* __restrict__ px,
                      const uint32_t* __restrict__ words_in,
                      uint32_t* __restrict__ words_out, int nb,
                      int mode_mask, float aw, ExactLadder lad) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const Bits128 w = load_words(words_in, nb, b);
  Bits128 out = w;
  const int mode = block_mode(w);
  if (mode < 8 && ((mode_mask >> mode) & 1)) {
    uint32_t pix[16];
    load_pixels(px, nb, b, pix);
    Bits128 nw = w;
    float err_new = 0.0f, err_old = 0.0f;
    switch (mode) {
      case 1: refine_subsets<1, L, W>(pix, w, aw, lad, nw, err_new, err_old);
              break;
      case 3: refine_subsets<3, L, W>(pix, w, aw, lad, nw, err_new, err_old);
              break;
      case 4: refine_45<4, L, W>(pix, w, aw, lad, nw, err_new, err_old);
              break;
      case 5: refine_45<5, L, W>(pix, w, aw, lad, nw, err_new, err_old);
              break;
      case 6:
        if constexpr (M6)
          refine_subsets<6, L, W>(pix, w, aw, lad, nw, err_new, err_old);
        break;
      case 7: refine_subsets<7, L, W>(pix, w, aw, lad, nw, err_new, err_old);
              break;
      default: break;
    }
    if (err_new < err_old) out = nw;
  }
  store_words(words_out, nb, b, out);
}

// Host launcher: alpha_weight arrives as its f32 bit pattern; at 1.0 the
// unweighted instance runs
template <int L, bool M6>
int launch_refine(const void* px, const void* words_in, void* words_out,
                  int nb, int mode_mask, int aw_bits, ExactLadder lad,
                  void* stream) {
  float aw;
  std::memcpy(&aw, &aw_bits, sizeof aw);
  const int grid = (nb + kThreads - 1) / kThreads;
  if (aw != 1.0f)
    bc7_refine_kernel<L, true, M6>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)px, (const uint32_t*)words_in,
            (uint32_t*)words_out, nb, mode_mask, aw, lad);
  else
    bc7_refine_kernel<L, false, M6>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)px, (const uint32_t*)words_in,
            (uint32_t*)words_out, nb, mode_mask, aw, lad);
  return (int)cudaGetLastError();
}

}  // namespace bc7
