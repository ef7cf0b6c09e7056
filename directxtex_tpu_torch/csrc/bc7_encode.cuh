// K2 — the whole BC7 search of one tier, one thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc7_encode_pallas /
// _bc7_all_kernel, in five variants, each a template instance built from
// its own source:
//   kOpaque (bc7_encode.cu)       modes (1, 3, 5, 6, 4), the default tier
//                                 on images without alpha (share2sub,
//                                 share45, m4_ims=(0,));
//   kAlpha  (bc7_encode_alpha.cu) modes (1, 3, 5, 6, 7, 4), the default
//                                 tier on images with alpha;
//   kQuick  (bc7_encode_quick.cu) mode 6 alone (the QUICK tier);
//   kMaxq   (bc7_encode_maxq.cu)  modes (1, 3, 5, 6, 4), the maxq tier
//                                 (share2sub=False, share45=False,
//                                 m4_ims=(0, 1));
//   kMaxqAlpha (bc7_encode_maxq_alpha.cu) modes (1, 3, 5, 6, 7, 4), the
//                                 maxq tier on images with alpha.
// Each variant has a weighted instance (W) that scales the alpha
// channel's squared error by alpha_weight in scoring and index
// assignment; the unweighted one is launched at alpha_weight 1.0 and does
// no multiply. Plain twin: bc67._bc7_search_plain (the JAX package's jnp
// search), step for step and in the same operation order:
//   - off-axis ranking of the 64 two-subset shapes (3 power iterations)
//     and the top 4 by (estimate, shape) — _k_shape_topk; the TPU's
//     [128, 16] partition-mask product on the MXU is a 16-term masked sum
//     per (shape, subset) here, in pixel order;
//   - default tier: per candidate, one float trajectory per subset (axis
//     fit, K=8 float assignment, LS refit) shared by modes 1 and 3, each
//     of which then quantizes, assigns exactly, swaps anchors and emits —
//     _k_partition_fold_multi / _k_eval_2sub_shared;
//     maxq tier: modes 1 and 3 each fitted on its own per candidate (axis
//     fit, assign, LS refit, re-assign, keep the better per subset,
//     anchor swaps) — _k_partition_fold / _k_eval_subsets;
//   - mode 6 (axis fit, assign, LS refit, re-assign, keep the better) —
//     _k_mode6;
//   - default tier: per rotation, one float trajectory shared by modes 4
//     and 5 at index mode 0 — _k_rot_data / _k_modes45_shared;
//     maxq tier: per rotation and index mode (mode 4: 0 and 1, mode 5: 0)
//     each candidate fitted on its own (quantize, assign colour and alpha
//     at the index mode's precisions, one LS refit per group,
//     re-evaluate, keep the better) — _k_rot_data / _k_mode45;
//   - kAlpha, kMaxqAlpha: mode 7 on modes 1/3's top-4 shapes, each
//     candidate fitted on its own — _k_partition_fold(7); a block whose
//     alpha is 255 everywhere skips it, as its error would be masked to
//     inf (pallas_kernels.py:1952-1956);
//   - the cross-mode fold in list order with a strict `<`. Each mode keeps
//     its own running best over its candidates, so the fold runs in the
//     twin's order whatever order the modes were evaluated in.
// The TPU evaluated every lane through where-chains over [16, T] planes;
// here each block is one thread's scalar program. The TPU kernel fixes the
// mode-4/5 anchors once, on the fold winner (_k_mode45_finish); this
// kernel fixes and emits every candidate as the jnp twin does. A fix moves
// no error, so the winner and its words are the same.
//
// Bound: compute. A block reads 64 bytes and writes 20, against roughly
// 10^5 integer and f32 operations, so the kernel is limited by issue rate
// and by registers: the per-thread state (16 packed pixels, 16 centred
// pixel vectors during ranking, 16 indices, endpoints) spills past 255
// registers into local memory, which the L1 cache serves. The design keeps
// pixels packed as RGBA8 words (16 registers for the block), recomputes
// cross moments instead of holding them, keeps the top-4 shapes in a
// compare-swap chain, and loops over shapes, candidates and rotations
// without unrolling to bound code size and build time. The maxq variants
// run each mode's candidates as a loop of its own, after the others, so
// that only one mode's fit state is live at a time.
//
// Built with --fmad=false: every float step rounds as the plain twin's
// separate torch ops do, so kernel and twin pick the same words.
#pragma once

#include <cstring>

#include "bc7_common.cuh"

namespace bc7 {

enum Variant { kOpaque = 0, kAlpha = 1, kQuick = 2, kMaxq = 3,
               kMaxqAlpha = 4 };

// Initial endpoints: masked min/max box + best-diagonal axis pick
// (_minmax_axis_endpoints_t, bc67.py:553)
template <bool WITH_ALPHA>
__device__ __forceinline__ void minmax_axis(const uint32_t pix[16],
                                            unsigned msk, float e0[4],
                                            float e1[4]) {
  float mi[4], ma[4], mid[4], ab[4], dirv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mi[c] = 1e9f;
    ma[c] = -1e9f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if ((msk >> i) & 1u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = (float)px_at(pix, i, c);
        mi[c] = fminf(mi[c], x);
        ma[c] = fmaxf(ma[c], x);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    mid[c] = (mi[c] + ma[c]) * 0.5f;
    ab[c] = ma[c] - mi[c];
  }
  float fab = ab[0] * ab[0];
  fab = fab + ab[1] * ab[1];
  fab = fab + ab[2] * ab[2];
  if (WITH_ALPHA) fab = fab + ab[3] * ab[3];
  const float den = fab > 0.0f ? fab : 1.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) dirv[c] = ab[c] / den;

  float pt[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float m = ((msk >> i) & 1u) ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      pt[i][c] = ((float)px_at(pix, i, c) - mid[c]) * dirv[c] * m;
  }
  float best = -1.0f, bsg = 1.0f, bsb = 1.0f, bsa = 1.0f;
  constexpr int n_signs = WITH_ALPHA ? 8 : 4;
#pragma unroll
  for (int j = 0; j < n_signs; ++j) {
    const float sg = (j & (WITH_ALPHA ? 4 : 2)) ? -1.0f : 1.0f;
    const float sb = (j & (WITH_ALPHA ? 2 : 1)) ? -1.0f : 1.0f;
    const float sa = (WITH_ALPHA && (j & 1)) ? -1.0f : 1.0f;
    float score = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float f = pt[i][0] + sg * pt[i][1];
      f = f + sb * pt[i][2];
      if (WITH_ALPHA) f = f + sa * pt[i][3];
      score = score + f * f;
    }
    if (score > best) {
      best = score;
      bsg = sg;
      bsb = sb;
      bsa = sa;
    }
  }
  e0[0] = mi[0];
  e1[0] = ma[0];
  e0[1] = bsg < 0.0f ? ma[1] : mi[1];
  e1[1] = bsg < 0.0f ? mi[1] : ma[1];
  e0[2] = bsb < 0.0f ? ma[2] : mi[2];
  e1[2] = bsb < 0.0f ? mi[2] : ma[2];
  e0[3] = (WITH_ALPHA && bsa < 0.0f) ? ma[3] : mi[3];
  e1[3] = (WITH_ALPHA && bsa < 0.0f) ? mi[3] : ma[3];
}

// Float-endpoint palette assignment over channels [LO, HI): the
// precision-free trajectory step (_float_assign_ch_t, bc67.py:1002)
template <int IPREC, int LO, int HI>
__device__ __forceinline__ void float_assign(const uint32_t pix[16],
                                             const float e0[4],
                                             const float e1[4],
                                             float idx[16]) {
  constexpr int K = 1 << IPREC;
  float e[4];
  float span = 0.0f;
#pragma unroll
  for (int c = LO; c < HI; ++c) {
    e[c] = e1[c] - e0[c];
    span = span + e[c] * e[c];
  }
  const float s64 = 64.0f / (span > 0.0f ? span : 1.0f);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    float dot = 0.0f;
#pragma unroll
    for (int c = LO; c < HI; ++c)
      dot = dot + ((float)px_at(pix, i, c) - e0[c]) * e[c];
    const float p64 = fminf(fmaxf(dot * s64, 0.0f), 64.0f);
    const float kf = fminf(fmaxf(rintf(p64 * (float)((K - 1) / 64.0)), 0.0f),
                           K - 1.0f);
    const float wk = pal_weight_f<K>(kf);
    const float wkp = pal_weight_f<K>(fminf(kf + 1.0f, K - 1.0f));
    const float wkm = pal_weight_f<K>(fmaxf(kf - 1.0f, 0.0f));
    const bool up = kf < K - 1 && 2.0f * p64 > wk + wkp;
    const bool dn = kf > 0 && 2.0f * p64 < wk + wkm;
    idx[i] = up ? kf + 1.0f : (dn ? kf - 1.0f : kf);
  }
}

// Least-squares endpoint refit of channels [LO, HI) with per-pixel palette
// weights x = w/64 (_ls_refit, bc67.py:524 / :1056); in place
template <int LO, int HI>
__device__ __forceinline__ void ls_refit(const uint32_t pix[16],
                                         const float x[16], unsigned msk,
                                         float e0[4], float e1[4]) {
  float a[16], b[16];
  float A = 0.0f, B = 0.0f, C = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float m = ((msk >> i) & 1u) ? 1.0f : 0.0f;
    a[i] = (1.0f - x[i]) * m;
    b[i] = x[i] * m;
    A = A + a[i] * a[i];
    B = B + a[i] * b[i];
    C = C + b[i] * b[i];
  }
  const float det = A * C - B * B;
  const bool ok = fabsf(det) > 1e-6f;
  const float inv = 1.0f / (ok ? det : 1.0f);
#pragma unroll
  for (int c = LO; c < HI; ++c) {
    float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = (float)px_at(pix, i, c);
      r0 = r0 + a[i] * p;
      r1 = r1 + b[i] * p;
    }
    const float n0 = fminf(fmaxf((C * r0 - B * r1) * inv, 0.0f), 255.0f);
    const float n1 = fminf(fmaxf((A * r1 - B * r0) * inv, 0.0f), 255.0f);
    if (ok) {
      e0[c] = n0;
      e1[c] = n1;
    }
  }
}

template <int IPREC, int LO, int HI>
__device__ __forceinline__ void ls_refit_f(const uint32_t pix[16],
                                           const float idx[16], unsigned msk,
                                           float e0[4], float e1[4]) {
  float x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = pal_weight_f<1 << IPREC>(idx[i]) * (1.0f / 64.0f);
  ls_refit<LO, HI>(pix, x, msk, e0, e1);
}

// Float endpoints -> codes + p-bit majority vote (_quantize_endpoints_t)
template <int M>
__device__ __forceinline__ void quantize_endpoints(const float e0f[4],
                                                   const float e1f[4],
                                                   int q0[4], int q1[4],
                                                   int& p0, int& p1) {
  int v0 = 0, v1 = 0, nvote = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int e0 = (int)fminf(fmaxf(rintf(e0f[c]), 0.0f), 255.0f);
    const int e1 = (int)fminf(fmaxf(rintf(e1f[c]), 0.0f), 255.0f);
    if (prec(M, c) == 0) {
      q0[c] = q1[c] = 0;
    } else if (prec(M, c) != prec_p(M, c)) {
      const int f0 = quantize_u8(e0, prec_p(M, c));
      const int f1 = quantize_u8(e1, prec_p(M, c));
      v0 += f0 & 1;
      v1 += f1 & 1;
      ++nvote;
      q0[c] = f0 >> 1;
      q1[c] = f1 >> 1;
    } else {
      q0[c] = quantize_u8(e0, prec(M, c));
      q1[c] = quantize_u8(e1, prec(M, c));
    }
  }
  p0 = nvote ? (v0 > (nvote >> 1) ? 1 : 0) : 0;
  p1 = nvote ? (v1 > (nvote >> 1) ? 1 : 0) : 0;
}

// Off-axis ranking of the first S shapes with NS subsets
// (_shape_estimates_table(off_axis=True) + _top_k_shapes, bc67.py:1243):
// the 4 shapes of least (estimate, shape), in that order. K2 ranks the 64
// two-subset shapes; K9 (bc7_shapes.cu) any of (2 or 3 subsets) x (16 or
// 64 shapes). Each subset's 11 masked sums run over the 16 pixels in
// pixel order, as the plain twin's masked sums do.
template <int NS = 2, int S = 64>
__device__ __forceinline__ void shape_top4(const uint32_t pix[16],
                                           int cand[4]) {
  static_assert(NS == 2 || NS == 3, "two or three subsets");
  float mu[4], xc[16][4], q[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s = s + (float)px_at(pix, i, c);
    mu[c] = s * (1.0f / 16.0f);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) xc[i][c] = (float)px_at(pix, i, c) - mu[c];
    float s = xc[i][0] * xc[i][0];
    s = s + xc[i][1] * xc[i][1];
    s = s + xc[i][2] * xc[i][2];
    q[i] = s + xc[i][3] * xc[i][3];
  }
  const float on_axis = (float)(1.0 - 0.05);   // 1 - _ON_AXIS_W
  float bv[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  int bi[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const uint32_t pp = NS == 2 ? c_pp2[s] : c_pp3[s];
    // 11 masked 16-pixel sums per subset: |xc|^2, xc (4), RGB cross (6)
    float acc[NS][11];
#pragma unroll
    for (int k = 0; k < 11; ++k) {
#pragma unroll
      for (int p = 0; p < NS; ++p) acc[p][k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float v[11] = {q[i], xc[i][0], xc[i][1], xc[i][2], xc[i][3],
                           xc[i][0] * xc[i][0], xc[i][0] * xc[i][1],
                           xc[i][0] * xc[i][2], xc[i][1] * xc[i][1],
                           xc[i][1] * xc[i][2], xc[i][2] * xc[i][2]};
      // pp is the same in every thread: no divergence
      if constexpr (NS == 3) {
        const unsigned sub = (pp >> (2 * i)) & 3u;
        if (sub == 2u) {
#pragma unroll
          for (int k = 0; k < 11; ++k) acc[2][k] = acc[2][k] + v[k];
        } else if (sub == 1u) {
#pragma unroll
          for (int k = 0; k < 11; ++k) acc[1][k] = acc[1][k] + v[k];
        } else {
#pragma unroll
          for (int k = 0; k < 11; ++k) acc[0][k] = acc[0][k] + v[k];
        }
      } else if ((pp >> (2 * i)) & 1u) {
#pragma unroll
        for (int k = 0; k < 11; ++k) acc[1][k] = acc[1][k] + v[k];
      } else {
#pragma unroll
        for (int k = 0; k < 11; ++k) acc[0][k] = acc[0][k] + v[k];
      }
    }
    int cnt[NS];
    if constexpr (NS == 3) {
      unsigned msk[3];
      subset_masks3(s, msk);
#pragma unroll
      for (int p = 0; p < 3; ++p) cnt[p] = __popc(msk[p]);
    } else {
      const int n1 = __popc(subset1_mask(s));
      cnt[0] = 16 - n1;
      cnt[1] = n1;
    }
    float est = 0.0f;
#pragma unroll
    for (int p = 0; p < NS; ++p) {
      const float* sp = acc[p];
      const int n = cnt[p];
      const float ninv = 1.0f / (float)max(n, 1);
      float s2 = sp[1] * sp[1];
      s2 = s2 + sp[2] * sp[2];
      s2 = s2 + sp[3] * sp[3];
      s2 = s2 + sp[4] * sp[4];
      const float sse = sp[0] - s2 * ninv;
      float cv[3][3];
      int k = 5;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = a; b < 3; ++b) {
          cv[a][b] = cv[b][a] = sp[k] - sp[1 + a] * sp[1 + b] * ninv;
          ++k;
        }
      }
      // dominant eigenvalue by power iteration
      float v0 = 1.0f, v1 = 1.0f, v2 = 1.0f;
#pragma unroll
      for (int it = 0; it < 3; ++it) {   // _POWER_ITERS
        const float w0 = cv[0][0] * v0 + cv[0][1] * v1 + cv[0][2] * v2;
        const float w1 = cv[1][0] * v0 + cv[1][1] * v1 + cv[1][2] * v2;
        const float w2 = cv[2][0] * v0 + cv[2][1] * v1 + cv[2][2] * v2;
        const float nrm = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
        const float inv = 1.0f / fmaxf(nrm, 1e-20f);
        v0 = w0 * inv;
        v1 = w1 * inv;
        v2 = w2 * inv;
      }
      const float lam =
          v0 * (cv[0][0] * v0 + cv[0][1] * v1 + cv[0][2] * v2)
          + v1 * (cv[1][0] * v0 + cv[1][1] * v1 + cv[1][2] * v2)
          + v2 * (cv[2][0] * v0 + cv[2][1] * v1 + cv[2][2] * v2);
      est = est + fmaxf(sse - lam * on_axis, 0.0f);
    }
    // running top 4; a tie keeps the earlier shape first (jnp.argmin)
    if (est < bv[3]) {
      bv[3] = est;
      bi[3] = s;
      if (bv[3] < bv[2]) { const float t = bv[2]; bv[2] = bv[3]; bv[3] = t; swap_ints(bi[2], bi[3]); }
      if (bv[2] < bv[1]) { const float t = bv[1]; bv[1] = bv[2]; bv[2] = t; swap_ints(bi[1], bi[2]); }
      if (bv[1] < bv[0]) { const float t = bv[0]; bv[0] = bv[1]; bv[1] = t; swap_ints(bi[0], bi[1]); }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) cand[k] = bi[k];
}

struct Best {
  float err;
  Bits128 w;
};

__device__ __forceinline__ void keep_if_better(Best& best, float err,
                                               const Bits128& w) {
  if (err < best.err) {
    best.err = err;
    best.w = w;
  }
}

// Modes 1/3 on one shape candidate from the shared trajectory endpoints
// (_eval_2sub_shared's per-mode part, bc67.py:1128)
template <int M, bool W>
__device__ __forceinline__ void eval_2sub_mode(const uint32_t pix[16],
                                               int shape, unsigned m1,
                                               const float se0[2][4],
                                               const float se1[2][4],
                                               float aw, Best& best) {
  constexpr int P = index_prec(M);
  int q0[2][4], q1[2][4], p0[2], p1[2], idx[16];
  float total = 0.0f;
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    const unsigned msk = sub ? m1 : (~m1 & 0xFFFFu);
    int u0[4], u1[4], it[16];
    quantize_endpoints<M>(se0[sub], se1[sub], q0[sub], q1[sub], p0[sub],
                          p1[sub]);
    unquantize_endpoints<M>(q0[sub], q1[sub], p0[sub], p1[sub], u0, u1);
    total = total + assign_indices<P, 0, 4, W>(pix, u0, u1, msk, it, aw);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (sub == 0 ? !((m1 >> i) & 1u) : ((m1 >> i) & 1u)) idx[i] = it[i];
  }
  anchor_swaps_2sub<P>(shape, m1, q0, q1, p0, p1, idx);
  keep_if_better(best, total,
                 emit_block<M>(shape, 0, 0, q0, q1, p0, p1, idx, nullptr));
}

// One subset of a mode fitted on its own (_eval_subset_candidate's
// per-subset part, bc67.py:908): axis fit, quantize and assign, one LS
// refit and re-assign, keep the better. Writes the codes, p bits and the
// indices of all 16 pixels (the caller keeps those in `msk`); returns the
// subset's error.
template <int M, bool W>
__device__ __forceinline__ float fit_subset(const uint32_t pix[16],
                                            unsigned msk, float aw,
                                            int q0[4], int q1[4], int& p0,
                                            int& p1, int idx[16]) {
  constexpr int P = index_prec(M);
  float e0[4], e1[4];
  minmax_axis<(prec(M, 3) > 0)>(pix, msk, e0, e1);
  int u0[4], u1[4];
  quantize_endpoints<M>(e0, e1, q0, q1, p0, p1);
  unquantize_endpoints<M>(q0, q1, p0, p1, u0, u1);
  float err = assign_indices<P, 0, 4, W>(pix, u0, u1, msk, idx, aw);

  float x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = (float)pal_weight<1 << P>(idx[i]) * (1.0f / 64.0f);
  ls_refit<0, 4>(pix, x, msk, e0, e1);
  int qb0[4], qb1[4], pb0, pb1, idxb[16];
  quantize_endpoints<M>(e0, e1, qb0, qb1, pb0, pb1);
  unquantize_endpoints<M>(qb0, qb1, pb0, pb1, u0, u1);
  const float err_b = assign_indices<P, 0, 4, W>(pix, u0, u1, msk, idxb, aw);
  if (err_b < err) {
    err = err_b;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q0[c] = qb0[c];
      q1[c] = qb1[c];
    }
    p0 = pb0;
    p1 = pb1;
#pragma unroll
    for (int i = 0; i < 16; ++i) idx[i] = idxb[i];
  }
  return err;
}

// Mode 6 (_eval_subset_candidate on one full-block subset, bc67.py:908)
template <bool W>
__device__ __forceinline__ Best eval_mode6(const uint32_t pix[16], float aw) {
  int q0[1][4], q1[1][4], p0[1], p1[1], idx[16];
  const float err =
      fit_subset<6, W>(pix, 0xFFFFu, aw, q0[0], q1[0], p0[0], p1[0], idx);
  if (idx[0] & 8) {
#pragma unroll
    for (int c = 0; c < 4; ++c) swap_ints(q0[0][c], q1[0][c]);
    swap_ints(p0[0], p1[0]);
#pragma unroll
    for (int i = 0; i < 16; ++i) idx[i] = 15 - idx[i];
  }
  return Best{err, emit_block<6>(0, 0, 0, q0, q1, p0, p1, idx, nullptr)};
}

// A partition mode on one shape candidate, each subset fitted on its own
// (_eval_subset_candidate over the shape's subsets, then anchor swaps and
// emit; bc67.py:1348-1384): mode 7 in every tier and modes 1 and 3 in the
// maxq tier (two subsets, m1 the pixel mask of subset 1), modes 0 and 2
// (three subsets, from c_pp3; m1 unused) in K7
template <int M, bool W>
__device__ __forceinline__ void eval_partition(const uint32_t pix[16],
                                               int shape, unsigned m1,
                                               float aw, Best& best) {
  if constexpr (parts(M) == 2) {
    int q0[3][4], q1[3][4], p0[3], p1[3], idx[16];
    unsigned msk[3];
    subset_masks3(shape, msk);
    float total = 0.0f;
#pragma unroll
    for (int sub = 0; sub < 3; ++sub) {
      int it[16];
      total = total + fit_subset<M, W>(pix, msk[sub], aw, q0[sub], q1[sub],
                                       p0[sub], p1[sub], it);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if ((msk[sub] >> i) & 1u) idx[i] = it[i];
    }
    anchor_swaps_3sub<index_prec(M)>(shape, msk, q0, q1, p0, p1, idx);
    keep_if_better(best, total,
                   emit_block<M>(shape, 0, 0, q0, q1, p0, p1, idx, nullptr));
  } else {
    int q0[2][4], q1[2][4], p0[2], p1[2], idx[16];
    float total = 0.0f;
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      const unsigned msk = sub ? m1 : (~m1 & 0xFFFFu);
      int it[16];
      total = total + fit_subset<M, W>(pix, msk, aw, q0[sub], q1[sub],
                                       p0[sub], p1[sub], it);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if ((msk >> i) & 1u) idx[i] = it[i];
    }
    anchor_swaps_2sub<index_prec(M)>(shape, m1, q0, q1, p0, p1, idx);
    keep_if_better(best, total,
                   emit_block<M>(shape, 0, 0, q0, q1, p0, p1, idx, nullptr));
  }
}

// Mode 4 or 5 at index mode 0 from one rotation's shared trajectory
// endpoints (_try_modes45_shared's per-mode part, bc67.py:1564); the alpha
// weight rides the true alpha channel, at rot - 1 after a rotation
template <int M, bool W>
__device__ __forceinline__ void eval_45_mode(const uint32_t prp[16], int rot,
                                             const float e0[4],
                                             const float e1[4], float aw,
                                             Best& best) {
  constexpr int P1 = index_prec(M), P2 = index_prec2(M);
  const int wch = rot ? rot - 1 : 3;
  int q0[1][4], q1[1][4], p0[1], p1[1], u0[4], u1[4], w1[16], w2[16];
  quantize_endpoints<M>(e0, e1, q0[0], q1[0], p0[0], p1[0]);
  unquantize_endpoints<M>(q0[0], q1[0], p0[0], p1[0], u0, u1);
  float err = assign_indices<P1, 0, 3, W>(prp, u0, u1, 0xFFFFu, w1, aw, wch);
  err = err + assign_indices<P2, 3, 4, W>(prp, u0, u1, 0xFFFFu, w2, aw, wch);
  // independent anchor fixes of the two index sets (BC6HBC7.cpp:3196-3216)
  if (w1[0] & (1 << (P1 - 1))) {
#pragma unroll
    for (int i = 0; i < 16; ++i) w1[i] = (1 << P1) - 1 - w1[i];
#pragma unroll
    for (int c = 0; c < 3; ++c) swap_ints(q0[0][c], q1[0][c]);
  }
  if (w2[0] & (1 << (P2 - 1))) {
#pragma unroll
    for (int i = 0; i < 16; ++i) w2[i] = (1 << P2) - 1 - w2[i];
    swap_ints(q0[0][3], q1[0][3]);
  }
  keep_if_better(best, err, emit_block<M>(0, rot, 0, q0, q1, p0, p1, w1, w2));
}

// One rotation's pixels and initial endpoints for modes 4/5: RGB axis fit
// with alpha min/max (_k_rot_data, pallas_kernels.py:1473)
__device__ __forceinline__ void rot_data(const uint32_t pix[16], int rot,
                                         uint32_t prp[16], float e0[4],
                                         float e1[4]) {
  rotate_pixels(pix, rot, prp);
  minmax_axis<false>(prp, 0xFFFFu, e0, e1);
  float amin = 1e9f, amax = -1e9f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    amin = fminf(amin, (float)px_at(prp, i, 3));
    amax = fmaxf(amax, (float)px_at(prp, i, 3));
  }
  e0[3] = amin;
  e1[3] = amax;
}

// Mode 4 or 5 at index mode IM, one rotation's candidate fitted on its own
// (_dual_eval_ref + _try_single_mode's anchor fixes, bc67.py:1387-1502):
// quantize, assign colour at CP and alpha at AP bits, one LS refit per
// group from the integer indices, re-evaluate, keep the better (strict
// `<`), independent colour / alpha anchor fixes, emit
template <int M, int IM, bool W>
__device__ __forceinline__ void eval_45_own(const uint32_t prp[16], int rot,
                                            const float e0f[4],
                                            const float e1f[4], float aw,
                                            Best& best) {
  constexpr int P1 = index_prec(M), P2 = index_prec2(M);
  constexpr int CP = IM ? P2 : P1, AP = IM ? P1 : P2;
  const int wch = rot ? rot - 1 : 3;
  int q0[1][4], q1[1][4], p0[1], p1[1], u0[4], u1[4], ci[16], ai[16];
  quantize_endpoints<M>(e0f, e1f, q0[0], q1[0], p0[0], p1[0]);
  unquantize_endpoints<M>(q0[0], q1[0], p0[0], p1[0], u0, u1);
  float err = assign_indices<CP, 0, 3, W>(prp, u0, u1, 0xFFFFu, ci, aw, wch);
  err = err + assign_indices<AP, 3, 4, W>(prp, u0, u1, 0xFFFFu, ai, aw, wch);

  float e0[4], e1[4], x[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    e0[c] = e0f[c];
    e1[c] = e1f[c];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = (float)pal_weight<1 << CP>(ci[i]) * (1.0f / 64.0f);
  ls_refit<0, 3>(prp, x, 0xFFFFu, e0, e1);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    x[i] = (float)pal_weight<1 << AP>(ai[i]) * (1.0f / 64.0f);
  ls_refit<3, 4>(prp, x, 0xFFFFu, e0, e1);
  int qb0[4], qb1[4], pb0, pb1, cb[16], ab[16];
  quantize_endpoints<M>(e0, e1, qb0, qb1, pb0, pb1);
  unquantize_endpoints<M>(qb0, qb1, pb0, pb1, u0, u1);
  float err_b = assign_indices<CP, 0, 3, W>(prp, u0, u1, 0xFFFFu, cb, aw,
                                            wch);
  err_b = err_b + assign_indices<AP, 3, 4, W>(prp, u0, u1, 0xFFFFu, ab, aw,
                                              wch);
  if (err_b < err) {
    err = err_b;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q0[0][c] = qb0[c];
      q1[0][c] = qb1[c];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      ci[i] = cb[i];
      ai[i] = ab[i];
    }
  }
  int* w1 = IM ? ai : ci;
  int* w2 = IM ? ci : ai;
  anchor_swaps_45<P1, P2>(IM == 0, w1, w2, q0[0], q1[0]);
  keep_if_better(best, err, emit_block<M>(0, rot, IM, q0, q1, p0, p1, w1, w2));
}

// The maxq tier's search (_bc7_all_kernel with share2sub=False,
// share45=False, m4_ims=(0, 1)): each mode's candidates in a loop of its
// own, then the fold in the order (1, 3, 5, 6, [7,] 4)
template <bool ALPHA, bool W>
__device__ __forceinline__ Best search_maxq(const uint32_t pix[16],
                                            float aw) {
  bool has_alpha = false;
  if (ALPHA) {
#pragma unroll
    for (int i = 0; i < 16; ++i) has_alpha |= (pix[i] >> 24) != 0xFFu;
  }
  int cand[4];
  shape_top4(pix, cand);
  Best best1{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int k = 0; k < 4; ++k)
    eval_partition<1, W>(pix, cand[k], subset1_mask(cand[k]), aw, best1);
  Best best3{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int k = 0; k < 4; ++k)
    eval_partition<3, W>(pix, cand[k], subset1_mask(cand[k]), aw, best3);

  const Best best6 = eval_mode6<W>(pix, aw);

  Best best5{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int rot = 0; rot < 4; ++rot) {
    uint32_t prp[16];
    float e0[4], e1[4];
    rot_data(pix, rot, prp, e0, e1);
    eval_45_own<5, 0, W>(prp, rot, e0, e1, aw, best5);
  }
  Best best4{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int rot = 0; rot < 4; ++rot) {
    uint32_t prp[16];
    float e0[4], e1[4];
    rot_data(pix, rot, prp, e0, e1);
    eval_45_own<4, 0, W>(prp, rot, e0, e1, aw, best4);
    eval_45_own<4, 1, W>(prp, rot, e0, e1, aw, best4);
  }

  Best best7{INFINITY, {0ull, 0ull}};
  if (ALPHA && has_alpha) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k)
      eval_partition<7, W>(pix, cand[k], subset1_mask(cand[k]), aw, best7);
  }

  Best fold{INFINITY, {0ull, 0ull}};
  keep_if_better(fold, best1.err, best1.w);
  keep_if_better(fold, best3.err, best3.w);
  keep_if_better(fold, best5.err, best5.w);
  keep_if_better(fold, best6.err, best6.w);
  if (ALPHA) keep_if_better(fold, best7.err, best7.w);
  keep_if_better(fold, best4.err, best4.w);
  return fold;
}

template <int V, bool W>
__global__ void __launch_bounds__(kThreads)
    bc7_encode_kernel(const int32_t* __restrict__ px, float* __restrict__ err,
                      uint32_t* __restrict__ words, int nb, float aw) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t pix[16];
  load_pixels(px, nb, b, pix);

  if (V == kQuick) {
    const Best best6 = eval_mode6<W>(pix, aw);
    err[b] = best6.err;
    store_words(words, nb, b, best6.w);
    return;
  }

  if (V == kMaxq || V == kMaxqAlpha) {
    const Best best = search_maxq<V == kMaxqAlpha, W>(pix, aw);
    err[b] = best.err;
    store_words(words, nb, b, best.w);
    return;
  }

  // mode 7 only where some texel's alpha is below 255
  bool has_alpha = false;
  if (V == kAlpha) {
#pragma unroll
    for (int i = 0; i < 16; ++i) has_alpha |= (pix[i] >> 24) != 0xFFu;
  }

  // modes 1 and 3: top-4 shapes, one shared float trajectory each
  int cand[4];
  shape_top4(pix, cand);
  Best best1{INFINITY, {0ull, 0ull}}, best3{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const int shape = cand[k];
    const unsigned m1 = subset1_mask(shape);
    float se0[2][4], se1[2][4];
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      const unsigned msk = sub ? m1 : (~m1 & 0xFFFFu);
      float idxf[16];
      minmax_axis<false>(pix, msk, se0[sub], se1[sub]);
      float_assign<3, 0, 3>(pix, se0[sub], se1[sub], idxf);   // IPREC 3
      ls_refit_f<3, 0, 3>(pix, idxf, msk, se0[sub], se1[sub]);
    }
    eval_2sub_mode<1, W>(pix, shape, m1, se0, se1, aw, best1);
    eval_2sub_mode<3, W>(pix, shape, m1, se0, se1, aw, best3);
  }

  const Best best6 = eval_mode6<W>(pix, aw);

  // modes 4 and 5: four rotations, one shared float trajectory each
  Best best4{INFINITY, {0ull, 0ull}}, best5{INFINITY, {0ull, 0ull}};
#pragma unroll 1
  for (int rot = 0; rot < 4; ++rot) {
    uint32_t prp[16];
    float e0[4], e1[4], cidx[16], aidx[16];
    rot_data(pix, rot, prp, e0, e1);
    float_assign<2, 0, 3>(prp, e0, e1, cidx);
    float_assign<3, 3, 4>(prp, e0, e1, aidx);
    ls_refit_f<2, 0, 3>(prp, cidx, 0xFFFFu, e0, e1);
    ls_refit_f<3, 3, 4>(prp, aidx, 0xFFFFu, e0, e1);
    eval_45_mode<4, W>(prp, rot, e0, e1, aw, best4);
    eval_45_mode<5, W>(prp, rot, e0, e1, aw, best5);
  }

  // mode 7 on modes 1/3's shapes, each fitted on its own. It runs last:
  // placed inside the shape loop above, where the shared trajectories'
  // state is live, it spilled more and ran markedly slower on the H100.
  Best best7{INFINITY, {0ull, 0ull}};
  if (V == kAlpha && has_alpha) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k)
      eval_partition<7, W>(pix, cand[k], subset1_mask(cand[k]), aw,
                              best7);
  }

  // cross-mode fold in the order (1, 3, 5, 6, [7,] 4), strict `<`
  Best fold{INFINITY, {0ull, 0ull}};
  keep_if_better(fold, best1.err, best1.w);
  keep_if_better(fold, best3.err, best3.w);
  keep_if_better(fold, best5.err, best5.w);
  keep_if_better(fold, best6.err, best6.w);
  if (V == kAlpha) keep_if_better(fold, best7.err, best7.w);
  keep_if_better(fold, best4.err, best4.w);
  err[b] = fold.err;
  store_words(words, nb, b, fold.w);
}

// Host launcher of variant V: alpha_weight arrives as its f32 bit pattern;
// at 1.0 the unweighted instance runs.
template <int V>
int launch_encode(const void* px, void* err, void* words, int nb,
                  int aw_bits, void* stream) {
  float aw;
  std::memcpy(&aw, &aw_bits, sizeof aw);
  const int grid = (nb + kThreads - 1) / kThreads;
  if (aw != 1.0f)
    bc7_encode_kernel<V, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)px, (float*)err, (uint32_t*)words, nb, aw);
  else
    bc7_encode_kernel<V, false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)px, (float*)err, (uint32_t*)words, nb, aw);
  return (int)cudaGetLastError();
}

}  // namespace bc7
