// K2 — the whole BC7 search of one tier: the opaque variant as a team of
// four warps per 32 blocks (below, bc7_encode_opaque_kernel), the others
// one thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc7_encode_pallas /
// _bc7_all_kernel, in three variants, each a template instance built from
// its own source:
//   kOpaque (bc7_encode.cu)       modes (1, 3, 5, 6, 4), the default tier
//                                 (share2sub, share45, m4_ims=(0,));
//   kQuick  (bc7_encode_quick.cu) mode 6 alone (the QUICK tier);
//   kMaxq   (bc7_encode_maxq.cu)  modes (1, 3, 5, 6, 4), the maxq tier
//                                 (share2sub=False, share45=False,
//                                 m4_ims=(0, 1)).
// The searches with mode 7, (1, 3, 5, 6, 7, 4) in either tier, are the
// kOpaque or kMaxq search, which also writes the top-4 two-subset shapes
// it ranked, then mode 7 on those shapes over the blocks with alpha and a
// fold (bc7_mode7.cu).
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
//   - the cross-mode fold in list order with a strict `<`. Each mode keeps
//     its own running best over its candidates, so the fold runs in the
//     twin's order whatever order the modes were evaluated in.
// The TPU evaluated every lane through where-chains over [16, T] planes;
// here each block is one thread's scalar program (split over four warps'
// phases in the opaque variant). The TPU kernel fixes the mode-4/5
// anchors once, on the fold winner (_k_mode45_finish); this kernel fixes
// and emits every candidate as the jnp twin does. A fix moves no error, so
// the winner and its words are the same.
//
// Bound: compute. A block reads 64 bytes and writes 20, against roughly
// 10^5 integer and f32 operations, so the kernel is limited by issue rate
// and by registers. In the one-thread variants the per-thread state (16
// packed pixels, 16 centred pixel vectors during ranking, 16 indices,
// endpoints) spills past 255 registers into local memory, which the L1
// cache serves. The design keeps pixels packed as RGBA8 words (16
// registers for the block), recomputes cross moments instead of holding
// them, keeps the top-4 shapes in a compare-swap chain, and loops over
// shapes, candidates and rotations without unrolling to bound code size
// and build time. The maxq variants run each mode's candidates as a loop
// of its own, after the others, so that only one mode's fit state is live
// at a time. The opaque team kernel stages pixels and centred pixels in
// shared memory and gives each warp one phase's slice at a time, so that
// its state fits 128 registers.
//
// Built with --fmad=false: every float step rounds as the plain twin's
// separate torch ops do, so kernel and twin pick the same words.
#pragma once

#include <cstring>

#include "bc7_common.cuh"

namespace bc7 {

enum Variant { kOpaque, kQuick, kMaxq };

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

// A block's 11 moment terms of pixel i, as the shape ranking sums them:
// |xc|^2, xc (4 channels) and the RGB cross products xc_a * xc_b (a <= b),
// xc the pixel less the block's mean. MomentsRegs computes them from a
// thread's centred pixels; the opaque search's team reads them staged in
// shared memory (MomentsShared below). fence() ends one shape's reads.
struct MomentsRegs {
  const float (*xc)[4];
  const float* q;
  __device__ __forceinline__ void fence() const {}
  __device__ __forceinline__ void operator()(int i, float v[11]) const {
    const float x0 = xc[i][0], x1 = xc[i][1], x2 = xc[i][2], x3 = xc[i][3];
    v[0] = q[i];
    v[1] = x0;
    v[2] = x1;
    v[3] = x2;
    v[4] = x3;
    v[5] = x0 * x0;
    v[6] = x0 * x1;
    v[7] = x0 * x2;
    v[8] = x1 * x1;
    v[9] = x1 * x2;
    v[10] = x2 * x2;
  }
};

// The block's mean per channel, summed in pixel order
// (_shape_estimates_table's mu)
__device__ __forceinline__ void block_mean(const uint32_t pix[16],
                                           float mu[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s = s + (float)px_at(pix, i, c);
    mu[c] = s * (1.0f / 16.0f);
  }
}

// Centred pixels and their squared norms (_shape_estimates_table's xc
// and q)
__device__ __forceinline__ void shape_moments(const uint32_t pix[16],
                                              float xc[16][4], float q[16]) {
  float mu[4];
  block_mean(pix, mu);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) xc[i][c] = (float)px_at(pix, i, c) - mu[c];
    float s = xc[i][0] * xc[i][0];
    s = s + xc[i][1] * xc[i][1];
    s = s + xc[i][2] * xc[i][2];
    q[i] = s + xc[i][3] * xc[i][3];
  }
}

// The off-axis estimate of the shapes first, first + STRIDE, ... below
// last with NS subsets, folded into a running top 4 (bv, bi) by
// (estimate, shape): a tie keeps the earlier shape first, as jnp.argmin
// does. Each subset's 11 masked sums run over the 16 pixels in pixel
// order, as the plain twin's masked sums do.
template <int NS, int STRIDE, class Moments>
__device__ __forceinline__ void rank_shapes(const Moments& mom, int first,
                                            int last, float bv[4],
                                            int bi[4]) {
  static_assert(NS == 2 || NS == 3, "two or three subsets");
  const float on_axis = (float)(1.0 - 0.05);   // 1 - _ON_AXIS_W
#pragma unroll 1
  for (int s = first; s < last; s += STRIDE) {
    mom.fence();
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
      float v[11];
      mom(i, v);
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
}

// Off-axis ranking of the first S shapes with NS subsets
// (_shape_estimates_table(off_axis=True) + _top_k_shapes, bc67.py:1243):
// the 4 shapes of least (estimate, shape), in that order. K9
// (bc7_shapes.cu) ranks any of (2 or 3 subsets) x (16 or 64 shapes), the
// one-thread K2 variants the 64 two-subset shapes; one thread ranks every
// shape of its block.
template <int NS = 2, int S = 64>
__device__ __forceinline__ void shape_top4(const uint32_t pix[16],
                                           int cand[4]) {
  float xc[16][4], q[16];
  shape_moments(pix, xc, q);
  float bv[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  int bi[4] = {0, 0, 0, 0};
  rank_shapes<NS, 1>(MomentsRegs{xc, q}, 0, S, bv, bi);
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

// Modes 1/3's shared float trajectory on one shape candidate
// (_eval_2sub_shared, bc67.py:1128): per subset an axis fit, a K=8 float
// assignment and an LS refit; m1 the pixel mask of subset 1
__device__ __forceinline__ void trajectory_2sub(const uint32_t pix[16],
                                                unsigned m1,
                                                float se0[2][4],
                                                float se1[2][4]) {
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    const unsigned msk = sub ? m1 : (~m1 & 0xFFFFu);
    float idxf[16];
    minmax_axis<false>(pix, msk, se0[sub], se1[sub]);
    float_assign<3, 0, 3>(pix, se0[sub], se1[sub], idxf);   // IPREC 3
    ls_refit_f<3, 0, 3>(pix, idxf, msk, se0[sub], se1[sub]);
  }
}

// Modes 4/5's shared float trajectory of one rotation at index mode 0
// (_k_rot_data + _k_modes45_shared): the rotated pixels and the refitted
// endpoints
__device__ __forceinline__ void trajectory_45(const uint32_t pix[16],
                                              int rot, uint32_t prp[16],
                                              float e0[4], float e1[4]) {
  float cidx[16], aidx[16];
  rot_data(pix, rot, prp, e0, e1);
  float_assign<2, 0, 3>(prp, e0, e1, cidx);
  float_assign<3, 3, 4>(prp, e0, e1, aidx);
  ls_refit_f<2, 0, 3>(prp, cidx, 0xFFFFu, e0, e1);
  ls_refit_f<3, 3, 4>(prp, aidx, 0xFFFFu, e0, e1);
}

// The maxq tier's search (_bc7_all_kernel with share2sub=False,
// share45=False, m4_ims=(0, 1)): each mode's candidates in a loop of its
// own, then the fold in the order (1, 3, 5, 6, 4); the top-4 shapes into
// picks[k * nb + b] where picks is not null
template <bool W>
__device__ __forceinline__ Best search_maxq(const uint32_t pix[16],
                                            float aw,
                                            int32_t* __restrict__ picks,
                                            int nb, int b) {
  int cand[4];
  shape_top4(pix, cand);
  if (picks) {
#pragma unroll
    for (int k = 0; k < 4; ++k) picks[(size_t)k * nb + b] = cand[k];
  }
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

  Best fold{INFINITY, {0ull, 0ull}};
  keep_if_better(fold, best1.err, best1.w);
  keep_if_better(fold, best3.err, best3.w);
  keep_if_better(fold, best5.err, best5.w);
  keep_if_better(fold, best6.err, best6.w);
  keep_if_better(fold, best4.err, best4.w);
  return fold;
}

// The quick and maxq variants: one thread per block. picks (maxq, where
// not null): the top-4 two-subset shapes, [4, NB] in rank order.
template <int V, bool W>
__global__ void __launch_bounds__(kThreads)
    bc7_encode_kernel(const int32_t* __restrict__ px, float* __restrict__ err,
                      uint32_t* __restrict__ words,
                      int32_t* __restrict__ picks, int nb, float aw) {
  static_assert(V == kQuick || V == kMaxq,
                "the opaque search is the team kernel's");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  uint32_t pix[16];
  load_pixels(px, nb, b, pix);
  const Best best = V == kQuick ? eval_mode6<W>(pix, aw)
                                 : search_maxq<W>(pix, aw, picks, nb, b);
  err[b] = best.err;
  store_words(words, nb, b, best.w);
}

// ---------------------------------------------------------------------------
// The opaque search as a team: a CTA of four warps searches 32 blocks, one
// per lane, and warp w runs slice w of each phase for all 32:
//   1. the CTA stages the blocks' pixels in shared memory (packed RGBA8,
//      64 bytes a block), then each pixel's 11 moment terms (warp w
//      pixels 4w..4w+3 of every block);
//   2. warp w ranks shapes w, w + 4, ..., w + 60 and keeps a local top 4
//      by (estimate, shape);
//   3. every warp merges the four local lists by the same total order
//      (the lower shape first on an equal estimate: shape_top4's and
//      _top_k_shapes's tie rule), which gives the one-thread ranking's
//      cand[0..3] exactly (written to picks[w] where picks is not null,
//      for mode 7's launch); warp w runs candidate rank w (both subset
//      trajectories, then modes 1 and 3) and rotation w (modes 4 and 5);
//      the last warp also runs mode 6. Each result goes to shared memory,
//      over the moment terms, which no warp reads after the ranking;
//   4. warp 0 folds each block's results, lane by lane: per mode over the
//      candidates and the rotations in rank order, then over the modes in
//      the order (1, 3, 5, 6, 4), with keep_if_better's strict `<`.
// At any step all 32 lanes of a warp are on the same shape, candidate rank
// or rotation, so control flow stays uniform in the warp and c_pp2[s]
// stays a broadcast. The per-shape arithmetic, the trajectories and the
// per-mode evaluations are the one-thread search's, in the same operation
// order, so the words and errors are the plain twin's.
//
// Registers: the kernel is held to 128 a thread, 16 warps an SM, where
// the one-thread kernel held 8 at 255. The ranking reads its moment terms
// from shared memory anew for each shape (MomentsShared's fence): hoisted
// out of the shape loop, the loads held 80 registers and the ranking
// spilled. Fenced, it needs 56. The evaluation phase needs more than 128
// and spills (ptxas, PERF.md), which is what holds the kernel back.
// ---------------------------------------------------------------------------
constexpr int kTeamBlocks = 32;                 // blocks per CTA, one a lane
constexpr int kTeamWarps = kThreads / 32;       // slices of each phase
static_assert(kTeamWarps == 4, "four candidate ranks and four rotations");

// result slots of a block: modes 1 and 3 per candidate rank, 5 and 4 per
// rotation, mode 6
enum TeamSlot { kSlot1 = 0, kSlot3 = 4, kSlot5 = 8, kSlot4 = 12,
                kSlot6 = 16, kSlots = 17 };

struct TeamSmem {
  uint32_t pix[16][kTeamBlocks];                // packed RGBA8
  float top_est[kTeamWarps][4][kTeamBlocks];    // each warp's local top 4
  int top_shape[kTeamWarps][4][kTeamBlocks];
  // the ranking's moment terms, then, after the ranking's barrier, the
  // evaluations' results
  union {
    float4 mom[16][3][kTeamBlocks];             // 11 moment terms a pixel
    struct {
      float err[kSlots][kTeamBlocks];
      uint32_t w[kSlots][4][kTeamBlocks];
    } res;
  };
};

// the staged moment terms of lane `lane`'s block, as rank_shapes reads
// them. The fence (a compiler memory barrier) makes each shape load them
// anew: hoisted out of the shape loop, they would hold 80 registers.
struct MomentsShared {
  const TeamSmem* sm;
  int lane;
  __device__ __forceinline__ void fence() const {
    asm volatile("" ::: "memory");
  }
  __device__ __forceinline__ void operator()(int i, float v[11]) const {
    const float4 a = sm->mom[i][0][lane], b = sm->mom[i][1][lane],
                 c = sm->mom[i][2][lane];
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
    v[4] = b.x;
    v[5] = b.y;
    v[6] = b.z;
    v[7] = b.w;
    v[8] = c.x;
    v[9] = c.y;
    v[10] = c.z;
  }
};

// Phase 1a: pixel j of block b0 + l into pix[j][l]; a lane past the last
// block stages zeros (its results are never stored)
__device__ __forceinline__ void team_stage_pixels(
    TeamSmem& sm, const int32_t* __restrict__ px, int nb, int b0, int tid) {
#pragma unroll
  for (int r = 0; r < 16 * kTeamBlocks / kThreads; ++r) {
    const int slot = r * kThreads + tid;
    const int i = slot / kTeamBlocks, l = slot % kTeamBlocks;
    const int b = b0 + l;
    uint32_t v = 0;
    if (b < nb) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v |= ((uint32_t)px[(i * 4 + c) * nb + b] & 0xFFu) << (8 * c);
    }
    sm.pix[i][l] = v;
  }
}

// Phase 1b: the moment terms of pixels 4w..4w+3 of lane `lane`'s block
// (the mean over all 16, as shape_moments takes it)
__device__ __forceinline__ void team_moments(TeamSmem& sm, int warp,
                                             int lane) {
  uint32_t pix[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) pix[i] = sm.pix[i][lane];
  float mu[4];
  block_mean(pix, mu);
#pragma unroll
  for (int j = 0; j < 16 / kTeamWarps; ++j) {
    const int i = warp * (16 / kTeamWarps) + j;
    float x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = (float)px_at(pix, i, c) - mu[c];
    float s = x[0] * x[0];
    s = s + x[1] * x[1];
    s = s + x[2] * x[2];
    s = s + x[3] * x[3];
    sm.mom[i][0][lane] = make_float4(s, x[0], x[1], x[2]);
    sm.mom[i][1][lane] = make_float4(x[3], x[0] * x[0], x[0] * x[1],
                                     x[0] * x[2]);
    sm.mom[i][2][lane] = make_float4(x[1] * x[1], x[1] * x[2], x[2] * x[2],
                                     0.0f);
  }
}

// Phase 2: warp w's slice of the 64 two-subset shapes
__device__ __forceinline__ void team_rank(TeamSmem& sm, int warp, int lane) {
  float bv[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  int bi[4] = {0, 0, 0, 0};
  rank_shapes<2, kTeamWarps>(MomentsShared{&sm, lane}, warp, 64, bv, bi);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sm.top_est[warp][k][lane] = bv[k];
    sm.top_shape[warp][k][lane] = bi[k];
  }
}

// (e1, s1) before (e2, s2) in the ranking's total order
__device__ __forceinline__ bool rank_before(float e1, int s1, float e2,
                                            int s2) {
  return e1 < e2 || (e1 == e2 && s1 < s2);
}

// The merged rank `k` shape of lane `lane`'s block
__device__ __forceinline__ int team_candidate(const TeamSmem& sm, int k,
                                              int lane) {
  float bv[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  int bi[4] = {64, 64, 64, 64};
#pragma unroll
  for (int w = 0; w < kTeamWarps; ++w) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float e = sm.top_est[w][j][lane];
      const int s = sm.top_shape[w][j][lane];
      if (rank_before(e, s, bv[3], bi[3])) {
        bv[3] = e;
        bi[3] = s;
#pragma unroll
        for (int t = 2; t >= 0; --t) {
          if (rank_before(bv[t + 1], bi[t + 1], bv[t], bi[t])) {
            const float f = bv[t];
            bv[t] = bv[t + 1];
            bv[t + 1] = f;
            swap_ints(bi[t], bi[t + 1]);
          }
        }
      }
    }
  }
  return k == 0 ? bi[0] : k == 1 ? bi[1] : k == 2 ? bi[2] : bi[3];
}

__device__ __forceinline__ void team_put(TeamSmem& sm, int slot, int lane,
                                         const Best& r) {
  sm.res.err[slot][lane] = r.err;
  sm.res.w[slot][0][lane] = (uint32_t)r.w.lo;
  sm.res.w[slot][1][lane] = (uint32_t)(r.w.lo >> 32);
  sm.res.w[slot][2][lane] = (uint32_t)r.w.hi;
  sm.res.w[slot][3][lane] = (uint32_t)(r.w.hi >> 32);
}

__device__ __forceinline__ Best team_get(const TeamSmem& sm, int slot,
                                         int lane) {
  Best r;
  r.err = sm.res.err[slot][lane];
  r.w.lo = (unsigned long long)sm.res.w[slot][0][lane]
         | ((unsigned long long)sm.res.w[slot][1][lane] << 32);
  r.w.hi = (unsigned long long)sm.res.w[slot][2][lane]
         | ((unsigned long long)sm.res.w[slot][3][lane] << 32);
  return r;
}

// Phase 3: candidate rank w (modes 1 and 3), rotation w (modes 4 and 5)
// and, on the last warp, mode 6; rank w's shape into picks[w] where picks
// is not null
template <bool W>
__device__ __forceinline__ void team_eval(TeamSmem& sm, int warp, int lane,
                                          float aw,
                                          int32_t* __restrict__ picks,
                                          int nb, int b0) {
  uint32_t pix[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) pix[i] = sm.pix[i][lane];
  {
    const int shape = team_candidate(sm, warp, lane);
    if (picks && b0 + lane < nb)
      picks[(size_t)warp * nb + b0 + lane] = shape;
    const unsigned m1 = subset1_mask(shape);
    float se0[2][4], se1[2][4];
    trajectory_2sub(pix, m1, se0, se1);
    Best r1{INFINITY, {0ull, 0ull}}, r3{INFINITY, {0ull, 0ull}};
    eval_2sub_mode<1, W>(pix, shape, m1, se0, se1, aw, r1);
    team_put(sm, kSlot1 + warp, lane, r1);
    eval_2sub_mode<3, W>(pix, shape, m1, se0, se1, aw, r3);
    team_put(sm, kSlot3 + warp, lane, r3);
  }
  {
    const int rot = warp;
    uint32_t prp[16];
    float e0[4], e1[4];
    trajectory_45(pix, rot, prp, e0, e1);
    Best r4{INFINITY, {0ull, 0ull}}, r5{INFINITY, {0ull, 0ull}};
    eval_45_mode<4, W>(prp, rot, e0, e1, aw, r4);
    team_put(sm, kSlot4 + rot, lane, r4);
    eval_45_mode<5, W>(prp, rot, e0, e1, aw, r5);
    team_put(sm, kSlot5 + rot, lane, r5);
  }
  if (warp == kTeamWarps - 1) team_put(sm, kSlot6, lane, eval_mode6<W>(pix, aw));
}

// Phase 4: lane `lane`'s fold, stored for a block below nb
__device__ __forceinline__ void team_fold(const TeamSmem& sm, int lane,
                                          float* __restrict__ err,
                                          uint32_t* __restrict__ words,
                                          int nb, int b0) {
  Best best1{INFINITY, {0ull, 0ull}}, best3{INFINITY, {0ull, 0ull}};
  Best best4{INFINITY, {0ull, 0ull}}, best5{INFINITY, {0ull, 0ull}};
#pragma unroll
  for (int k = 0; k < kTeamWarps; ++k) {
    Best r = team_get(sm, kSlot1 + k, lane);
    keep_if_better(best1, r.err, r.w);
    r = team_get(sm, kSlot3 + k, lane);
    keep_if_better(best3, r.err, r.w);
    r = team_get(sm, kSlot5 + k, lane);
    keep_if_better(best5, r.err, r.w);
    r = team_get(sm, kSlot4 + k, lane);
    keep_if_better(best4, r.err, r.w);
  }
  const Best best6 = team_get(sm, kSlot6, lane);
  Best fold{INFINITY, {0ull, 0ull}};
  keep_if_better(fold, best1.err, best1.w);
  keep_if_better(fold, best3.err, best3.w);
  keep_if_better(fold, best5.err, best5.w);
  keep_if_better(fold, best6.err, best6.w);
  keep_if_better(fold, best4.err, best4.w);
  const int b = b0 + lane;
  if (b < nb) {
    err[b] = fold.err;
    store_words(words, nb, b, fold.w);
  }
}

template <bool W>
__global__ void __launch_bounds__(kThreads, 4)
    bc7_encode_opaque_kernel(const int32_t* __restrict__ px,
                             float* __restrict__ err,
                             uint32_t* __restrict__ words,
                             int32_t* __restrict__ picks, int nb, float aw) {
  __shared__ TeamSmem sm;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b0 = blockIdx.x * kTeamBlocks;
  team_stage_pixels(sm, px, nb, b0, tid);
  __syncthreads();
  team_moments(sm, warp, lane);
  __syncthreads();
  team_rank(sm, warp, lane);
  __syncthreads();
  team_eval<W>(sm, warp, lane, aw, picks, nb, b0);
  __syncthreads();
  if (warp == 0) team_fold(sm, lane, err, words, nb, b0);
}

// Host launcher of variant V: alpha_weight arrives as its f32 bit pattern;
// at 1.0 the unweighted instance runs. picks: [4, NB] int32 or null (the
// opaque and maxq variants write their top-4 shapes there).
template <int V>
int launch_encode(const void* px, void* err, void* words, void* picks,
                  int nb, int aw_bits, void* stream) {
  float aw;
  std::memcpy(&aw, &aw_bits, sizeof aw);
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* p = (const int32_t*)px;
  float* e = (float*)err;
  uint32_t* w = (uint32_t*)words;
  int32_t* k = (int32_t*)picks;
  if constexpr (V == kOpaque) {
    const int grid = (nb + kTeamBlocks - 1) / kTeamBlocks;
    if (aw != 1.0f)
      bc7_encode_opaque_kernel<true><<<grid, kThreads, 0, s>>>(p, e, w, k,
                                                               nb, aw);
    else
      bc7_encode_opaque_kernel<false><<<grid, kThreads, 0, s>>>(p, e, w, k,
                                                                nb, aw);
  } else {
    const int grid = (nb + kThreads - 1) / kThreads;
    if (aw != 1.0f)
      bc7_encode_kernel<V, true><<<grid, kThreads, 0, s>>>(p, e, w, k, nb,
                                                           aw);
    else
      bc7_encode_kernel<V, false><<<grid, kThreads, 0, s>>>(p, e, w, k, nb,
                                                            aw);
  }
  return (int)cudaGetLastError();
}

}  // namespace bc7
