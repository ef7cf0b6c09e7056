// K3 — BC7 winner-refine with the analytic moment ladder (LADDER_MOMENT),
// one thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc7_refine_pallas /
// _bc7_refine_kernel (its _k_refine_2sub and _k_refine_45uni passes, built
// on _k_moment_subset_dyn). Plain twin: bc67._bc7_refine_plain
// (refine_bc7_words with LADDER_MOMENT over modes 1, 3, 5, 4). Each block
// unpacks its own winner from its words, takes the quadratic-model argmin
// of a joint {-1, 0, +1}^2 q-step endpoint move per channel, re-assigns
// indices once and re-emits where the exact error drops. The TPU ran both
// unified family passes on every lane; here a thread branches to its own
// mode's pass only. All moment math is exact in f32 (integers and 64ths),
// so the words equal the plain twin's word for word.
//
// Bound: compute. A block reads 80 bytes and writes 16, against a few
// thousand integer and f32 operations for its one mode. The design keeps
// pixels packed as RGBA8 words and leaves the block's words untouched
// (one copy) where the mode is out of scope or the error does not drop.
#include "bc7_common.cuh"

namespace bc7 {

// Analytic single-step endpoint move of one subset (_moment_channels_t,
// bc67.py:817). q0/q1 move in place; returns the pre-move fixed-index
// error. wk_rgb / wk_a: palette weights of the color and alpha indices.
template <int M>
__device__ __forceinline__ float moment_move(const uint32_t pix[16],
                                             unsigned msk, int q0[4],
                                             int q1[4], int p0, int p1,
                                             const int wk_rgb[16],
                                             const int wk_a[16]) {
  const int p1u = shared_p(M) ? p0 : p1;
  float err0 = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (prec(M, c) == 0) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float d = (float)(px_at(pix, i, c) - 255);
        s = s + (((msk >> i) & 1u) ? d * d : 0.0f);
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
      s = s + (in ? r * r : 0.0f);
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

// Modes 1/3 (_refine_mode_subsets, bc67.py:1685)
template <int M>
__device__ __forceinline__ void refine_2sub(const uint32_t pix[16],
                                            const Bits128& w, Bits128& out,
                                            float& err_new, float& err_old) {
  constexpr int P = index_prec(M);
  int pos = M + 1;
  const int shape = get_bits(w, pos, 6);
  pos += 6;
  int q0[2][4], q1[2][4], p0[2], p1[2], idx[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
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
  for (int sub = 0; sub < 2; ++sub) {
    p0[sub] = shared_p(M) ? pb[sub] : pb[2 * sub];
    p1[sub] = shared_p(M) ? pb[sub] : pb[2 * sub + 1];
  }
  const int anchor = c_pa2[shape] & 0xF;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int n = P - ((i == 0 || i == anchor) ? 1 : 0);
    idx[i] = get_bits(w, pos, n);
    pos += n;
  }

  const unsigned m1 = subset1_mask(shape);
  int wk[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) wk[i] = pal_weight<1 << P>(idx[i]);
  err_new = 0.0f;
  err_old = 0.0f;
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    const unsigned msk = sub ? m1 : (~m1 & 0xFFFFu);
    int q0t[4], q1t[4], u0[4], u1[4], it[16];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q0t[c] = q0[sub][c];
      q1t[c] = q1[sub][c];
    }
    const float err0 =
        moment_move<M>(pix, msk, q0t, q1t, p0[sub], p1[sub], wk, wk);
    unquantize_endpoints<M>(q0t, q1t, p0[sub], p1[sub], u0, u1);
    const float err_t = assign_indices<P, 0, 4>(pix, u0, u1, msk, it);
    if (err_t < err0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        q0[sub][c] = q0t[c];
        q1[sub][c] = q1t[c];
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if ((msk >> i) & 1u) idx[i] = it[i];
    }
    err_new = err_new + fminf(err_t, err0);
    err_old = err_old + err0;
  }
  // anchor swaps (AssignIndices, BC6HBC7.cpp:3181-3194)
#pragma unroll
  for (int sub = 0; sub < 2; ++sub) {
    int a = idx[0];
    if (sub) {
#pragma unroll
      for (int i = 1; i < 16; ++i)
        if (i == anchor) a = idx[i];
    }
    if (a & (1 << (P - 1))) {
#pragma unroll
      for (int c = 0; c < 4; ++c) swap_ints(q0[sub][c], q1[sub][c]);
      swap_ints(p0[sub], p1[sub]);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (((m1 >> i) & 1u) == (unsigned)sub) idx[i] = (1 << P) - 1 - idx[i];
    }
  }
  out = emit_block<M>(shape, 0, 0, q0, q1, p0, p1, idx, nullptr);
}

// Modes 4/5 (_refine_mode45, bc67.py:1765)
template <int M>
__device__ __forceinline__ void refine_45(const uint32_t pix[16],
                                          const Bits128& w, Bits128& out,
                                          float& err_new, float& err_old) {
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
  const float err0 = moment_move<M>(prp, 0xFFFFu, q0t, q1t, 0, 0, wkc, wka);
  unquantize_endpoints<M>(q0t, q1t, 0, 0, u0, u1);
  float err_t;
  if (im0) {
    err_t = assign_indices<P1, 0, 3>(prp, u0, u1, 0xFFFFu, ct);
    err_t = err_t + assign_indices<P2, 3, 4>(prp, u0, u1, 0xFFFFu, at);
  } else {
    err_t = assign_indices<P2, 0, 3>(prp, u0, u1, 0xFFFFu, ct);
    err_t = err_t + assign_indices<P1, 3, 4>(prp, u0, u1, 0xFFFFu, at);
  }
  if (err_t < err0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q0[0][c] = q0t[c];
      q1[0][c] = q1t[c];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      cidx[i] = ct[i];
      aidx[i] = at[i];
    }
  }
  err_new = fminf(err_t, err0);
  err_old = err0;

  // independent anchor fixes (AssignIndices, BC6HBC7.cpp:3196-3216)
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    w1[i] = im0 ? cidx[i] : aidx[i];
    w2[i] = im0 ? aidx[i] : cidx[i];
  }
  const bool swap1 = w1[0] & (1 << (P1 - 1));
  const bool swap2 = w2[0] & (1 << (P2 - 1));
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (swap1) w1[i] = (1 << P1) - 1 - w1[i];
    if (swap2) w2[i] = (1 << P2) - 1 - w2[i];
  }
  const bool swap_rgb = im0 ? swap1 : swap2;
  const bool swap_a = im0 ? swap2 : swap1;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < 3 ? swap_rgb : swap_a) swap_ints(q0[0][c], q1[0][c]);
  out = emit_block<M>(0, rot, im, q0, q1, p0, p1, w1, w2);
}

__global__ void __launch_bounds__(kThreads)
    bc7_refine_kernel(const int32_t* __restrict__ px,
                      const uint32_t* __restrict__ words_in,
                      uint32_t* __restrict__ words_out, int nb,
                      int mode_mask) {
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
      case 1: refine_2sub<1>(pix, w, nw, err_new, err_old); break;
      case 3: refine_2sub<3>(pix, w, nw, err_new, err_old); break;
      case 4: refine_45<4>(pix, w, nw, err_new, err_old); break;
      case 5: refine_45<5>(pix, w, nw, err_new, err_old); break;
      default: break;
    }
    if (err_new < err_old) out = nw;
  }
  store_words(words_out, nb, b, out);
}

}  // namespace bc7

extern "C" int bc7_refine_launch(const void* px, const void* words_in,
                                 void* words_out, int nb, int mode_mask,
                                 void* stream) {
  const int grid = (nb + bc7::kThreads - 1) / bc7::kThreads;
  bc7::bc7_refine_kernel<<<grid, bc7::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const uint32_t*)words_in, (uint32_t*)words_out, nb,
      mode_mask);
  return (int)cudaGetLastError();
}
