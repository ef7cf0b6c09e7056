// The BC6H shape ranking shared by K5 (bc6h_encode.cu) and its launch of
// its own (bc6h_shapes.cu): the off-axis estimate of each of the 32
// two-region shapes at axis_w = 0 and the top 4 by (estimate, shape).
#pragma once

#include "bc6h_common.cuh"

namespace bc6h {

// Off-axis ranking of the 32 two-region shapes
// (_shape_estimates_table(n_shapes=32, axis_w=0) on RGB plus a zero alpha
// plane, whose terms add exact zeros and are left out) and the 4 shapes
// of least (estimate, shape), in that order
__device__ __forceinline__ void shape_top4(const Px& px, int cand[4]) {
  float mu[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = px.f(c, 0);
#pragma unroll 4
    for (int i = 1; i < 16; ++i) s = s + px.f(c, i);
    mu[c] = s * (1.0f / 16.0f);
  }
  float bv[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
  int bi[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int s = 0; s < 32; ++s) {
    const uint32_t pp = bc7::c_pp2[s];
    // 10 masked 16-pixel sums per subset: |xc|^2, xc (3), RGB cross (6)
    float acc[2][10];
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[0][k] = acc[1][k] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const float x0 = px.f(0, i) - mu[0], x1 = px.f(1, i) - mu[1],
                  x2 = px.f(2, i) - mu[2];
      float q = x0 * x0;
      q = q + x1 * x1;
      q = q + x2 * x2;
      const float v[10] = {q, x0, x1, x2, x0 * x0, x0 * x1,
                           x0 * x2, x1 * x1, x1 * x2, x2 * x2};
      if ((pp >> (2 * i)) & 1u) {
#pragma unroll
        for (int k = 0; k < 10; ++k) acc[1][k] = acc[1][k] + v[k];
      } else {
#pragma unroll
        for (int k = 0; k < 10; ++k) acc[0][k] = acc[0][k] + v[k];
      }
    }
    const int n1 = __popc(bc7::subset1_mask(s));
    float est = 0.0f;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float* sp = acc[p];
      const int n = p ? n1 : 16 - n1;
      const float ninv = 1.0f / (float)max(n, 1);
      float s2 = sp[1] * sp[1];
      s2 = s2 + sp[2] * sp[2];
      s2 = s2 + sp[3] * sp[3];
      const float sse = sp[0] - s2 * ninv;
      float cv[3][3];
      int k = 4;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = a; b < 3; ++b) {
          cv[a][b] = cv[b][a] = sp[k] - sp[1 + a] * sp[1 + b] * ninv;
          ++k;
        }
      }
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
      est = est + fmaxf(sse - lam * 1.0f, 0.0f);   // 1 - axis_w
    }
    // running top 4; a tie keeps the earlier shape first (argmin)
    if (est < bv[3]) {
      bv[3] = est;
      bi[3] = s;
      if (bv[3] < bv[2]) { const float t = bv[2]; bv[2] = bv[3]; bv[3] = t; bc7::swap_ints(bi[2], bi[3]); }
      if (bv[2] < bv[1]) { const float t = bv[1]; bv[1] = bv[2]; bv[2] = t; bc7::swap_ints(bi[1], bi[2]); }
      if (bv[1] < bv[0]) { const float t = bv[0]; bv[0] = bv[1]; bv[1] = t; bc7::swap_ints(bi[0], bi[1]); }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) cand[k] = bi[k];
}

}  // namespace bc6h
