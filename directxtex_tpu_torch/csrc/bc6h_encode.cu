// K5 — the whole BC6H shared-fit search, one thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_encode_pallas /
// _bc6h_all_kernel (BC6H_SHARED_FIT, keep-better off). Plain twin:
// bc6h._bc6h_search_plain (the JAX package's jnp search), step for step
// and in the same operation order:
//   - rows 10-13: one precision-free float trajectory over the block
//     (min/max box, float assignment at 16 levels, 3 LS rounds), then per
//     row a quantize + exact rescore, one quantized LS refit below 11 bits
//     of endpoint precision, anchor swap, delta fit and emit;
//   - off-axis ranking of the 32 two-region shapes (axis_w = 0, three
//     power iterations) and the top 4 by (estimate, shape) — shape_top4,
//     bc6h_shapes.cuh;
//   - per candidate, one trajectory per region, then per precision group
//     (rows {0} {1} {2,3,4} {5} {6,7,8} {9}) one rescore shared by the
//     group's rows, each of which applies its own delta fit and emit.
// The twin folds rows 10-13, then rows 0-9 with candidates in rank order,
// strict `<`; this kernel walks candidates outermost (to keep one
// candidate's trajectories in registers) and folds on (error, position in
// the twin's order), which picks the same winner.
//
// Bound: operations. A block needs 96 bytes in (48 halves; read here as
// int32) and 16 out, against about 174,000 elementwise operations of the
// search (tests/test_torch_op_counts.py); the per-thread dependence
// chains (16-pixel sums in order, LS solves, power iteration) set the
// pace. The design stages the 48 pixels in shared memory as int16
// (12 KB per 128 threads) so the candidate, group and row loops stay
// rolled and registers hold only endpoints and packed 4-bit indices.
//
// Built with --fmad=false: every float step rounds as the plain twin's
// separate torch ops do, so kernel and twin pick the same words.
#include "bc6h_shapes.cuh"

namespace bc6h {

// Float-endpoint palette assignment of the masked pixels
// (_bc6h_palette_err_f with score=False)
template <int K>
__device__ __forceinline__ unsigned long long float_assign(const Px& px,
                                                           unsigned msk,
                                                           const float e0[3],
                                                           const float e1[3]) {
  float e[3];
  float span = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e[c] = e1[c] - e0[c];
    span = span + e[c] * e[c];
  }
  const float s64 = 64.0f / (span > 0.0f ? span : 1.0f);
  unsigned long long idx = 0ull;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    if (!((msk >> i) & 1u)) continue;
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) dot = dot + (px.f(c, i) - e0[c]) * e[c];
    const float p64 = fminf(fmaxf(dot * s64, 0.0f), 64.0f);
    const float kf = fminf(fmaxf(rintf(p64 * (float)((K - 1) / 64.0)), 0.0f),
                           K - 1.0f);
    const float wk = pal_weight_f<K>(kf);
    const float wkp = pal_weight_f<K>(fminf(kf + 1.0f, K - 1.0f));
    const float wkm = pal_weight_f<K>(fmaxf(kf - 1.0f, 0.0f));
    const bool up = kf < K - 1 && 2.0f * p64 > wk + wkp;
    const bool dn = kf > 0 && 2.0f * p64 < wk + wkm;
    idx_set(idx, i, (int)(up ? kf + 1.0f : (dn ? kf - 1.0f : kf)));
  }
  return idx;
}

// One precision-free fit trajectory of a subset (_bc6h_shared_fit)
template <int K>
__device__ __forceinline__ void shared_fit(const Px& px, unsigned msk,
                                           bool sgn, float e0[3],
                                           float e1[3]) {
  float cap[3];
  mag_cap(px, msk, e0, e1, cap);
  unsigned long long idx = float_assign<K>(px, msk, e0, e1);
#pragma unroll 1
  for (int r = 0; r < 3; ++r) {   // BC6H_SHARED_ROUNDS
    ls_refit<K, false>(px, msk, idx, cap, sgn, e0, e1);
    if (r < 2) idx = float_assign<K>(px, msk, e0, e1);
  }
}

// One subset of _bc6h_group_rescore: quantize the trajectory endpoints at
// precision prec_w, rescore exactly, and below BC6H_GROUP_REFIT_MINPREC
// one quantized-domain LS round kept where it scores lower. Writes the
// subset's pixels of idx; returns the subset error.
template <int K>
__device__ __forceinline__ float rescore_subset(const Px& px, unsigned msk,
                                                bool sgn, int prec_w,
                                                const float e0[3],
                                                const float e1[3], int q0[3],
                                                int q1[3],
                                                unsigned long long& idx) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q0[c] = quantize((int)rintf(e0[c]), prec_w, sgn);
    q1[c] = quantize((int)rintf(e1[c]), prec_w, sgn);
  }
  float err = palette_err_q<K>(px, msk, q0, q1, prec_w, sgn, idx);
  if (prec_w < 11) {
    float mi[3], ma[3], cap[3], r0[3], r1[3];
    mag_cap(px, msk, mi, ma, cap);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r0[c] = e0[c];
      r1[c] = e1[c];
    }
    ls_refit<K, true>(px, msk, idx, cap, sgn, r0, r1);
    int qr0[3], qr1[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      qr0[c] = quantize((int)rintf(r0[c]), prec_w, sgn);
      qr1[c] = quantize((int)rintf(r1[c]), prec_w, sgn);
    }
    unsigned long long idx_r = idx;
    const float err_r = palette_err_q<K>(px, msk, qr0, qr1, prec_w, sgn,
                                         idx_r);
    if (err_r < err) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q0[c] = qr0[c];
        q1[c] = qr1[c];
      }
      idx = idx_r;
    }
    err = fminf(err_r, err);
  }
  return err;
}

struct Best {
  float err;
  int order;   // position of the candidate in the twin's fold order
  Bits128 w;
};

// the twin's strict-`<` fold, independent of visiting order
__device__ __forceinline__ bool beats(const Best& best, float err,
                                      int order) {
  return err < best.err || (err == best.err && order < best.order);
}

__global__ void __launch_bounds__(kThreads)
    bc6h_encode_kernel(const int32_t* __restrict__ px_g,
                       float* __restrict__ err_out,
                       uint32_t* __restrict__ words, int nb, int sgn_i) {
  __shared__ int16_t s_px[48 * kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const bool sgn = sgn_i != 0;
  const Px px = stage_pixels(px_g, nb, b, s_px);
  Best best{INFINITY, -1, {0ull, 0ull}};

  // rows 10-13 off one trajectory over the whole block
  {
    float se0[3], se1[3];
    shared_fit<16>(px, 0xFFFFu, sgn, se0, se1);
#pragma unroll 1
    for (int row = 10; row < 14; ++row) {
      int q[2][2][3] = {}, f[2][2][3];
      unsigned long long idx = 0ull;
      float total = 0.0f;
      total = total + rescore_subset<16>(px, 0xFFFFu, sgn, c_info[row].prec_w,
                                         se0, se1, q[0][0], q[0][1], idx);
      anchor_swap<16>(0xFFFFu, 0, q[0][0], q[0][1], idx);
      const float err = transform_fit(row, sgn, q, f) ? total : INFINITY;
      if (beats(best, err, row - 10)) {
        best.err = err;
        best.order = row - 10;
        best.w = emit(row, 0, f, idx, -1);
      }
    }
  }

  // rows 0-9 over the top 4 shapes
  int cand[4];
  shape_top4(px, cand);
#pragma unroll 1
  for (int k = 0; k < 4; ++k) {
    const int shape = cand[k];
    const unsigned m1 = bc7::subset1_mask(shape);
    const unsigned m0 = ~m1 & 0xFFFFu;
    const int a2 = bc7::c_pa2[shape] & 0xF;
    float s0e0[3], s0e1[3], s1e0[3], s1e1[3];
    shared_fit<8>(px, m0, sgn, s0e0, s0e1);
    shared_fit<8>(px, m1, sgn, s1e0, s1e1);
#pragma unroll 1
    for (int g = 0; g < 6; ++g) {
      const int first = c_group_first[g];
      const int prec_w = c_info[first].prec_w;
      int q[2][2][3];
      unsigned long long idx = 0ull;
      float total = 0.0f;
      total = total + rescore_subset<8>(px, m0, sgn, prec_w, s0e0, s0e1,
                                        q[0][0], q[0][1], idx);
      total = total + rescore_subset<8>(px, m1, sgn, prec_w, s1e0, s1e1,
                                        q[1][0], q[1][1], idx);
      anchor_swap<8>(m0, 0, q[0][0], q[0][1], idx);
      anchor_swap<8>(m1, a2, q[1][0], q[1][1], idx);
#pragma unroll 1
      for (int row = first; row < first + c_group_rows[g]; ++row) {
        int f[2][2][3];
        const float err = transform_fit(row, sgn, q, f) ? total : INFINITY;
        const int order = 4 + 4 * row + k;
        if (beats(best, err, order)) {
          best.err = err;
          best.order = order;
          best.w = emit(row, shape, f, idx, a2);
        }
      }
    }
  }
  err_out[b] = best.err;
  bc7::store_words(words, nb, b, best.w);
}

}  // namespace bc6h

extern "C" int bc6h_encode_launch(const void* px, void* err, void* words,
                                  int nb, int sgn, void* stream) {
  const int grid = (nb + bc6h::kThreads - 1) / bc6h::kThreads;
  bc6h::bc6h_encode_kernel<<<grid, bc6h::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (float*)err, (uint32_t*)words, nb, sgn);
  return (int)cudaGetLastError();
}
