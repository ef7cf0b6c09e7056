// K6 — BC6H winner-refine, one thread per 4x4 block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_refine_pallas /
// _bc6h_refine_kernel (bc67._refine_bc6h_core). Plain twin:
// bc6h._bc6h_refine_plain, step for step and in the same operation order.
// Each thread unpacks its block's winning state (mode row, shape,
// endpoints, stored indices) and runs the quantized-endpoint ladder on it:
//   - one-region winners (rows 10-13) at all four one-region precisions;
//   - two-region winners at their own precision, or with cross2 at every
//     two-region precision group;
// with the re-mapping ladder (remap: every probe re-assigns indices,
// PerturbOne's MapColors) or the fixed-index ladder followed by one
// re-assignment, then the anchor swap, each row's delta fit and emit, and
// a strict-`<` fold against the stored state's error. The TPU ran both
// units on every lane and selected; a thread here runs its own unit only.
// The ladder (rounds, up to 8 deltas), the second unit's ladder, signed,
// remap and cross2 are launch arguments.
//
// Bound: operations. A block needs 112 bytes in and 16 out; the maxq
// refine costs about 0.8 million (one-region winner) to 1.3 million
// (two-region) elementwise operations per block, every probe a full
// re-assignment of the region's pixels (tests/test_torch_op_counts.py).
// The design stages pixels in shared memory as int16, keeps the rounds,
// channel, endpoint, delta and group loops rolled around one scorer call
// site, and holds endpoints in registers through select helpers.
//
// Built with --fmad=false, so kernel and twin pick the same words.
#include "bc6h_common.cuh"

namespace bc6h {

// (rounds, deltas): deltas 8 bits each, low byte first, a zero ends them
struct Ladder {
  int rounds;
  uint32_t lo, hi;
  __device__ __forceinline__ int delta(int j) const {
    return (int)(((j < 4 ? lo >> (8 * j) : hi >> (8 * (j - 4)))) & 0xFFu);
  }
};

__device__ __forceinline__ int get3(const int a[3], int c) {
  return c == 0 ? a[0] : (c == 1 ? a[1] : a[2]);
}
__device__ __forceinline__ void set3(int a[3], int c, int v) {
  a[0] = c == 0 ? v : a[0];
  a[1] = c == 1 ? v : a[1];
  a[2] = c == 2 ? v : a[2];
}
__device__ __forceinline__ float getf3(const float a[3], int c) {
  return c == 0 ? a[0] : (c == 1 ? a[1] : a[2]);
}
__device__ __forceinline__ void setf3(float a[3], int c, float v) {
  a[0] = c == 0 ? v : a[0];
  a[1] = c == 1 ? v : a[1];
  a[2] = c == 2 ? v : a[2];
}

// one channel's masked SSE at the fixed palette weights of idx
// (_bc6h_cherr_dyn)
template <int K>
__device__ __forceinline__ float cherr(const Px& px, int c, unsigned msk,
                                       int u0, int u1, unsigned long long idx,
                                       bool sgn) {
  float s = 0.0f;
#pragma unroll 4
  for (int i = 0; i < 16; ++i) {
    if (!((msk >> i) & 1u)) continue;
    const int w = pal_weight<K>(idx_at(idx, i));
    const int pal = finish((u0 * (64 - w) + u1 * w + 32) >> 6, sgn);
    const float d = (float)(px(c, i) - pal);
    s = s + d * d;
  }
  return s;
}

// q-space clip range per channel (_ladder_bounds, _bc6h_ladder_caps)
__device__ __forceinline__ void ladder_bounds(const Px& px, unsigned msk,
                                              const int q0[3],
                                              const int q1[3], int precw,
                                              bool sgn, bool remap,
                                              int qlo[3], int qhi[3]) {
  int hi, lo;
  if (sgn) {
    hi = precw >= 16 ? kF16Max : (1 << (precw - 1)) - 1;
    lo = -hi;
  } else {
    hi = (remap || precw < 15) ? (1 << precw) - 1 : kF16Max;
    lo = 0;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int m = 0;
#pragma unroll 4
    for (int i = 0; i < 16; ++i)
      if ((msk >> i) & 1u) m = max(m, abs(px(c, i)));
    const int capq = quantize(m + 1024, precw, sgn);   // BC6H_LS_MAG_CAP
    const int cap = max(capq, max(abs(q0[c]), abs(q1[c])));
    qlo[c] = max(lo, -cap);
    qhi[c] = min(hi, cap);
  }
}

// Re-mapping ladder (_bc6h_perturb_remap_dyn): every probe re-assigns the
// masked pixels' indices. Updates q0/q1 and the masked entries of idx;
// returns the final error.
template <int K>
__device__ float ladder_remap(const Px& px, unsigned msk, int q0[3],
                              int q1[3], int precw, bool sgn,
                              const Ladder& lad, unsigned long long& idx) {
  int qlo[3], qhi[3];
  ladder_bounds(px, msk, q0, q1, precw, sgn, true, qlo, qhi);
  float err = palette_err_q<K>(px, msk, q0, q1, precw, sgn, idx);
#pragma unroll 1
  for (int r = 0; r < lad.rounds; ++r) {
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {
#pragma unroll 1
        for (int j = 0; j < 8; ++j) {
          const int d = lad.delta(j);
          if (!d) break;
#pragma unroll 1
          for (int s = 0; s < 2; ++s) {
            const int cur = get3(which ? q1 : q0, c);
            const int qt = min(max(cur + (s ? -d : d), get3(qlo, c)),
                               get3(qhi, c));
            int t0[3] = {q0[0], q0[1], q0[2]};
            int t1[3] = {q1[0], q1[1], q1[2]};
            set3(which ? t1 : t0, c, qt);
            unsigned long long idx_t = idx;
            const float err_t = palette_err_q<K>(px, msk, t0, t1, precw,
                                                 sgn, idx_t);
            if (err_t < err) {
              set3(which ? q1 : q0, c, qt);
              idx = idx_t;
            }
            err = fminf(err_t, err);
          }
        }
      }
    }
  }
  return err;
}

// Fixed-index ladder (_bc6h_perturb_dyn) at the palette weights of widx:
// per channel and endpoint, the probes keep the indices. Updates q0/q1;
// returns the final error.
template <int K>
__device__ float ladder_fixed(const Px& px, unsigned msk, int q0[3],
                              int q1[3], unsigned long long widx, int precw,
                              bool sgn, const Ladder& lad) {
  int qlo[3], qhi[3];
  ladder_bounds(px, msk, q0, q1, precw, sgn, false, qlo, qhi);
  float ch[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    ch[c] = cherr<K>(px, c, msk, unquantize(q0[c], precw, sgn),
                     unquantize(q1[c], precw, sgn), widx, sgn);
#pragma unroll 1
  for (int r = 0; r < lad.rounds; ++r) {
#pragma unroll 1
    for (int c = 0; c < 3; ++c) {
      float base = getf3(ch, c);
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {
        const int other_u = unquantize(get3(which ? q0 : q1, c), precw, sgn);
#pragma unroll 1
        for (int j = 0; j < 8; ++j) {
          const int d = lad.delta(j);
          if (!d) break;
#pragma unroll 1
          for (int s = 0; s < 2; ++s) {
            const int cur = get3(which ? q1 : q0, c);
            const int qt = min(max(cur + (s ? -d : d), get3(qlo, c)),
                               get3(qhi, c));
            const int ut = unquantize(qt, precw, sgn);
            const float e = which ? cherr<K>(px, c, msk, other_u, ut, widx, sgn)
                                  : cherr<K>(px, c, msk, ut, other_u, widx, sgn);
            if (e < base) set3(which ? q1 : q0, c, qt);
            base = fminf(e, base);
          }
        }
      }
      setf3(ch, c, base);
    }
  }
  float err = 0.0f;
  err = err + ch[0];
  err = err + ch[1];
  return err + ch[2];
}

// One subset's ladder and index update at precision prec (the unit bodies
// of _refine_bc6h_core). widx: the stored indices (fixed-ladder weights
// and fallback). Returns the subset's new error.
template <int K>
__device__ __forceinline__ float refine_subset(const Px& px, unsigned msk,
                                               int q0[3], int q1[3],
                                               unsigned long long widx,
                                               int prec, bool sgn, bool remap,
                                               const Ladder& lad,
                                               unsigned long long& idx) {
  if (remap) return ladder_remap<K>(px, msk, q0, q1, prec, sgn, lad, idx);
  const float err_l = ladder_fixed<K>(px, msk, q0, q1, widx, prec, sgn, lad);
  unsigned long long idx_t = idx;
  const float err_t = palette_err_q<K>(px, msk, q0, q1, prec, sgn, idx_t);
  if (err_t < err_l) idx = idx_t;
  return fminf(err_t, err_l);
}

__global__ void __launch_bounds__(kThreads)
    bc6h_refine_kernel(const int32_t* __restrict__ px_g,
                       const uint32_t* __restrict__ words_in,
                       uint32_t* __restrict__ words_out, int nb,
                       Ladder lad, Ladder lad2, int flags) {
  __shared__ int16_t s_px[48 * kThreads];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nb) return;
  const bool sgn = flags & 1, remap = flags & 2, cross2 = flags & 4;
  const Bits128 w = bc7::load_words(words_in, nb, b);
  Bits128 out = w;
  const int row = mode_row(w);
  if (row < 0) {   // reserved mode: passes through
    bc7::store_words(words_out, nb, b, out);
    return;
  }
  const Px px = stage_pixels(px_g, nb, b, s_px);
  int qm[2][2][3];
  const int shape = unpack(w, row, sgn, qm);
  const int precw = c_info[row].prec_w;

  if (row >= 10) {
    // unit A: the winner laddered at all four one-region precisions
    const unsigned long long idx1 = read_indices(w, row, -1);
    int u0w[3], u1w[3], ef0[3], ef1[3];
    float best = 0.0f;   // the stored state's error: the bar to beat
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      u0w[c] = unquantize(qm[0][0][c], precw, sgn);
      u1w[c] = unquantize(qm[0][1][c], precw, sgn);
      ef0[c] = finish(u0w[c], sgn);
      ef1[c] = finish(u1w[c], sgn);
      best = best + cherr<16>(px, c, 0xFFFFu, u0w[c], u1w[c], idx1, sgn);
    }
#pragma unroll 1
    for (int ra = 10; ra < 14; ++ra) {
      const int prec_a = c_info[ra].prec_w;
      const bool same = precw == prec_a;
      int q[2][2][3] = {}, f[2][2][3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[0][0][c] = same ? qm[0][0][c] : quantize(ef0[c], prec_a, sgn);
        q[0][1][c] = same ? qm[0][1][c] : quantize(ef1[c], prec_a, sgn);
      }
      unsigned long long idx = idx1;
      const float err_new = refine_subset<16>(px, 0xFFFFu, q[0][0], q[0][1],
                                              idx1, prec_a, sgn, remap, lad,
                                              idx);
      anchor_swap<16>(0xFFFFu, 0, q[0][0], q[0][1], idx);
      const float errf = transform_fit(ra, sgn, q, f) ? err_new : INFINITY;
      if (errf < best) {
        best = errf;
        out = emit(ra, 0, f, idx, -1);
      }
    }
  } else {
    // unit B: the two-region winner at its own precision, or at every
    // two-region precision group with cross2
    const unsigned m1 = bc7::subset1_mask(shape);
    const unsigned m0 = ~m1 & 0xFFFFu;
    const int a2 = bc7::c_pa2[shape] & 0xF;
    const unsigned long long idx2 = read_indices(w, row, a2);
    int ef[2][2][3];
    float sub_err[2];
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int u0 = unquantize(qm[sub][0][c], precw, sgn);
        const int u1 = unquantize(qm[sub][1][c], precw, sgn);
        ef[sub][0][c] = finish(u0, sgn);
        ef[sub][1][c] = finish(u1, sgn);
        s = s + cherr<8>(px, c, sub ? m1 : m0, u0, u1, idx2, sgn);
      }
      sub_err[sub] = s;
    }
    // the bar: the stored state's error, summed as the twin sums it
    float best;
    if (remap) {
      best = 0.0f;
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          best = best + cherr<8>(px, c, sub ? m1 : m0,
                                 unquantize(qm[sub][0][c], precw, sgn),
                                 unquantize(qm[sub][1][c], precw, sgn), idx2,
                                 sgn);
    } else {
      best = sub_err[0] + sub_err[1];
    }
    const int n_groups = cross2 ? 6 : 1;
#pragma unroll 1
    for (int g = 0; g < n_groups; ++g) {
      const int first = cross2 ? c_group_first[g] : row;
      const int n_rows = cross2 ? c_group_rows[g] : 1;
      const int prec_b = c_info[first].prec_w;
      const bool same = precw == prec_b;
      int q[2][2][3], f[2][2][3];
#pragma unroll
      for (int sub = 0; sub < 2; ++sub)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            q[sub][e][c] = same ? qm[sub][e][c]
                                : quantize(ef[sub][e][c], prec_b, sgn);
      unsigned long long idx = idx2;
      float err_new = 0.0f;
      err_new = err_new + refine_subset<8>(px, m0, q[0][0], q[0][1], idx2,
                                           prec_b, sgn, remap, lad2, idx);
      err_new = err_new + refine_subset<8>(px, m1, q[1][0], q[1][1], idx2,
                                           prec_b, sgn, remap, lad2, idx);
      anchor_swap<8>(m0, 0, q[0][0], q[0][1], idx);
      anchor_swap<8>(m1, a2, q[1][0], q[1][1], idx);
#pragma unroll 1
      for (int r = first; r < first + n_rows; ++r) {
        const float errf = transform_fit(r, sgn, q, f) ? err_new : INFINITY;
        if (errf < best) {
          best = errf;
          out = emit(r, shape, f, idx, a2);
        }
      }
    }
  }
  bc7::store_words(words_out, nb, b, out);
}

}  // namespace bc6h

extern "C" int bc6h_refine_launch(const void* px, const void* words_in,
                                  void* words_out, int nb, int rounds,
                                  int d_lo, int d_hi, int rounds2, int d2_lo,
                                  int d2_hi, int flags, void* stream) {
  const int grid = (nb + bc6h::kThreads - 1) / bc6h::kThreads;
  const bc6h::Ladder lad{rounds, (uint32_t)d_lo, (uint32_t)d_hi};
  const bc6h::Ladder lad2{rounds2, (uint32_t)d2_lo, (uint32_t)d2_hi};
  bc6h::bc6h_refine_kernel<<<grid, bc6h::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)px, (const uint32_t*)words_in, (uint32_t*)words_out, nb,
      lad, lad2, flags);
  return (int)cudaGetLastError();
}
