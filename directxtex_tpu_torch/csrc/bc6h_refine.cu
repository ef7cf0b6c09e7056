// K6 — BC6H winner-refine: a unit bucket pass, then one launch of lane
// jobs per unit, each job one ladder, and a fold per block.
//
// Replaces directxtex_tpu/bc/pallas_kernels.py:bc6h_refine_pallas /
// _bc6h_refine_kernel (bc67._refine_bc6h_core). Plain twin:
// bc6h._bc6h_refine_plain, step for step and in the same operation order.
// The refine unpacks each block's winning state (mode row, shape,
// endpoints, stored indices) and runs the quantized-endpoint ladder on it:
//   - unit A, one-region winners (rows 10-13): the region at all four
//     one-region precisions;
//   - unit B, two-region winners (rows 0-9): each subset at the winner's
//     own precision, or with cross2 at every two-region precision group;
// with the re-mapping ladder (remap: every probe re-assigns indices,
// PerturbOne's MapColors) or the fixed-index ladder followed by one
// re-assignment, then the anchor swap, each row's delta fit and emit, and
// a strict-`<` fold against the stored state's error. The ladder (rounds,
// up to 8 deltas), the second unit's ladder, signed, remap and cross2 are
// launch arguments.
//
// Design. bc6h_unit_buckets copies the words (a reserved mode, or a block
// whose error does not drop, passes through as this copy) and lists the
// blocks of each unit (one __ballot_sync + __popc per warp and unit, a
// shared-memory atomic per warp, one global atomicAdd per CTA and unit;
// the counts stay on the card). Then one launch per unit, so that no warp
// holds both units. A block's refine is a set of jobs, each one ladder:
//   unit A: 4 jobs, one per one-region precision (rows 10..13), a lane
//     each;
//   unit B: one job per (precision group g, subset s), 6 x 2 with cross2,
//     1 x 2 without (the block's own precision); a lane per group runs
//     its two subsets' jobs in lockstep (ladder_remap_pair): 6 lanes a
//     block, or 1.
// A CTA takes the next blocks of its unit's list and stages their pixels
// once in shared memory (int16, one column a block). Each job ends with
// its subset's anchor swap and leaves the subset's error, endpoints and
// indices in the block's slot 2g + s of shared memory; after a barrier
// one lane per block folds.
//
// Why the words equal the one-thread refine's (and the twin's). A ladder
// reads only the stored state, the pixels and its own mask, and writes
// only its own endpoints and the masked entries of its index plane
// (ladder_remap, palette_err); the anchor swap of a subset reads its own
// anchor (pixel 0 lies in subset 0, the shape's second anchor in subset
// 1) and flips its own entries. So the ladders of a block are independent
// and each job computes exactly what the one-thread loop computed for its
// (precision, subset). In lockstep, both subsets take the same probe
// sequence (rounds, channel, endpoint, delta, sign) that each would take
// alone; one pass over the 16 pixels scores both, each pixel against its
// own subset's trial endpoints into its own subset's sum, so each sum
// runs over its subset's pixels in pixel order with palette_err's
// arithmetic, and each subset accepts or keeps its probe by its own
// strict `<`. The fold merges a group's two index planes by the subsets'
// masks, which together cover the 16 pixels once, and runs in the twin's
// order with the same arithmetic: the stored-state bar (summed over
// subsets and channels, or sub + sub without remap), per group err = 0 +
// e_sub0 + e_sub1, the groups in order and the rows in order within a
// group (unit A: rows 10..13), transform_fit, a strict `<`. The last
// improvement stands, so the fold keeps the winning (group, row) and
// emits once: emit is a pure function of (row, shape, fitted endpoints,
// indices), so that is the word the twin's emit-per-improvement leaves.
//
// Bound: operations. A block needs 96 bytes of pixels and 16 of words in
// and 16 out; the maxq refine costs about 0.8 million (one-region winner)
// to 1.3 million (two-region) elementwise operations per block, every
// probe a full re-assignment of the subset's pixels
// (tests/test_torch_op_counts.py). The one-thread kernel filled the card
// about half a wave deep (98,304 threads at 159 registers) and ran a
// block's 12 ladders in series. A lane per (group, subset), each looping
// over the 16 pixels with half of them masked off, ran 1.46x slower than
// a lane per group, whose one pass over the pixels does both subsets'
// work (PERF.md).
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
template <int K, class P>
__device__ __forceinline__ float cherr(const P& px, int c, unsigned msk,
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
template <class P>
__device__ __forceinline__ void ladder_bounds(const P& px, unsigned msk,
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
template <int K, class P>
__device__ __forceinline__ float ladder_remap(const P& px, unsigned msk,
                                              int q0[3], int q1[3], int precw,
                                              bool sgn, const Ladder& lad,
                                              unsigned long long& idx) {
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
            const int cur = which ? get3(q1, c) : get3(q0, c);
            const int qt = min(max(cur + (s ? -d : d), get3(qlo, c)),
                               get3(qhi, c));
            // the probe: endpoint `which`, channel c moved to qt (selects,
            // not a pointer to one of the arrays, keep them in registers)
            int t0[3], t1[3];
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              t0[k] = (!which && k == c) ? qt : q0[k];
              t1[k] = (which && k == c) ? qt : q1[k];
            }
            unsigned long long idx_t = idx;
            const float err_t = palette_err_q<K>(px, msk, t0, t1, precw,
                                                 sgn, idx_t);
            if (err_t < err) {
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                q0[k] = t0[k];
                q1[k] = t1[k];
              }
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
template <int K, class P>
__device__ __forceinline__ float ladder_fixed(const P& px, unsigned msk,
                                              int q0[3], int q1[3],
                                              unsigned long long widx,
                                              int precw, bool sgn,
                                              const Ladder& lad) {
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
        const int other_u =
            unquantize(which ? get3(q0, c) : get3(q1, c), precw, sgn);
#pragma unroll 1
        for (int j = 0; j < 8; ++j) {
          const int d = lad.delta(j);
          if (!d) break;
#pragma unroll 1
          for (int s = 0; s < 2; ++s) {
            const int cur = which ? get3(q1, c) : get3(q0, c);
            const int qt = min(max(cur + (s ? -d : d), get3(qlo, c)),
                               get3(qhi, c));
            const int ut = unquantize(qt, precw, sgn);
            const float e = which ? cherr<K>(px, c, msk, other_u, ut, widx, sgn)
                                  : cherr<K>(px, c, msk, ut, other_u, widx, sgn);
            if (e < base) {
              if (which)
                set3(q1, c, qt);
              else
                set3(q0, c, qt);
            }
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
template <int K, class P>
__device__ __forceinline__ float refine_subset(const P& px, unsigned msk,
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

// ---------------------------------------------------------------------------
// The unit bucket pass
// ---------------------------------------------------------------------------
enum Unit { kUnitA = 0, kUnitB = 1, kUnitReserved = 2, kUnits = 3 };

__device__ __forceinline__ int unit_of(int row) {
  return row < 0 ? kUnitReserved : (row >= 10 ? kUnitA : kUnitB);
}

constexpr int kBucketThreads = 512;

// words_out = words_in; lists [kUnits, NB], counts [kUnits] (zeroed
// first): each unit's blocks, a warp's in lane order, the warps' order
// the atomics'
__global__ void __launch_bounds__(kBucketThreads)
    bc6h_unit_buckets_kernel(const uint32_t* __restrict__ words_in,
                             uint32_t* __restrict__ words_out,
                             int32_t* __restrict__ lists,
                             int32_t* __restrict__ counts, int nb) {
  __shared__ int cta_count[kUnits], cta_base[kUnits];
  const int b = blockIdx.x * kBucketThreads + threadIdx.x;
  if (threadIdx.x < kUnits) cta_count[threadIdx.x] = 0;
  int unit = kUnits;
  if (b < nb) {
    const Bits128 w = bc7::load_words(words_in, nb, b);
    bc7::store_words(words_out, nb, b, w);
    unit = unit_of(mode_row(w));
  }
  __syncthreads();
  // every lane stays for the ballots (the grid is whole warps)
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int pos = 0;
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const unsigned hit = __ballot_sync(0xFFFFFFFFu, unit == u);
    if (!hit) continue;
    const int leader = __ffs(hit) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(cta_count + u, __popc(hit));
    base = __shfl_sync(0xFFFFFFFFu, base, leader);
    if (unit == u) pos = base + __popc(hit & below);
  }
  __syncthreads();
  if (threadIdx.x < kUnits && cta_count[threadIdx.x])
    cta_base[threadIdx.x] = atomicAdd(counts + threadIdx.x,
                                      cta_count[threadIdx.x]);
  __syncthreads();
  if (unit < kUnits) lists[(size_t)unit * nb + cta_base[unit] + pos] = b;
}

// ---------------------------------------------------------------------------
// Lane jobs and the fold
// ---------------------------------------------------------------------------
// A block's jobs and lanes: unit A, 4 jobs, a lane each (one per
// precision); unit B, a job per (precision group g, subset s), 12 with
// cross2, 2 without, whose results land in slot 2g + s, and a lane per
// group that runs its two subsets' jobs in lockstep (6 lanes, or 1).
template <int UNIT, bool CROSS2>
struct UnitShape {
  static constexpr int kJobs = UNIT == kUnitA ? 4 : (CROSS2 ? 12 : 2);
  static constexpr int kLanes = UNIT == kUnitA ? 4 : kJobs / 2;
  // blocks a CTA, so that a CTA is whole warps
  static constexpr int kBlocks = kLanes == 6 ? 16 : 128 / kLanes;
  static constexpr int kThreads = kLanes * kBlocks;
  // CTAs an SM should hold: at most 85 registers a thread (80 with 304 /
  // 320 bytes of spill for unit B with cross2 ran 3-7% faster than 128
  // with 52 / 104 or 141 with none; PERF.md)
  static constexpr int kMinBlocks = kThreads == 96 ? 8 : 6;
};

struct JobOut {
  unsigned long long idx;   // the subset's entries after its anchor swap
  float err;
  int q[2][3];              // endpoints after the anchor swap
};

template <int UNIT, bool CROSS2>
struct UnitSmem {
  using S = UnitShape<UNIT, CROSS2>;
  int16_t px[48 * S::kBlocks];         // [48][kBlocks]
  JobOut out[S::kBlocks * S::kJobs];   // [kBlocks][kJobs]
};

struct RefineArgs {
  const int32_t* px;
  const uint32_t* words_in;
  uint32_t* words_out;
  const int32_t* list;     // this unit's blocks
  const int32_t* count;    // how many
  int nb;
  Ladder lad, lad2;        // unit A's and unit B's ladders
  bool sgn, remap, cross2;
};

// Phase 1: the CTA's blocks' pixels, [48][kBlocks] int16; slots past the
// list's end are left unset (no job reads them)
template <int UNIT, bool CROSS2>
__device__ __forceinline__ void stage_unit_pixels(
    UnitSmem<UNIT, CROSS2>& sm, const RefineArgs& a, int t0, int n, int tid) {
  using S = UnitShape<UNIT, CROSS2>;
  constexpr int B = S::kBlocks;
#pragma unroll 1
  for (int k = tid; k < 48 * B; k += S::kThreads) {
    const int r = k / B, s = k % B;
    if (t0 + s < n)
      sm.px[r * B + s] = (int16_t)a.px[(size_t)r * a.nb + a.list[t0 + s]];
  }
}

// the stored state of block b: mode row, shape, endpoints, precision
struct Stored {
  Bits128 w;
  int row, shape, precw;
  int qm[2][2][3];
};

__device__ __forceinline__ Stored read_stored(const RefineArgs& a, int b) {
  Stored st;
  st.w = bc7::load_words(a.words_in, a.nb, b);
  st.row = mode_row(st.w);
  st.shape = unpack(st.w, st.row, a.sgn, st.qm);
  st.precw = c_info[st.row].prec_w;
  return st;
}

// region sub's endpoints at precision prec: the stored ones at the stored
// precision, else the finished stored values requantized
__device__ __forceinline__ void start_endpoints(const Stored& st, int sub,
                                                int prec, bool sgn,
                                                int q0[3], int q1[3]) {
  const bool same = st.precw == prec;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int f0 = finish(unquantize(st.qm[sub][0][c], st.precw, sgn), sgn);
    const int f1 = finish(unquantize(st.qm[sub][1][c], st.precw, sgn), sgn);
    q0[c] = same ? st.qm[sub][0][c] : quantize(f0, prec, sgn);
    q1[c] = same ? st.qm[sub][1][c] : quantize(f1, prec, sgn);
  }
}

__device__ __forceinline__ void put_job(JobOut& o, float err,
                                        const int q0[3], const int q1[3],
                                        unsigned long long idx) {
  o.err = err;
  o.idx = idx;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.q[0][c] = q0[c];
    o.q[1][c] = q1[c];
  }
}

// Both subsets' re-mapping ladders in lockstep (a unit-B lane): at
// each probe both move the same (channel, endpoint, delta, sign), each
// within its own bounds, one palette_err_pair scores both, and each
// subset keeps its own probe by its own strict `<`. Per subset that is
// ladder_remap's sequence of states and sums.
template <int K, class P>
__device__ __forceinline__ void ladder_remap_pair(const P& px, unsigned m1,
                                                  int q[2][2][3], int precw,
                                                  bool sgn, const Ladder& lad,
                                                  unsigned long long& idx,
                                                  float err[2]) {
  const unsigned long long nm1 = nibble_mask(m1);
  int qlo[2][3], qhi[2][3];
  ladder_bounds(px, ~m1 & 0xFFFFu, q[0][0], q[0][1], precw, sgn, true,
                qlo[0], qhi[0]);
  ladder_bounds(px, m1, q[1][0], q[1][1], precw, sgn, true, qlo[1], qhi[1]);
  palette_err_pair<K>(px, m1, q, precw, sgn, idx, err);
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
            int t[2][2][3];
#pragma unroll
            for (int sub = 0; sub < 2; ++sub) {
              const int cur = which ? get3(q[sub][1], c) : get3(q[sub][0], c);
              const int qt = min(max(cur + (s ? -d : d), get3(qlo[sub], c)),
                                 get3(qhi[sub], c));
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                t[sub][0][k] = (!which && k == c) ? qt : q[sub][0][k];
                t[sub][1][k] = (which && k == c) ? qt : q[sub][1][k];
              }
            }
            unsigned long long idx_t = idx;
            float err_t[2];
            palette_err_pair<K>(px, m1, t, precw, sgn, idx_t, err_t);
#pragma unroll
            for (int sub = 0; sub < 2; ++sub) {
              if (err_t[sub] < err[sub]) {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                  q[sub][0][k] = t[sub][0][k];
                  q[sub][1][k] = t[sub][1][k];
                }
                const unsigned long long nm = sub ? nm1 : ~nm1;
                idx = (idx & ~nm) | (idx_t & nm);
              }
              err[sub] = fminf(err_t[sub], err[sub]);
            }
          }
        }
      }
    }
  }
}

// Phase 2: lane l of the block in slot s: its job(s), each a ladder at one
// precision on one subset and that subset's anchor swap; results into the
// block's slots (2g + s for unit B)
template <int UNIT, bool CROSS2>
__device__ __forceinline__ void unit_lane(UnitSmem<UNIT, CROSS2>& sm,
                                          const RefineArgs& a, int b, int s,
                                          int l) {
  using S = UnitShape<UNIT, CROSS2>;
  const PxT<S::kBlocks> px{sm.px + s};
  JobOut* o = sm.out + s * S::kJobs;
  const Stored st = read_stored(a, b);
  if constexpr (UNIT == kUnitA) {
    const int prec = c_info[10 + l].prec_w;
    const unsigned long long idx1 = read_indices(st.w, st.row, -1);
    int q0[3], q1[3];
    start_endpoints(st, 0, prec, a.sgn, q0, q1);
    unsigned long long idx = idx1;
    const float err = refine_subset<16>(px, 0xFFFFu, q0, q1, idx1, prec,
                                        a.sgn, a.remap, a.lad, idx);
    anchor_swap<16>(0xFFFFu, 0, q0, q1, idx);
    put_job(o[l], err, q0, q1, idx);
  } else {
    const unsigned m1 = bc7::subset1_mask(st.shape);
    const int a2 = bc7::c_pa2[st.shape] & 0xF;
    const unsigned long long idx2 = read_indices(st.w, st.row, a2);
    const int g = l;
    const int prec = CROSS2 ? c_info[c_group_first[g]].prec_w : st.precw;
    int q[2][2][3];
    start_endpoints(st, 0, prec, a.sgn, q[0][0], q[0][1]);
    start_endpoints(st, 1, prec, a.sgn, q[1][0], q[1][1]);
    float err[2];
    unsigned long long idx = idx2;
    if (a.remap) {
      ladder_remap_pair<8>(px, m1, q, prec, a.sgn, a.lad2, idx, err);
    } else {
      // the fixed-index ladders one after the other (no path runs them)
#pragma unroll 1
      for (int sub = 0; sub < 2; ++sub)
        err[sub] = refine_subset<8>(px, sub ? m1 : (~m1 & 0xFFFFu),
                                    q[sub][0], q[sub][1], idx2, prec, a.sgn,
                                    false, a.lad2, idx);
    }
    anchor_swap<8>(~m1 & 0xFFFFu, 0, q[0][0], q[0][1], idx);
    anchor_swap<8>(m1, a2, q[1][0], q[1][1], idx);
    put_job(o[2 * g], err[0], q[0][0], q[0][1], idx);
    put_job(o[2 * g + 1], err[1], q[1][0], q[1][1], idx);
  }
}

// Phase 3: the fold of the block in slot s, in the twin's order; writes
// the block's words where a row beats the stored state
template <int UNIT, bool CROSS2>
__device__ __forceinline__ void unit_fold(const UnitSmem<UNIT, CROSS2>& sm,
                                          const RefineArgs& a, int b,
                                          int s) {
  using S = UnitShape<UNIT, CROSS2>;
  const JobOut* o = sm.out + s * S::kJobs;
  const PxT<S::kBlocks> px{sm.px + s};
  const Stored st = read_stored(a, b);
  const bool sgn = a.sgn;
  int q[2][2][3] = {}, f[2][2][3];
  if constexpr (UNIT == kUnitA) {
    const unsigned long long idx1 = read_indices(st.w, st.row, -1);
    float best = 0.0f;   // the stored state's error: the bar to beat
#pragma unroll
    for (int c = 0; c < 3; ++c)
      best = best + cherr<16>(px, c, 0xFFFFu,
                              unquantize(st.qm[0][0][c], st.precw, sgn),
                              unquantize(st.qm[0][1][c], st.precw, sgn),
                              idx1, sgn);
    int win = -1;
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[0][0][c] = o[j].q[0][c];
        q[0][1][c] = o[j].q[1][c];
      }
      const float errf = transform_fit(10 + j, sgn, q, f) ? o[j].err
                                                          : INFINITY;
      if (errf < best) {
        best = errf;
        win = j;
      }
    }
    if (win < 0) return;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[0][0][c] = o[win].q[0][c];
      q[0][1][c] = o[win].q[1][c];
    }
    transform_fit(10 + win, sgn, q, f);
    bc7::store_words(a.words_out, a.nb, b,
                     emit(10 + win, 0, f, o[win].idx, -1));
  } else {
    const unsigned m1 = bc7::subset1_mask(st.shape);
    const unsigned m0 = ~m1 & 0xFFFFu;
    const int a2 = bc7::c_pa2[st.shape] & 0xF;
    const unsigned long long idx2 = read_indices(st.w, st.row, a2);
    // the bar: the stored state's error, summed as the twin sums it
    float best = 0.0f, sub_err[2];
#pragma unroll
    for (int sub = 0; sub < 2; ++sub) {
      float e = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float ch = cherr<8>(px, c, sub ? m1 : m0,
                                  unquantize(st.qm[sub][0][c], st.precw, sgn),
                                  unquantize(st.qm[sub][1][c], st.precw, sgn),
                                  idx2, sgn);
        e = e + ch;
        best = best + ch;
      }
      sub_err[sub] = e;
    }
    if (!a.remap) best = sub_err[0] + sub_err[1];
    int win_g = -1, win_r = 0;
#pragma unroll 1
    for (int g = 0; g < S::kJobs / 2; ++g) {
      const JobOut& o0 = o[2 * g];
      const JobOut& o1 = o[2 * g + 1];
      float err_new = 0.0f;
      err_new = err_new + o0.err;
      err_new = err_new + o1.err;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          q[0][e][c] = o0.q[e][c];
          q[1][e][c] = o1.q[e][c];
        }
      const int first = CROSS2 ? c_group_first[g] : st.row;
      const int n_rows = CROSS2 ? c_group_rows[g] : 1;
#pragma unroll 1
      for (int r = first; r < first + n_rows; ++r) {
        const float errf = transform_fit(r, sgn, q, f) ? err_new : INFINITY;
        if (errf < best) {
          best = errf;
          win_g = g;
          win_r = r;
        }
      }
    }
    if (win_g < 0) return;
    const JobOut& o0 = o[2 * win_g];
    const JobOut& o1 = o[2 * win_g + 1];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[0][e][c] = o0.q[e][c];
        q[1][e][c] = o1.q[e][c];
      }
    transform_fit(win_r, sgn, q, f);
    const unsigned long long nm1 = nibble_mask(m1);
    const unsigned long long idx = (o0.idx & ~nm1) | (o1.idx & nm1);
    bc7::store_words(a.words_out, a.nb, b, emit(win_r, st.shape, f, idx, a2));
  }
}

// One unit's launch: CTA c takes list entries c * kBlocks onwards; thread
// tid is lane tid % kLanes of slot tid / kLanes, then threads
// 0..kBlocks-1 fold one slot each
template <int UNIT, bool CROSS2>
__global__ void __launch_bounds__(UnitShape<UNIT, CROSS2>::kThreads,
                                  UnitShape<UNIT, CROSS2>::kMinBlocks)
    bc6h_refine_unit_kernel(RefineArgs a) {
  using S = UnitShape<UNIT, CROSS2>;
  __shared__ UnitSmem<UNIT, CROSS2> sm;
  const int n = *a.count;
  const int t0 = blockIdx.x * S::kBlocks;
  if (t0 >= n) return;                       // the same in the whole CTA
  const int tid = threadIdx.x;
  stage_unit_pixels(sm, a, t0, n, tid);
  __syncthreads();
  const int s = tid / S::kLanes;
  if (t0 + s < n) unit_lane(sm, a, a.list[t0 + s], s, tid % S::kLanes);
  __syncthreads();
  if (tid < S::kBlocks && t0 + tid < n)
    unit_fold(sm, a, a.list[t0 + tid], tid);
}

template <int UNIT, bool CROSS2>
int launch_unit(const RefineArgs& a, cudaStream_t stream) {
  using S = UnitShape<UNIT, CROSS2>;
  const int grid = (a.nb + S::kBlocks - 1) / S::kBlocks;
  bc6h_refine_unit_kernel<UNIT, CROSS2><<<grid, S::kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace bc6h

// words_in [4, NB] -> words_out [4, NB] (a copy), lists [3, NB], counts
// [3]: units A (rows 10-13), B (rows 0-9) and reserved
extern "C" int bc6h_unit_buckets_launch(const void* words_in,
                                        void* words_out, void* lists,
                                        void* counts, int nb, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemsetAsync(counts, 0,
                                   bc6h::kUnits * sizeof(int32_t), s);
  if (rc != cudaSuccess) return (int)rc;
  const int grid = (nb + bc6h::kBucketThreads - 1) / bc6h::kBucketThreads;
  bc6h::bc6h_unit_buckets_kernel<<<grid, bc6h::kBucketThreads, 0, s>>>(
      (const uint32_t*)words_in, (uint32_t*)words_out, (int32_t*)lists,
      (int32_t*)counts, nb);
  return (int)cudaGetLastError();
}

// K6's whole call: the bucket pass into words_out, then unit A's launch
// (ladder rounds / d_lo / d_hi) and unit B's (rounds2 / d2_*; 12 jobs a
// block with cross2, else 2), all on `stream`, with no host sync. flags:
// 1 signed, 2 remap, 4 cross2.
extern "C" int bc6h_refine_launch(const void* px, const void* words_in,
                                  void* words_out, void* lists, void* counts,
                                  int nb, int rounds, int d_lo, int d_hi,
                                  int rounds2, int d2_lo, int d2_hi,
                                  int flags, void* stream) {
  int rc = bc6h_unit_buckets_launch(words_in, words_out, lists, counts, nb,
                                    stream);
  if (rc != 0) return rc;
  bc6h::RefineArgs a;
  a.px = (const int32_t*)px;
  a.words_in = (const uint32_t*)words_in;
  a.words_out = (uint32_t*)words_out;
  a.nb = nb;
  a.lad = bc6h::Ladder{rounds, (uint32_t)d_lo, (uint32_t)d_hi};
  a.lad2 = bc6h::Ladder{rounds2, (uint32_t)d2_lo, (uint32_t)d2_hi};
  a.sgn = flags & 1;
  a.remap = flags & 2;
  a.cross2 = flags & 4;
  const cudaStream_t s = (cudaStream_t)stream;
  a.list = (const int32_t*)lists + (size_t)bc6h::kUnitA * nb;
  a.count = (const int32_t*)counts + bc6h::kUnitA;
  rc = bc6h::launch_unit<bc6h::kUnitA, false>(a, s);
  if (rc != 0) return rc;
  a.list = (const int32_t*)lists + (size_t)bc6h::kUnitB * nb;
  a.count = (const int32_t*)counts + bc6h::kUnitB;
  return a.cross2 ? bc6h::launch_unit<bc6h::kUnitB, true>(a, s)
                  : bc6h::launch_unit<bc6h::kUnitB, false>(a, s);
}
