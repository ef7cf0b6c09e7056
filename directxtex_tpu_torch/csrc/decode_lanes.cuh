// Shared device code of the two decode kernels, K1 (BC7) and K4 (BC6H).
//
// Work is cut in chunks of 32 consecutive blocks, one warp a chunk,
// grid-stride over the launch's warps. A chunk runs in two phases:
//
//   1. headers: lane i parses block i of the chunk (mode, shape, the
//      unquantized endpoints of every subset, the index bits) into a
//      record in shared memory, so one warp instruction parses 32 headers;
//   2. pixels: the f32 epilogue gives each block sixteen lanes (lane =
//      pixel, two blocks a step, 16 steps), each reading its block's record
//      and writing its pixel as one float4, so a warp writes 512 contiguous
//      bytes of decode's [NB, 16, 4] f32; the words API's planes epilogue
//      keeps lane i on block i for its 16 pixels, so each row store of
//      [ROWS, NB] int32 is 32 consecutive blocks.
//
// Only the warp's own records pass between the phases (__syncwarp). A CTA
// stages its constant tables in shared memory once.
//
// Input: the packed blocks [NB, 16] u8 (one 16-byte load a block) or the
// words API's lane-major words [4, NB] u32.
#pragma once

#include "bc7_common.cuh"

namespace dec {

using bc7::Bits128;

constexpr int kThreads = 256;           // threads a CTA
constexpr int kWarps = kThreads / 32;   // chunks a CTA holds at once

// the decode's epilogue: f32 [NB, 16, 4] or int32 planes [ROWS, NB]
enum Out { kF32 = 1, kPlanes = 0 };

// block b's 128 bits from the packed blocks or the lane-major words
template <bool PACKED>
__device__ __forceinline__ Bits128 load_block(const uint32_t* __restrict__ src,
                                              int nb, int b) {
  if (PACKED) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(src) + b);
    Bits128 r;
    r.lo = (unsigned long long)q.x | ((unsigned long long)q.y << 32);
    r.hi = (unsigned long long)q.z | ((unsigned long long)q.w << 32);
    return r;
  }
  return bc7::load_words(src, nb, b);
}

// the 64 bits from bit BASE up (fewer past bit 127)
template <int BASE>
__device__ __forceinline__ unsigned long long window(const Bits128& w) {
  if (BASE == 0) return w.lo;
  if (BASE < 64) return (w.lo >> (BASE & 63)) | (w.hi << ((64 - BASE) & 63));
  return w.hi >> ((BASE - 64) & 63);
}

// n bits (n <= 31) at a runtime bit position, without branches
__device__ __forceinline__ uint32_t bits_at(const Bits128& w, int pos, int n) {
  const unsigned long long lo = pos >= 64 ? w.hi : w.lo;
  const unsigned long long hi = pos >= 64 ? 0ull : w.hi;
  const int s = pos & 63;
  const unsigned long long v = s ? (lo >> s) | (hi << (64 - s)) : lo;
  return (uint32_t)v & ((1u << n) - 1u);
}

// Closed-form index field of pixel i in an index set of prec-bit indices
// whose anchor pixels (pixel 0 and the fixups a2, a3; 16 = none) hold one
// bit less: its bit offset from the set's start, and its width. This is
// the sequential `pos += n` walk of read_indices, written per pixel
// (bc67._index_field is the same formula, pinned against the walk by
// tests/test_torch_decode_lanes.py).
__device__ __forceinline__ int index_offset(int i, int prec, int a2, int a3) {
  return prec * i - ((i > 0) + (a2 < i) + (a3 < i));
}
__device__ __forceinline__ int index_width(int i, int prec, int a2, int a3) {
  return prec - ((i == 0 || i == a2 || i == a3) ? 1 : 0);
}

// the index of pixel i in a set that starts at the window's bit 0
__device__ __forceinline__ int index_at(unsigned long long win, int i,
                                        int prec, int a2, int a3) {
  return (int)(win >> index_offset(i, prec, a2, a3))
         & ((1 << index_width(i, prec, a2, a3)) - 1);
}

// chunks of 32 blocks in nb blocks
inline int n_chunks(int nb) { return (nb + 31) / 32; }

// CTAs of a grid-stride launch over n_chunks chunks: as many as fit on
// the device at once (occupancy measured once per kernel instance)
template <typename K>
inline int persistent_grid(K kernel, int* occupancy, int n_chunks) {
  if (*occupancy == 0) {
    int occ = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
    *occupancy = occ > 0 ? occ : 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int ctas = *occupancy * (sms > 0 ? sms : 1);
  const int need = (n_chunks + kWarps - 1) / kWarps;
  return need < ctas ? need : ctas;
}

}  // namespace dec
