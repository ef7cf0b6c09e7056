// PIZ Huffman codec, native fast path for io/exr_piz.py.
//
// The reference reads PIZ via the OpenEXR library's C++ codec
// (Auxiliary/DirectXTexEXR.cpp:17-31 -> RgbaInputFile); here the
// byte-loop half of the chunk codec (Huffman encode/decode) runs native
// while the vectorizable half (bitmap/LUT/wavelet) stays numpy.
// exr_piz.py is the format oracle: this file is a faithful port and the
// test suite asserts byte-identical streams both ways.

#include <cstdint>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

constexpr int HUF_ENCBITS = 16;
constexpr int HUF_DECBITS = 14;
constexpr int HUF_ENCSIZE = (1 << HUF_ENCBITS) + 1;
constexpr int HUF_DECSIZE = 1 << HUF_DECBITS;
constexpr int HUF_DECMASK = HUF_DECSIZE - 1;

constexpr int SHORT_ZEROCODE_RUN = 59;
constexpr int LONG_ZEROCODE_RUN = 63;
constexpr int SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN;

// canonical codes from lengths: value = (code << 6) | length
void canonical_code_table(int64_t* hcode /* in: lengths, out: codes */) {
  int64_t n[59] = {0};
  for (int i = 0; i < HUF_ENCSIZE; ++i)
    if (hcode[i] > 0 && hcode[i] < 59) n[hcode[i]] += 1;
  int64_t c = 0;
  for (int i = 58; i > 0; --i) {
    int64_t nc = (c + n[i]) >> 1;
    n[i] = c;
    c = nc;
  }
  for (int i = 0; i < HUF_ENCSIZE; ++i) {
    int64_t l = hcode[i];
    if (l > 0) hcode[i] = l | (n[l]++ << 6);
  }
}

struct BitReader {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  uint64_t c = 0;
  int lc = 0;
  bool ok = true;

  int bits(int nbits) {
    while (lc < nbits) {
      if (pos >= n) {
        ok = false;
        return 0;
      }
      c = (c << 8) | data[pos++];
      lc += 8;
    }
    lc -= nbits;
    return static_cast<int>((c >> lc) & ((1u << nbits) - 1));
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t c = 0;
  int lc = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint64_t v, int nbits) {
    // codes reach 58 bits and lc can hold 7 — split so the u64
    // accumulator never overflows (python used unbounded ints)
    if (nbits > 32) {
      put(v >> 32, nbits - 32);
      v &= 0xFFFFFFFFull;
      nbits = 32;
    }
    c = (c << nbits) | v;
    lc += nbits;
    while (lc >= 8) {
      lc -= 8;
      out.push_back(static_cast<uint8_t>((c >> lc) & 0xFF));
    }
  }
  void flush_pad() {
    if (lc) out.push_back(static_cast<uint8_t>((c << (8 - lc)) & 0xFF));
  }
};

}  // namespace

extern "C" {

// Huffman stream -> u16[n_raw]. Returns 0 on success, <0 on corrupt input.
int piz_huf_uncompress(const uint8_t* data, int64_t n_data, uint16_t* out,
                       int64_t n_raw) {
  if (n_raw == 0) return 0;
  if (n_data < 20) return -1;
  uint32_t im, iM, tl, n_bits, resv;
  std::memcpy(&im, data, 4);
  std::memcpy(&iM, data + 4, 4);
  std::memcpy(&tl, data + 8, 4);
  std::memcpy(&n_bits, data + 12, 4);
  std::memcpy(&resv, data + 16, 4);
  (void)tl;
  (void)resv;
  if (im >= HUF_ENCSIZE || iM >= HUF_ENCSIZE) return -2;

  // unpack the 6-bit code-length table (zero-run codes included)
  std::vector<int64_t> hcode(HUF_ENCSIZE, 0);
  BitReader br{data + 20, n_data - 20};
  for (uint32_t i = im; i <= iM;) {
    int l = br.bits(6);
    if (!br.ok) return -3;
    if (l == LONG_ZEROCODE_RUN) {
      int run = br.bits(8) + SHORTEST_LONG_RUN;
      if (!br.ok || i + run > iM + 1) return -3;
      i += run;
    } else if (l >= SHORT_ZEROCODE_RUN) {
      int run = l - SHORT_ZEROCODE_RUN + 2;
      if (i + run > iM + 1) return -3;
      i += run;
    } else {
      hcode[i++] = l;
    }
  }
  canonical_code_table(hcode.data());

  // decode tables: 14-bit prefix LUT for short codes, map for long ones
  std::vector<int32_t> short_lit(HUF_DECSIZE, -1);
  std::vector<int8_t> short_len(HUF_DECSIZE, 0);
  std::unordered_map<uint64_t, int32_t> long_codes;
  for (int sym = 0; sym < HUF_ENCSIZE; ++sym) {
    int l = static_cast<int>(hcode[sym] & 63);
    if (!l) continue;
    uint64_t cd = static_cast<uint64_t>(hcode[sym] >> 6);
    if (l <= HUF_DECBITS) {
      uint64_t base = cd << (HUF_DECBITS - l);
      uint64_t cnt = 1ull << (HUF_DECBITS - l);
      if (base + cnt > HUF_DECSIZE) return -4;
      for (uint64_t k = 0; k < cnt; ++k) {
        short_lit[base + k] = sym;
        short_len[base + k] = static_cast<int8_t>(l);
      }
    } else {
      long_codes[(static_cast<uint64_t>(l) << 58) | cd] = sym;
    }
  }

  const uint8_t* stream = data + 20 + br.pos;
  int64_t n_stream = n_data - 20 - br.pos;
  int64_t n_bytes = (static_cast<int64_t>(n_bits) + 7) / 8;
  if (n_bytes > n_stream) return -5;

  int64_t pos_out = 0;
  uint32_t rlc = iM;
  // 128-bit accumulator: the long-code refill can hold up to 57 pending
  // bits before pulling another byte (python used unbounded ints)
  unsigned __int128 c = 0;
  int lc = 0;
  int64_t pos = 0;

  // emit one symbol (run-length symbol repeats the previous value)
  auto out_sym = [&](int sym) -> bool {
    if (static_cast<uint32_t>(sym) == rlc) {
      while (lc < 8) {
        if (pos >= n_bytes) return false;
        c = (c << 8) | stream[pos++];
        lc += 8;
      }
      lc -= 8;
      int cs = static_cast<int>((c >> lc) & 0xFF);
      if (pos_out == 0 || pos_out + cs > n_raw) return false;
      uint16_t v = out[pos_out - 1];
      for (int k = 0; k < cs; ++k) out[pos_out + k] = v;
      pos_out += cs;
    } else {
      if (pos_out >= n_raw) return false;
      out[pos_out++] = static_cast<uint16_t>(sym);
    }
    return true;
  };

  while (pos < n_bytes) {
    c = (c << 8) | stream[pos++];
    lc += 8;
    while (lc >= HUF_DECBITS) {
      uint32_t idx = static_cast<uint32_t>((c >> (lc - HUF_DECBITS))
                                           & HUF_DECMASK);
      int sym = short_lit[idx];
      if (sym >= 0) {
        lc -= short_len[idx];
        if (!out_sym(sym)) return -6;
      } else {
        bool found = false;
        for (int l = HUF_DECBITS + 1; l < 59; ++l) {
          while (lc < l && pos < n_bytes) {
            c = (c << 8) | stream[pos++];
            lc += 8;
          }
          if (lc < l) break;
          uint64_t cd = (c >> (lc - l)) & ((1ull << l) - 1);
          auto it = long_codes.find((static_cast<uint64_t>(l) << 58) | cd);
          if (it != long_codes.end()) {
            lc -= l;
            if (!out_sym(it->second)) return -6;
            found = true;
            break;
          }
        }
        if (!found) return -7;
      }
    }
  }

  // tail: drop the padding bits of the final byte, flush whole codes
  int pad = static_cast<int>(n_bytes * 8 - static_cast<int64_t>(n_bits));
  c >>= pad;
  lc -= pad;
  while (lc > 0) {
    uint32_t idx = static_cast<uint32_t>((c << (HUF_DECBITS - lc))
                                         & HUF_DECMASK);
    int sym = short_lit[idx];
    if (sym < 0 || short_len[idx] > lc) return -8;
    lc -= short_len[idx];
    if (!out_sym(sym)) return -6;
  }
  return pos_out == n_raw ? 0 : -9;
}

// u16[n_raw] -> Huffman stream (hufCompress layout). Returns the output
// byte count, or <0 on error / insufficient capacity. The stream is
// byte-identical to exr_piz.huf_compress (same tree tie-breaking).
int64_t piz_huf_compress(const uint16_t* raw, int64_t n_raw, uint8_t* out,
                         int64_t cap) {
  if (n_raw == 0) return 0;

  std::vector<int64_t> freq(HUF_ENCSIZE, 0);
  for (int64_t i = 0; i < n_raw; ++i) freq[raw[i]] += 1;

  int im = 0, iM = 1;
  {
    int lo = -1, hi = -1;
    for (int s = 0; s < HUF_ENCSIZE; ++s)
      if (freq[s]) {
        if (lo < 0) lo = s;
        hi = s;
      }
    if (lo >= 0) {
      im = lo;
      iM = hi + 1;  // run-length symbol slot
    }
  }

  // plain Huffman tree clamped to 58 bits; tie-breaking mirrors the
  // python oracle's heap entries (freq, sym, [symbols])
  std::vector<int64_t> lengths(HUF_ENCSIZE, 0);
  {
    std::vector<int64_t> work(freq);
    work[iM] += 1;
    struct Node {
      int64_t f;
      int64_t tie;
      int32_t list_id;
    };
    auto cmp = [](const Node& a, const Node& b) {
      return a.f != b.f ? a.f > b.f : a.tie > b.tie;
    };
    std::priority_queue<Node, std::vector<Node>, decltype(cmp)> heap(cmp);
    std::vector<std::vector<int32_t>> lists;
    int n_syms = 0;
    int only = -1;
    for (int s = 0; s < HUF_ENCSIZE; ++s)
      if (work[s]) {
        lists.push_back({s});
        heap.push({work[s], s, static_cast<int32_t>(lists.size() - 1)});
        ++n_syms;
        only = s;
      }
    if (n_syms == 1) {
      lengths[only] = 1;
    } else {
      while (heap.size() > 1) {
        Node a = heap.top();
        heap.pop();
        Node b = heap.top();
        heap.pop();
        for (int32_t s : lists[a.list_id]) lengths[s] += 1;
        for (int32_t s : lists[b.list_id]) lengths[s] += 1;
        std::vector<int32_t>& la = lists[a.list_id];
        la.insert(la.end(), lists[b.list_id].begin(),
                  lists[b.list_id].end());
        heap.push({a.f + b.f, b.tie, a.list_id});
      }
      for (auto& l : lengths)
        if (l > 58) l = 58;
    }
  }

  std::vector<int64_t> hcode(lengths);
  canonical_code_table(hcode.data());

  // pack the code-length table
  std::vector<uint8_t> table;
  {
    BitWriter bw(table);
    for (int i = im; i <= iM;) {
      int l = static_cast<int>(hcode[i] & 63);
      if (l == 0) {
        int j = i;
        while (j <= iM && (hcode[j] & 63) == 0) {
          ++j;
          if (j - i == 255 + SHORTEST_LONG_RUN) break;
        }
        int run = j - i;
        if (run >= SHORTEST_LONG_RUN) {
          bw.put(LONG_ZEROCODE_RUN, 6);
          bw.put(run - SHORTEST_LONG_RUN, 8);
          i = j;
          continue;
        }
        if (run >= 2) {
          bw.put(SHORT_ZEROCODE_RUN + run - 2, 6);
          i = j;
          continue;
        }
      }
      bw.put(l, 6);
      ++i;
    }
    bw.flush_pad();
  }

  // encode the data with run-length chains through the rlc symbol
  std::vector<uint8_t> body;
  body.reserve(static_cast<size_t>(n_raw));
  int64_t n_bits_total;
  {
    BitWriter bw(body);
    auto put_code = [&](int64_t code_len) {
      bw.put(static_cast<uint64_t>(code_len >> 6),
             static_cast<int>(code_len & 63));
    };
    int rlc = iM;
    int64_t i = 0;
    while (i < n_raw) {
      int64_t j = i + 1;
      while (j < n_raw && raw[j] == raw[i]) ++j;
      int v = raw[i];
      int64_t run = j - i - 1;
      put_code(hcode[v]);
      while (run >= 255) {
        put_code(hcode[rlc]);
        bw.put(255, 8);
        run -= 255;
      }
      if (run > 0) {
        int64_t cost_rl = (hcode[rlc] & 63) + 8;
        int64_t cost_lit = (hcode[v] & 63) * run;
        if (cost_rl < cost_lit) {
          put_code(hcode[rlc]);
          bw.put(static_cast<uint64_t>(run), 8);
        } else {
          for (int64_t k = 0; k < run; ++k) put_code(hcode[v]);
        }
      }
      i = j;
    }
    n_bits_total = static_cast<int64_t>(body.size()) * 8 + bw.lc;
    bw.flush_pad();
  }

  int64_t total = 20 + static_cast<int64_t>(table.size())
      + static_cast<int64_t>(body.size());
  if (total > cap) return -1;
  uint32_t head[5] = {static_cast<uint32_t>(im), static_cast<uint32_t>(iM),
                      static_cast<uint32_t>(table.size()),
                      static_cast<uint32_t>(n_bits_total), 0};
  std::memcpy(out, head, 20);
  if (!table.empty()) std::memcpy(out + 20, table.data(), table.size());
  if (!body.empty())
    std::memcpy(out + 20 + table.size(), body.data(), body.size());
  return total;
}

}  // extern "C"
