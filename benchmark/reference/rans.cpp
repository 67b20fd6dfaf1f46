// A frozen copy of the port's rANS coder (onedc_tpu_torch/ops/cpp/onedc_rans.cpp)
// that the benchmark's reference decodes with; the program's own copy may change.
// OneDC-TPU host-side entropy coding: range-ANS coder + CDF quantizer.
//
// A from-scratch implementation of the byte-aligned rANS coding scheme used
// by learned-codec stacks (semantics compatible with the reference's
// src/cpp/rans/{rans_byte.h,rans.cpp} + py_rans.cpp container format):
//   * precision 16 CDF tables, 31-bit state, renorm lower bound 1<<23
//   * escape/bypass coding of out-of-range symbols in 2-bit chunks
//   * negative cdf index => symbol skipped (decoder emits 0)
//   * multi-part stream container: 1 flag byte
//     ((nparts-1)<<4 | size_field_is_16bit) + per-part u16/u32 sizes (little
//     endian, all but last part) + concatenated part payloads
//
// Exposed as a plain C API for ctypes (no pybind11 in this environment).
// Multi-part encoding/decoding runs parts on std::threads.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int kPrecision = 16;
constexpr uint32_t kRansL = 1u << 23;  // renormalization lower bound
constexpr uint16_t kBypassBits = 2;
constexpr uint16_t kMaxBypassVal = (1u << kBypassBits) - 1;

struct CodedSym {
  uint16_t start;
  uint16_t range;  // range == 0 marks a raw bypass chunk of kBypassBits bits
};

// Coarse inverse-CDF bank: per cdf row, a 256-entry table giving the bucket
// index at each 256-wide slice of cum space, so the per-symbol linear scan
// starts at most ~2 buckets below its target instead of at 0 (row sizes run
// to ~100 entries). 256 entries (not a full 2^16 inverse) keeps the whole
// bank ~128 KB and cache-resident — the full table was measured SLOWER
// (24 vs 49 Msym/s) because every lookup missed L2. Built once per DISTINCT
// bank content and shared via shared_ptr: a batched decode makes one
// Decoder per stream, and each registers the same bank.
constexpr int kInvShift = kPrecision - 8;  // 256 slices of cum space

struct InvBank {
  std::vector<std::vector<uint16_t>> rows;
};

std::shared_ptr<const InvBank> get_inv_bank(
    const std::vector<std::vector<int32_t>> &cdf_rows,
    const std::vector<int32_t> &sizes) {
  // key = (size, row values) of every row; FNV-1a hash bucket + full
  // equality check (a collision must never alias two banks). The hit
  // path (every per-stream decoder of a serving batch re-registers the
  // same bank) hashes and compares IN PLACE — the ~100 KB key vector is
  // only materialized when a genuinely new bank is inserted.
  uint64_t h = 1469598103934665603ull;
  auto mix = [&h](int32_t v) {
    h ^= static_cast<uint32_t>(v);
    h *= 1099511628211ull;
  };
  size_t key_len = 0;
  for (size_t i = 0; i < cdf_rows.size(); ++i) {
    mix(sizes[i]);
    for (int32_t v : cdf_rows[i]) mix(v);
    key_len += 1 + cdf_rows[i].size();
  }
  auto key_equals = [&](const std::vector<int32_t> &stored) {
    if (stored.size() != key_len) return false;
    size_t p = 0;
    for (size_t i = 0; i < cdf_rows.size(); ++i) {
      if (stored[p++] != sizes[i]) return false;
      const auto &row = cdf_rows[i];
      if (!std::equal(row.begin(), row.end(), stored.begin() + p))
        return false;
      p += row.size();
    }
    return true;
  };
  static std::mutex mu;
  static std::unordered_map<
      uint64_t, std::vector<std::pair<std::vector<int32_t>,
                                      std::shared_ptr<const InvBank>>>>
      cache;
  std::lock_guard<std::mutex> lock(mu);
  auto &bucket = cache[h];
  for (const auto &e : bucket) {
    if (key_equals(e.first)) return e.second;
  }
  std::vector<int32_t> key;
  key.reserve(key_len);
  for (size_t i = 0; i < cdf_rows.size(); ++i) {
    key.push_back(sizes[i]);
    key.insert(key.end(), cdf_rows[i].begin(), cdf_rows[i].end());
  }
  auto bank = std::make_shared<InvBank>();
  bank->rows.resize(cdf_rows.size());
  for (size_t i = 0; i < cdf_rows.size(); ++i) {
    const std::vector<int32_t> &cdf = cdf_rows[i];
    const int32_t size = sizes[i];
    std::vector<uint16_t> &inv = bank->rows[i];
    inv.assign(256, 0);
    // inv[t] = scan result at cum = t << kInvShift; the scan
    // `while (s+1 < size && cdf[s+1] <= cum) ++s` is monotone in cum, so
    // starting a later scan from inv[cum >> kInvShift] is exact
    int32_t s = 0;
    for (uint32_t t = 0; t < 256; ++t) {
      const int32_t cum = static_cast<int32_t>(t << kInvShift);
      while (s + 1 < size && cdf[s + 1] <= cum) ++s;
      inv[t] = static_cast<uint16_t>(s);
    }
  }
  bucket.emplace_back(std::move(key), bank);
  return bank;
}

struct CdfGroup {
  // flattened per-symbol (start, range) pairs per cdf row
  std::vector<std::vector<CodedSym>> sym_rows;
  std::vector<std::vector<int32_t>> cdf_rows;  // raw rows, for decode search
  std::vector<int32_t> sizes;
  std::vector<int32_t> offsets;
  std::shared_ptr<const InvBank> inv;  // decoders only; shared across coders
};

inline void enc_renorm(uint32_t &x, std::vector<uint8_t> &out, uint32_t freq) {
  const uint32_t x_max = freq << 15;
  while (x >= x_max) {
    out.push_back(static_cast<uint8_t>(x & 0xff));
    x >>= 8;
  }
}

// --------------------------------------------------------------------------
// Single-part encoder
// --------------------------------------------------------------------------

class PartEncoder {
 public:
  void add_group(const CdfGroup &g) { groups_.push_back(&g); }

  void encode(const int16_t *symbols, const int16_t *indexes, int n,
              int group_idx) {
    const CdfGroup &g = *groups_[group_idx];
    buf_.reserve(buf_.size() + static_cast<size_t>(n) * 3 / 2);
    for (int i = 0; i < n; ++i) {
      const int32_t cdf_idx = indexes[i];
      if (cdf_idx < 0) continue;  // force-zero skip
      const int32_t max_value = g.sizes[cdf_idx] - 2;
      int32_t value = symbols[i] - g.offsets[cdf_idx];

      uint32_t raw_val = 0;
      if (value < 0) {
        raw_val = static_cast<uint32_t>(-2 * value - 1);
        value = max_value;
      } else if (value >= max_value) {
        raw_val = static_cast<uint32_t>(2 * (value - max_value));
        value = max_value;
      }
      buf_.push_back(g.sym_rows[cdf_idx][value]);

      if (value == max_value) {
        // escape: emit chunk count then the raw value, kBypassBits at a time
        int32_t n_bypass = 0;
        while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;
        int32_t v = n_bypass;
        while (v >= kMaxBypassVal) {
          buf_.push_back({kMaxBypassVal, 0});
          v -= kMaxBypassVal;
        }
        buf_.push_back({static_cast<uint16_t>(v), 0});
        for (int32_t j = 0; j < n_bypass; ++j) {
          buf_.push_back({static_cast<uint16_t>(
                              (raw_val >> (j * kBypassBits)) & kMaxBypassVal),
                          0});
        }
      }
    }
  }

  void flush() {
    uint32_t x = kRansL;
    std::vector<uint8_t> rev;
    rev.reserve(buf_.size() * 2 + 8);
    // rANS is LIFO: walk the buffered symbols backwards, emit bytes forward
    // into `rev`, then reverse once at the end.
    for (auto it = buf_.rbegin(); it != buf_.rend(); ++it) {
      if (it->range != 0) {
        enc_renorm(x, rev, it->range);
        x = ((x / it->range) << kPrecision) + (x % it->range) + it->start;
      } else {
        // raw bits put: freq = 1 << (precision - nbits)
        const uint32_t freq = 1u << (kPrecision - kBypassBits);
        enc_renorm(x, rev, freq);
        x = (x << kBypassBits) | it->start;
      }
    }
    // final state, little-endian, most significant byte first in `rev`
    rev.push_back(static_cast<uint8_t>(x >> 24));
    rev.push_back(static_cast<uint8_t>(x >> 16));
    rev.push_back(static_cast<uint8_t>(x >> 8));
    rev.push_back(static_cast<uint8_t>(x >> 0));
    stream_.assign(rev.rbegin(), rev.rend());
  }

  void reset() { buf_.clear(); }
  const std::vector<uint8_t> &stream() const { return stream_; }

 private:
  std::vector<const CdfGroup *> groups_;
  std::vector<CodedSym> buf_;
  std::vector<uint8_t> stream_;
};

// --------------------------------------------------------------------------
// Single-part decoder
// --------------------------------------------------------------------------

class PartDecoder {
 public:
  void add_group(const CdfGroup &g) { groups_.push_back(&g); }

  void set_stream(const uint8_t *data, size_t n) {
    data_.assign(data, data + n);
    // Guard bytes: a well-formed decode never reads past the payload, but
    // mismatched index vectors must not run off the buffer (UB in ref impl).
    data_.insert(data_.end(), 8, 0);
    pos_ = 0;
    x_ = static_cast<uint32_t>(data_[0]) | (static_cast<uint32_t>(data_[1]) << 8) |
         (static_cast<uint32_t>(data_[2]) << 16) |
         (static_cast<uint32_t>(data_[3]) << 24);
    pos_ = 4;
  }

  // One symbol against group g's row cdf_idx (negative => skipped symbol,
  // emits 0). Factored out of the loop so the multi-stream interleaved
  // decode can drive many decoders' independent state chains from one
  // loop (ILP: the state update of one chain overlaps the CDF lookup of
  // the next on a single core).
  inline int16_t decode_one(const CdfGroup &g, int32_t cdf_idx) {
    if (cdf_idx < 0) return 0;
    const int32_t *cdf = g.cdf_rows[cdf_idx].data();
    const int32_t size = g.sizes[cdf_idx];
    const int32_t max_value = size - 2;
    const uint32_t cum = x_ & ((1u << kPrecision) - 1);

    // coarse-table start + short scan (see InvBank)
    int32_t s = g.inv->rows[cdf_idx][cum >> kInvShift];
    while (s + 1 < size && static_cast<uint32_t>(cdf[s + 1]) <= cum) ++s;

    advance(static_cast<uint32_t>(cdf[s]),
            static_cast<uint32_t>(cdf[s + 1] - cdf[s]));

    int32_t value = s;
    if (value == max_value) {
      int32_t v = static_cast<int32_t>(get_bits(kBypassBits));
      int32_t n_bypass = v;
      while (v == kMaxBypassVal) {
        v = static_cast<int32_t>(get_bits(kBypassBits));
        n_bypass += v;
      }
      uint32_t raw_val = 0;
      for (int32_t j = 0; j < n_bypass; ++j) {
        raw_val |= get_bits(kBypassBits) << (j * kBypassBits);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    return static_cast<int16_t>(value + g.offsets[cdf_idx]);
  }

  void decode(const int16_t *indexes, int n, int group_idx, int16_t *out) {
    const CdfGroup &g = *groups_[group_idx];
    for (int i = 0; i < n; ++i) {
      out[i] = decode_one(g, indexes[i]);
    }
  }

  const CdfGroup &group(int idx) const { return *groups_[idx]; }

 private:
  void advance(uint32_t start, uint32_t freq) {
    const uint32_t mask = (1u << kPrecision) - 1;
    x_ = freq * (x_ >> kPrecision) + (x_ & mask) - start;
    while (x_ < kRansL) {
      x_ = (x_ << 8) | data_[pos_++];
    }
  }

  uint32_t get_bits(uint32_t nbits) {
    const uint32_t val = x_ & ((1u << nbits) - 1);
    x_ >>= nbits;
    if (x_ < kRansL) {
      x_ = (x_ << 8) | data_[pos_++];
    }
    return val;
  }

  std::vector<const CdfGroup *> groups_;
  std::vector<uint8_t> data_;
  size_t pos_ = 0;
  uint32_t x_ = 0;
};

// --------------------------------------------------------------------------
// Multi-part encoder/decoder with the container format
// --------------------------------------------------------------------------

struct Encoder {
  explicit Encoder(int parts) : parts(std::max(1, parts)) {
    encs.resize(this->parts);
  }
  int parts;
  std::vector<CdfGroup> groups;
  std::vector<PartEncoder> encs;
  std::vector<uint8_t> container;

  int add_cdf(const int32_t *cdfs, int n_cdf, int width,
              const int32_t *sizes, const int32_t *offsets) {
    CdfGroup g;
    g.sizes.assign(sizes, sizes + n_cdf);
    g.offsets.assign(offsets, offsets + n_cdf);
    g.cdf_rows.resize(n_cdf);
    g.sym_rows.resize(n_cdf);
    for (int i = 0; i < n_cdf; ++i) {
      const int32_t *row = cdfs + static_cast<size_t>(i) * width;
      g.cdf_rows[i].assign(row, row + width);
      g.sym_rows[i].resize(width > 0 ? width - 1 : 0);
      for (int j = 0; j + 1 < width; ++j) {
        g.sym_rows[i][j] = {static_cast<uint16_t>(row[j]),
                            static_cast<uint16_t>(row[j + 1] - row[j])};
      }
    }
    groups.push_back(std::move(g));
    const int idx = static_cast<int>(groups.size()) - 1;
    for (auto &e : encs) e.add_group(groups.back());
    return idx;
  }

  void encode(const int16_t *symbols, const int16_t *indexes, int n,
              int group_idx) {
    const int each = n / parts;
    for (int p = 0; p < parts; ++p) {
      const int off = p * each;
      const int cnt = (p == parts - 1) ? n - off : each;
      encs[p].encode(symbols + off, indexes + off, cnt, group_idx);
    }
  }

  void flush() {
    if (parts == 1) {
      encs[0].flush();
    } else {
      std::vector<std::thread> ts;
      ts.reserve(parts);
      for (int p = 0; p < parts; ++p) {
        ts.emplace_back([this, p] { encs[p].flush(); });
      }
      for (auto &t : ts) t.join();
    }
    build_container();
  }

  void build_container() {
    size_t total = 0, maximum = 0;
    for (int p = 0; p < parts; ++p) {
      const size_t n = encs[p].stream().size();
      total += n;
      if (p < parts - 1 && n > maximum) maximum = n;
    }
    const int per_header = maximum > 65535 ? 4 : 2;
    size_t overhead = 1;
    if (parts > 1) overhead += static_cast<size_t>(parts - 1) * per_header;

    container.assign(total + overhead, 0);
    container[0] = static_cast<uint8_t>(((parts - 1) << 4) +
                                        (per_header == 2 ? 1 : 0));
    for (int p = 0; p < parts - 1; ++p) {
      const uint32_t n = static_cast<uint32_t>(encs[p].stream().size());
      if (per_header == 2) {
        const uint16_t n16 = static_cast<uint16_t>(n);
        std::memcpy(container.data() + 1 + 2 * p, &n16, 2);
      } else {
        std::memcpy(container.data() + 1 + 4 * p, &n, 4);
      }
    }
    size_t off = overhead;
    for (int p = 0; p < parts; ++p) {
      const auto &s = encs[p].stream();
      std::memcpy(container.data() + off, s.data(), s.size());
      off += s.size();
    }
  }

  void reset() {
    for (auto &e : encs) e.reset();
    container.clear();
  }
};

struct Decoder {
  explicit Decoder(int parts) : parts(std::max(1, parts)) {
    decs.resize(this->parts);
  }
  int parts;
  std::vector<CdfGroup> groups;
  std::vector<PartDecoder> decs;

  int add_cdf(const int32_t *cdfs, int n_cdf, int width,
              const int32_t *sizes, const int32_t *offsets) {
    CdfGroup g;
    g.sizes.assign(sizes, sizes + n_cdf);
    g.offsets.assign(offsets, offsets + n_cdf);
    g.cdf_rows.resize(n_cdf);
    for (int i = 0; i < n_cdf; ++i) {
      const int32_t *row = cdfs + static_cast<size_t>(i) * width;
      g.cdf_rows[i].assign(row, row + width);
    }
    g.inv = get_inv_bank(g.cdf_rows, g.sizes);
    groups.push_back(std::move(g));
    for (auto &d : decs) d.add_group(groups.back());
    return static_cast<int>(groups.size()) - 1;
  }

  void set_stream(const uint8_t *data, size_t n) {
    const uint8_t flag = data[0];
    const int n_streams = (flag >> 4) + 1;
    const int per_header = (flag & 0x0f) == 1 ? 2 : 4;
    std::vector<uint32_t> sizes;
    size_t off = 1, declared = 0;
    for (int i = 0; i < n_streams - 1; ++i) {
      uint32_t s = 0;
      if (per_header == 2) {
        uint16_t s16;
        std::memcpy(&s16, data + off, 2);
        s = s16;
        off += 2;
      } else {
        std::memcpy(&s, data + off, 4);
        off += 4;
      }
      sizes.push_back(s);
      declared += s;
    }
    sizes.push_back(static_cast<uint32_t>(n - off - declared));
    for (int i = 0; i < n_streams; ++i) {
      decs[i].set_stream(data + off, sizes[i]);
      off += sizes[i];
    }
  }

  void decode(const int16_t *indexes, int n, int group_idx, int16_t *out) {
    const int each = n / parts;
    if (parts == 1) {
      decs[0].decode(indexes, n, group_idx, out);
      return;
    }
    std::vector<std::thread> ts;
    ts.reserve(parts);
    for (int p = 0; p < parts; ++p) {
      const int off = p * each;
      const int cnt = (p == parts - 1) ? n - off : each;
      ts.emplace_back([this, p, indexes, off, cnt, group_idx, out] {
        decs[p].decode(indexes + off, cnt, group_idx, out + off);
      });
    }
    for (auto &t : ts) t.join();
  }
};

// Multi-stream decode: one call decodes the SAME number of symbols from
// n_dec independent decoders (SURVEY section 7's "batched rANS driven by
// device-computed CDF indices") — a single native call for a whole serving
// chunk instead of one ctypes round trip (or pooled thread) per stream.
// Streams decode back to back: a round-robin ILP interleave of the state
// chains was measured SLOWER on the serving bank (32.7 vs 39.3 Msym/s) —
// the per-symbol loop is bounded by branch mispredicts (scan exit, renorm)
// and per-cursor state traffic, not by chain latency, so interleaving only
// added overhead. Semantics identical to per-decoder decode.
void decode_multi(Decoder *const *ds, int n_dec, const int16_t *indexes,
                  int n, int group_idx, int16_t *out) {
  for (int d = 0; d < n_dec; ++d) {
    ds[d]->decode(indexes + static_cast<size_t>(d) * n, n, group_idx,
                  out + static_cast<size_t>(d) * n);
  }
}

}  // namespace

// --------------------------------------------------------------------------
// C API
// --------------------------------------------------------------------------

extern "C" {

void *onedc_encoder_new(int stream_parts) { return new Encoder(stream_parts); }
void onedc_encoder_free(void *e) { delete static_cast<Encoder *>(e); }

int onedc_encoder_add_cdf(void *e, const int32_t *cdfs, int n_cdf, int width,
                          const int32_t *sizes, const int32_t *offsets) {
  return static_cast<Encoder *>(e)->add_cdf(cdfs, n_cdf, width, sizes, offsets);
}

void onedc_encoder_encode(void *e, const int16_t *symbols,
                          const int16_t *indexes, int n, int group) {
  static_cast<Encoder *>(e)->encode(symbols, indexes, n, group);
}

void onedc_encoder_flush(void *e) { static_cast<Encoder *>(e)->flush(); }

int onedc_encoder_stream_size(void *e) {
  return static_cast<int>(static_cast<Encoder *>(e)->container.size());
}

void onedc_encoder_get_stream(void *e, uint8_t *out) {
  const auto &c = static_cast<Encoder *>(e)->container;
  std::memcpy(out, c.data(), c.size());
}

void onedc_encoder_reset(void *e) { static_cast<Encoder *>(e)->reset(); }

void onedc_encoder_clear_cdfs(void *e) {
  auto *enc = static_cast<Encoder *>(e);
  const int parts = enc->parts;
  enc->groups.clear();
  enc->encs.assign(parts, PartEncoder());
}

void *onedc_decoder_new(int stream_parts) { return new Decoder(stream_parts); }
void onedc_decoder_free(void *d) { delete static_cast<Decoder *>(d); }

int onedc_decoder_add_cdf(void *d, const int32_t *cdfs, int n_cdf, int width,
                          const int32_t *sizes, const int32_t *offsets) {
  return static_cast<Decoder *>(d)->add_cdf(cdfs, n_cdf, width, sizes, offsets);
}

void onedc_decoder_set_stream(void *d, const uint8_t *data, int n) {
  static_cast<Decoder *>(d)->set_stream(data, static_cast<size_t>(n));
}

void onedc_decoder_decode(void *d, const int16_t *indexes, int n, int group,
                          int16_t *out) {
  static_cast<Decoder *>(d)->decode(indexes, n, group, out);
}

// `indexes`/`out` are row-major (n_dec, n); every decoder decodes row d.
void onedc_decoder_decode_multi(void *const *handles, int n_dec,
                                const int16_t *indexes, int n, int group,
                                int16_t *out) {
  std::vector<Decoder *> ds(static_cast<size_t>(n_dec));
  for (int i = 0; i < n_dec; ++i) {
    ds[static_cast<size_t>(i)] = static_cast<Decoder *>(handles[i]);
  }
  decode_multi(ds.data(), n_dec, indexes, n, group, out);
}

void onedc_decoder_clear_cdfs(void *d) {
  auto *dec = static_cast<Decoder *>(d);
  const int parts = dec->parts;
  dec->groups.clear();
  dec->decs.assign(parts, PartDecoder());
}

// PMF -> quantized 16-bit CDF with frequency stealing; semantics match the
// reference's MLCodec_CXX.pmf_to_quantized_cdf (src/cpp/ops/ops.cpp:24-82):
// float round of p * 2^precision (+0.5 trunc), integer renormalization to
// total 2^precision, then steal from the smallest freq>1 bucket to remove
// zero-width buckets.
void onedc_pmf_to_quantized_cdf(const float *pmf, int n, int precision,
                                uint32_t *cdf /* n + 1 */) {
  cdf[0] = 0;
  for (int i = 0; i < n; ++i) {
    cdf[i + 1] = static_cast<uint32_t>(
        std::round(pmf[i] * static_cast<float>(1 << precision)) + 0.5);
  }
  uint64_t total = 0;
  for (int i = 0; i <= n; ++i) total += cdf[i];
  if (total == 0) total = 1;
  for (int i = 0; i <= n; ++i) {
    cdf[i] = static_cast<uint32_t>(
        ((1ull << precision) * static_cast<uint64_t>(cdf[i])) / total);
  }
  for (int i = 1; i <= n; ++i) cdf[i] += cdf[i - 1];
  cdf[n] = 1u << precision;

  for (int i = 0; i < n; ++i) {
    if (cdf[i] != cdf[i + 1]) continue;
    uint32_t best_freq = ~0u;
    int best_steal = -1;
    for (int j = 0; j < n; ++j) {
      const uint32_t freq = cdf[j + 1] - cdf[j];
      if (freq > 1 && freq < best_freq) {
        best_freq = freq;
        best_steal = j;
      }
    }
    if (best_steal < 0) continue;
    if (best_steal < i) {
      for (int j = best_steal + 1; j <= i; ++j) cdf[j]--;
    } else {
      for (int j = i + 1; j <= best_steal; ++j) cdf[j]++;
    }
  }
}

}  // extern "C"
