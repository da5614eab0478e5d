// Native host-side LZ4 block codec (clean-room, written from the format
// contract in lz4_sgori_tpu/format.py + docs/BlockFormat.md — the same
// greedy level-1 semantics as the Python golden codec, which is itself
// byte-parity with LZ4_compress_default).
//
// Role in the framework: the reference's runtime is native kernel C; this
// is the TPU framework's native host runtime piece — the fast CPU path for
// container IO, the write-verify fallback encoder, and a third
// cross-implementation oracle for tests. The TPU compute path stays
// JAX/XLA (ops/); this file is deliberately scalar C++ because the host
// side is latency-bound, not lane-bound.
//
// Exported C ABI (bound via ctypes in lz4_sgori_tpu/native/__init__.py):
//   int  lz4j_compress_bound(int n);
//   int  lz4j_compress_default(const uint8_t* src, uint8_t* dst,
//                              int src_size, int dst_cap);
//   int  lz4j_decompress_safe(const uint8_t* src, uint8_t* dst,
//                             int src_size, int dst_cap);
// Return: bytes written, or 0 (compress failure) / negative input position
// (malformed decode), matching the classic LZ4 API conventions.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMinMatch = 4;
constexpr int kLastLiterals = 5;
constexpr int kMfLimit = 12;       // WILDCOPYLENGTH + MINMATCH
constexpr int kMinLength = 13;     // MFLIMIT + 1
constexpr int kMlBits = 4;
constexpr int kMlMask = (1 << kMlBits) - 1;
constexpr int kRunMask = (1 << (8 - kMlBits)) - 1;
constexpr int kDistanceMax = 65535;
constexpr int kSkipTrigger = 6;
constexpr int64_t kMaxInputSize = 0x7E000000;
constexpr uint32_t kHash4Prime = 2654435761u;
constexpr uint64_t kHash5Prime = 889523592379ull;
constexpr int kHashLog = 12;       // MEMORY_USAGE 14 -> 4096-entry table
constexpr int kSmallInputLimit = 65536 + (kMfLimit - 1);

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/arm64), matching the format
}

inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t hash4(uint32_t v, int hashlog) {
  return (v * kHash4Prime) >> (32 - hashlog);
}

inline uint32_t hash5(uint64_t v, int hashlog) {
  return static_cast<uint32_t>(((v << 24) * kHash5Prime) >> (64 - hashlog));
}

}  // namespace

extern "C" {

int lz4j_compress_bound(int n) {
  if (n < 0 || static_cast<int64_t>(n) > kMaxInputSize) return 0;
  return n + n / 255 + 16;
}

int lz4j_compress_default(const uint8_t* src, uint8_t* dst, int src_size,
                          int dst_cap) {
  if (src_size < 0 || static_cast<int64_t>(src_size) > kMaxInputSize)
    return 0;
  const int bound = lz4j_compress_bound(src_size);
  const bool limited = dst_cap < bound;
  const int n = src_size;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  const bool small = n < kSmallInputLimit;
  const int hashlog = small ? kHashLog + 1 : kHashLog;
  auto hpos = [&](int i) -> uint32_t {
    return small ? hash4(read32(src + i), hashlog)
                 : hash5(read64(src + i), hashlog);
  };

  int anchor = 0;
  if (n >= kMinLength) {
    std::vector<int32_t> table(static_cast<size_t>(1) << hashlog, 0);
    const int mflimit = n - kMfLimit;      // last legal match start
    const int matchlimit = n - kLastLiterals;

    table[hpos(0)] = 0;
    int pos = 1;
    uint32_t fh = hpos(1);

    for (;;) {
      // --- skip-accelerated candidate search ---
      int fpos = pos, step = 1;
      int search_match_nb = 1 << kSkipTrigger;  // acceleration 1
      int mpos;
      bool found = false;
      for (;;) {
        const uint32_t h = fh;
        if (fpos + step > mflimit + 1) break;
        pos = fpos;
        fpos += step;
        step = search_match_nb++ >> kSkipTrigger;
        mpos = table[h];
        fh = hpos(fpos);
        table[h] = pos;
        if ((small || mpos + kDistanceMax >= pos) &&
            read32(src + mpos) == read32(src + pos)) {
          found = true;
          break;
        }
      }
      if (!found) break;

      // --- catch up ---
      while (pos > anchor && mpos > 0 && src[pos - 1] == src[mpos - 1]) {
        --pos;
        --mpos;
      }

      // --- literals ---
      int lit_len = pos - anchor;
      uint8_t* token = op;
      if (limited &&
          op + 1 + lit_len + (2 + 1 + kLastLiterals) + lit_len / 255 > oend)
        return 0;
      ++op;
      int tok;
      if (lit_len >= kRunMask) {
        tok = kRunMask << kMlBits;
        int rem = lit_len - kRunMask;
        for (; rem >= 255; rem -= 255) *op++ = 255;
        *op++ = static_cast<uint8_t>(rem);
      } else {
        tok = lit_len << kMlBits;
      }
      std::memcpy(op, src + anchor, lit_len);
      op += lit_len;

      // --- match(es) ---
      for (;;) {
        const int offset = pos - mpos;
        *op++ = static_cast<uint8_t>(offset);
        *op++ = static_cast<uint8_t>(offset >> 8);

        int p = pos + kMinMatch, m = mpos + kMinMatch;
        const int count_limit = matchlimit - p;
        int mc = 0;
        while (mc < count_limit && src[p + mc] == src[m + mc]) ++mc;
        pos = p + mc;

        if (limited && op + 1 + kLastLiterals + (mc >> 8) > oend) return 0;
        if (mc >= kMlMask) {
          tok += kMlMask;
          int rem = mc - kMlMask;
          for (; rem >= 255; rem -= 255) *op++ = 255;
          *op++ = static_cast<uint8_t>(rem);
        } else {
          tok += mc;
        }
        *token = static_cast<uint8_t>(tok);

        anchor = pos;
        if (pos > mflimit) break;

        table[hpos(pos - 2)] = pos - 2;  // refill
        const uint32_t h = hpos(pos);
        mpos = table[h];
        table[h] = pos;
        if ((small || mpos + kDistanceMax >= pos) &&
            read32(src + mpos) == read32(src + pos)) {
          tok = 0;
          token = op++;
          continue;
        }
        break;
      }

      if (pos > mflimit) break;
      ++pos;
      fh = hpos(pos);
    }
  }

  // --- last literals ---
  const int last_run = n - anchor;
  if (limited &&
      op + last_run + 1 + (last_run + 255 - kRunMask) / 255 > oend)
    return 0;
  if (last_run >= kRunMask) {
    *op++ = kRunMask << kMlBits;
    int rem = last_run - kRunMask;
    for (; rem >= 255; rem -= 255) *op++ = 255;
    *op++ = static_cast<uint8_t>(rem);
  } else {
    *op++ = static_cast<uint8_t>(last_run << kMlBits);
  }
  std::memcpy(op, src + anchor, last_run);
  op += last_run;
  return static_cast<int>(op - dst);
}

int lz4j_decompress_safe(const uint8_t* src, uint8_t* dst, int src_size,
                         int dst_cap) {
  if (src_size <= 0) return -1;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_size;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;

  for (;;) {
    if (ip >= iend) return -static_cast<int>(ip - src) - 1;
    const int token = *ip++;

    // literal length
    // LSIC lengths accumulate in int64_t: a malicious 0xFF chain would wrap
    // a 32-bit accumulator (UB) and defeat the bound checks below. Any
    // length beyond dst_cap is invalid regardless, so fail as soon as it is
    // exceeded — int64_t cannot wrap first (<= 255 per extension byte).
    int64_t lit_len = token >> kMlBits;
    if (lit_len == kRunMask) {
      int b;
      do {
        if (ip >= iend) return -static_cast<int>(ip - src) - 1;
        b = *ip++;
        lit_len += b;
        if (lit_len > dst_cap) return -static_cast<int>(ip - src) - 1;
      } while (b == 255);
    }
    if (ip + lit_len > iend) return -static_cast<int>(ip - src) - 1;
    if (op + lit_len > oend) return -static_cast<int>(ip - src) - 1;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;

    if (ip == iend) break;  // literal-only terminal sequence

    // offset
    if (ip + 2 > iend) return -static_cast<int>(ip - src) - 1;
    const int offset = ip[0] | (ip[1] << 8);
    ip += 2;
    const uint8_t* match = op - offset;
    if (offset == 0 || match < dst) return -static_cast<int>(ip - src) - 1;

    // match length
    // same int64_t LSIC overflow guard as the literal-length loop above
    int64_t ml = (token & kMlMask) + kMinMatch;
    if ((token & kMlMask) == kMlMask) {
      int b;
      do {
        if (ip >= iend) return -static_cast<int>(ip - src) - 1;
        b = *ip++;
        ml += b;
        if (ml > dst_cap) return -static_cast<int>(ip - src) - 1;
      } while (b == 255);
    }
    if (op + ml > oend) return -static_cast<int>(ip - src) - 1;
    for (int k = 0; k < ml; ++k) op[k] = match[k];  // overlap-safe forward copy
    op += ml;
  }
  return static_cast<int>(op - dst);
}

}  // extern "C"
