// A Zstandard frame decoder (RFC 8878) and the CRC-32C of the OCDBT files,
// for the port's reader of orbax train-state directories
// (`lwdetr_tpu_torch/train/orbax_read.py`).
//
// Orbax writes a train state through tensorstore: an OCDBT key-value store
// whose manifests and b-tree nodes are zstd-compressed and checksummed with
// CRC-32C, holding zarr v2 arrays whose chunks are zstd frames. Python has no
// zstd module and the port depends on no package that has one, so the
// decoder is here. It decodes every frame a conforming encoder emits:
//
//   * frames with or without the content size, single-segment or not, with a
//     window of up to 2^31 bytes, with or without the XXH64 content checksum
//     (verified when present); concatenated frames and skippable frames;
//   * raw, RLE and compressed blocks;
//   * raw, RLE, Huffman-compressed and treeless literals, in 1 or 4 streams,
//     the Huffman weights FSE-coded or direct;
//   * sequences with predefined, RLE, FSE-compressed and repeated tables,
//     and the repeat-offset history.
//
// Dictionaries are not supported (orbax writes none): a frame that names one
// is refused. Every malformed or truncated input gives a negative error code
// (`zstd_error_name`), never a read or write outside the buffers.
//
// The whole output of a call stays in one buffer, so a match reads its
// source from the output itself and no separate window is kept.
//
// Plain C ABI, loaded through ctypes; built with g++ at first use.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Error : int64_t {
  kOk = 0,
  kTruncated = -1,          // the input ends inside a frame
  kBadMagic = -2,           // bytes that start no zstd or skippable frame
  kReserved = -3,           // a reserved bit or value is set
  kDictionary = -4,         // the frame needs a dictionary
  kWindow = -5,             // window larger than 2^31
  kBlockSize = -6,          // a block larger than 128 KiB
  kLiterals = -7,           // malformed literals section
  kHuffman = -8,            // malformed Huffman table or stream
  kFse = -9,                // malformed FSE table description
  kSequences = -10,         // malformed sequences section
  kOffset = -11,            // a match reaching before the frame's start
  kContentSize = -12,       // the frame's size differs from its header's
  kChecksum = -13,          // content checksum mismatch
  kOutputFull = -14,        // the output exceeds the caller's capacity or limit
  kNoFrame = -15,           // the input holds no frame
  kAlloc = -16,             // out of memory
};

constexpr size_t kBlockMax = 128 * 1024;

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ---- output -------------------------------------------------------------

struct Out {
  uint8_t* p = nullptr;
  size_t len = 0, cap = 0, limit = 0;
  bool grow = false;

  // Room for `extra` more bytes: kOk, kOutputFull or kAlloc.
  int64_t reserve(size_t extra) {
    if (extra > limit - len) return kOutputFull;
    size_t need = len + extra;
    if (need <= cap) return kOk;
    if (!grow) return kOutputFull;
    size_t next = cap ? cap : 1 << 16;
    while (next < need) next = next > limit / 2 ? limit : next * 2;
    uint8_t* q = static_cast<uint8_t*>(std::realloc(p, next));
    if (!q) return kAlloc;
    p = q;
    cap = next;
    return kOk;
  }
};

// ---- bit readers ----------------------------------------------------------

inline uint64_t load_le(const uint8_t* p, size_t n, size_t at) {
  if (at + 8 <= n) {
    uint64_t v;
    std::memcpy(&v, p + at, 8);
    return v;
  }
  uint64_t v = 0;
  for (size_t i = 0; at + i < n && i < 8; ++i) v |= uint64_t(p[at + i]) << (8 * i);
  return v;
}

// Little-endian, least significant bit first (the FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // bits consumed
  uint32_t peek(int nb) const {  // nb <= 25; zeros past the end
    uint64_t v = load_le(p, n, pos >> 3) >> (pos & 7);
    return uint32_t(v & ((uint64_t(1) << nb) - 1));
  }
  void skip(int nb) { pos += nb; }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    pos += nb;
    return v;
  }
};

// Read from the end toward the start (Huffman streams and sequences): the
// last byte's highest set bit marks the start; a field read takes the next
// bits downward, the first read most significant. Bits below the start of the
// stream read as zeros and drive `pos` negative, which callers check.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;  // bits left
  bool init(const uint8_t* src, size_t len) {
    if (len == 0 || src[len - 1] == 0) return false;
    p = src;
    n = len;
    pos = int64_t(len - 1) * 8 + highbit32(src[len - 1]);
    return true;
  }
  uint64_t peek(int nb) const {  // nb <= 56
    if (nb == 0) return 0;
    int64_t lo = pos - nb;
    if (lo >= 0) return (load_le(p, n, size_t(lo >> 3)) >> (lo & 7)) & ((uint64_t(1) << nb) - 1);
    if (pos <= 0) return 0;
    return (load_le(p, n, 0) & ((uint64_t(1) << pos) - 1)) << (-lo);
  }
  uint64_t read(int nb) {
    uint64_t v = peek(nb);
    pos -= nb;
    return v;
  }
};

// ---- checksums ----------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t merge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }
inline uint64_t rd64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int k = 1; k < 8; ++k) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};

const CrcTables& crc_tables() {
  static const CrcTables tables;  // built once, thread-safe
  return tables;
}


uint64_t xxh64_impl(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += uint64_t(len);
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- FSE ------------------------------------------------------------------

struct FseEntry {
  uint16_t base;
  uint8_t sym;
  uint8_t bits;
};

struct FseTable {
  int log = 0;
  bool valid = false;
  FseEntry t[512];
};

// Reads an FSE table description (RFC 8878 4.1.1); returns the bytes it took
// or an error.
int64_t read_ncount(const uint8_t* src, size_t n, int max_sym, int max_log, int16_t* norm,
                    int* last_sym, int* table_log) {
  if (n == 0) return kTruncated;
  ForwardBits fb{src, n};
  int log = int(fb.read(4)) + 5;
  if (log > max_log) return kFse;
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  int nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  for (int i = 0; i <= max_sym; ++i) norm[i] = 0;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int r;
      while ((r = int(fb.read(2))) == 3) {
        sym += 3;
        if (sym > max_sym) return kFse;
      }
      sym += r;
      if (sym > max_sym) return kFse;
    }
    int max = (2 * threshold - 1) - remaining;
    uint32_t v = fb.peek(nbits);
    int count;
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      fb.skip(nbits - 1);
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      fb.skip(nbits);
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold && threshold > 1) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) return kFse;
  size_t used = (fb.pos + 7) >> 3;
  if (used > n) return kTruncated;
  *last_sym = sym - 1;
  *table_log = log;
  return int64_t(used);
}

bool build_fse(FseTable& tab, const int16_t* norm, int last_sym, int log) {
  const int size = 1 << log;
  int high = size - 1;
  uint16_t next[256];
  for (int s = 0; s <= last_sym; ++s) {
    if (norm[s] == -1) {
      tab.t[high--].sym = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s <= last_sym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      tab.t[pos].sym = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) return false;
  for (int u = 0; u < size; ++u) {
    uint32_t ns = next[tab.t[u].sym]++;
    if (ns == 0) return false;
    int nb = log - highbit32(ns);
    tab.t[u].bits = uint8_t(nb);
    tab.t[u].base = uint16_t((ns << nb) - size);
  }
  tab.log = log;
  tab.valid = true;
  return true;
}

void rle_fse(FseTable& tab, uint8_t sym) {
  tab.log = 0;
  tab.t[0] = FseEntry{0, sym, 0};
  tab.valid = true;
}

// ---- sequence codes ---------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
// the predefined distributions (RFC 8878 3.1.1.3.2.2)
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---- Huffman ----------------------------------------------------------------

struct HufEntry {
  uint8_t sym;
  uint8_t bits;
};

struct HufTable {
  int max_bits = 0;
  bool valid = false;
  HufEntry t[1 << 11];
};

// Reads a Huffman tree description; returns the bytes it took or an error.
int64_t read_huffman(HufTable& huf, const uint8_t* src, size_t n) {
  if (n == 0) return kTruncated;
  uint8_t weights[258];
  int nw = 0;
  const int header = src[0];
  int64_t used;
  if (header < 128) {  // FSE-compressed weights, two interleaved states
    if (size_t(header) + 1 > n) return kTruncated;
    int16_t norm[256];
    int last, log;
    int64_t k = read_ncount(src + 1, header, 255, 6, norm, &last, &log);
    if (k < 0) return k == kTruncated ? kHuffman : k;
    FseTable tab;
    if (!build_fse(tab, norm, last, log)) return kHuffman;
    BackBits bb;
    if (!bb.init(src + 1 + k, size_t(header - k))) return kHuffman;
    uint32_t s1 = uint32_t(bb.read(log)), s2 = uint32_t(bb.read(log));
    for (;;) {
      if (nw > 255) return kHuffman;
      const FseEntry& e1 = tab.t[s1];
      weights[nw++] = e1.sym;
      s1 = e1.base + uint32_t(bb.read(e1.bits));
      if (bb.pos < 0) {
        weights[nw++] = tab.t[s2].sym;
        break;
      }
      const FseEntry& e2 = tab.t[s2];
      weights[nw++] = e2.sym;
      s2 = e2.base + uint32_t(bb.read(e2.bits));
      if (bb.pos < 0) {
        weights[nw++] = tab.t[s1].sym;
        break;
      }
    }
    if (nw > 255) return kHuffman;
    used = 1 + header;
  } else {  // direct: 4 bits a weight
    nw = header - 127;
    size_t bytes = (nw + 1) / 2;
    if (1 + bytes > n) return kTruncated;
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = int64_t(1 + bytes);
  }
  uint32_t total = 0;
  for (int i = 0; i < nw; ++i) {
    if (weights[i] > 11) return kHuffman;
    if (weights[i]) total += uint32_t(1) << (weights[i] - 1);
  }
  if (total == 0) return kHuffman;
  const int max_bits = highbit32(total) + 1;
  if (max_bits > 11) return kHuffman;
  const uint32_t rest = (uint32_t(1) << max_bits) - total;
  if (rest & (rest - 1)) return kHuffman;
  weights[nw++] = uint8_t(highbit32(rest) + 1);
  // canonical codes: by weight, then symbol, the lowest weights first
  uint32_t start[13] = {0};
  uint32_t count[13] = {0};
  for (int s = 0; s < nw; ++s) count[weights[s]]++;
  // a prefix code's deepest level holds an even number of codes, two at least
  if (count[1] < 2 || (count[1] & 1)) return kHuffman;
  uint32_t next = 0;
  for (int w = 1; w <= max_bits; ++w) {
    start[w] = next;
    next += count[w] << (w - 1);
  }
  if (next != (uint32_t(1) << max_bits)) return kHuffman;
  for (int s = 0; s < nw; ++s) {
    int w = weights[s];
    if (!w) continue;
    uint32_t len = uint32_t(1) << (w - 1);
    HufEntry e{uint8_t(s), uint8_t(max_bits + 1 - w)};
    for (uint32_t u = start[w]; u < start[w] + len; ++u) huf.t[u] = e;
    start[w] += len;
  }
  huf.max_bits = max_bits;
  huf.valid = true;
  return used;
}

// One Huffman-coded stream of literals, decoded into `out[0, left)`.
struct HufStream {
  BackBits bb;
  uint8_t* out = nullptr;
  size_t left = 0;

  bool init(const uint8_t* src, size_t n, uint8_t* dst, size_t count) {
    out = dst;
    left = count;
    return bb.init(src, n);
  }
  // while 64 bits lie below `pos`, one load whose top bit is the stream's
  // next gives at least 57 bits: five codes of at most 11 bits
  bool fast() const { return bb.pos >= 64 && left >= 5; }
  void five(const HufTable& huf) {
    // locals: a byte store may alias any member, which would then be reloaded
    const HufEntry* t = huf.t;
    const int drop = 64 - huf.max_bits;
    int64_t pos = bb.pos;
    uint8_t* o = out;
    const int64_t top = (pos + 7) >> 3;  // bytes [top - 8, top) hold bit pos - 1
    uint64_t v;
    std::memcpy(&v, bb.p + top - 8, 8);
    v <<= top * 8 - pos;
    for (int k = 0; k < 5; ++k) {
      const HufEntry e = t[v >> drop];
      o[k] = e.sym;
      v <<= e.bits;
      pos -= e.bits;
    }
    bb.pos = pos;
    out = o + 5;
    left -= 5;
  }
  // the rest of the stream; true when it ends exactly at its first bit
  bool finish(const HufTable& huf) {
    while (fast()) five(huf);
    for (; left; --left) {
      const HufEntry& e = huf.t[bb.peek(huf.max_bits)];
      *out++ = e.sym;
      bb.pos -= e.bits;
    }
    return bb.pos == 0;
  }
};

// ---- frames -----------------------------------------------------------------

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3];
  std::vector<uint8_t> lits;
};

struct Decoder {
  const uint8_t* src;
  size_t n;
  Out& out;
  FrameState st;

  // The literals section: sets `lit` / `nlit`; returns the bytes it took.
  int64_t literals(const uint8_t* p, size_t n, const uint8_t** lit, size_t* nlit) {
    if (n < 1) return kTruncated;
    const int type = p[0] & 3, sf = (p[0] >> 2) & 3;
    if (type < 2) {  // raw or RLE
      size_t size, hdr;
      if (sf == 0 || sf == 2) {
        size = p[0] >> 3;
        hdr = 1;
      } else if (sf == 1) {
        if (n < 2) return kTruncated;
        size = (p[0] >> 4) + (size_t(p[1]) << 4);
        hdr = 2;
      } else {
        if (n < 3) return kTruncated;
        size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
        hdr = 3;
      }
      if (size > kBlockMax) return kLiterals;
      if (type == 0) {
        if (hdr + size > n) return kTruncated;
        *lit = p + hdr;
        *nlit = size;
        return int64_t(hdr + size);
      }
      if (hdr + 1 > n) return kTruncated;
      st.lits.assign(size, p[hdr]);
      *lit = st.lits.data();
      *nlit = size;
      return int64_t(hdr + 1);
    }
    size_t regen, comp, hdr;
    int streams = sf == 0 ? 1 : 4;
    if (sf < 2) {
      if (n < 3) return kTruncated;
      uint32_t h = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16);
      regen = (h >> 4) & 0x3FF;
      comp = (h >> 14) & 0x3FF;
      hdr = 3;
    } else if (sf == 2) {
      if (n < 4) return kTruncated;
      uint32_t h = p[0] | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
      regen = (h >> 4) & 0x3FFF;
      comp = (h >> 18) & 0x3FFF;
      hdr = 4;
    } else {
      if (n < 5) return kTruncated;
      uint64_t h = p[0] | (uint64_t(p[1]) << 8) | (uint64_t(p[2]) << 16) | (uint64_t(p[3]) << 24) |
                   (uint64_t(p[4]) << 32);
      regen = size_t((h >> 4) & 0x3FFFF);
      comp = size_t((h >> 22) & 0x3FFFF);
      hdr = 5;
    }
    if (regen > kBlockMax) return kLiterals;
    if (hdr + comp > n) return kTruncated;
    const uint8_t* q = p + hdr;
    size_t qn = comp;
    if (type == 2) {
      int64_t k = read_huffman(st.huf, q, qn);
      if (k < 0) return k;
      q += k;
      qn -= size_t(k);
    } else if (!st.huf.valid) {
      return kHuffman;  // treeless literals with no earlier table in the frame
    }
    st.lits.resize(regen);
    uint8_t* o = st.lits.data();
    if (streams == 1) {
      HufStream hs;
      if (!hs.init(q, qn, o, regen) || !hs.finish(st.huf)) return kHuffman;
    } else {
      if (qn < 6) return kLiterals;
      size_t s[4];
      s[0] = q[0] | (size_t(q[1]) << 8);
      s[1] = q[2] | (size_t(q[3]) << 8);
      s[2] = q[4] | (size_t(q[5]) << 8);
      if (s[0] + s[1] + s[2] + 6 > qn) return kLiterals;
      s[3] = qn - 6 - s[0] - s[1] - s[2];
      const size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) return kLiterals;
      const uint8_t* sp = q + 6;
      HufStream hs[4];
      for (int i = 0; i < 4; ++i) {
        if (!hs[i].init(sp, s[i], o + i * seg, i < 3 ? seg : regen - 3 * seg)) return kHuffman;
        sp += s[i];
      }
      // the four streams in step: their table lookups overlap
      while (hs[0].fast() && hs[1].fast() && hs[2].fast() && hs[3].fast()) {
        for (int i = 0; i < 4; ++i) hs[i].five(st.huf);
      }
      for (int i = 0; i < 4; ++i) {
        if (!hs[i].finish(st.huf)) return kHuffman;
      }
    }
    *lit = o;
    *nlit = regen;
    return int64_t(hdr + comp);
  }

  // One table of the sequences section; returns the bytes it took.
  int64_t table(FseTable& tab, int mode, const uint8_t* p, size_t n, const int16_t* def,
                int def_last, int def_log, int max_sym, int max_log) {
    if (mode == 0) {
      if (!build_fse(tab, def, def_last, def_log)) return kSequences;
      return 0;
    }
    if (mode == 1) {
      if (n < 1) return kTruncated;
      if (p[0] > max_sym) return kSequences;
      rle_fse(tab, p[0]);
      return 1;
    }
    if (mode == 2) {
      int16_t norm[64];
      int last, log;
      int64_t k = read_ncount(p, n, max_sym, max_log, norm, &last, &log);
      if (k < 0) return k;
      if (!build_fse(tab, norm, last, log)) return kSequences;
      return k;
    }
    return tab.valid ? int64_t(kOk) : int64_t(kSequences);  // repeat
  }

  int64_t block(const uint8_t* p, size_t n, size_t frame_start) {
    const uint8_t* lit;
    size_t nlit;
    int64_t k = literals(p, n, &lit, &nlit);
    if (k < 0) return k;
    p += k;
    n -= size_t(k);
    if (n < 1) return kTruncated;
    size_t nseq;
    if (p[0] < 128) {
      nseq = p[0];
      p += 1;
      n -= 1;
    } else if (p[0] < 255) {
      if (n < 2) return kTruncated;
      nseq = ((size_t(p[0]) - 128) << 8) + p[1];
      p += 2;
      n -= 2;
    } else {
      if (n < 3) return kTruncated;
      nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
      p += 3;
      n -= 3;
    }
    if (nseq == 0) {
      if (n != 0) return kSequences;
      if (int64_t e = out.reserve(nlit)) return e;
      std::memcpy(out.p + out.len, lit, nlit);
      out.len += nlit;
      return kOk;
    }
    if (n < 1) return kTruncated;
    const int modes = p[0];
    if (modes & 3) return kReserved;
    p += 1;
    n -= 1;
    k = table(st.ll, modes >> 6, p, n, kLLDefault, 35, 6, 35, 9);
    if (k < 0) return k;
    p += k;
    n -= size_t(k);
    k = table(st.of, (modes >> 4) & 3, p, n, kOFDefault, 28, 5, 31, 8);
    if (k < 0) return k;
    p += k;
    n -= size_t(k);
    k = table(st.ml, (modes >> 2) & 3, p, n, kMLDefault, 52, 6, 52, 9);
    if (k < 0) return k;
    p += k;
    n -= size_t(k);

    BackBits bb;
    if (!bb.init(p, n)) return kSequences;
    uint32_t sll = uint32_t(bb.read(st.ll.log));
    uint32_t sof = uint32_t(bb.read(st.of.log));
    uint32_t sml = uint32_t(bb.read(st.ml.log));
    size_t lit_pos = 0;
    const size_t block_start = out.len;
    uint32_t* rep = st.rep;
    for (size_t i = 0; i < nseq; ++i) {
      const FseEntry& eo = st.of.t[sof];
      const FseEntry& el = st.ll.t[sll];
      const FseEntry& em = st.ml.t[sml];
      const int ofc = eo.sym;
      if (ofc > 31 || el.sym > 35 || em.sym > 52) return kSequences;
      uint32_t ofv = (uint32_t(1) << ofc) + uint32_t(bb.read(ofc));
      size_t ml = kMLBase[em.sym] + size_t(bb.read(kMLBits[em.sym]));
      size_t ll = kLLBase[el.sym] + size_t(bb.read(kLLBits[el.sym]));
      uint32_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        uint32_t idx = ofv - 1 + (ll == 0 ? 1 : 0);  // 0..3
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? rep[0] - 1 : rep[idx];
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = el.base + uint32_t(bb.read(el.bits));
        sml = em.base + uint32_t(bb.read(em.bits));
        sof = eo.base + uint32_t(bb.read(eo.bits));
      }
      if (bb.pos < 0) return kSequences;
      if (ll > nlit - lit_pos) return kSequences;
      if (out.len - block_start + ll + ml > kBlockMax) return kBlockSize;
      if (int64_t e = out.reserve(ll + ml)) return e;
      std::memcpy(out.p + out.len, lit + lit_pos, ll);
      out.len += ll;
      lit_pos += ll;
      if (offset == 0 || offset > out.len - frame_start) return kOffset;
      uint8_t* d = out.p + out.len;
      const uint8_t* s = d - offset;
      if (offset >= ml) {
        std::memcpy(d, s, ml);
      } else if (offset >= 8) {
        size_t j = 0;
        for (; j + 8 <= ml; j += 8) std::memcpy(d + j, s + j, 8);
        for (; j < ml; ++j) d[j] = s[j];
      } else {
        for (size_t j = 0; j < ml; ++j) d[j] = s[j];
      }
      out.len += ml;
    }
    if (bb.pos != 0) return kSequences;
    size_t rest = nlit - lit_pos;
    if (out.len - block_start + rest > kBlockMax) return kBlockSize;
    if (int64_t e = out.reserve(rest)) return e;
    std::memcpy(out.p + out.len, lit + lit_pos, rest);
    out.len += rest;
    return kOk;
  }

  int64_t frame(size_t& at) {
    const uint8_t* p = src + at;
    size_t n = this->n - at;
    if (n < 5) return kTruncated;
    const int fhd = p[4];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
    const int did_flag = fhd & 3;
    if (fhd & 8) return kReserved;
    size_t pos = 5;
    if (!single) {
      if (n < pos + 1) return kTruncated;
      const int exponent = p[pos] >> 3;
      if (10 + exponent > 31) return kWindow;
      pos += 1;
    }
    const int did_size = did_flag == 3 ? 4 : did_flag;
    if (n < pos + did_size) return kTruncated;
    uint32_t did = 0;
    for (int i = 0; i < did_size; ++i) did |= uint32_t(p[pos + i]) << (8 * i);
    if (did != 0) return kDictionary;
    pos += did_size;
    const int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : 1 << fcs_flag;
    if (n < pos + fcs_size) return kTruncated;
    bool has_size = fcs_size > 0;
    uint64_t content = 0;
    for (int i = 0; i < fcs_size; ++i) content |= uint64_t(p[pos + i]) << (8 * i);
    if (fcs_size == 2) content += 256;
    pos += fcs_size;
    if (has_size) {  // a declared size must fit before anything is decoded
      if (content > out.limit - out.len) return kOutputFull;
    }
    const size_t frame_start = out.len;
    st.huf.valid = st.ll.valid = st.of.valid = st.ml.valid = false;
    st.rep[0] = 1;
    st.rep[1] = 4;
    st.rep[2] = 8;
    for (;;) {
      if (n < pos + 3) return kTruncated;
      const uint32_t bh = p[pos] | (uint32_t(p[pos + 1]) << 8) | (uint32_t(p[pos + 2]) << 16);
      pos += 3;
      const bool last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (size > kBlockMax) return kBlockSize;
      if (type == 0) {
        if (n < pos + size) return kTruncated;
        if (int64_t e = out.reserve(size)) return e;
        std::memcpy(out.p + out.len, p + pos, size);
        out.len += size;
        pos += size;
      } else if (type == 1) {
        if (n < pos + 1) return kTruncated;
        if (int64_t e = out.reserve(size)) return e;
        std::memset(out.p + out.len, p[pos], size);
        out.len += size;
        pos += 1;
      } else if (type == 2) {
        if (n < pos + size) return kTruncated;
        int64_t r = block(p + pos, size, frame_start);
        if (r < 0) return r;
        pos += size;
      } else {
        return kReserved;
      }
      if (last) break;
    }
    const size_t produced = out.len - frame_start;
    if (has_size && produced != content) return kContentSize;
    if (checksum) {
      if (n < pos + 4) return kTruncated;
      uint32_t want = p[pos] | (uint32_t(p[pos + 1]) << 8) | (uint32_t(p[pos + 2]) << 16) |
                      (uint32_t(p[pos + 3]) << 24);
      if (uint32_t(xxh64_impl(out.p + frame_start, produced, 0)) != want) return kChecksum;
      pos += 4;
    }
    at += pos;
    return kOk;
  }

  int64_t run() {
    size_t at = 0;
    int frames = 0;
    while (at < n) {
      if (n - at < 4) return kTruncated;
      const uint32_t magic = src[at] | (uint32_t(src[at + 1]) << 8) |
                             (uint32_t(src[at + 2]) << 16) | (uint32_t(src[at + 3]) << 24);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (n - at < 8) return kTruncated;
        const uint32_t size = src[at + 4] | (uint32_t(src[at + 5]) << 8) |
                              (uint32_t(src[at + 6]) << 16) | (uint32_t(src[at + 7]) << 24);
        if (n - at - 8 < size) return kTruncated;
        at += 8 + size_t(size);
        continue;
      }
      if (magic != 0xFD2FB528u) return kBadMagic;
      int64_t r = frame(at);
      if (r < 0) return r;
      frames++;
    }
    return frames ? int64_t(out.len) : kNoFrame;
  }
};

}  // namespace

extern "C" {

// Decodes the frames of src[0, n) into dst[0, cap); returns the bytes
// written, or a negative error code (`zstd_error_name`).
int64_t zstd_decode_into(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  Out out;
  out.p = dst;
  out.cap = out.limit = cap;
  Decoder d{src, n, out, {}};
  return d.run();
}

// Decodes the frames of src[0, n) into a buffer it allocates and grows up to
// `limit` bytes; *dst receives it (release with `zstd_free`), also on error.
int64_t zstd_decode_alloc(const uint8_t* src, size_t n, size_t limit, uint8_t** dst) {
  Out out;
  out.limit = limit;
  out.grow = true;
  Decoder d{src, n, out, {}};
  int64_t r = d.run();
  *dst = out.p;
  return r;
}

void zstd_free(uint8_t* p) { std::free(p); }

const char* zstd_error_name(int64_t code) {
  switch (code) {
    case kTruncated: return "truncated input";
    case kBadMagic: return "not a zstd frame";
    case kReserved: return "reserved bit or block type set";
    case kDictionary: return "frame needs a dictionary";
    case kWindow: return "window larger than 2^31 bytes";
    case kBlockSize: return "block larger than 128 KiB";
    case kLiterals: return "malformed literals section";
    case kHuffman: return "malformed Huffman table or stream";
    case kFse: return "malformed FSE table description";
    case kSequences: return "malformed sequences section";
    case kOffset: return "match offset before the frame's start";
    case kContentSize: return "decoded size differs from the frame header's";
    case kChecksum: return "content checksum mismatch";
    case kOutputFull: return "output larger than the expected size";
    case kNoFrame: return "no frame in the input";
    case kAlloc: return "out of memory";
    default: return "unknown error";
  }
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) { return xxh64_impl(p, n, seed); }

// CRC-32C (Castagnoli), as the OCDBT files carry it.
uint32_t crc32c(const uint8_t* p, size_t n) {
  const auto& crc_table = crc_tables().t;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo = c ^ rd32(p), hi = rd32(p + 4);
    c = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^ crc_table[5][(lo >> 16) & 0xFF] ^
        crc_table[4][lo >> 24] ^ crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
        crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ crc_table[0][(c ^ *p++) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
