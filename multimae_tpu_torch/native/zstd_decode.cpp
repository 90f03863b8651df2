// zstd_decode: the Zstandard decoder of the TIFF reader in data/image_io.py
// (compression 50000), in plain C++17 with a C interface, bound with ctypes
// by native/__init__.py. It reads RFC 8878 frames as libtiff 4.7's
// ZSTDDecode has libzstd read them for Pillow:
//
//   * the frame header (window or single-segment form, content size,
//     checksum flag; a dictionary ID or a window past libzstd's default 128
//     MiB limit is refused), raw, RLE and compressed blocks, each at most
//     min(window, 128 KiB) long, and the content checksum (XXH64);
//   * literals raw, RLE, Huffman-coded with their tree (weights direct or
//     FSE-coded) or treeless (the previous tree), in one stream or four;
//   * sequences with literal-length, match-length and offset codes in
//     predefined, RLE, FSE-compressed or repeat mode, repeat offsets, and
//     matches within the window and the frame;
//   * one frame per strip, as ZSTDDecode loops ZSTD_decompressStream: a
//     frame that ends before the strip is full fails (so does a skippable
//     frame in front); once the strip is full nothing more is read, but for
//     the block that follows a block ending exactly on the strip's end, and
//     the checksum after a last block ending there, which libzstd's
//     streaming loop still decodes. A frame whose content size is declared
//     must hold exactly that much.
//
// Every check libzstd makes on the way fails the strip here too (a
// Huffman or FSE bitstream not consumed to its last bit, a table
// description that does not sum, an offset past the window or the data,
// literals or output past the block's limits); where libzstd accepts a
// frame this decoder refuses, the TIFF reader refuses the file.
//
// mm_zstd_decode returns 0 with `size` bytes in `out`, or a negative code
// (ZSTD_ERRORS in native/__init__.py). `kinds`, when not null, counts what
// the data held (ZSTD_KINDS in native/__init__.py), for the tests.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err {
  kOk = 0, kTruncated = -1, kMagic = -2, kHeader = -3, kWindow = -4, kDict = -5,
  kBlockType = -6, kBlockSize = -7, kLiterals = -8, kHuffman = -9, kFse = -10,
  kSequences = -11, kOffset = -12, kContentSize = -13, kChecksum = -14, kEarlyEnd = -15,
  kSkippable = -16,
};

enum Kind {
  kRawBlock, kRleBlock, kCompressedBlock, kRawLiterals, kRleLiterals, kHuffman1, kHuffman4,
  kTreeless1, kTreeless4, kFseWeights, kDirectWeights, kSeqPredefined, kSeqRle,
  kSeqCompressed, kSeqRepeat, kRepeatOffset, kChecksumFrame, kSingleSegment, kNoSequences,
  kKinds
};

struct Fail {
  int code;
};

[[noreturn]] void fail(int code) { throw Fail{code}; }

int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// A backward bitstream (RFC 8878 4.1.3.1): read from the last byte's bit
// below its highest set bit, toward the first byte; bits past the start read
// as zero and count as over-read.
struct BackBits {
  const uint8_t* p;
  int64_t n, pos;  // bytes; bits left before the start
  BackBits(const uint8_t* src, size_t size, int err) : p(src), n(int64_t(size)) {
    if (size == 0 || src[size - 1] == 0) fail(err);
    pos = n * 8 - (8 - highbit(src[size - 1]));
  }
  // Bits [lo, lo + nb) as a number, bit lo + nb - 1 the most significant;
  // bits below 0 are zero.
  uint64_t at(int64_t lo, int nb) const {
    if (nb == 0) return 0;
    if (lo < 0) return lo + nb > 0 ? at(0, int(lo + nb)) << -lo : 0;
    int64_t byte = lo >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 8 && byte + i < n; ++i) w |= uint64_t(p[byte + i]) << (8 * i);
    return (w >> (lo & 7)) & ((uint64_t(1) << nb) - 1);
  }
  uint64_t read(int nb) {
    pos -= nb;
    return at(pos, nb);
  }
  uint64_t peek(int nb) const { return at(pos - nb, nb); }
  void skip(int nb) { pos -= nb; }
  bool overflow() const { return pos < 0; }
  bool done() const { return pos == 0; }
};

// FSE_readNCount: a table description read forward, least significant bit
// first; bits past `n` bytes read as zero and fail the read.
struct NCount {
  std::vector<int16_t> norm;
  int log = 0;
  size_t bytes = 0;
};

NCount read_ncount(const uint8_t* src, size_t n, int max_symbol, int max_log, int err) {
  NCount nc;
  uint64_t at = 0;
  auto bits = [&](int nb) {
    uint32_t v = 0;
    for (int i = 0; i < nb; ++i, ++at) {
      uint32_t b = at < n * 8 ? (src[at >> 3] >> (at & 7)) & 1 : 0;
      v |= b << i;
    }
    return v;
  };
  auto peek = [&](int nb) {
    uint64_t save = at;
    uint32_t v = bits(nb);
    at = save;
    return v;
  };
  int log = int(bits(4)) + 5;
  if (log > 15 || log > max_log) fail(err);
  nc.log = log;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0;
  bool prev0 = false;
  nc.norm.assign(size_t(max_symbol) + 1, 0);
  while (remaining > 1 && sym <= max_symbol) {
    if (prev0) {
      int zeros = 0;
      for (;;) {
        uint32_t r = bits(2);
        zeros += int(r);
        if (r != 3) break;
      }
      sym += zeros;
      if (sym > max_symbol) fail(err);
    }
    int mx = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = peek(nbits - 1);
    if (int(low & uint32_t(threshold - 1)) < mx) {
      count = int(low & uint32_t(threshold - 1));
      at += nbits - 1;
    } else {
      count = int(peek(nbits) & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= mx;
      at += nbits;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    nc.norm[size_t(sym++)] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || at > n * 8) fail(err);
  nc.norm.resize(size_t(sym));
  nc.bytes = size_t((at + 7) / 8);
  return nc;
}

struct FseCell {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct Fse {
  std::vector<FseCell> cells;
  int log = 0;
};

// FSE_buildDTable: symbols spread with step (size/2 + size/8 + 3), the
// "less than 1" ones at the end.
Fse build_fse(const std::vector<int16_t>& norm, int log, int err) {
  Fse t;
  t.log = log;
  const uint32_t size = 1u << log, mask = size - 1;
  t.cells.assign(size, FseCell{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  uint32_t high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      t.cells[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3;
  uint32_t pos = 0;
  for (size_t s = 0; s < norm.size(); ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[pos].symbol = uint16_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) fail(err);
  for (uint32_t u = 0; u < size; ++u) {
    uint32_t s = t.cells[u].symbol;
    uint32_t ns = next[s]++;
    int nb = log - highbit(ns);
    t.cells[u].nbits = uint8_t(nb);
    t.cells[u].base = uint16_t((ns << nb) - size);
  }
  return t;
}

Fse rle_fse(uint16_t symbol) {
  Fse t;
  t.log = 0;
  t.cells.assign(1, FseCell{symbol, 0, 0});
  return t;
}

struct Huffman {
  std::vector<uint8_t> symbol, nbits;
  int log = 0;
};

struct Frame {
  Huffman huf;
  bool has_huf = false;
  Fse ll, of, ml;
  bool has_ll = false, has_of = false, has_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,    9,    10,   11,
                              12, 13, 14, 15, 16, 18,  20,  22,  24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,  29,  30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,  67,  83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

void count(long* kinds, int k) {
  if (kinds) ++kinds[k];
}

// HUF_readStats and HUF_readDTableX1: the weights, the last one implied,
// then the table of 1 << log entries (symbols by weight, then by value).
size_t read_huffman(const uint8_t* src, size_t n, Huffman& h, long* kinds) {
  if (n < 1) fail(kHuffman);
  const uint32_t head = src[0];
  std::vector<uint8_t> w;
  size_t used;
  if (head >= 128) {
    size_t num = head - 127, bytes = (num + 1) / 2;
    if (bytes + 1 > n || num >= 256) fail(kHuffman);
    for (size_t i = 0; i < num; ++i) w.push_back(i & 1 ? src[1 + i / 2] & 15 : src[1 + i / 2] >> 4);
    used = bytes + 1;
    count(kinds, kDirectWeights);
  } else {
    if (head + 1 > n) fail(kHuffman);
    NCount nc = read_ncount(src + 1, head, 255, 6, kHuffman);
    if (nc.bytes > head) fail(kHuffman);
    Fse t = build_fse(nc.norm, nc.log, kHuffman);
    BackBits b(src + 1 + nc.bytes, head - nc.bytes, kHuffman);
    // FSE_decompress_usingDTable: two states in turn until the stream is
    // read past its start, then one more symbol from the other state.
    uint32_t s1 = uint32_t(b.read(t.log)), s2 = uint32_t(b.read(t.log));
    auto sym = [&](uint32_t& st) {
      const FseCell& c = t.cells[st];
      st = c.base + uint32_t(b.read(c.nbits));
      return uint8_t(c.symbol);
    };
    for (;;) {
      if (w.size() + 2 > 255) fail(kHuffman);
      w.push_back(sym(s1));
      if (b.overflow()) {
        w.push_back(sym(s2));
        break;
      }
      if (w.size() + 2 > 255) fail(kHuffman);
      w.push_back(sym(s2));
      if (b.overflow()) {
        w.push_back(sym(s1));
        break;
      }
    }
    used = head + 1;
    count(kinds, kFseWeights);
  }
  uint32_t total = 0, rank[16] = {0};
  for (uint8_t x : w) {
    if (x > 12) fail(kHuffman);
    ++rank[x];
    total += (1u << x) >> 1;
  }
  if (total == 0) fail(kHuffman);
  int log = highbit(total) + 1;
  if (log > 12) fail(kHuffman);
  uint32_t rest = (1u << log) - total;
  if (rest != (1u << highbit(rest))) fail(kHuffman);
  w.push_back(uint8_t(highbit(rest) + 1));
  ++rank[w.back()];
  if (rank[1] < 2 || (rank[1] & 1)) fail(kHuffman);
  h.log = log;
  h.symbol.assign(size_t(1) << log, 0);
  h.nbits.assign(size_t(1) << log, 0);
  uint32_t start[16] = {0}, next = 0;
  for (int k = 1; k <= log; ++k) {
    start[k] = next;
    next += rank[k] << (k - 1);
  }
  for (size_t s = 0; s < w.size(); ++s) {
    if (!w[s]) continue;
    uint32_t len = (1u << w[s]) >> 1;
    for (uint32_t i = 0; i < len; ++i) {
      h.symbol[start[w[s]] + i] = uint8_t(s);
      h.nbits[start[w[s]] + i] = uint8_t(log + 1 - w[s]);
    }
    start[w[s]] += len;
  }
  return used;
}

void huffman_stream(const Huffman& h, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  BackBits b(src, n, kHuffman);
  for (size_t i = 0; i < count; ++i) {
    uint32_t v = uint32_t(b.peek(h.log));
    out[i] = h.symbol[v];
    b.skip(h.nbits[v]);
  }
  if (!b.done()) fail(kHuffman);
}

uint32_t le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint32_t(p[i]) << (8 * i);
  return v;
}

// The literals section: its bytes used, the literals in `lit`.
size_t read_literals(const uint8_t* src, size_t n, size_t block_max, Frame& fr,
                     std::vector<uint8_t>& lit, long* kinds) {
  if (n < 2) fail(kLiterals);
  const int type = src[0] & 3, form = (src[0] >> 2) & 3;
  if (type <= 1) {  // raw, RLE
    size_t hs, size;
    if (form == 0 || form == 2) {
      hs = 1;
      size = src[0] >> 3;
    } else if (form == 1) {
      hs = 2;
      if (n < 3) fail(kLiterals);
      size = le(src, 2) >> 4;
    } else {
      hs = 3;
      if (n < 4) fail(kLiterals);
      size = le(src, 3) >> 4;
    }
    if (size > block_max) fail(kLiterals);
    if (type == 0) {
      if (hs + size > n) fail(kLiterals);
      lit.assign(src + hs, src + hs + size);
      count(kinds, kRawLiterals);
      return hs + size;
    }
    if (hs + 1 > n) fail(kLiterals);
    lit.assign(size, src[hs]);
    count(kinds, kRleLiterals);
    return hs + 1;
  }
  if (n < 5) fail(kLiterals);
  size_t hs, size, csize;
  bool single = form == 0;
  const uint32_t v = le(src, 4);
  if (form <= 1) {
    hs = 3;
    size = (v >> 4) & 0x3FF;
    csize = (v >> 14) & 0x3FF;
  } else if (form == 2) {
    hs = 4;
    size = (v >> 4) & 0x3FFF;
    csize = v >> 18;
  } else {
    hs = 5;
    uint64_t w = uint64_t(le(src, 4)) | (uint64_t(src[4]) << 32);
    size = size_t((w >> 4) & 0x3FFFF);
    csize = size_t((w >> 22) & 0x3FFFF);
  }
  if (size > 128 * 1024 || size > block_max) fail(kLiterals);
  if (!single && size < 6) fail(kLiterals);
  if (hs + csize > n) fail(kLiterals);
  const uint8_t* p = src + hs;
  size_t left = csize;
  if (type == 2) {
    Huffman h;
    size_t used = read_huffman(p, left, h, kinds);
    p += used;
    left -= used;
    fr.huf = h;
    count(kinds, single ? kHuffman1 : kHuffman4);
  } else {
    if (!fr.has_huf) fail(kLiterals);
    count(kinds, single ? kTreeless1 : kTreeless4);
  }
  lit.assign(size, 0);
  if (single) {
    huffman_stream(fr.huf, p, left, lit.data(), size);
  } else {
    if (left < 10) fail(kHuffman);
    size_t l1 = le(p, 2), l2 = le(p + 2, 2), l3 = le(p + 4, 2);
    if (6 + l1 + l2 + l3 > left) fail(kHuffman);
    size_t l4 = left - 6 - l1 - l2 - l3, seg = (size + 3) / 4;
    if (3 * seg > size) fail(kHuffman);
    const uint8_t* q = p + 6;
    huffman_stream(fr.huf, q, l1, lit.data(), seg);
    huffman_stream(fr.huf, q + l1, l2, lit.data() + seg, seg);
    huffman_stream(fr.huf, q + l1 + l2, l3, lit.data() + 2 * seg, seg);
    huffman_stream(fr.huf, q + l1 + l2 + l3, l4, lit.data() + 3 * seg, size - 3 * seg);
  }
  if (type == 2) fr.has_huf = true;
  return hs + csize;
}

Fse predefined(const int16_t* norm, int n, int log) {
  return build_fse(std::vector<int16_t>(norm, norm + n), log, kFse);
}

// One table of ZSTD_decodeSeqHeaders: its bytes used.
size_t read_table(const uint8_t* p, size_t n, int mode, int max_symbol, int max_log,
                  const Fse& dflt, Fse& t, bool& has, long* kinds) {
  if (mode == 0) {
    t = dflt;
    has = true;
    count(kinds, kSeqPredefined);
    return 0;
  }
  if (mode == 1) {
    if (n < 1 || p[0] > max_symbol) fail(kSequences);
    t = rle_fse(p[0]);
    has = true;
    count(kinds, kSeqRle);
    return 1;
  }
  if (mode == 2) {
    NCount nc = read_ncount(p, n, max_symbol, max_log, kFse);
    if (nc.bytes > n) fail(kFse);
    t = build_fse(nc.norm, nc.log, kFse);
    has = true;
    count(kinds, kSeqCompressed);
    return nc.bytes;
  }
  if (!has) fail(kSequences);
  count(kinds, kSeqRepeat);
  return 0;
}

void decode_block(const uint8_t* src, size_t n, size_t block_max, Frame& fr,
                  std::vector<uint8_t>& out, size_t window, long* kinds) {
  std::vector<uint8_t> lit;
  size_t used = read_literals(src, n, block_max, fr, lit, kinds);
  const uint8_t* p = src + used;
  size_t left = n - used;
  if (left < 1) fail(kSequences);
  size_t nseq = p[0];
  size_t hs = 1;
  if (nseq > 0x7F) {
    if (nseq == 0xFF) {
      if (left < 3) fail(kSequences);
      nseq = le(p + 1, 2) + 0x7F00;
      hs = 3;
    } else {
      if (left < 2) fail(kSequences);
      nseq = ((nseq - 0x80) << 8) + p[1];
      hs = 2;
    }
  }
  p += hs;
  left -= hs;
  const size_t start = out.size();
  if (nseq == 0) {
    if (left != 0) fail(kSequences);
    out.insert(out.end(), lit.begin(), lit.end());
    count(kinds, kNoSequences);
    return;
  }
  if (left < 1 || (p[0] & 3)) fail(kSequences);
  const int modes = p[0];
  ++p;
  --left;
  static const Fse ll_default = predefined(kLLDefault, 36, 6),
                   of_default = predefined(kOFDefault, 29, 5),
                   ml_default = predefined(kMLDefault, 53, 6);
  size_t k;
  k = read_table(p, left, modes >> 6, 35, 9, ll_default, fr.ll, fr.has_ll, kinds);
  p += k;
  left -= k;
  k = read_table(p, left, (modes >> 4) & 3, 31, 8, of_default, fr.of, fr.has_of, kinds);
  p += k;
  left -= k;
  k = read_table(p, left, (modes >> 2) & 3, 52, 9, ml_default, fr.ml, fr.has_ml, kinds);
  p += k;
  left -= k;
  BackBits b(p, left, kSequences);
  uint32_t sll = uint32_t(b.read(fr.ll.log)), sof = uint32_t(b.read(fr.of.log)),
           sml = uint32_t(b.read(fr.ml.log));
  size_t litpos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const FseCell &cl = fr.ll.cells[sll], &co = fr.of.cells[sof], &cm = fr.ml.cells[sml];
    const uint32_t llc = cl.symbol, ofc = co.symbol, mlc = cm.symbol;
    if (llc > 35 || mlc > 52 || ofc > 31) fail(kSequences);
    uint64_t offset;
    uint64_t ofv = (uint64_t(1) << ofc) + b.read(int(ofc));
    uint64_t ml = kMLBase[mlc] + b.read(kMLBits[mlc]);
    uint64_t ll = kLLBase[llc] + b.read(kLLBits[llc]);
    if (ofv > 3) {
      offset = ofv - 3;
      fr.rep[2] = fr.rep[1];
      fr.rep[1] = fr.rep[0];
      fr.rep[0] = offset;
    } else {
      count(kinds, kRepeatOffset);
      uint64_t idx = ofv - 1 + (ll == 0);  // 0: rep1, 1: rep2, 2: rep3, 3: rep1 - 1
      if (idx == 0) {
        offset = fr.rep[0];
      } else {
        offset = idx == 3 ? fr.rep[0] - 1 : fr.rep[idx];
        if (offset == 0) fail(kOffset);
        if (idx != 1) fr.rep[2] = fr.rep[1];
        fr.rep[1] = fr.rep[0];
        fr.rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll = cl.base + uint32_t(b.read(cl.nbits));
      sml = cm.base + uint32_t(b.read(cm.nbits));
      sof = co.base + uint32_t(b.read(co.nbits));
    }
    if (ll > lit.size() - litpos) fail(kSequences);
    if (out.size() - start + ll + ml > block_max) fail(kBlockSize);
    out.insert(out.end(), lit.begin() + long(litpos), lit.begin() + long(litpos + ll));
    litpos += ll;
    if (offset > out.size() || offset > window) fail(kOffset);
    size_t from = out.size() - size_t(offset), to = out.size();
    out.resize(to + size_t(ml));
    if (offset >= ml) {
      std::memcpy(out.data() + to, out.data() + from, size_t(ml));
    } else {
      for (uint64_t j = 0; j < ml; ++j) out[to + j] = out[from + j];
    }
  }
  if (!b.done()) fail(kSequences);
  if (out.size() - start + (lit.size() - litpos) > block_max) fail(kBlockSize);
  out.insert(out.end(), lit.begin() + long(litpos), lit.end());
}

// XXH64 of `n` bytes, seed 0.
uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                 P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                 P5 = 2870177450012600261ull;
  auto rotl = [](uint64_t x, int r) { return (x << r) | (x >> (64 - r)); };
  auto rd64 = [](const uint8_t* q) {
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v |= uint64_t(q[i]) << (8 * i);
    return v;
  };
  auto round = [&](uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; };
  auto merge = [&](uint64_t acc, uint64_t v) { return (acc ^ round(0, v)) * P1 + P4; };
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = round(v1, rd64(p));
      v2 = round(v2, rd64(p + 8));
      v3 = round(v3, rd64(p + 16));
      v4 = round(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h ^= round(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= uint64_t(le(p, 4)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

int decode(const uint8_t* src, size_t n, uint8_t* dst, size_t size, long* kinds) {
  if (n < 4) fail(kTruncated);
  const uint32_t magic = le(src, 4);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) fail(kSkippable);
  if (magic != 0xFD2FB528u) fail(kMagic);
  if (n < 5) fail(kTruncated);
  const uint8_t fhd = src[4];
  const int fcs_flag = fhd >> 6, dict_flag = fhd & 3;
  const bool single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  if (fhd & 8) fail(kHeader);
  size_t at = 5;
  uint64_t window = 0;
  if (!single) {
    if (at >= n) fail(kTruncated);
    const uint8_t wd = src[at++];
    int wlog = 10 + (wd >> 3);
    if (wlog > 31) fail(kWindow);
    window = uint64_t(1) << wlog;
    window += (window >> 3) * (wd & 7);
  }
  const int dict_bytes[4] = {0, 1, 2, 4};
  if (at + size_t(dict_bytes[dict_flag]) > n) fail(kTruncated);
  if (le(src + at, dict_bytes[dict_flag])) fail(kDict);
  at += size_t(dict_bytes[dict_flag]);
  const int fcs_bytes[4] = {single ? 1 : 0, 2, 4, 8};
  const int fb = fcs_bytes[fcs_flag];
  bool has_fcs = fb > 0;
  uint64_t fcs = 0;
  if (at + size_t(fb) > n) fail(kTruncated);
  for (int i = 0; i < fb; ++i) fcs |= uint64_t(src[at + size_t(i)]) << (8 * i);
  if (fb == 2) fcs += 256;
  at += size_t(fb);
  if (single) window = fcs;
  if (window > (uint64_t(1) << 27)) fail(kWindow);
  const size_t block_max = size_t(window < 128 * 1024 ? window : 128 * 1024);
  if (single) count(kinds, kSingleSegment);
  if (has_fcs && fcs < size) fail(kEarlyEnd);
  Frame fr;
  std::vector<uint8_t> out;
  out.reserve(size);
  const size_t win = size_t(window);
  for (;;) {
    // A block not whole in the data: libzstd buffers it and the strip ends
    // there, full or short.
    if (at + 3 > n) {
      if (out.size() >= size) break;
      fail(kTruncated);
    }
    const uint32_t bh = le(src + at, 3);
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    if (type == 3) fail(kBlockType);
    const size_t csize = type == 1 ? 1 : bsize;
    if (type == 2 && bsize > block_max) fail(kBlockSize);
    if (at + 3 + csize > n) {
      if (out.size() >= size) break;
      fail(kTruncated);
    }
    at += 3;
    if (type == 0) {
      if (bsize > block_max) fail(kBlockSize);
      out.insert(out.end(), src + at, src + at + bsize);
      count(kinds, kRawBlock);
    } else if (type == 1) {
      if (bsize > block_max) fail(kBlockSize);
      out.insert(out.end(), bsize, src[at]);
      count(kinds, kRleBlock);
    } else {
      decode_block(src + at, bsize, block_max, fr, out, win, kinds);
      count(kinds, kCompressedBlock);
    }
    at += csize;
    if (has_fcs && out.size() > fcs) fail(kContentSize);
    if (last) {
      if (has_fcs && out.size() != fcs) fail(kContentSize);
      if (out.size() < size) fail(kEarlyEnd);
      // libzstd reads the checksum only where the strip took the whole
      // block: a flush cut short stops its loop first.
      if (checksum) {
        count(kinds, kChecksumFrame);
        if (out.size() == size && at + 4 <= n &&
            le(src + at, 4) != uint32_t(xxh64(out.data(), out.size())))
          fail(kChecksum);
      }
      break;
    }
    // The strip filled inside this block: libzstd's flush stops short and
    // its loop ends. Filled exactly at its end, the loop goes on to the next
    // block.
    if (out.size() > size) break;
  }
  std::memcpy(dst, out.data(), size);
  return kOk;
}

}  // namespace

extern "C" {

int mm_zstd_decode(const uint8_t* src, long len, uint8_t* dst, long size, long* kinds) {
  try {
    return decode(src, size_t(len), dst, size_t(size), kinds);
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return kTruncated;
  }
}

}  // extern "C"
