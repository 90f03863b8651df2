// tiff_decode: the decompressors of the TIFF reader in data/image_io.py
// (read_tiff), in plain C++17 with a C interface, bound with ctypes by
// native/__init__.py. Each is bit-equal to libtiff 4.7's decoder as Pillow
// runs it, and to its Python twin (image_io.lzw_twin, packbits_twin):
//
//   * LZW (compression 5): codes of 9-12 bits, MSB-first, widened one code
//     early (LZWDecode); a stream that starts with the old bit-reversed
//     codes takes libtiff's LZWDecodeCompat (LSB-first, widened on time);
//   * PackBits (compression 32773): PackBitsDecode;
//   * ThunderScan (compression 32809): ThunderDecodeRow, 4-bit samples
//     as runs of the last one, 2- and 3-bit deltas from it, or raw.
//
// LZW and PackBits write at most `size` bytes and read at most `len`; they stop once
// `size` bytes are out, as libtiff stops once its strip or tile is full.
// Return: the bytes written (fewer than `size` where the data ends first),
// or for LZW a negative code for a stream libtiff refuses:
//   -1 a code not yet in the table, -2 a code past the literals after a
//   Clear code, -3 a full table in the old coding.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

long mm_tiff_lzw(const uint8_t* data, long len, uint8_t* out, long size) {
  // An entry is the previous code's string plus the next string's first
  // byte; both lie in `out` one after the other, so an entry is kept as the
  // place and length of its bytes there and copied forward from it.
  static thread_local long where[4096];
  static thread_local int length[4096];
  const bool compat = len >= 2 && data[0] == 0 && (data[1] & 1);
  uint64_t acc = 0;
  int acc_bits = 0, nbits = 9, maxcode = 0, old = 0;
  long pos = 0, written = 0, last = 0;  // `last`: where the previous code's string starts
  long free_entry = -1;  // libtiff's free entry before its table: a Clear code must come first
  auto next_code = [&]() -> int {
    while (acc_bits < nbits && pos < len) {
      if (compat) {
        acc |= uint64_t(data[pos++]) << acc_bits;
      } else {
        acc = (acc << 8) | data[pos++];
      }
      acc_bits += 8;
    }
    if (acc_bits < nbits) return 257;  // out of data: libtiff reads an EOI code
    int code;
    if (compat) {
      code = int(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = int((acc >> (acc_bits - nbits)) & ((1u << nbits) - 1));
      acc &= (uint64_t(1) << (acc_bits - nbits)) - 1;
    }
    acc_bits -= nbits;
    return code;
  };
  auto old_length = [&]() { return old < 256 ? 1 : length[old]; };
  while (written < size) {
    int code = next_code();
    if (code == 257) break;
    if (code == 256) {
      do {
        free_entry = 258;
        nbits = 9;
        maxcode = compat ? 511 : 510;
        code = next_code();
      } while (code == 256);
      if (code == 257) break;
      if (code > 256) return -2;
      last = written;
      out[written++] = uint8_t(code);
      old = code;
      continue;
    }
    if (compat) {
      if (free_entry < 0 || free_entry >= 4096) return -3;
    }
    if (code > free_entry) return -1;  // the old coding: an entry of length 0
    where[free_entry] = last;
    length[free_entry] = old_length() + 1;
    if (++free_entry > maxcode) {
      nbits = std::min(nbits + 1, 12);
      maxcode = (1 << nbits) - (compat ? 1 : 2);
      if (!compat && free_entry >= 4096) free_entry = -1;  // only Clear or EOI may follow
    }
    old = code;
    last = written;
    if (code < 256) {
      out[written++] = uint8_t(code);
      continue;
    }
    const long n = std::min<long>(length[code], size - written);
    const uint8_t* src = out + where[code];
    for (long k = 0; k < n; ++k) out[written + k] = src[k];  // forward: may overlap
    written += n;
  }
  return written;
}

long mm_tiff_packbits(const uint8_t* data, long len, uint8_t* out, long size) {
  long pos = 0, written = 0;
  while (pos < len && written < size) {
    const int c = data[pos++];
    if (c >= 128) {
      if (c == 128) continue;  // a no-op
      const long count = std::min<long>(257 - c, size - written);
      if (pos >= len) break;
      std::memset(out + written, data[pos++], size_t(count));
      written += count;
    } else {
      const long count = std::min<long>(c + 1, size - written);
      if (len - pos < count) break;
      std::memcpy(out + written, data + pos, size_t(count));
      written += count;
      pos += count;
    }
  }
  return written;
}

// ThunderDecodeRow over `size` bytes of rows `scanline` bytes apart, each
// `width` 4-bit pixels: returns 0, or -1 where a row ends short or long
// (libtiff's "Not enough data" / "Too much data"), the rows before it
// decoded and that row's tail zeroed as libtiff leaves them.
int mm_tiff_thunderscan(const uint8_t* data, long len, uint8_t* out, long size, long scanline,
                        long width) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  if (scanline <= 0 || size % scanline) return -1;
  const uint8_t* bp = data;
  long cc = len;
  for (uint8_t* row = out; row < out + size; row += scanline) {
    uint8_t* op = row;
    unsigned lastpixel = 0;
    long npixels = 0;
    const long maxpixels = width;
    auto set = [&](unsigned v) {  // SETPIXEL
      lastpixel = v & 0xf;
      if (npixels < maxpixels) {
        if (npixels++ & 1)
          *op++ |= uint8_t(lastpixel);
        else
          op[0] = uint8_t(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < maxpixels) {
      int n = *bp++, delta;
      --cc;
      switch (n & 0xc0) {
        case 0x00:  // a run of the last pixel, n times
          if (npixels & 1) {
            op[0] |= uint8_t(lastpixel);
            lastpixel = *op++;
            ++npixels;
            --n;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += n;
          if (npixels <= maxpixels)
            for (; n > 0; n -= 2) *op++ = uint8_t(lastpixel);
          if (n == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        case 0x40:  // three 2-bit deltas (2: none)
          if ((delta = (n >> 4) & 3) != 2) set(unsigned(int(lastpixel) + two[delta]));
          if ((delta = (n >> 2) & 3) != 2) set(unsigned(int(lastpixel) + two[delta]));
          if ((delta = n & 3) != 2) set(unsigned(int(lastpixel) + two[delta]));
          break;
        case 0x80:  // two 3-bit deltas (4: none)
          if ((delta = (n >> 3) & 7) != 4) set(unsigned(int(lastpixel) + three[delta]));
          if ((delta = n & 7) != 4) set(unsigned(int(lastpixel) + three[delta]));
          break;
        default:  // raw
          set(unsigned(n));
          break;
      }
    }
    if (npixels != maxpixels) {
      uint8_t* end = row + (maxpixels + 1) / 2;
      if (op < end) std::memset(op, 0, size_t(end - op));
      return -1;
    }
  }
  return 0;
}

}  // extern "C"
