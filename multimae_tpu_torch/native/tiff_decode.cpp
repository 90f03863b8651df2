// tiff_decode: the decompressors of the TIFF reader in data/image_io.py
// (read_tiff), in plain C++17 with a C interface, bound with ctypes by
// native/__init__.py. Each is bit-equal to libtiff 4.7's decoder as Pillow
// runs it, and to its Python twin (image_io.lzw_twin, packbits_twin):
//
//   * LZW (compression 5): codes of 9-12 bits, MSB-first, widened one code
//     early (LZWDecode); a stream that starts with the old bit-reversed
//     codes takes libtiff's LZWDecodeCompat (LSB-first, widened on time);
//   * PackBits (compression 32773): PackBitsDecode.
//
// Both write at most `size` bytes and read at most `len`; they stop once
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

}  // extern "C"
