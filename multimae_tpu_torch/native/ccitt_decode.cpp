// ccitt_decode: the CCITT decoders of the TIFF reader in data/image_io.py
// (compressions 2, 3, 4 and 32771), in plain C++17 with a C interface,
// bound with ctypes by native/__init__.py. It is libtiff 4.7's tif_fax3.c
// decoding as Pillow runs it, to the bit, and its Python twin is
// image_io.ccitt_twin:
//
//   * Modified Huffman runs (Fax3DecodeRLE) with byte-aligned rows (RLE,
//     compression 2) or 16-bit-aligned rows (RLEW, 32771): the alignment is
//     taken against the data's address, which is the file offset's parity
//     in Pillow's memory-mapped reads;
//   * Group 3 (compression 3): an EOL before every row (Fax3Decode1D), and
//     with T4Options bit 0 the tag bit that makes a row 1-D or 2-D READ
//     coded against the row above (Fax3Decode2D); fill bits before an EOL
//     are skipped by the EOL search;
//   * Group 4 (compression 4): every row 2-D coded (MMR) against the row
//     above, the first against an all-white row (Fax4Decode).
//
// libtiff's state tables (tif_fax3sm.c, made by mkg3states.c from the T.4
// codes), bit accumulator, run arrays and their clean-up after a bad code
// word are the same here, so damaged data decodes to the rows libtiff gives
// Pillow. A row is a run array filled into 1-bit pixels, black runs as 1
// bits (_TIFFFax3fillruns): each strip's decoded bytes are what libtiff
// hands Pillow.
//
// Return: 0 when libtiff's decode returns success for the strip with all its
// rows, -1 where it returns -1 (Pillow then fails), -2 where Group 4 data
// ends early with rows left undecoded (libtiff returns success and Pillow
// keeps whatever its buffer held there). info[0] counts the errors libtiff
// reports and decodes past (a bad code word, a row of the wrong length),
// info[1] the extension codes of uncompressed mode among them, info[2] the
// rows decoded.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
       S_MakeUpB, S_MakeUp, S_EOL };

struct TabEnt {
  uint8_t state, width;
  uint32_t param;
};

// The T.4 codes, most significant bit first, as mkg3states.c lists them
// (least significant bit first there).
const char* const kTermW[64] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100"};
const char* const kMakeUpW[27] = {
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010", "011011011",
    "010011000", "010011001", "010011010", "011000", "010011011"};
const char* const kTermB[64] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111"};
const char* const kMakeUpB[27] = {
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* const kMakeUp[13] = {
    "00000001000", "00000001100", "00000001101", "000000010010", "000000010011",
    "000000010100", "000000010101", "000000010110", "000000010111", "000000011100",
    "000000011101", "000000011110", "000000011111"};

// mkg3states.c FillTable: every index whose low `width` bits are the code
// (least significant bit first) takes the entry; later fills overwrite.
void fill(TabEnt* t, int size, const char* code, int state, uint32_t param) {
  int width = int(std::strlen(code)), lsb = 0;
  for (int i = 0; i < width; ++i) lsb |= (code[i] - '0') << i;
  for (int c = lsb; c < (1 << size); c += 1 << width)
    t[c] = {uint8_t(state), uint8_t(width), param};
}

struct Tables {
  TabEnt main[128], white[4096], black[8192];
  uint8_t rev[256];
  Tables() {
    std::memset(this, 0, sizeof(*this));
    for (int b = 0; b < 256; ++b)
      for (int i = 0; i < 8; ++i) rev[b] |= uint8_t(((b >> i) & 1) << (7 - i));
    fill(main, 7, "0001", S_Pass, 0);
    fill(main, 7, "001", S_Horiz, 0);
    fill(main, 7, "1", S_V0, 0);
    fill(main, 7, "011", S_VR, 1);
    fill(main, 7, "000011", S_VR, 2);
    fill(main, 7, "0000011", S_VR, 3);
    fill(main, 7, "010", S_VL, 1);
    fill(main, 7, "000010", S_VL, 2);
    fill(main, 7, "0000010", S_VL, 3);
    fill(main, 7, "0000001", S_Ext, 0);
    fill(main, 7, "0000000", S_EOL, 0);
    for (int i = 0; i < 27; ++i) fill(white, 12, kMakeUpW[i], S_MakeUpW, 64 * (i + 1));
    for (int i = 0; i < 13; ++i) fill(white, 12, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
    for (int i = 0; i < 64; ++i) fill(white, 12, kTermW[i], S_TermW, i);
    fill(white, 12, "00000000000", S_EOL, 0);
    for (int i = 0; i < 27; ++i) fill(black, 13, kMakeUpB[i], S_MakeUpB, 64 * (i + 1));
    for (int i = 0; i < 13; ++i) fill(black, 13, kMakeUp[i], S_MakeUp, 1792 + 64 * i);
    for (int i = 0; i < 64; ++i) fill(black, 13, kTermB[i], S_TermB, i);
    fill(black, 13, "00000000000", S_EOL, 0);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// _TIFFFax3fillruns: white runs clear bits, black runs set them; a run past
// lastx is cut there (and so changed in the array, which the next row reads).
void fillruns(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  static const unsigned char masks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int black = 0; black < 2; ++black) {
      uint32_t run = runs[black];
      if (x + run > lastx || run > lastx) run = runs[black] = lastx - x;
      if (!run) continue;
      uint8_t* cp = buf + (x >> 3);
      uint32_t bx = x & 7;
      if (run > 8 - bx) {
        if (bx) {
          if (black) *cp++ |= uint8_t(0xff >> bx);
          else *cp++ &= uint8_t(0xff << (8 - bx));
          run -= 8 - bx;
        }
        uint32_t n = run >> 3;
        if (n) {
          std::memset(cp, black ? 0xff : 0x00, n);
          cp += n;
          run &= 7;
        }
        if (run) {
          if (black) cp[0] = uint8_t((cp[0] | (0xff00 >> run)) & 0xff);
          else cp[0] &= uint8_t(0xff >> run);
        }
      } else {
        if (black) cp[0] |= uint8_t(masks[run] >> bx);
        else cp[0] &= uint8_t(~(masks[run] >> bx));
      }
      x += runs[black];
    }
  }
}

}  // namespace

extern "C" {

// `kind`: 0 RLE, 1 RLEW, 2 Group 3 1-D, 3 Group 3 with 2-D rows, 4 Group 4.
// `odd`: the strip's first byte lies at an odd file offset. `out`: rows x
// rowbytes bytes, written row by row.
int mm_ccitt_decode(const uint8_t* data, long len, int kind, int width, int rowbytes, int rows,
                    int odd, uint8_t* out, long* info) {
  const Tables& T = tables();
  const int lastx = width;
  uint32_t nruns = ((uint32_t(width) + 1 + 31) / 32) * 32;
  const bool ref_line = kind >= 3;
  if (ref_line) nruns *= 2;
  // fillruns may write one past the last run, as libtiff's may.
  std::vector<uint32_t> store(2 * size_t(nruns) + 1, 0);
  uint32_t* curruns = store.data();
  uint32_t* refruns = ref_line ? store.data() + nruns : nullptr;
  if (refruns) {
    refruns[0] = uint32_t(width);
    refruns[1] = 0;
  }
  info[0] = info[1] = info[2] = 0;
  uint32_t BitAcc = 0;
  int BitsAvail = 0, EOLcnt = 0, a0 = 0, RunLength = 0, b1 = 0;
  const uint8_t* cp = data;
  const uint8_t* ep = data + len;
  uint32_t *pa = nullptr, *thisrun = curruns, *pb = nullptr;
  const TabEnt* TabEnt = nullptr;
  long line = 0;
  uint8_t* buf = out;
  long occ = long(rows) * rowbytes;
  // libtiff's bit reader takes bytes least significant bit first through
  // its bit-reversal table (FillOrder 1; the caller has reversed the bytes
  // of a FillOrder 2 strip), so codes come most significant bit first.
  const uint8_t* rev = T.rev;
#define EndOfData() (cp >= ep)
#define NeedBits8(n, eoflab)                                       \
  do {                                                             \
    if (BitsAvail < (n)) {                                         \
      if (EndOfData()) {                                           \
        if (BitsAvail == 0) goto eoflab;                           \
        BitsAvail = (n);                                           \
      } else {                                                     \
        BitAcc |= uint32_t(rev[*cp++]) << BitsAvail;               \
        BitsAvail += 8;                                            \
      }                                                            \
    }                                                              \
  } while (0)
#define NeedBits16(n, eoflab)                                      \
  do {                                                             \
    if (BitsAvail < (n)) {                                         \
      if (EndOfData()) {                                           \
        if (BitsAvail == 0) goto eoflab;                           \
        BitsAvail = (n);                                           \
      } else {                                                     \
        BitAcc |= uint32_t(rev[*cp++]) << BitsAvail;               \
        if ((BitsAvail += 8) < (n)) {                              \
          if (EndOfData()) {                                       \
            BitsAvail = (n);                                       \
          } else {                                                 \
            BitAcc |= uint32_t(rev[*cp++]) << BitsAvail;           \
            BitsAvail += 8;                                        \
          }                                                        \
        }                                                          \
      }                                                            \
    }                                                              \
  } while (0)
#define GetBits(n) (BitAcc & ((1u << (n)) - 1))
#define ClrBits(n)    \
  do {                \
    BitsAvail -= (n); \
    BitAcc >>= (n);   \
  } while (0)
#define LOOKUP8(wid, tab, eoflab)    \
  do {                               \
    NeedBits8(wid, eoflab);          \
    TabEnt = tab + GetBits(wid);     \
    ClrBits(TabEnt->width);          \
  } while (0)
#define LOOKUP16(wid, tab, eoflab)   \
  do {                               \
    NeedBits16(wid, eoflab);         \
    TabEnt = tab + GetBits(wid);     \
    ClrBits(TabEnt->width);          \
  } while (0)
#define REPORT() (++info[0])
#define SETVALUE(x)                                  \
  do {                                               \
    if (pa >= thisrun + nruns) return -1;            \
    *pa++ = uint32_t(RunLength + (x));               \
    a0 += (x);                                       \
    RunLength = 0;                                   \
  } while (0)
#define CLEANUP_RUNS()                                    \
  do {                                                    \
    if (RunLength) SETVALUE(0);                           \
    if (a0 != lastx) {                                    \
      REPORT();                                           \
      while (a0 > lastx && pa > thisrun) a0 -= int(*--pa); \
      if (a0 < lastx) {                                   \
        if (a0 < 0) a0 = 0;                               \
        if ((pa - thisrun) & 1) SETVALUE(0);              \
        SETVALUE(lastx - a0);                             \
      } else if (a0 > lastx) {                            \
        SETVALUE(lastx);                                  \
        SETVALUE(0);                                      \
      }                                                   \
    }                                                     \
  } while (0)
#define SYNC_EOL(eoflab)                                  \
  do {                                                    \
    if (EOLcnt == 0) {                                    \
      for (;;) {                                          \
        NeedBits16(11, eoflab);                           \
        if (GetBits(11) == 0) break;                      \
        ClrBits(1);                                       \
      }                                                   \
    }                                                     \
    for (;;) {                                            \
      NeedBits8(8, eoflab);                               \
      if (GetBits(8)) break;                              \
      ClrBits(8);                                         \
    }                                                     \
    while (GetBits(1) == 0) ClrBits(1);                   \
    ClrBits(1);                                           \
    EOLcnt = 0;                                           \
  } while (0)
#define EXPAND1D(eoflab)                                               \
  do {                                                                 \
    for (;;) {                                                         \
      for (;;) {                                                       \
        LOOKUP16(12, T.white, eof1d##eoflab);                          \
        switch (TabEnt->state) {                                       \
          case S_EOL:                                                  \
            EOLcnt = 1;                                                \
            goto done1d##eoflab;                                       \
          case S_TermW:                                                \
            SETVALUE(int(TabEnt->param));                              \
            goto doneWhite1d##eoflab;                                  \
          case S_MakeUpW:                                              \
          case S_MakeUp:                                               \
            a0 += int(TabEnt->param);                                  \
            RunLength += int(TabEnt->param);                           \
            break;                                                     \
          default:                                                     \
            REPORT();                                                  \
            goto done1d##eoflab;                                       \
        }                                                              \
      }                                                                \
    doneWhite1d##eoflab:                                               \
      if (a0 >= lastx) goto done1d##eoflab;                            \
      for (;;) {                                                       \
        LOOKUP16(13, T.black, eof1d##eoflab);                          \
        switch (TabEnt->state) {                                       \
          case S_EOL:                                                  \
            EOLcnt = 1;                                                \
            goto done1d##eoflab;                                       \
          case S_TermB:                                                \
            SETVALUE(int(TabEnt->param));                              \
            goto doneBlack1d##eoflab;                                  \
          case S_MakeUpB:                                              \
          case S_MakeUp:                                               \
            a0 += int(TabEnt->param);                                  \
            RunLength += int(TabEnt->param);                           \
            break;                                                     \
          default:                                                     \
            REPORT();                                                  \
            goto done1d##eoflab;                                       \
        }                                                              \
      }                                                                \
    doneBlack1d##eoflab:                                               \
      if (a0 >= lastx) goto done1d##eoflab;                            \
      if (*(pa - 1) == 0 && *(pa - 2) == 0) pa -= 2;                   \
    }                                                                  \
  eof1d##eoflab:                                                       \
    CLEANUP_RUNS();                                                    \
    goto eoflab;                                                       \
  done1d##eoflab:                                                      \
    CLEANUP_RUNS();                                                    \
  } while (0)
#define CHECK_b1                                                 \
  do {                                                           \
    if (pa != thisrun)                                           \
      while (b1 <= a0 && b1 < lastx) {                           \
        if (pb + 1 >= refruns + nruns) return -1;                \
        b1 += int(pb[0] + pb[1]);                                \
        pb += 2;                                                 \
      }                                                          \
  } while (0)
#define EXPAND2D(eoflab)                                                     \
  do {                                                                       \
    while (a0 < lastx) {                                                     \
      if (pa >= thisrun + nruns) return -1;                                  \
      LOOKUP8(7, T.main, eof2d##eoflab);                                     \
      switch (TabEnt->state) {                                               \
        case S_Pass:                                                         \
          CHECK_b1;                                                          \
          if (pb + 1 >= refruns + nruns) return -1;                          \
          b1 += int(*pb++);                                                  \
          RunLength += b1 - a0;                                              \
          a0 = b1;                                                           \
          b1 += int(*pb++);                                                  \
          break;                                                             \
        case S_Horiz:                                                        \
          if ((pa - thisrun) & 1) {                                          \
            for (;;) {                                                       \
              LOOKUP16(13, T.black, eof2d##eoflab);                          \
              switch (TabEnt->state) {                                       \
                case S_TermB:                                                \
                  SETVALUE(int(TabEnt->param));                              \
                  goto doneWhite2da##eoflab;                                 \
                case S_MakeUpB:                                              \
                case S_MakeUp:                                               \
                  a0 += int(TabEnt->param);                                  \
                  RunLength += int(TabEnt->param);                           \
                  break;                                                     \
                default:                                                     \
                  goto badBlack2d##eoflab;                                   \
              }                                                              \
            }                                                                \
          doneWhite2da##eoflab:;                                             \
            for (;;) {                                                       \
              LOOKUP16(12, T.white, eof2d##eoflab);                          \
              switch (TabEnt->state) {                                       \
                case S_TermW:                                                \
                  SETVALUE(int(TabEnt->param));                              \
                  goto doneBlack2da##eoflab;                                 \
                case S_MakeUpW:                                              \
                case S_MakeUp:                                               \
                  a0 += int(TabEnt->param);                                  \
                  RunLength += int(TabEnt->param);                           \
                  break;                                                     \
                default:                                                     \
                  goto badWhite2d##eoflab;                                   \
              }                                                              \
            }                                                                \
          doneBlack2da##eoflab:;                                             \
          } else {                                                           \
            for (;;) {                                                       \
              LOOKUP16(12, T.white, eof2d##eoflab);                          \
              switch (TabEnt->state) {                                       \
                case S_TermW:                                                \
                  SETVALUE(int(TabEnt->param));                              \
                  goto doneWhite2db##eoflab;                                 \
                case S_MakeUpW:                                              \
                case S_MakeUp:                                               \
                  a0 += int(TabEnt->param);                                  \
                  RunLength += int(TabEnt->param);                           \
                  break;                                                     \
                default:                                                     \
                  goto badWhite2d##eoflab;                                   \
              }                                                              \
            }                                                                \
          doneWhite2db##eoflab:;                                             \
            for (;;) {                                                       \
              LOOKUP16(13, T.black, eof2d##eoflab);                          \
              switch (TabEnt->state) {                                       \
                case S_TermB:                                                \
                  SETVALUE(int(TabEnt->param));                              \
                  goto doneBlack2db##eoflab;                                 \
                case S_MakeUpB:                                              \
                case S_MakeUp:                                               \
                  a0 += int(TabEnt->param);                                  \
                  RunLength += int(TabEnt->param);                           \
                  break;                                                     \
                default:                                                     \
                  goto badBlack2d##eoflab;                                   \
              }                                                              \
            }                                                                \
          doneBlack2db##eoflab:;                                             \
          }                                                                  \
          CHECK_b1;                                                          \
          break;                                                             \
        case S_V0:                                                           \
          CHECK_b1;                                                          \
          SETVALUE(b1 - a0);                                                 \
          if (pb >= refruns + nruns) return -1;                              \
          b1 += int(*pb++);                                                  \
          break;                                                             \
        case S_VR:                                                           \
          CHECK_b1;                                                          \
          SETVALUE(b1 - a0 + int(TabEnt->param));                            \
          if (pb >= refruns + nruns) return -1;                              \
          b1 += int(*pb++);                                                  \
          break;                                                             \
        case S_VL:                                                           \
          CHECK_b1;                                                          \
          if (b1 < int(a0 + TabEnt->param)) {                                \
            REPORT();                                                        \
            goto eol2d##eoflab;                                              \
          }                                                                  \
          SETVALUE(b1 - a0 - int(TabEnt->param));                            \
          b1 -= int(*--pb);                                                  \
          break;                                                             \
        case S_Ext:                                                          \
          *pa++ = uint32_t(lastx - a0);                                      \
          REPORT();                                                          \
          ++info[1];                                                         \
          goto eol2d##eoflab;                                                \
        case S_EOL:                                                          \
          *pa++ = uint32_t(lastx - a0);                                      \
          NeedBits8(4, eof2d##eoflab);                                       \
          if (GetBits(4)) REPORT();                                          \
          ClrBits(4);                                                        \
          EOLcnt = 1;                                                        \
          goto eol2d##eoflab;                                                \
        default:                                                             \
        badMain2d##eoflab:                                                   \
          REPORT();                                                          \
          goto eol2d##eoflab;                                                \
        badBlack2d##eoflab:                                                  \
          REPORT();                                                          \
          goto eol2d##eoflab;                                                \
        badWhite2d##eoflab:                                                  \
          REPORT();                                                          \
          goto eol2d##eoflab;                                                \
        eof2d##eoflab:                                                       \
          CLEANUP_RUNS();                                                    \
          goto eoflab;                                                       \
      }                                                                      \
    }                                                                        \
    if (RunLength) {                                                         \
      if (RunLength + a0 < lastx) {                                          \
        NeedBits8(1, eof2d##eoflab);                                         \
        if (!GetBits(1)) goto badMain2d##eoflab;                             \
        ClrBits(1);                                                          \
      }                                                                      \
      SETVALUE(0);                                                           \
    }                                                                        \
  eol2d##eoflab:                                                             \
    CLEANUP_RUNS();                                                          \
  } while (0)

  if (kind <= 1) {  // Fax3DecodeRLE
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      EXPAND1D(EOFRLE);
      fillruns(buf, thisrun, pa, uint32_t(lastx));
      if (kind == 0) {
        int n = BitsAvail - (BitsAvail & ~7);
        ClrBits(n);
      } else {
        int n = BitsAvail - (BitsAvail & ~15);
        ClrBits(n);
        if (BitsAvail == 0 && ((cp - data) + odd) % 2) cp++;
      }
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
      continue;
    EOFRLE:
      fillruns(buf, thisrun, pa, uint32_t(lastx));
      info[2] = line;
      return -1;
    }
  } else if (kind == 2) {  // Fax3Decode1D
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun;
      SYNC_EOL(EOF1D);
      EXPAND1D(EOF1D);
      fillruns(buf, thisrun, pa, uint32_t(lastx));
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
      continue;
    EOF1D:
      CLEANUP_RUNS();
      fillruns(buf, thisrun, pa, uint32_t(lastx));
      info[2] = line;
      return -1;
    }
  } else if (kind == 3) {  // Fax3Decode2D
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      SYNC_EOL(EOF2D);
      int is1D;
      NeedBits8(1, EOF2D);
      is1D = int(GetBits(1));
      ClrBits(1);
      pb = refruns;
      b1 = int(*pb++);
      if (is1D)
        EXPAND1D(EOF2Da);
      else
        EXPAND2D(EOF2Da);
      fillruns(buf, thisrun, pa, uint32_t(lastx));
      if (pa < thisrun + nruns) SETVALUE(0);
      {
        uint32_t* t = curruns;
        curruns = refruns;
        refruns = t;
      }
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
      continue;
    EOF2D:
      CLEANUP_RUNS();
    EOF2Da:
      fillruns(buf, thisrun, pa, uint32_t(lastx));
      info[2] = line;
      return -1;
    }
  } else {  // Fax4Decode
    while (occ > 0) {
      a0 = 0;
      RunLength = 0;
      pa = thisrun = curruns;
      pb = refruns;
      b1 = int(*pb++);
      EXPAND2D(EOFG4);
      if (EOLcnt) goto EOFG4;
      fillruns(buf, thisrun, pa, uint32_t(lastx));
      SETVALUE(0);
      {
        uint32_t* t = curruns;
        curruns = refruns;
        refruns = t;
      }
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
      continue;
    EOFG4:
      NeedBits16(13, BADG4);
    BADG4:
      ClrBits(13);
      fillruns(buf, thisrun, pa, uint32_t(lastx));
      if (!line) return -1;
      info[2] = line + 1;
      return line + 1 < rows ? -2 : 0;
    }
  }
  info[2] = line;
  return 0;
#undef EndOfData
#undef NeedBits8
#undef NeedBits16
#undef GetBits
#undef ClrBits
#undef LOOKUP8
#undef LOOKUP16
#undef REPORT
#undef SETVALUE
#undef CLEANUP_RUNS
#undef SYNC_EOL
#undef EXPAND1D
#undef CHECK_b1
#undef EXPAND2D
}

}  // extern "C"
