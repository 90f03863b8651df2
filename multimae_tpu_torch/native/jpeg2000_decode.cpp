// JPEG 2000 codestream decoder (ISO/IEC 15444-1) for the port's image
// loader, written to give what PIL 12.1 gives over OpenJPEG 2.5: the
// codestream's main and tile-part headers, Tier-2 packets in all five
// progression orders with POC, PPM and PPT, SOP and EPH, Tier-1 (MQ and raw
// passes with every code-block style), ROI maxshift, dequantisation, the
// inverse 5/3 (integers) and 9/7 (OpenJPEG's single-precision lifting), the
// RCT or ICT, the DC level shift with OpenJPEG's rounding and clipping, and
// Pillow's Jpeg2KDecode.c unpackers. The JP2 container is read in Python
// (data/image_io.py); this file takes the codestream, PIL's mode and the
// colour space the container gave.
//
// Built with -ffp-contract=off: every float multiply and add is rounded on
// its own, as OpenJPEG's SSE lanes and its scalar code round them.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

[[noreturn]] void fail(const std::string& m) { throw std::runtime_error(m); }

// What OpenJPEG 2.5 decodes and this decoder does not (JPEG 2000 Part 15
// high-throughput code-blocks, Part 2 multiple component transforms): the
// entry points return -2, and the loader raises UnsupportedImage.
struct Unsupported : std::runtime_error {
  using std::runtime_error::runtime_error;
};
[[noreturn]] void unsupported(const std::string& m) { throw Unsupported(m); }

// ---------------------------------------------------------------- headers --

struct Step {
  int expn = 0, mant = 0;
};

struct Coding {  // COD / COC: what one component's code-blocks use
  int csty = 0;  // bit 0: precinct sizes given
  int nres = 1;  // decomposition levels + 1
  int cbw = 6, cbh = 6, cblksty = 0, qmfbid = 1;
  int prcw[33], prch[33];
};

struct Quant {  // QCD / QCC
  int qntsty = 0, numgbits = 0, nsteps = 0;
  Step steps[97];
};

struct Poc {
  int res0, comp0, lay1, res1, comp1, prg;
};

struct TileHeader {
  bool has_cod = false, has_qcd = false;
  int csty = 0, prg = 0, numlayers = 1, mct = 0;
  Coding cod;
  Quant qcd;
  std::vector<int> has_coc, has_qcc, has_rgn;
  std::vector<Coding> coc;
  std::vector<Quant> qcc;
  std::vector<int> rgn;
  std::vector<Poc> pocs;
};

struct CompInfo {
  int dx = 1, dy = 1, prec = 8, sgnd = 0;
};

struct Tile {
  int parts_seen = 0, parts_total = 0;
  bool seen = false;
  TileHeader th;
  std::vector<uint8_t> data;                    // tile-part bodies in order
  std::vector<std::pair<int, std::vector<uint8_t>>> ppt;  // (Zppt, bytes)
};

struct Codestream {
  int rsiz = 0;           // Rsiz: 0x4000 marks Part 15 (HT) capabilities, 0x8000 Part 2
  bool has_cap = false;   // a CAP marker, which a Part 15 codestream carries
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0, tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
  std::vector<CompInfo> comps;
  TileHeader main;
  std::vector<Tile> tiles;
  // The tiles in OpenJPEG's decoding order: a tile whose last tile-part
  // (by TNsot) has been read is decoded then; the rest at the end of the
  // codestream in index order.
  std::vector<int> tile_order;
  // PPM's packet headers, Nppm fields taken out: OpenJPEG reads them with
  // one cursor across the tiles in their decoding order.
  std::vector<uint8_t> ppm;
  bool uses_ppm = false;
};

// What a Part 2 or Part 15 codestream uses: unsupported where Rsiz claims
// the part (OpenJPEG 2.5 decodes it), a damaged codestream where it does not.
[[noreturn]] void part2(const Codestream& cs, const std::string& what) {
  if (cs.rsiz & 0x8000) unsupported("Part 2 " + what);
  fail("Part 2 " + what + " in a codestream whose Rsiz names no Part 2 capabilities");
}

[[noreturn]] void part15(const Codestream& cs) {
  if ((cs.rsiz & 0x4000) && cs.has_cap) unsupported("high-throughput (Part 15) code-blocks");
  fail("the high-throughput code-block style in a codestream without Part 15 capabilities");
}

struct Reader {
  const uint8_t* p;
  size_t n, pos = 0;
  Reader(const uint8_t* d, size_t len) : p(d), n(len) {}
  void need(size_t k, const char* what) const {
    if (pos + k > n) fail(std::string("truncated ") + what);
  }
  int u8() { need(1, "marker segment"); return p[pos++]; }
  int u16() { need(2, "marker segment"); int v = (p[pos] << 8) | p[pos + 1]; pos += 2; return v; }
  uint32_t u32() {
    need(4, "marker segment");
    uint32_t v = (uint32_t(p[pos]) << 24) | (uint32_t(p[pos + 1]) << 16) |
                 (uint32_t(p[pos + 2]) << 8) | p[pos + 3];
    pos += 4;
    return v;
  }
};

void read_siz(Reader& r, int len, Codestream& cs) {
  if (len < 41 || (len - 38) % 3 != 0) fail("bad SIZ marker size");
  cs.rsiz = r.u16();
  uint32_t X1 = r.u32(), Y1 = r.u32(), X0 = r.u32(), Y0 = r.u32();
  uint32_t TDX = r.u32(), TDY = r.u32(), TX0 = r.u32(), TY0 = r.u32();
  int nc = r.u16();
  if (nc == 0 || nc > 16384 || nc != (len - 38) / 3) fail("bad SIZ component count");
  if (X1 > 0x7fffffffu || Y1 > 0x7fffffffu || X0 >= X1 || Y0 >= Y1)
    fail("negative or zero image size in SIZ");
  if (TDX == 0 || TDY == 0 || TDX > 0x7fffffffu || TDY > 0x7fffffffu)
    fail("invalid tile size in SIZ");
  if (TX0 > X0 || TY0 > Y0 || uint64_t(TX0) + TDX <= X0 || uint64_t(TY0) + TDY <= Y0)
    fail("illegal tile offset in SIZ");
  cs.x0 = int(X0), cs.y0 = int(Y0), cs.x1 = int(X1), cs.y1 = int(Y1);
  cs.tx0 = int(TX0), cs.ty0 = int(TY0), cs.tdx = int(TDX), cs.tdy = int(TDY);
  cs.comps.resize(nc);
  for (auto& c : cs.comps) {
    int s = r.u8();
    c.prec = (s & 0x7f) + 1;
    c.sgnd = s >> 7;
    c.dx = r.u8();
    c.dy = r.u8();
    if (c.prec > 31) fail("component precision past 31 bits");
    if (c.dx < 1 || c.dy < 1) fail("component sub-sampling of 0 in SIZ");
  }
  uint64_t tw = (uint64_t(X1) - TX0 + TDX - 1) / TDX, th = (uint64_t(Y1) - TY0 + TDY - 1) / TDY;
  if (tw == 0 || th == 0 || tw * th > 65535) fail("invalid number of tiles in SIZ");
  cs.tw = int(tw), cs.th = int(th);
  cs.tiles.resize(size_t(tw * th));
}

void read_spcod(Reader& r, Coding& c, bool precincts, int end) {
  int levels = r.u8();
  if (levels > 32) fail("more than 32 decomposition levels");
  c.nres = levels + 1;
  c.cbw = r.u8() + 2;
  c.cbh = r.u8() + 2;
  if (c.cbw > 10 || c.cbh > 10 || c.cbw + c.cbh > 12) fail("bad code-block size");
  c.cblksty = r.u8();
  if (c.cblksty & 0x80) fail("unknown code-block style bits");
  c.qmfbid = r.u8();
  if (c.qmfbid > 1) fail("unknown wavelet transform");
  c.csty = precincts ? 1 : 0;
  for (int i = 0; i < c.nres; ++i) {
    if (precincts) {
      if (int(r.pos) >= end) fail("precinct sizes missing");
      int v = r.u8();
      c.prcw[i] = v & 15;
      c.prch[i] = v >> 4;
      if (i != 0 && (c.prcw[i] == 0 || c.prch[i] == 0)) fail("bad precinct size");
    } else {
      c.prcw[i] = c.prch[i] = 15;
    }
  }
}

void read_cod(Reader& r, int len, TileHeader& h) {
  int end = int(r.pos) + len - 2;
  if (len < 12) fail("bad COD marker size");
  h.csty = r.u8();
  if (h.csty & ~7) fail("unknown Scod bits");
  h.prg = r.u8();
  if (h.prg > 4) fail("unknown progression order");
  h.numlayers = r.u16();
  if (h.numlayers == 0) fail("zero layers in COD");
  h.mct = r.u8();
  if (h.mct > 2) fail("unknown multiple component transform");
  read_spcod(r, h.cod, h.csty & 1, end);
  if (int(r.pos) != end) fail("bad COD marker size");
  h.has_cod = true;
}

int read_compno(Reader& r, size_t nc) {
  int c = nc <= 256 ? r.u8() : r.u16();
  if (size_t(c) >= nc) fail("component index past the component count");
  return c;
}

void read_coc(Reader& r, int len, TileHeader& h, size_t nc) {
  int end = int(r.pos) + len - 2;
  int c = read_compno(r, nc);
  int scoc = r.u8();
  if (scoc & ~1) fail("unknown Scoc bits");
  read_spcod(r, h.coc[c], scoc & 1, end);
  if (int(r.pos) != end) fail("bad COC marker size");
  h.has_coc[c] = 1;
}

void read_sqcd(Reader& r, Quant& q, int bytes) {
  if (bytes < 1) fail("bad quantization marker size");
  int s = r.u8();
  q.qntsty = s & 31;
  q.numgbits = s >> 5;
  if (q.qntsty > 2) fail("unknown quantization style");
  int rest = bytes - 1;
  if (q.qntsty == 0) {
    q.nsteps = rest;
  } else if (q.qntsty == 1) {
    if (rest != 2) fail("bad quantization marker size");
    q.nsteps = 1;
  } else {
    if (rest % 2) fail("bad quantization marker size");
    q.nsteps = rest / 2;
  }
  int kept = std::min(q.nsteps, 97);
  for (int b = 0; b < q.nsteps; ++b) {
    Step st;
    if (q.qntsty == 0) {
      st.expn = r.u8() >> 3;
    } else {
      int v = r.u16();
      st.expn = v >> 11;
      st.mant = v & 0x7ff;
    }
    if (b < kept) q.steps[b] = st;
  }
  if (q.qntsty == 1) {
    for (int b = 1; b < 97; ++b) {
      q.steps[b].expn = std::max(q.steps[0].expn - (b - 1) / 3, 0);
      q.steps[b].mant = q.steps[0].mant;
    }
  }
  q.nsteps = q.qntsty == 1 ? 97 : kept;
}

void read_poc(Reader& r, int len, TileHeader& h, size_t nc) {
  int per = nc <= 256 ? 7 : 9;
  if ((len - 2) % per != 0 || len - 2 < per) fail("bad POC marker size");
  for (int i = 0; i < (len - 2) / per; ++i) {
    Poc p;
    p.res0 = r.u8();
    p.comp0 = nc <= 256 ? r.u8() : r.u16();
    p.lay1 = r.u16();
    p.res1 = r.u8();
    p.comp1 = nc <= 256 ? r.u8() : r.u16();
    if (p.comp1 == 0) p.comp1 = 256;
    p.prg = r.u8();
    if (p.prg > 4) fail("unknown progression order in POC");
    p.comp1 = std::min<int>(p.comp1, int(nc));
    p.lay1 = std::min(p.lay1, 65535);
    h.pocs.push_back(p);
  }
}

void init_header(TileHeader& h, size_t nc) {
  h.has_coc.assign(nc, 0);
  h.has_qcc.assign(nc, 0);
  h.has_rgn.assign(nc, 0);
  h.coc.assign(nc, Coding());
  h.qcc.assign(nc, Quant());
  h.rgn.assign(nc, 0);
}

// A marker segment of a main or tile-part header. Returns false for a
// marker it does not take here.
bool header_marker(int m, Reader& r, int len, TileHeader& h, Codestream& cs, bool tile_part,
                   Tile* tile) {
  size_t nc = cs.comps.size();
  int end = int(r.pos) + len - 2;
  switch (m) {
    case 0xff52: read_cod(r, len, h); break;
    case 0xff53: read_coc(r, len, h, nc); break;
    case 0xff5c: read_sqcd(r, h.qcd, len - 2); h.has_qcd = true; break;
    case 0xff5d: {
      int c = read_compno(r, nc);
      read_sqcd(r, h.qcc[c], end - int(r.pos));
      h.has_qcc[c] = 1;
      break;
    }
    case 0xff5e: {
      int c = read_compno(r, nc);
      if (r.u8() != 0) fail("unknown ROI style in RGN");
      h.rgn[c] = r.u8();
      h.has_rgn[c] = 1;
      break;
    }
    case 0xff5f: read_poc(r, len, h, nc); break;
    case 0xff61: {  // PPT
      if (!tile_part) return false;
      int z = r.u8();
      for (auto& pp : tile->ppt)
        if (pp.first == z) fail("a Zppt read twice");
      tile->ppt.emplace_back(z, std::vector<uint8_t>(r.p + r.pos, r.p + end));
      break;
    }
    case 0xff55: case 0xff57: case 0xff58: case 0xff63: case 0xff64:  // TLM PLM PLT CRG COM
    case 0xff50: cs.has_cap = true; break;  // CAP (Part 15)
    case 0xff59: break;                     // CPF (Part 15)
    case 0xff74: case 0xff75: case 0xff77: case 0xff78:  // MCT MCC MCO CBD (Part 2)
      part2(cs, "multiple component transform markers");
    default:
      return false;
  }
  if (m == 0xff55 || m == 0xff57 || m == 0xff63 || m == 0xff50 || m == 0xff59) {
    if (tile_part) fail("main-header marker in a tile-part header");
  }
  if (m == 0xff58 && !tile_part) fail("PLT in the main header");
  r.pos = size_t(end);
  return true;
}

Codestream parse(const uint8_t* d, size_t n) {
  Codestream cs;
  Reader r(d, n);
  if (n < 4 || r.u16() != 0xff4f) fail("no SOC marker");
  if (r.u16() != 0xff51) fail("no SIZ marker after SOC");
  int len = r.u16();
  r.need(size_t(len - 2), "SIZ");
  read_siz(r, len, cs);
  size_t nc = cs.comps.size();
  init_header(cs.main, nc);
  std::vector<std::pair<int, std::vector<uint8_t>>> ppms;
  // main header
  for (;;) {
    if (r.pos + 2 > n) fail("codestream ends in the main header");
    int m = r.u16();
    if (m == 0xff90) break;
    if (m < 0xff30) fail("expected a marker in the main header");
    if (m >= 0xff30 && m <= 0xff3f) continue;
    int l = r.u16();
    if (l < 2) fail("bad marker segment length");
    r.need(size_t(l - 2), "marker segment");
    if (m == 0xff60) {  // PPM
      int z = r.u8();
      for (auto& pp : ppms)
        if (pp.first == z) fail("a Zppm read twice");
      ppms.emplace_back(z, std::vector<uint8_t>(d + r.pos, d + r.pos + l - 3));
      r.pos += size_t(l - 3);
      continue;
    }
    if (!header_marker(m, r, l, cs.main, cs, false, nullptr))
      fail("unknown or misplaced marker in the main header");
  }
  if (!cs.main.has_cod) fail("no COD marker in the main header");
  if (!cs.main.has_qcd) fail("no QCD marker in the main header");
  std::stable_sort(ppms.begin(), ppms.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  // OpenJPEG's opj_j2k_merge_ppm: the Nppm fields out, a field may span markers
  cs.uses_ppm = !ppms.empty();
  uint32_t remaining = 0;
  for (auto& pp : ppms) {
    const std::vector<uint8_t>& v = pp.second;
    size_t at = 0;
    uint32_t take = std::min<uint32_t>(remaining, uint32_t(v.size()));
    cs.ppm.insert(cs.ppm.end(), v.begin(), v.begin() + take);
    remaining -= take;
    at = take;
    while (at < v.size()) {
      if (v.size() - at < 4) fail("not enough bytes to read Nppm");
      uint32_t np = (uint32_t(v[at]) << 24) | (uint32_t(v[at + 1]) << 16) |
                    (uint32_t(v[at + 2]) << 8) | v[at + 3];
      at += 4;
      size_t here = std::min<size_t>(np, v.size() - at);
      cs.ppm.insert(cs.ppm.end(), v.begin() + long(at), v.begin() + long(at + here));
      at += here;
      remaining = np - uint32_t(here);
    }
  }
  if (remaining) fail("corrupted PPM markers");
  std::vector<uint8_t> queued(cs.tiles.size(), 0);
  // tile-parts
  r.pos -= 2;
  for (;;) {
    if (r.pos + 2 > n) fail("codestream ends without EOC");
    int m = r.u16();
    if (m == 0xffd9) break;
    if (m != 0xff90) fail("expected SOT");
    size_t sot_at = r.pos - 2;
    int l = r.u16();
    if (l != 10) fail("bad SOT marker size");
    int isot = r.u16();
    uint32_t psot = r.u32();
    int tpsot = r.u8(), tnsot = r.u8();
    if (isot >= cs.tw * cs.th) fail("tile index past the tile count");
    if (psot != 0 && psot < 14) fail("bad Psot");
    Tile& t = cs.tiles[size_t(isot)];
    if (tpsot != t.parts_seen) fail("tile-parts out of order");
    if (tnsot != 0) {
      if (tpsot >= tnsot) fail("TPsot past TNsot");
      if (t.parts_total && t.parts_total != tnsot) fail("TNsot changed between tile-parts");
      t.parts_total = tnsot;
    } else if (t.parts_total && tpsot >= t.parts_total) {
      fail("more tile-parts than TNsot");
    }
    if (!t.seen) {
      t.seen = true;
      init_header(t.th, nc);
    }
    size_t end = psot ? sot_at + psot : n;
    if (psot == 0 && n >= 2 && d[n - 2] == 0xff && d[n - 1] == 0xd9) end = n - 2;
    if (end > n) fail("tile-part runs past the end of the codestream");
    // tile-part header
    for (;;) {
      if (r.pos + 2 > end) fail("tile-part header runs past its tile-part");
      int mm = r.u16();
      if (mm == 0xff93) break;
      if (mm < 0xff30) fail("expected a marker in a tile-part header");
      int ll = r.u16();
      if (ll < 2 || r.pos + size_t(ll - 2) > end) fail("bad marker segment length");
      if (mm == 0xff52 || mm == 0xff53 || mm == 0xff5c || mm == 0xff5d || mm == 0xff5e ||
          mm == 0xff5f) {
        if (tpsot != 0 && mm != 0xff5f && mm != 0xff5e)
          fail("COD/COC/QCD/QCC in a later tile-part");
      }
      if (!header_marker(mm, r, ll, t.th, cs, true, &t))
        fail("unknown or misplaced marker in a tile-part header");
    }
    if (cs.uses_ppm && !t.ppt.empty()) fail("PPM and PPT in one codestream");
    t.data.insert(t.data.end(), d + r.pos, d + end);
    t.parts_seen++;
    if (t.parts_total && t.parts_seen == t.parts_total && !queued[size_t(isot)]) {
      queued[size_t(isot)] = 1;
      cs.tile_order.push_back(isot);
    }
    r.pos = end;
  }
  for (size_t i = 0; i < cs.tiles.size(); ++i)
    if (cs.tiles[i].seen && !queued[i]) cs.tile_order.push_back(int(i));
  return cs;
}

// ------------------------------------------------------------- structures --

inline int ceildiv(int64_t a, int64_t b) { return int((a + b - 1) / b); }
inline int ceildivpow2(int64_t a, int b) { return int((a + (int64_t(1) << b) - 1) >> b); }
inline int floordivpow2(int64_t a, int b) { return int(a >> b); }

struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  int leaves = 0;
  void init(int w, int h) {
    nodes.clear();
    leaves = w * h;
    if (!leaves) return;
    std::vector<int> ws{w}, hs{h};
    while (ws.back() > 1 || hs.back() > 1) {
      ws.push_back((ws.back() + 1) / 2);
      hs.push_back((hs.back() + 1) / 2);
    }
    int total = 0;
    for (size_t i = 0; i < ws.size(); ++i) total += ws[i] * hs[i];
    nodes.assign(size_t(total), Node{-1, 999, 0});
    int base = 0;
    for (size_t l = 0; l + 1 < ws.size(); ++l) {
      int next = base + ws[l] * hs[l];
      for (int y = 0; y < hs[l]; ++y)
        for (int x = 0; x < ws[l]; ++x)
          nodes[size_t(base + y * ws[l] + x)].parent = next + (y / 2) * ws[l + 1] + x / 2;
      base = next;
    }
  }
};

struct Bio {
  const uint8_t* p;
  const uint8_t* start;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  bool past = false;
  Bio(const uint8_t* s, const uint8_t* e) : p(s), start(s), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (p < end) buf |= *p++;
    else past = true;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) {
      if (ct == 0) bytein();
      ct--;
      v |= ((buf >> ct) & 1u) << i;
    }
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t used() const { return size_t(p - start); }
};

bool tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
  int stk[40];
  int sp = 0;
  int node = leaf;
  while (t.nodes[size_t(node)].parent >= 0) {
    stk[sp++] = node;
    node = t.nodes[size_t(node)].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& nd = t.nodes[size_t(node)];
    if (low > nd.low) nd.low = low;
    else low = nd.low;
    while (low < threshold) {
      if (low >= nd.value) break;
      if (bio.read(1)) nd.value = low;
      else ++low;
      if (bio.past) fail("packet header runs past its data");
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return t.nodes[size_t(node)].value < threshold;
}

struct Seg {
  int maxpasses = 0, numpasses = 0, len = 0, newpasses = 0, newlen = 0;
};

struct Cblk {
  int x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0;
  bool included = false;
  std::vector<Seg> segs;
  std::vector<uint8_t> data;
  int newpasses = 0;
};

struct Prec {
  int cw = 0, ch = 0;
  std::vector<int> cblks;  // indices into the band's code-blocks, row-major
  TagTree incl, imsb;
};

struct Band {
  int bandno = 0, x0 = 0, y0 = 0, x1 = 0, y1 = 0, numbps = 0;
  float stepsize = 0;
  std::vector<Cblk> cblks;
  std::vector<Prec> precs;
};

struct Res {
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0, pdx = 15, pdy = 15, pw = 0, ph = 0;
  std::vector<Band> bands;
};

struct TileComp {
  int x0, y0, x1, y1;
  Coding cod;
  Quant q;
  int roishift = 0;
  std::vector<Res> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
};

void build_tilecomp(TileComp& tc, const CompInfo& ci) {
  int nres = tc.cod.nres;
  tc.res.resize(size_t(nres));
  for (int r = 0; r < nres; ++r) {
    Res& res = tc.res[size_t(r)];
    int lev = nres - 1 - r;
    res.x0 = ceildivpow2(tc.x0, lev), res.y0 = ceildivpow2(tc.y0, lev);
    res.x1 = ceildivpow2(tc.x1, lev), res.y1 = ceildivpow2(tc.y1, lev);
    res.pdx = tc.cod.prcw[r], res.pdy = tc.cod.prch[r];
    if (res.x1 > res.x0) {
      res.pw = ceildivpow2(res.x1, res.pdx) - floordivpow2(res.x0, res.pdx);
    }
    if (res.y1 > res.y0) {
      res.ph = ceildivpow2(res.y1, res.pdy) - floordivpow2(res.y0, res.pdy);
    }
    if (int64_t(res.pw) * res.ph > (1 << 24)) fail("too many precincts");
    int nbands = r == 0 ? 1 : 3;
    res.bands.resize(size_t(nbands));
    int cbgw = r == 0 ? res.pdx : res.pdx - 1, cbgh = r == 0 ? res.pdy : res.pdy - 1;
    int cbw = std::min(tc.cod.cbw, cbgw), cbh = std::min(tc.cod.cbh, cbgh);
    for (int b = 0; b < nbands; ++b) {
      Band& band = res.bands[size_t(b)];
      band.bandno = r == 0 ? 0 : b + 1;
      if (r == 0) {
        band.x0 = res.x0, band.y0 = res.y0, band.x1 = res.x1, band.y1 = res.y1;
      } else {
        int nb = nres - r;  // decomposition level of the band
        int xob = band.bandno & 1, yob = band.bandno >> 1;
        band.x0 = ceildivpow2(int64_t(tc.x0) - (int64_t(xob) << (nb - 1)), nb);
        band.y0 = ceildivpow2(int64_t(tc.y0) - (int64_t(yob) << (nb - 1)), nb);
        band.x1 = ceildivpow2(int64_t(tc.x1) - (int64_t(xob) << (nb - 1)), nb);
        band.y1 = ceildivpow2(int64_t(tc.y1) - (int64_t(yob) << (nb - 1)), nb);
      }
      int stepno = r == 0 ? 0 : 3 * (r - 1) + b + 1;
      Step st;
      if (tc.q.qntsty == 1 || stepno < tc.q.nsteps) st = tc.q.steps[stepno];
      else if (tc.q.nsteps > 0) fail("too few quantization step sizes for the bands");
      else fail("no quantization step sizes");
      band.numbps = st.expn + tc.q.numgbits - 1;
      double rb = ci.prec;
      band.stepsize = float((1.0 + st.mant / 2048.0) * std::pow(2.0, rb - st.expn));
      // precincts and code-blocks
      band.precs.resize(size_t(res.pw) * size_t(res.ph));
      if (band.x1 <= band.x0 || band.y1 <= band.y0) {
        for (auto& p : band.precs) { p.incl.init(0, 0); p.imsb.init(0, 0); }
        continue;
      }
      for (int pj = 0; pj < res.ph; ++pj) {
        for (int pi = 0; pi < res.pw; ++pi) {
          Prec& prc = band.precs[size_t(pj * res.pw + pi)];
          // precinct rectangle in the resolution, mapped to the band
          int64_t px0 = (int64_t(floordivpow2(res.x0, res.pdx)) + pi) << res.pdx;
          int64_t py0 = (int64_t(floordivpow2(res.y0, res.pdy)) + pj) << res.pdy;
          int64_t px1 = px0 + (int64_t(1) << res.pdx), py1 = py0 + (int64_t(1) << res.pdy);
          int64_t bx0, by0, bx1, by1;
          if (r == 0) {
            bx0 = px0, by0 = py0, bx1 = px1, by1 = py1;
          } else {
            bx0 = px0 >> 1, by0 = py0 >> 1, bx1 = px1 >> 1, by1 = py1 >> 1;
          }
          bx0 = std::max<int64_t>(bx0, band.x0), by0 = std::max<int64_t>(by0, band.y0);
          bx1 = std::min<int64_t>(bx1, band.x1), by1 = std::min<int64_t>(by1, band.y1);
          if (bx1 <= bx0 || by1 <= by0) {
            prc.incl.init(0, 0);
            prc.imsb.init(0, 0);
            continue;
          }
          int cx0 = floordivpow2(bx0, cbw), cy0 = floordivpow2(by0, cbh);
          int cx1 = ceildivpow2(bx1, cbw), cy1 = ceildivpow2(by1, cbh);
          prc.cw = cx1 - cx0, prc.ch = cy1 - cy0;
          prc.incl.init(prc.cw, prc.ch);
          prc.imsb.init(prc.cw, prc.ch);
          for (int cy = cy0; cy < cy1; ++cy) {
            for (int cx = cx0; cx < cx1; ++cx) {
              Cblk cb;
              cb.x0 = std::max<int>(cx << cbw, int(bx0));
              cb.y0 = std::max<int>(cy << cbh, int(by0));
              cb.x1 = std::min<int>((cx + 1) << cbw, int(bx1));
              cb.y1 = std::min<int>((cy + 1) << cbh, int(by1));
              prc.cblks.push_back(int(band.cblks.size()));
              band.cblks.push_back(std::move(cb));
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------- Tier-2 --

struct PacketSource {
  const uint8_t* body;
  size_t body_len, body_pos = 0;
  const uint8_t* hdr;  // separate headers (PPM/PPT) or null
  size_t hdr_len, hdr_pos = 0;
};

int getnumpasses(Bio& b) {
  if (!b.read(1)) return 1;
  if (!b.read(1)) return 2;
  int n = int(b.read(2));
  if (n != 3) return 3 + n;
  n = int(b.read(5));
  if (n != 31) return 6 + n;
  return 37 + int(b.read(7));
}

void init_seg(Cblk& cb, int cblksty, bool first) {
  Seg s;
  if (cblksty & 4) s.maxpasses = 1;  // termination on each pass
  else if (cblksty & 1) {           // bypass
    if (first) s.maxpasses = 10;
    else {
      int prev = cb.segs.back().maxpasses;
      s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    s.maxpasses = 109;
  }
  cb.segs.push_back(s);
}

void read_packet(PacketSource& src, TileComp& tc, int resno, int precno, int layno, int csty) {
  Res& res = tc.res[size_t(resno)];
  const uint8_t* hbase;
  size_t hlen, *hpos;
  if (src.hdr) {
    hbase = src.hdr, hlen = src.hdr_len, hpos = &src.hdr_pos;
  } else {
    hbase = src.body, hlen = src.body_len, hpos = &src.body_pos;
  }
  // SOP
  if (csty & 2) {
    size_t& bp = src.body_pos;
    if (bp + 1 < src.body_len && src.body[bp] == 0xff && src.body[bp + 1] == 0x91) {
      if (bp + 6 > src.body_len) fail("SOP marker runs past the tile data");
      bp += 6;
    }
  }
  if (*hpos >= hlen) {  // no bytes left: OpenJPEG reads an empty packet
    if (csty & 4) fail("expected an EPH marker past the end of the packet headers");
    return;
  }
  const uint8_t* hs = hbase + *hpos;
  Bio bio(hs, hbase + hlen);
  bool present = bio.read(1);
  std::vector<std::pair<Band*, Cblk*>> inc;
  if (present) {
    for (auto& band : res.bands) {
      if (size_t(precno) >= band.precs.size()) continue;
      Prec& prc = band.precs[size_t(precno)];
      for (size_t k = 0; k < prc.cblks.size(); ++k) {
        Cblk& cb = band.cblks[size_t(prc.cblks[k])];
        bool included;
        if (!cb.included) included = tgt_decode(bio, prc.incl, int(k), layno + 1);
        else included = bio.read(1);
        if (bio.past) fail("packet header runs past its data");
        if (!included) {
          cb.newpasses = 0;
          continue;
        }
        if (!cb.included) {
          int i = 0;
          while (!tgt_decode(bio, prc.imsb, int(k), i)) {
            if (++i > 74) fail("bad zero bit-plane count");
          }
          cb.numbps = band.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        int n = getnumpasses(bio);
        int inc_bits = 0;
        while (bio.read(1)) {
          if (++inc_bits > 32) fail("bad Lblock increment");
        }
        cb.numlenbits += inc_bits;
        cb.newpasses = n;
        size_t segno;
        if (cb.segs.empty()) {
          init_seg(cb, tc.cod.cblksty, true);
        } else if (cb.segs.back().numpasses == cb.segs.back().maxpasses) {
          init_seg(cb, tc.cod.cblksty, false);
        }
        segno = cb.segs.size() - 1;
        int left = n;
        for (;;) {
          Seg& sg = cb.segs[segno];
          sg.newpasses = std::min(sg.maxpasses - sg.numpasses, left);
          int bits = cb.numlenbits;
          for (int v = sg.newpasses; v > 1; v >>= 1) ++bits;
          if (bits > 32) fail("bad code-word segment length size");
          sg.newlen = int(bio.read(bits));
          if (bio.past) fail("packet header runs past its data");
          left -= sg.newpasses;
          if (left <= 0) break;
          init_seg(cb, tc.cod.cblksty, false);
          segno = cb.segs.size() - 1;
        }
        // the segments that gained passes start where the last one ended
        inc.emplace_back(&band, &cb);
        cb.included = true;
      }
    }
  }
  bio.inalign();
  if (bio.past) fail("packet header runs past its data");
  *hpos += bio.used();
  if (csty & 4) {  // EPH: OpenJPEG 2.5 refuses a packet header without it
    if (*hpos + 2 > hlen || hbase[*hpos] != 0xff || hbase[*hpos + 1] != 0x92)
      fail("expected an EPH marker");
    *hpos += 2;
  }
  // packet body
  for (auto& pr : inc) {
    Cblk& cb = *pr.second;
    // the segments that got data in this packet are the last ones whose
    // newpasses were set; walk from the first segment with newpasses
    size_t first = cb.segs.size();
    int total = 0;
    for (size_t s = cb.segs.size(); s-- > 0;) {
      total += cb.segs[s].newpasses;
      first = s;
      if (total >= cb.newpasses) break;
    }
    for (size_t s = first; s < cb.segs.size(); ++s) {
      Seg& sg = cb.segs[s];
      if (sg.newlen < 0 || src.body_pos + size_t(sg.newlen) > src.body_len)
        fail("code-block data runs past the tile data");
      cb.data.insert(cb.data.end(), src.body + src.body_pos, src.body + src.body_pos + sg.newlen);
      src.body_pos += size_t(sg.newlen);
      sg.len += sg.newlen;
      sg.numpasses += sg.newpasses;
      sg.newpasses = 0;
      sg.newlen = 0;
    }
  }
}

// Packet order: OpenJPEG's pi.c iterators, the include table keeping each
// packet once across progression order changes.
struct Packet {
  int lay, res, comp, prec;
};

void packet_order(const Codestream& cs, const std::vector<TileComp>& tcs, const TileHeader& eff,
                  int tx0, int ty0, int tx1, int ty1, std::vector<Packet>& out) {
  int nc = int(tcs.size());
  int maxres = 0;
  for (auto& t : tcs) maxres = std::max(maxres, t.cod.nres);
  int nl = eff.numlayers;
  std::vector<Poc> pocs = eff.pocs;
  if (pocs.empty()) pocs.push_back(Poc{0, 0, nl, maxres, nc, eff.prg});
  // include table: per (comp, res) the precinct count
  std::vector<std::vector<std::vector<uint8_t>>> done(static_cast<size_t>(nc));
  for (int c = 0; c < nc; ++c) {
    done[size_t(c)].resize(tcs[size_t(c)].res.size());
    for (size_t r = 0; r < tcs[size_t(c)].res.size(); ++r) {
      const Res& res = tcs[size_t(c)].res[r];
      done[size_t(c)][r].assign(size_t(res.pw) * size_t(res.ph) * size_t(nl), 0);
    }
  }
  auto emit = [&](int l, int r, int c, int p) {
    if (c >= nc || r >= tcs[size_t(c)].cod.nres || l >= nl) return;
    const Res& res = tcs[size_t(c)].res[size_t(r)];
    if (p >= res.pw * res.ph) return;
    uint8_t& d = done[size_t(c)][size_t(r)][size_t(p) * size_t(nl) + size_t(l)];
    if (d) return;
    d = 1;
    out.push_back(Packet{l, r, c, p});
  };
  for (const Poc& poc : pocs) {
    int r0 = poc.res0, r1 = std::min(poc.res1, maxres);
    int c0 = poc.comp0, c1 = std::min(poc.comp1, nc);
    int l1 = std::min(poc.lay1, nl);
    if (poc.prg == 0 || poc.prg == 1) {  // LRCP, RLCP
      for (int a = 0; a < (poc.prg == 0 ? l1 : r1); ++a) {
        int l = poc.prg == 0 ? a : 0, r = poc.prg == 0 ? 0 : a;
        if (poc.prg == 1 && a < r0) continue;
        for (int b = (poc.prg == 0 ? r0 : 0); b < (poc.prg == 0 ? r1 : l1); ++b) {
          if (poc.prg == 0) r = b; else l = b;
          for (int c = c0; c < c1; ++c) {
            if (r >= tcs[size_t(c)].cod.nres) continue;
            const Res& res = tcs[size_t(c)].res[size_t(r)];
            for (int p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
          }
        }
      }
      continue;
    }
    // position-driven orders: steps of the smallest precinct over
    // components and resolutions on the reference grid
    int64_t dx = 0, dy = 0;
    for (int c = c0; c < c1; ++c) {
      const CompInfo& ci = cs.comps[size_t(c)];
      const TileComp& tc = tcs[size_t(c)];
      for (int r = 0; r < tc.cod.nres; ++r) {
        const Res& res = tc.res[size_t(r)];
        int lev = tc.cod.nres - 1 - r;
        if (res.pdx + lev < 32) {
          int64_t ddx = int64_t(ci.dx) << (res.pdx + lev);
          dx = dx ? std::min(dx, ddx) : ddx;
        }
        if (res.pdy + lev < 32) {
          int64_t ddy = int64_t(ci.dy) << (res.pdy + lev);
          dy = dy ? std::min(dy, ddy) : ddy;
        }
      }
    }
    if (!dx || !dy) continue;
    auto visit = [&](int c, int r, int64_t x, int64_t y, int l0, int l1_) {
      const CompInfo& ci = cs.comps[size_t(c)];
      const TileComp& tc = tcs[size_t(c)];
      if (r >= tc.cod.nres) return;
      const Res& res = tc.res[size_t(r)];
      int lev = tc.cod.nres - 1 - r;
      int64_t sx = int64_t(ci.dx) << lev, sy = int64_t(ci.dy) << lev;
      int64_t trx0 = ceildiv(tx0, sx), try0 = ceildiv(ty0, sy);
      int64_t trx1 = ceildiv(tx1, sx), try1 = ceildiv(ty1, sy);
      int rpx = res.pdx + lev, rpy = res.pdy + lev;
      if (rpx >= 31 || rpy >= 31) return;
      if (!((y % (int64_t(ci.dy) << rpy) == 0) ||
            ((y == ty0) && ((try0 << lev) % (int64_t(1) << rpy)))))
        return;
      if (!((x % (int64_t(ci.dx) << rpx) == 0) ||
            ((x == tx0) && ((trx0 << lev) % (int64_t(1) << rpx)))))
        return;
      if (res.pw == 0 || res.ph == 0) return;
      if (trx0 == trx1 || try0 == try1) return;
      int64_t prci = floordivpow2(ceildiv(x, sx), res.pdx) - floordivpow2(trx0, res.pdx);
      int64_t prcj = floordivpow2(ceildiv(y, sy), res.pdy) -
                     floordivpow2(try0, res.pdy);
      int64_t p = prci + prcj * res.pw;
      if (p < 0 || p >= int64_t(res.pw) * res.ph) return;
      for (int l = l0; l < l1_; ++l) emit(l, r, c, int(p));
    };
    if (poc.prg == 2) {  // RPCL
      for (int r = r0; r < r1; ++r)
        for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
          for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
            for (int c = c0; c < c1; ++c) visit(c, r, x, y, 0, l1);
    } else if (poc.prg == 3) {  // PCRL
      for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
        for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
          for (int c = c0; c < c1; ++c)
            for (int r = r0; r < r1; ++r) visit(c, r, x, y, 0, l1);
    } else {  // CPRL
      for (int c = c0; c < c1; ++c) {
        const CompInfo& ci = cs.comps[size_t(c)];
        const TileComp& tc = tcs[size_t(c)];
        int64_t cdx = 0, cdy = 0;
        for (int r = 0; r < tc.cod.nres; ++r) {
          const Res& res = tc.res[size_t(r)];
          int lev = tc.cod.nres - 1 - r;
          if (res.pdx + lev < 32) {
            int64_t v = int64_t(ci.dx) << (res.pdx + lev);
            cdx = cdx ? std::min(cdx, v) : v;
          }
          if (res.pdy + lev < 32) {
            int64_t v = int64_t(ci.dy) << (res.pdy + lev);
            cdy = cdy ? std::min(cdy, v) : v;
          }
        }
        if (!cdx || !cdy) continue;
        for (int64_t y = ty0; y < ty1; y += cdy - (y % cdy))
          for (int64_t x = tx0; x < tx1; x += cdx - (x % cdx))
            for (int r = r0; r < r1; ++r) visit(c, r, x, y, 0, l1);
      }
    }
  }
}

// ---------------------------------------------------------------- Tier-1 --

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState MQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0ac1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0},
    {0x08a1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

struct Mq {
  const uint8_t* bp;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t st[NCTX], mps[NCTX];
  void reset() {
    for (int i = 0; i < NCTX; ++i) st[i] = 0, mps[i] = 0;
    st[CTX_UNI] = 46;
    st[CTX_AGG] = 3;
    st[CTX_ZC] = 4;
  }
  void bytein() {
    if (*bp == 0xff) {
      if (bp[1] > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += uint32_t(*bp) << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += uint32_t(*bp) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p, size_t len) {  // p has two 0xff past len
    bp = p;
    c = len == 0 ? (0xffu << 16) : (uint32_t(*bp) << 16);
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MqState& s = MQ[st[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        st[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = uint8_t(!mps[cx]);
        st[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= uint32_t(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = uint8_t(!mps[cx]);
          st[cx] = s.nlps;
        } else {
          d = mps[cx];
          st[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // raw (bypass) decoding
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          bp++;
          ct = 7;
        }
      } else {
        c = *bp;
        bp++;
        ct = 8;
      }
    }
    ct--;
    return int((c >> ct) & 1u);
  }
};

struct T1 {
  int w, h, orient, vsc;
  std::vector<int32_t> data;
  // per coefficient with a one-sample border: significance, sign, visited
  // in this bit-plane's significance pass, refined before
  std::vector<uint8_t> sig, chi, pi, mu;
  int W;
  void init(int w_, int h_, int orient_, int vsc_) {
    w = w_, h = h_, orient = orient_, vsc = vsc_;
    W = w + 2;
    data.assign(size_t(w) * size_t(h), 0);
    size_t n = size_t(W) * size_t(h + 2);
    sig.assign(n, 0), chi.assign(n, 0), pi.assign(n, 0), mu.assign(n, 0);
  }
  inline int at(int x, int y) const { return (y + 1) * W + x + 1; }
  // neighbour significance, with the row below a stripe's last row hidden
  // under vertically causal coding
  inline bool south_hidden(int y) const { return vsc && (y & 3) == 3; }
  inline void counts(int x, int y, int& hh, int& vv, int& dd) const {
    int i = at(x, y);
    bool s = !south_hidden(y);
    hh = sig[size_t(i - 1)] + sig[size_t(i + 1)];
    vv = sig[size_t(i - W)] + (s ? sig[size_t(i + W)] : 0);
    dd = sig[size_t(i - W - 1)] + sig[size_t(i - W + 1)] +
         (s ? sig[size_t(i + W - 1)] + sig[size_t(i + W + 1)] : 0);
  }
  inline bool any_neighbour(int x, int y) const {
    int hh, vv, dd;
    counts(x, y, hh, vv, dd);
    return hh + vv + dd != 0;
  }
  int zc(int x, int y) const {
    int hh, vv, dd;
    counts(x, y, hh, vv, dd);
    if (orient == 1) std::swap(hh, vv);
    if (orient == 3) {
      int hv = hh + vv;
      if (dd >= 3) return 8;
      if (dd == 2) return hv >= 1 ? 7 : 6;
      if (dd == 1) return hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
      return hv >= 2 ? 2 : hv;
    }
    if (hh == 2) return 8;
    if (hh == 1) return vv >= 1 ? 7 : (dd >= 1 ? 6 : 5);
    if (vv == 2) return 4;
    if (vv == 1) return 3;
    return dd >= 2 ? 2 : dd;
  }
  // sign context and the bit to XOR into the decoded sign
  void sc(int x, int y, int& ctx, int& xorbit) const {
    int i = at(x, y);
    auto contrib = [&](int j) { return sig[size_t(j)] ? (chi[size_t(j)] ? -1 : 1) : 0; };
    int hc = contrib(i - 1) + contrib(i + 1);
    int vc = contrib(i - W) + (south_hidden(y) ? 0 : contrib(i + W));
    hc = std::max(-1, std::min(1, hc));
    vc = std::max(-1, std::min(1, vc));
    if (hc < 0) hc = -hc, vc = -vc, xorbit = 1;
    else if (hc == 0 && vc < 0) vc = -vc, xorbit = 1;
    else xorbit = 0;
    if (hc == 0) ctx = CTX_SC + (vc == 1 ? 1 : 0);
    else ctx = CTX_SC + (vc == 1 ? 4 : (vc == 0 ? 3 : 2));
  }
  int mag(int x, int y) const {
    int i = at(x, y);
    if (mu[size_t(i)]) return CTX_MAG + 2;
    return any_neighbour(x, y) ? CTX_MAG + 1 : CTX_MAG;
  }
  void set_sig(int x, int y, int s, int32_t v) {
    int i = at(x, y);
    sig[size_t(i)] = 1;
    chi[size_t(i)] = uint8_t(s);
    data[size_t(y) * size_t(w) + size_t(x)] = s ? -v : v;
  }
};

// The coding passes. bpno is OpenJPEG's bpno_plus_one: data hold twice the
// coefficient's magnitude, the half of the last decoded bit-plane added.
void sigpass(T1& t, Mq& mq, int bpno, bool raw) {
  int32_t one = int32_t(1) << bpno, oneplushalf = one | (one >> 1);
  for (int k = 0; k < t.h; k += 4)
    for (int x = 0; x < t.w; ++x)
      for (int y = k; y < std::min(k + 4, t.h); ++y) {
        int i = t.at(x, y);
        if (t.sig[size_t(i)] || t.pi[size_t(i)] || !t.any_neighbour(x, y)) continue;
        int v;
        if (raw) {
          v = mq.raw();
          if (v) t.set_sig(x, y, mq.raw(), oneplushalf);
        } else {
          v = mq.decode(t.zc(x, y));
          if (v) {
            int ctx, xb;
            t.sc(x, y, ctx, xb);
            t.set_sig(x, y, mq.decode(ctx) ^ xb, oneplushalf);
          }
        }
        t.pi[size_t(i)] = 1;
      }
}

void refpass(T1& t, Mq& mq, int bpno, bool raw) {
  int32_t poshalf = (int32_t(1) << bpno) >> 1;
  for (int k = 0; k < t.h; k += 4)
    for (int x = 0; x < t.w; ++x)
      for (int y = k; y < std::min(k + 4, t.h); ++y) {
        int i = t.at(x, y);
        if (!t.sig[size_t(i)] || t.pi[size_t(i)]) continue;
        int v = raw ? mq.raw() : mq.decode(t.mag(x, y));
        int32_t& d = t.data[size_t(y) * size_t(t.w) + size_t(x)];
        d += (v ^ (d < 0)) ? poshalf : -poshalf;
        t.mu[size_t(i)] = 1;
      }
}

void clnpass(T1& t, Mq& mq, int bpno, bool segsym) {
  int32_t one = int32_t(1) << bpno, oneplushalf = one | (one >> 1);
  auto step = [&](int x, int y, bool known_sig) {
    int i = t.at(x, y);
    if (!known_sig) {
      if (t.sig[size_t(i)] || t.pi[size_t(i)]) return;
      if (!mq.decode(t.zc(x, y))) return;
    }
    int ctx, xb;
    t.sc(x, y, ctx, xb);
    t.set_sig(x, y, mq.decode(ctx) ^ xb, oneplushalf);
  };
  int full = t.h & ~3;
  for (int k = 0; k < full; k += 4)
    for (int x = 0; x < t.w; ++x) {
      bool run = true;
      for (int y = k; y < k + 4 && run; ++y) {
        int i = t.at(x, y);
        if (t.sig[size_t(i)] || t.pi[size_t(i)] || t.any_neighbour(x, y)) run = false;
      }
      int start = k;
      if (run) {
        if (!mq.decode(CTX_AGG)) continue;
        int rl = mq.decode(CTX_UNI);
        rl = (rl << 1) | mq.decode(CTX_UNI);
        step(x, k + rl, true);
        start = k + rl + 1;
      }
      for (int y = start; y < k + 4; ++y) step(x, y, false);
    }
  for (int x = 0; x < t.w; ++x)
    for (int y = full; y < t.h; ++y) step(x, y, false);
  std::fill(t.pi.begin(), t.pi.end(), 0);
  if (segsym) {
    for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
  }
}

void decode_cblk(T1& t, Cblk& cb, int orient, int roishift, int cblksty) {
  t.init(cb.x1 - cb.x0, cb.y1 - cb.y0, orient, (cblksty & 8) ? 1 : 0);
  int bpno = roishift + cb.numbps;
  if (bpno >= 31) fail("too many bit-planes in a code-block");
  Mq mq;
  mq.reset();
  std::vector<uint8_t> buf;
  size_t at = 0;
  int passtype = 2;
  for (auto& sg : cb.segs) {
    if (sg.numpasses == 0) continue;
    bool raw = (bpno <= cb.numbps - 4) && passtype < 2 && (cblksty & 1);
    buf.assign(cb.data.begin() + long(at), cb.data.begin() + long(at + size_t(sg.len)));
    buf.push_back(0xff);
    buf.push_back(0xff);
    at += size_t(sg.len);
    if (raw) mq.raw_init(buf.data());
    else mq.init(buf.data(), size_t(sg.len));
    for (int p = 0; p < sg.numpasses && bpno >= 1; ++p) {
      if (passtype == 0) sigpass(t, mq, bpno, raw);
      else if (passtype == 1) refpass(t, mq, bpno, raw);
      else clnpass(t, mq, bpno, cblksty & 32);
      if ((cblksty & 2) && !raw) mq.reset();
      if (++passtype == 3) {
        passtype = 0;
        bpno--;
      }
    }
  }
  if (roishift) {
    if (roishift >= 31) {
      std::fill(t.data.begin(), t.data.end(), 0);
    } else {
      int32_t thresh = int32_t(1) << roishift;
      for (auto& v : t.data) {
        int32_t m = v < 0 ? -v : v;
        if (m >= thresh) {
          m >>= roishift;
          v = v < 0 ? -m : m;
        }
      }
    }
  }
}

// ------------------------------------------------------ inverse transforms --

inline int32_t wadd(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t wsub(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }

// One line of the reversible 5/3 synthesis on interleaved samples (index i
// is low-pass where (i + cas) is even), whole-sample symmetric extension.
void idwt53_line(int32_t* x, int n, int cas) {
  if (n == 1) {
    if (cas) x[0] /= 2;
    return;
  }
  auto at = [&](int i) { return x[i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i)]; };
  for (int i = cas; i < n; i += 2) x[i] = wsub(x[i], wadd(wadd(at(i - 1), at(i + 1)), 2) >> 2);
  for (int i = 1 - cas; i < n; i += 2) x[i] = wadd(x[i], wadd(at(i - 1), at(i + 1)) >> 1);
}

const float K97 = 1.230174105f, TWO_INVK = 1.625732422f;
const float ALPHA = -1.586134342f, BETA = -0.052980118f, GAMMA = 0.882911075f,
            DELTA = 0.443506852f;

// One line of OpenJPEG 2.5's 9/7 synthesis (opj_v8dwt_decode).
void idwt97_line(float* x, int n, int cas) {
  int sn = cas ? n / 2 : (n + 1) / 2, dn = n - sn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  for (int i = cas; i < n; i += 2) x[i] = x[i] * K97;
  for (int i = 1 - cas; i < n; i += 2) x[i] = x[i] * TWO_INVK;
  auto lift = [&](int parity, float c) {
    for (int i = parity; i < n; i += 2) {
      float l = i - 1 >= 0 ? x[i - 1] : x[i + 1];
      float r = i + 1 < n ? x[i + 1] : x[i - 1];
      x[i] = x[i] + ((l + r) * c);
    }
  };
  lift(cas, -DELTA);
  lift(1 - cas, -GAMMA);
  lift(cas, -BETA);
  lift(1 - cas, -ALPHA);
}

template <typename T, typename F>
void idwt2d(T* a, int stride, const std::vector<Res>& res, F line) {
  std::vector<T> tmp;
  for (size_t r = 1; r < res.size(); ++r) {
    int rw = res[r].x1 - res[r].x0, rh = res[r].y1 - res[r].y0;
    int sw = res[r - 1].x1 - res[r - 1].x0, sh = res[r - 1].y1 - res[r - 1].y0;
    int casx = res[r].x0 & 1, casy = res[r].y0 & 1;
    tmp.resize(size_t(std::max(rw, rh)));
    if (rw > 0) {
      for (int j = 0; j < rh; ++j) {
        T* row = a + size_t(j) * size_t(stride);
        for (int i = 0; i < sw; ++i) tmp[size_t(2 * i + casx)] = row[i];
        for (int i = 0; i < rw - sw; ++i) tmp[size_t(2 * i + 1 - casx)] = row[sw + i];
        line(tmp.data(), rw, casx);
        std::copy(tmp.begin(), tmp.begin() + rw, row);
      }
    }
    if (rh > 0) {
      for (int i = 0; i < rw; ++i) {
        for (int j = 0; j < sh; ++j)
          tmp[size_t(2 * j + casy)] = a[size_t(j) * size_t(stride) + size_t(i)];
        for (int j = 0; j < rh - sh; ++j)
          tmp[size_t(2 * j + 1 - casy)] = a[size_t(sh + j) * size_t(stride) + size_t(i)];
        line(tmp.data(), rh, casy);
        for (int j = 0; j < rh; ++j) a[size_t(j) * size_t(stride) + size_t(i)] = tmp[size_t(j)];
      }
    }
  }
}

// -------------------------------------------------------------- the tiles --

struct DecodedTile {
  int x0, y0, x1, y1;  // on the reference grid
  std::vector<TileComp> comps;
};

void effective_header(const Codestream& cs, const Tile& t, TileHeader& eff,
                      std::vector<TileComp>& tcs) {
  const TileHeader& m = cs.main;
  const TileHeader& h = t.th;
  size_t nc = cs.comps.size();
  eff = h.has_cod ? h : m;
  eff.pocs = !h.pocs.empty() ? h.pocs : m.pocs;
  tcs.resize(nc);
  for (size_t c = 0; c < nc; ++c) {
    TileComp& tc = tcs[c];
    tc.cod = h.has_coc[c] ? h.coc[c] : (h.has_cod ? h.cod : (m.has_coc[c] ? m.coc[c] : m.cod));
    tc.q = h.has_qcc[c] ? h.qcc[c] : (h.has_qcd ? h.qcd : (m.has_qcc[c] ? m.qcc[c] : m.qcd));
    tc.roishift = h.has_rgn[c] ? h.rgn[c] : m.rgn[c];
  }
}

DecodedTile decode_tile(const Codestream& cs, int tileno, size_t& ppm_pos) {
  const Tile& t = cs.tiles[size_t(tileno)];
  DecodedTile dt;
  int p = tileno % cs.tw, q = tileno / cs.tw;
  dt.x0 = int(std::max<int64_t>(cs.tx0 + int64_t(p) * cs.tdx, cs.x0));
  dt.y0 = int(std::max<int64_t>(cs.ty0 + int64_t(q) * cs.tdy, cs.y0));
  dt.x1 = int(std::min<int64_t>(cs.tx0 + int64_t(p + 1) * cs.tdx, cs.x1));
  dt.y1 = int(std::min<int64_t>(cs.ty0 + int64_t(q + 1) * cs.tdy, cs.y1));
  TileHeader eff;
  effective_header(cs, t, eff, dt.comps);
  if (eff.mct == 2) part2(cs, "array-based multiple component transform");
  size_t nc = cs.comps.size();
  for (size_t c = 0; c < nc; ++c) {
    TileComp& tc = dt.comps[c];
    const CompInfo& ci = cs.comps[c];
    tc.x0 = ceildiv(dt.x0, ci.dx), tc.y0 = ceildiv(dt.y0, ci.dy);
    tc.x1 = ceildiv(dt.x1, ci.dx), tc.y1 = ceildiv(dt.y1, ci.dy);
    if (tc.cod.cblksty & 0x40) part15(cs);
    int64_t area = int64_t(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
    if (area > (int64_t(1) << 31)) fail("tile-component too large");
    build_tilecomp(tc, ci);
  }
  // Tier-2
  std::vector<Packet> order;
  packet_order(cs, dt.comps, eff, dt.x0, dt.y0, dt.x1, dt.y1, order);
  std::vector<uint8_t> hdrs;
  if (!t.ppt.empty()) {
    auto ppt = t.ppt;
    std::stable_sort(ppt.begin(), ppt.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    for (auto& pp : ppt) hdrs.insert(hdrs.end(), pp.second.begin(), pp.second.end());
  }
  bool separate = cs.uses_ppm || !t.ppt.empty();
  PacketSource src{t.data.data(), t.data.size(), 0, separate ? hdrs.data() : nullptr,
                   hdrs.size(), 0};
  if (cs.uses_ppm) src.hdr = cs.ppm.data(), src.hdr_len = cs.ppm.size(), src.hdr_pos = ppm_pos;
  static const uint8_t empty[1] = {0};
  if (separate && !src.hdr) src.hdr = empty;
  for (const Packet& pk : order)
    read_packet(src, dt.comps[size_t(pk.comp)], pk.res, pk.prec, pk.lay, eff.csty);
  if (cs.uses_ppm) ppm_pos = src.hdr_pos;
  // Tier-1 and dequantisation
  T1 t1;
  for (size_t c = 0; c < nc; ++c) {
    TileComp& tc = dt.comps[c];
    int w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
    bool rev = tc.cod.qmfbid == 1;
    if (rev) tc.idata.assign(size_t(w) * size_t(h), 0);
    else tc.fdata.assign(size_t(w) * size_t(h), 0.0f);
    for (size_t r = 0; r < tc.res.size(); ++r) {
      for (Band& band : tc.res[r].bands) {
        float step = 0.5f * band.stepsize;
        for (Cblk& cb : band.cblks) {
          decode_cblk(t1, cb, band.bandno, tc.roishift, tc.cod.cblksty);
          int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
          if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
          if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
          for (int j = 0; j < t1.h; ++j)
            for (int i = 0; i < t1.w; ++i) {
              int32_t v = t1.data[size_t(j) * size_t(t1.w) + size_t(i)];
              size_t o = size_t(y + j) * size_t(w) + size_t(x + i);
              if (rev) tc.idata[o] = v / 2;
              else tc.fdata[o] = float(v) * step;
            }
        }
      }
    }
  }
  return dt;
}

// A tile-component's samples between the stages: int32 (reversible) or
// float32 (irreversible), w x h.
struct Plane {
  int w = 0, h = 0, qmfbid = 1;
  std::vector<int32_t> i;
  std::vector<float> f;
};

Plane plane_of(TileComp& tc) {
  Plane p;
  p.w = tc.x1 - tc.x0, p.h = tc.y1 - tc.y0, p.qmfbid = tc.cod.qmfbid;
  p.i.swap(tc.idata);
  p.f.swap(tc.fdata);
  return p;
}

void inverse_dwt(Plane& p, const std::vector<Res>& res) {
  if (p.qmfbid == 1) idwt2d(p.i.data(), p.w, res, idwt53_line);
  else idwt2d(p.f.data(), p.w, res, idwt97_line);
}

// RCT / ICT on the first three components (OpenJPEG's opj_mct_decode and
// opj_mct_decode_real), then the DC level shift with OpenJPEG's rounding
// (lrintf) and clipping to the component's range: int32 samples.
void colour(std::vector<Plane>& ps, const std::vector<CompInfo>& comps, int mct,
            std::vector<std::vector<int32_t>>& out) {
  size_t nc = ps.size();
  if (mct && nc >= 3) {
    Plane &a = ps[0], &b = ps[1], &c = ps[2];
    if (a.w != b.w || a.w != c.w || a.h != b.h || a.h != c.h)
      fail("components of different sizes under a multiple component transform");
    if (a.qmfbid != b.qmfbid || a.qmfbid != c.qmfbid)
      fail("reversible and irreversible components under one multiple component transform");
    size_t n = size_t(a.w) * size_t(a.h);
    if (a.qmfbid == 1) {
      for (size_t i = 0; i < n; ++i) {
        int32_t y = a.i[i], u = b.i[i], v = c.i[i];
        int32_t g = wsub(y, wadd(u, v) >> 2);
        a.i[i] = wadd(v, g);
        b.i[i] = g;
        c.i[i] = wadd(u, g);
      }
    } else {
      for (size_t i = 0; i < n; ++i) {
        float y = a.f[i], u = b.f[i], v = c.f[i];
        a.f[i] = y + (v * 1.402f);
        b.f[i] = y - (u * 0.34413f) - (v * 0.71414f);
        c.f[i] = y + (u * 1.772f);
      }
    }
  }
  out.resize(nc);
  for (size_t k = 0; k < nc; ++k) {
    const CompInfo& ci = comps[k];
    Plane& p = ps[k];
    int64_t lo = ci.sgnd ? -(int64_t(1) << (ci.prec - 1)) : 0;
    int64_t hi = ci.sgnd ? (int64_t(1) << (ci.prec - 1)) - 1 : (int64_t(1) << ci.prec) - 1;
    int64_t shift = ci.sgnd ? 0 : int64_t(1) << (ci.prec - 1);
    size_t n = size_t(p.w) * size_t(p.h);
    auto& o = out[k];
    o.resize(n);
    if (p.qmfbid == 1) {
      for (size_t i = 0; i < n; ++i)
        o[i] = int32_t(std::min(hi, std::max(lo, int64_t(p.i[i]) + shift)));
    } else {
      for (size_t i = 0; i < n; ++i) {
        float v = p.f[i];
        if (v > float(INT32_MAX)) o[i] = int32_t(hi);
        else if (v < float(INT32_MIN)) o[i] = int32_t(lo);
        else o[i] = int32_t(std::min(hi, std::max(lo, int64_t(std::lrintf(v)) + shift)));
      }
    }
  }
}

// ------------------------------------------------------ Pillow's unpackers --

enum Mode { M_L = 0, M_LA, M_RGB, M_RGBA, M_I16, M_P, M_PA, M_CMYK };
enum Space { CS_UNSPECIFIED = 0, CS_SRGB, CS_GRAY, CS_SYCC, CS_EYCC, CS_CMYK };
const int MODE_BANDS[8] = {1, 2, 3, 4, 1, 1, 2, 4};

enum Unpacker {
  U_GRAY_L, U_GRAY_I, U_GRAYA_LA, U_GRAY_RGB, U_SRGB_RGB, U_SYCC_RGB, U_SRGBA, U_SYCCA
};

struct UnpackEntry {
  int mode, space, comps, subsampling, unpacker;
};

const UnpackEntry UNPACKERS[] = {
    {M_L, CS_GRAY, 1, 0, U_GRAY_L},        {M_P, CS_SRGB, 1, 0, U_GRAY_L},
    {M_PA, CS_SRGB, 2, 0, U_GRAYA_LA},     {M_I16, CS_GRAY, 1, 0, U_GRAY_I},
    {M_LA, CS_GRAY, 2, 0, U_GRAYA_LA},     {M_RGB, CS_GRAY, 1, 0, U_GRAY_RGB},
    {M_RGB, CS_GRAY, 2, 0, U_GRAY_RGB},    {M_RGB, CS_SRGB, 3, 1, U_SRGB_RGB},
    {M_RGB, CS_SYCC, 3, 1, U_SYCC_RGB},    {M_RGB, CS_SRGB, 4, 1, U_SRGB_RGB},
    {M_RGB, CS_SYCC, 4, 1, U_SYCC_RGB},    {M_RGBA, CS_GRAY, 1, 0, U_GRAY_RGB},
    {M_RGBA, CS_GRAY, 2, 0, U_GRAYA_LA},   {M_RGBA, CS_SRGB, 3, 1, U_SRGB_RGB},
    {M_RGBA, CS_SYCC, 3, 1, U_SYCC_RGB},   {M_RGBA, CS_SRGB, 4, 1, U_SRGBA},
    {M_RGBA, CS_SYCC, 4, 1, U_SYCCA},      {M_CMYK, CS_CMYK, 4, 1, U_SRGBA},
};

int find_unpacker(int mode, int space, const std::vector<CompInfo>& comps) {
  int nc = int(comps.size());
  if (nc < 1 || nc > 4) fail("a JPEG 2000 image of more than 4 components, which PIL refuses");
  int subsampling = -1;
  for (int n = 0; n < nc; ++n)
    if (comps[size_t(n)].dx != 1 || comps[size_t(n)].dy != 1) {
      subsampling = n;
      break;
    }
  if (space == CS_UNSPECIFIED) {
    if (nc <= 2) space = CS_GRAY;
    else if (subsampling == -1 || subsampling == 0) space = CS_SRGB;
    else if (subsampling == 1) space = CS_SYCC;
  }
  for (const auto& e : UNPACKERS)
    if (e.space == space && e.comps == nc && (e.subsampling || subsampling == -1) && e.mode == mode)
      return e.unpacker;
  fail("no unpacker for this mode, colour space and component count (PIL refuses it)");
}

inline uint32_t shiftu(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

// Where a tile lands: the image origin and the tile on the reference grid.
struct Geometry {
  int img_x0, img_y0, tx0, ty0, tx1, ty1;
};

inline uint32_t word_at(const uint8_t* p, int cz, size_t idx) {
  if (cz == 1) return p[idx];
  if (cz == 2) { uint16_t u; std::memcpy(&u, p + 2 * idx, 2); return u; }
  uint32_t u;
  std::memcpy(&u, p + 4 * idx, 4);
  return u;
}

// Pillow's ImagingConvertYCbCr2RGB (libImaging/ConvertYCbCr.c): tables of
// (int)((i - 128) * k * 64 + 0.5), 6 fractional bits, indexed by Cb and Cr.
struct YccTables {
  int16_t rcr[256], gcb[256], gcr[256], bcb[256];
  static int16_t entry(int i, double k) { return int16_t(int((i - 128) * k * 64 + 0.5)); }
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      rcr[i] = entry(i, 1.402);
      gcb[i] = entry(i, -0.34414);
      gcr[i] = entry(i, -0.71414);
      bcb[i] = entry(i, 1.772);
    }
  }
};

void ycbcr_to_rgb(uint8_t* px, int n, int stride) {
  static const YccTables t;
  for (int i = 0; i < n; ++i, px += stride) {
    int y = px[0], cb = px[1], cr = px[2];
    int r = y + (t.rcr[cr] >> 6);
    int g = y + ((t.gcb[cb] + t.gcr[cr]) >> 6);
    int b = y + (t.bcb[cb] >> 6);
    px[0] = uint8_t(r <= 0 ? 0 : (r >= 255 ? 255 : r));
    px[1] = uint8_t(g <= 0 ? 0 : (g >= 255 ? 255 : g));
    px[2] = uint8_t(b <= 0 ? 0 : (b >= 255 ? 255 : b));
  }
}

// The tile as Pillow's decoder receives it from opj_decode_tile_data and
// unpacks it (Jpeg2KDecode.c): each component's samples in (prec + 7) / 8
// bytes (3 taken as 4), one component after the other; the unpackers step
// through a component as if it held (w / dx) x (h / dy) samples. Writes
// the tile into `img`, (H, W, bands) bytes (uint16 for I;16), after
// Pillow's bounds check.
void unpack_tile(const std::vector<CompInfo>& comps, const Geometry& g,
                 const std::vector<std::vector<int32_t>>& planes, int unpacker, int mode,
                 uint8_t* img, int W, int H) {
  if (g.tx0 >= g.tx1 || g.ty0 >= g.ty1 || g.tx0 < g.img_x0 || g.ty0 < g.img_y0 ||
      int64_t(g.tx1) - g.img_x0 > W || int64_t(g.ty1) - g.img_y0 > H)
    fail("tile outside the image PIL allocated");
  int nc = int(comps.size());
  unsigned x0 = unsigned(g.tx0 - g.img_x0), y0 = unsigned(g.ty0 - g.img_y0);
  unsigned w = unsigned(g.tx1 - g.tx0), h = unsigned(g.ty1 - g.ty0);
  // the buffer, at least w * h * sum(csiz) bytes as Pillow allocates it
  std::vector<size_t> start;
  size_t total = 0, minimum = 0;
  for (int c = 0; c < nc; ++c) {
    int cz = (comps[size_t(c)].prec + 7) >> 3;
    if (cz == 3) cz = 4;
    start.push_back(total);
    total += planes[size_t(c)].size() * size_t(cz);
    minimum += size_t(w) * size_t(h) * size_t(cz);
  }
  std::vector<uint8_t> buf(std::max(total, minimum), 0);
  for (int c = 0; c < nc; ++c) {
    int cz = (comps[size_t(c)].prec + 7) >> 3;
    if (cz == 3) cz = 4;
    uint8_t* o = buf.data() + start[size_t(c)];
    const auto& pl = planes[size_t(c)];
    for (size_t i = 0; i < pl.size(); ++i) {
      int32_t v = pl[i];
      if (cz == 1) o[i] = uint8_t(v);
      else if (cz == 2) { uint16_t u = uint16_t(v); std::memcpy(o + 2 * i, &u, 2); }
      else std::memcpy(o + 4 * i, &v, 4);
    }
  }
  int bands = MODE_BANDS[mode];
  int used = (unpacker == U_GRAY_L || unpacker == U_GRAY_I || unpacker == U_GRAY_RGB) ? 1
             : (unpacker == U_GRAYA_LA) ? 2
             : (unpacker == U_SRGB_RGB || unpacker == U_SYCC_RGB) ? 3 : 4;
  int shifts[4], offsets[4], cz[4];
  unsigned dx[4], dy[4];
  const uint8_t* cdata[4];
  const uint8_t* cptr = buf.data();
  int outbits = unpacker == U_GRAY_I ? 16 : 8;
  for (int n = 0; n < used; ++n) {
    const CompInfo& ci = comps[size_t(n)];
    cdata[n] = cptr;
    shifts[n] = outbits - ci.prec;
    offsets[n] = ci.sgnd ? 1 << (ci.prec - 1) : 0;
    cz[n] = (ci.prec + 7) >> 3;
    if (cz[n] == 3) cz[n] = 4;
    dx[n] = unsigned(ci.dx), dy[n] = unsigned(ci.dy);
    if (shifts[n] < 0) offsets[n] += 1 << (-shifts[n] - 1);
    cptr += size_t(cz[n]) * (w / dx[n]) * (h / dy[n]);
  }
  std::vector<uint8_t> row4(size_t(w) * 4);
  for (unsigned y = 0; y < h; ++y) {
    if (unpacker == U_GRAY_I || unpacker == U_GRAY_L || unpacker == U_GRAY_RGB) {
      // the one-component unpackers step through the first plane as w x h
      const uint8_t* data = cdata[0] + size_t(cz[0]) * size_t(y) * size_t(w);
      for (unsigned x = 0; x < w; ++x) {
        uint32_t v = shiftu(uint32_t(offsets[0]) + word_at(data, cz[0], x), shifts[0]);
        if (unpacker == U_GRAY_I) {
          reinterpret_cast<uint16_t*>(img)[size_t(y0 + y) * size_t(W) + x0 + x] = uint16_t(v);
          continue;
        }
        uint8_t* px = &row4[size_t(x) * 4];
        px[0] = px[1] = px[2] = uint8_t(v);
        px[3] = 0xff;
      }
      if (unpacker == U_GRAY_I) continue;
    } else {
      const uint8_t* data[4];
      for (int n = 0; n < used; ++n)
        data[n] = cdata[n] + size_t(cz[n]) * (y / dy[n]) * (w / dx[n]);
      for (unsigned x = 0; x < w; ++x) {
        uint8_t* px = &row4[size_t(x) * 4];
        uint8_t v[4];
        for (int n = 0; n < used; ++n)
          v[n] = uint8_t(
              shiftu(uint32_t(offsets[n]) + word_at(data[n], cz[n], x / dx[n]), shifts[n]));
        if (unpacker == U_GRAYA_LA) {
          px[0] = px[1] = px[2] = v[0];
          px[3] = v[1];
        } else {
          px[0] = v[0], px[1] = v[1], px[2] = v[2];
          px[3] = used == 4 ? v[3] : 0xff;
        }
      }
      if (unpacker == U_SYCC_RGB || unpacker == U_SYCCA) ycbcr_to_rgb(row4.data(), int(w), 4);
    }
    uint8_t* orow = img + (size_t(y0 + y) * size_t(W) + x0) * size_t(bands);
    for (unsigned x = 0; x < w; ++x) {
      const uint8_t* px = &row4[size_t(x) * 4];
      uint8_t* o = orow + size_t(x) * size_t(bands);
      switch (mode) {
        case M_L: case M_P: o[0] = px[0]; break;
        case M_LA: case M_PA: o[0] = px[0]; o[1] = px[3]; break;
        case M_RGB: o[0] = px[0]; o[1] = px[1]; o[2] = px[2]; break;
        default: o[0] = px[0]; o[1] = px[1]; o[2] = px[2]; o[3] = px[3]; break;
      }
    }
  }
}

int tile_mct(const Codestream& cs, int tileno) {
  const Tile& t = cs.tiles[size_t(tileno)];
  return t.th.has_cod ? t.th.mct : cs.main.mct;
}

void set_msg(char* msg, long cap, const char* text) {
  if (!msg || cap <= 0) return;
  std::strncpy(msg, text, size_t(cap) - 1);
  msg[cap - 1] = 0;
}

long mode_bytes(int mode, int width, int height) {
  return long(width) * height * MODE_BANDS[mode] * (mode == M_I16 ? 2 : 1);
}

}  // namespace

extern "C" {

// Decode a JPEG 2000 codestream as PIL 12.1 (OpenJPEG 2.5) decodes it for
// PIL's `mode` (0 L, 1 LA, 2 RGB, 3 RGBA, 4 I;16, 5 P, 6 PA, 7 CMYK) and the
// container's colour space (0 unspecified, 1 sRGB, 2 grey, 3 sYCC, 4 eYCC,
// 5 CMYK) into out: (height, width, bands) bytes, uint16 for
// I;16, where (width, height) is PIL's size of the image. Pixels no tile
// covers stay 0. Returns 0; -1 with a message in msg where PIL refuses the
// codestream, -2 where PIL reads it and this decoder does not.
int mm_decode_jpeg2000(const uint8_t* data, long len, int mode, int space, int width,
                       int height, uint8_t* out, long cap, char* msg, long msg_cap) {
  try {
    if (len < 0 || mode < 0 || mode > 7 || width <= 0 || height <= 0) fail("bad arguments");
    long need = mode_bytes(mode, width, height);
    if (cap < need) fail("output buffer too small");
    std::memset(out, 0, size_t(need));
    Codestream cs = parse(data, size_t(len));
    int unpacker = find_unpacker(mode, space, cs.comps);
    size_t ppm_pos = 0;
    for (int tileno : cs.tile_order) {
      DecodedTile dt = decode_tile(cs, tileno, ppm_pos);
      std::vector<Plane> ps;
      for (auto& tc : dt.comps) {
        ps.push_back(plane_of(tc));
        inverse_dwt(ps.back(), tc.res);
      }
      std::vector<std::vector<int32_t>> planes;
      colour(ps, cs.comps, tile_mct(cs, tileno), planes);
      unpack_tile(cs.comps, Geometry{cs.x0, cs.y0, dt.x0, dt.y0, dt.x1, dt.y1}, planes, unpacker,
                  mode, out, width, height);
    }
    return 0;
  } catch (const Unsupported& e) {
    set_msg(msg, msg_cap, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_msg(msg, msg_cap, e.what());
    return -1;
  }
}

// The decoded tiles before the inverse wavelet transform, for the numpy
// twins. meta (int32) receives: the image x0, y0, the component count C,
// per component dx, dy, prec, sgnd; the unpacker PIL's mode and colour
// space select; the tile count T; per tile its x0, y0, x1, y1 and mct
// flag, then per component qmfbid, the resolution count R and R rectangles
// (x0, y0, x1, y1). coef receives per tile and component its w * h
// coefficients, int32 (qmfbid 1) or float32 bits (0), in OpenJPEG's
// layout (each resolution's bands beside the lower resolution). sizes[0]
// and sizes[1] receive the int32s meta and coef need; with either buffer
// too small the call returns -3 having set them. Returns 0; -1 with a
// message in msg.
int mm_jpeg2000_coefficients(const uint8_t* data, long len, int mode, int space, int32_t* meta,
                             long meta_cap, int32_t* coef, long coef_cap, long* sizes, char* msg,
                             long msg_cap) {
  try {
    Codestream cs = parse(data, size_t(len));
    int unpacker = find_unpacker(mode, space, cs.comps);
    std::vector<int32_t> m{cs.x0, cs.y0, int32_t(cs.comps.size())};
    for (auto& c : cs.comps) m.insert(m.end(), {c.dx, c.dy, c.prec, c.sgnd});
    m.push_back(unpacker);
    m.push_back(int32_t(cs.tile_order.size()));
    std::vector<int32_t> co;
    size_t ppm_pos = 0;
    for (int tileno : cs.tile_order) {
      DecodedTile dt = decode_tile(cs, tileno, ppm_pos);
      m.insert(m.end(), {dt.x0, dt.y0, dt.x1, dt.y1, tile_mct(cs, tileno)});
      for (auto& tc : dt.comps) {
        m.push_back(tc.cod.qmfbid);
        m.push_back(int32_t(tc.res.size()));
        for (auto& r : tc.res) m.insert(m.end(), {r.x0, r.y0, r.x1, r.y1});
        if (tc.cod.qmfbid == 1) co.insert(co.end(), tc.idata.begin(), tc.idata.end());
        else
          for (float f : tc.fdata) {
            int32_t b;
            std::memcpy(&b, &f, 4);
            co.push_back(b);
          }
      }
    }
    sizes[0] = long(m.size());
    sizes[1] = long(co.size());
    if (!meta || !coef || meta_cap < sizes[0] || coef_cap < sizes[1]) return -3;
    std::copy(m.begin(), m.end(), meta);
    std::copy(co.begin(), co.end(), coef);
    return 0;
  } catch (const Unsupported& e) {
    set_msg(msg, msg_cap, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_msg(msg, msg_cap, e.what());
    return -1;
  }
}

// The inverse wavelet transform of one tile-component alone, in place:
// `a` holds w * h int32 (qmfbid 1, the 5/3) or float32 (0, the 9/7)
// coefficients in OpenJPEG's layout, `rects` the nres resolution
// rectangles (x0, y0, x1, y1), the last w x h.
int mm_jpeg2000_idwt(void* a, int w, int h, int qmfbid, int nres, const int32_t* rects) {
  if (w <= 0 || h <= 0 || nres < 1) return -1;
  std::vector<Res> res(static_cast<size_t>(nres));
  for (int r = 0; r < nres; ++r) {
    res[size_t(r)].x0 = rects[4 * r], res[size_t(r)].y0 = rects[4 * r + 1];
    res[size_t(r)].x1 = rects[4 * r + 2], res[size_t(r)].y1 = rects[4 * r + 3];
  }
  if (res.back().x1 - res.back().x0 != w || res.back().y1 - res.back().y0 != h) return -1;
  if (qmfbid == 1) idwt2d(static_cast<int32_t*>(a), w, res, idwt53_line);
  else idwt2d(static_cast<float*>(a), w, res, idwt97_line);
  return 0;
}

// The colour stage of one tile alone: the components' samples after the
// inverse transform (int32 or float32 bits by qmfbid, one component after
// the other) through the RCT / ICT, the DC level shift and clipping, and
// Pillow's unpacker into `out` ((height, width, bands), as
// mm_decode_jpeg2000 writes it). meta: C, mode, unpacker, mct, image x0,
// y0, tile x0, y0, x1, y1, then per component dx, dy, prec, sgnd, qmfbid,
// w, h.
int mm_jpeg2000_colour(const int32_t* planes, const int32_t* meta, uint8_t* out, int width,
                       int height, char* msg, long msg_cap) {
  try {
    int nc = meta[0], mode = meta[1], unpacker = meta[2], mct = meta[3];
    if (nc < 1 || nc > 4 || mode < 0 || mode > 7) fail("bad arguments");
    Geometry g{meta[4], meta[5], meta[6], meta[7], meta[8], meta[9]};
    std::vector<CompInfo> comps(static_cast<size_t>(nc));
    std::vector<Plane> ps(static_cast<size_t>(nc));
    const int32_t* at = planes;
    for (int c = 0; c < nc; ++c) {
      const int32_t* m = meta + 10 + 7 * c;
      comps[size_t(c)] = CompInfo{m[0], m[1], m[2], m[3]};
      Plane& p = ps[size_t(c)];
      p.qmfbid = m[4], p.w = m[5], p.h = m[6];
      size_t n = size_t(p.w) * size_t(p.h);
      if (p.qmfbid == 1) p.i.assign(at, at + n);
      else {
        p.f.resize(n);
        std::memcpy(p.f.data(), at, n * 4);
      }
      at += n;
    }
    std::vector<std::vector<int32_t>> out_planes;
    colour(ps, comps, mct, out_planes);
    std::memset(out, 0, size_t(mode_bytes(mode, width, height)));
    unpack_tile(comps, g, out_planes, unpacker, mode, out, width, height);
    return 0;
  } catch (const Unsupported& e) {
    set_msg(msg, msg_cap, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_msg(msg, msg_cap, e.what());
    return -1;
  }
}

}  // extern "C"
