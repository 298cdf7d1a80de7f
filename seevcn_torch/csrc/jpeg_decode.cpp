// A baseline JPEG decoder with libjpeg's arithmetic, for hosts without an
// imaging library (the H100 host has no OpenCV or PIL).
//
// It is the counterpart of cv2.imread(path, IMREAD_COLOR) on a JPEG: BGR
// uint8 rows, a grayscale image replicated to three channels. To give the
// same bytes as OpenCV's libjpeg-turbo it follows libjpeg's decompressor
// step for step:
//   * Huffman decoding of sequential DCT scans (SOF0 baseline, SOF1
//     extended with Huffman tables), interleaved or one component a scan,
//     DRI restart intervals and their RSTn markers, 0xFF00 stuffing;
//   * dequantization and the accurate integer inverse DCT (jidctint.c,
//     "islow": 13-bit constants, two passes, the 1024-entry range limit);
//   * "fancy" upsampling of subsampled components (jdsample.c: the h2v1,
//     h1v2 and h2v2 triangle filters with their alternating rounding
//     biases, the rows above the first and below the last replicated as
//     jdmainct.c's context pointers do; plain replication where the
//     component is two samples wide or less, as jinit_upsampler chooses);
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c (16 fraction bits).
// The colour space is guessed as jdapimin.c does: JFIF or component ids
// 1, 2, 3 -> YCbCr; an Adobe marker's transform 0 or ids 'R', 'G', 'B' -> RGB.
//
// Not supported, each raising "unsupported" with the marker's name:
// progressive (SOF2, SOF6, SOF10, SOF14), lossless and hierarchical
// (SOF3, SOF5, SOF7), arithmetic coding (SOF9-SOF15), a sample precision
// other than 8 bits, component counts other than 1 and 3, sampling factors
// above 2, and a height given by a DNL marker. Corrupt or truncated data
// raises "corrupt" where libjpeg would warn and fill with zeros.
//
// C ABI (ctypes): seevcn_jpeg_info and seevcn_jpeg_decode; each returns 0,
// 1 (unsupported) or 2 (corrupt) and writes a message into err.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& msg) { throw Error{2, msg}; }
[[noreturn]] void unsupported(const std::string& msg) { throw Error{1, msg}; }

// Zigzag position -> natural (row-major) index; the 16 trailing 63s catch
// a run that steps past the block end, as jutils.c's table does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];   // the largest code of each length, -1 if none
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol, 0: longer code

  void build(const uint8_t counts[17], const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      // jdhuff.c's check, made before any code of this length is entered
      // in look: the codes must fit in l bits, and none may be all ones.
      if (counts[l] && code + counts[l] >= (1 << l)) corrupt("bad Huffman table");
      valoffset[l] = k - code;
      for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      maxcode[l] = counts[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

// MSB-first bit reader over entropy-coded data. A marker stops it; past
// one it feeds zero bits, and consuming any of those marks the data as
// cut short.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;       // bits held in acc (from the top)
  int fake = 0;        // how many of the held bits are zeros past the data
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker) {
        if (p >= end) {
          at_marker = true;
        } else if (p[0] == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            byte = 0xFF;
            p += 2;
          } else {
            at_marker = true;
          }
        } else {
          byte = *p++;
        }
      }
      if (at_marker) fake += 8;
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(acc >> (64 - n));
  }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
    if (nbits < fake) corrupt("premature end of entropy-coded data");
  }
  int get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  int decode(const Huffman& h) {
    uint32_t look = peek(16);
    uint16_t e = h.look[look >> (16 - kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(look >> (16 - l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[(h.valoffset[l] + code) & 0xFF];
      }
    }
    corrupt("bad Huffman code");
  }
  void reset() {
    acc = 0;
    nbits = 0;
    fake = 0;
    at_marker = false;
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

struct Component {
  int id, h, v, tq;
  int dw, dh;               // downsampled width and height (jdinput.c)
  int bw, bh;               // blocks across and down the plane
  int stride;
  std::vector<uint8_t> plane;
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  bool decoded = false;
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  int width = 0, height = 0;
  int ncomp = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool sof_seen = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
  uint8_t range_limit[1024];   // jdmaster.c's post-IDCT table

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {
    // indexed by the IDCT's output & 1023: the output read as a signed
    // 10-bit number, plus 128, clamped (libjpeg's table entry for entry)
    for (int t = 0; t < 1024; ++t) {
      int x = (t < 512 ? t : t - 1024) + 128;
      range_limit[t] = static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
    }
  }

  int u8() {
    if (pos >= len) corrupt("truncated file");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }
  // The next marker code after pos, skipping fill bytes (and, as libjpeg's
  // next_marker, any garbage before them).
  int next_marker() {
    for (;;) {
      while (u8() != 0xFF) {
      }
      int c;
      do {
        c = u8();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void read_sof(int marker) {
    int seg = u16();
    size_t stop = pos + seg - 2;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (precision != 8)
      unsupported("SOF" + std::to_string(marker - 0xC0) + " with " +
                  std::to_string(precision) + "-bit samples (only 8-bit is decoded)");
    if (height == 0) unsupported("a height given by a DNL marker");
    if (width == 0) corrupt("zero image width");
    if (ncomp != 1 && ncomp != 3)
      unsupported(std::to_string(ncomp) + " components (1 or 3 are decoded)");
    if (stop != pos + 3 * static_cast<size_t>(ncomp)) corrupt("bad SOF length");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        unsupported("sampling factor " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                    " (factors 1 and 2 are decoded)");
      if (c.tq > 3) corrupt("bad quantization table index");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.stride = 8 * c.bw;
      c.plane.assign(static_cast<size_t>(c.stride) * 8 * c.bh, 0);
    }
    sof_seen = true;
  }

  void read_dht() {
    int seg = u16();
    size_t stop = pos + seg - 2;
    while (pos < stop) {
      int tc = u8();
      int cls = tc >> 4, id = tc & 15;
      if (cls > 1 || id > 3) corrupt("bad Huffman table class or index");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) {
        counts[l] = static_cast<uint8_t>(u8());
        total += counts[l];
      }
      if (total > 256) corrupt("bad Huffman table");
      uint8_t sym[256];
      for (int i = 0; i < total; ++i) sym[i] = static_cast<uint8_t>(u8());
      (cls ? ac[id] : dc[id]).build(counts, sym, total);
    }
    if (pos != stop) corrupt("bad DHT length");
  }

  void read_dqt() {
    int seg = u16();
    size_t stop = pos + seg - 2;
    while (pos < stop) {
      int pq = u8();
      int prec = pq >> 4, id = pq & 15;
      if (id > 3 || prec > 1) corrupt("bad quantization table");
      for (int k = 0; k < 64; ++k)
        quant[id][kNatural[k]] = static_cast<uint16_t>(prec ? u16() : u8());
      quant_defined[id] = true;
    }
    if (pos != stop) corrupt("bad DQT length");
  }

  void skip_segment() {
    int seg = u16();
    if (seg < 2 || pos + seg - 2 > len) corrupt("bad segment length");
    pos += seg - 2;
  }

  void read_app(int marker) {
    int seg = u16();
    if (seg < 2 || pos + seg - 2 > len) corrupt("bad segment length");
    const uint8_t* b = data + pos;
    int n = seg - 2;
    if (marker == 0xE0 && n >= 5 && std::memcmp(b, "JFIF\0", 5) == 0) jfif = true;
    if (marker == 0xEE && n >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    pos += n;
  }

  // jidctint.c: dequantize, the column pass into a workspace scaled by
  // 2^PASS1_BITS, the row pass with rounding and the range limit.
  void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                      F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                      F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* in = coef + c;
      const uint16_t* qq = q + c;
      int* w = ws + c;
      if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
          in[48] == 0 && in[56] == 0) {
        int dcval = static_cast<int>(static_cast<int64_t>(in[0]) * qq[0] * (1 << P1));
        for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
        continue;
      }
      int64_t z2 = static_cast<int64_t>(in[16]) * qq[16];
      int64_t z3 = static_cast<int64_t>(in[48]) * qq[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = static_cast<int64_t>(in[0]) * qq[0];
      z3 = static_cast<int64_t>(in[32]) * qq[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = static_cast<int64_t>(in[56]) * qq[56];
      tmp1 = static_cast<int64_t>(in[40]) * qq[40];
      tmp2 = static_cast<int64_t>(in[24]) * qq[24];
      tmp3 = static_cast<int64_t>(in[8]) * qq[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CB - P1;
      constexpr int64_t R = int64_t(1) << (S - 1);
      w[0] = static_cast<int>((tmp10 + tmp3 + R) >> S);
      w[56] = static_cast<int>((tmp10 - tmp3 + R) >> S);
      w[8] = static_cast<int>((tmp11 + tmp2 + R) >> S);
      w[48] = static_cast<int>((tmp11 - tmp2 + R) >> S);
      w[16] = static_cast<int>((tmp12 + tmp1 + R) >> S);
      w[40] = static_cast<int>((tmp12 - tmp1 + R) >> S);
      w[24] = static_cast<int>((tmp13 + tmp0 + R) >> S);
      w[32] = static_cast<int>((tmp13 - tmp0 + R) >> S);
    }
    for (int r = 0; r < 8; ++r) {
      const int* w = ws + 8 * r;
      uint8_t* o = out + static_cast<size_t>(r) * stride;
      if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
          w[7] == 0) {
        constexpr int S = P1 + 3;
        uint8_t v = range_limit[((static_cast<int64_t>(w[0]) + (1 << (S - 1))) >> S) & 1023];
        for (int c = 0; c < 8; ++c) o[c] = v;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << CB);
      int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int S = CB + P1 + 3;
      constexpr int64_t R = int64_t(1) << (S - 1);
      o[0] = range_limit[((tmp10 + tmp3 + R) >> S) & 1023];
      o[7] = range_limit[((tmp10 - tmp3 + R) >> S) & 1023];
      o[1] = range_limit[((tmp11 + tmp2 + R) >> S) & 1023];
      o[6] = range_limit[((tmp11 - tmp2 + R) >> S) & 1023];
      o[2] = range_limit[((tmp12 + tmp1 + R) >> S) & 1023];
      o[5] = range_limit[((tmp12 - tmp1 + R) >> S) & 1023];
      o[3] = range_limit[((tmp13 + tmp0 + R) >> S) & 1023];
      o[4] = range_limit[((tmp13 - tmp0 + R) >> S) & 1023];
    }
  }

  void decode_block(Bits& bits, Component& c, int bx, int by) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    int s = bits.decode(dc[c.dc_tbl]);
    if (s > 11) corrupt("bad DC magnitude category");
    int diff = s ? extend(bits.get(s), s) : 0;
    c.pred += diff;
    coef[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = bits.decode(ac[c.ac_tbl]);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, quant[c.tq], c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8,
               c.stride);
  }

  void read_restart(Bits& bits, int& expected) {
    bits.reset();
    pos = static_cast<size_t>(bits.p - data);
    int m = next_marker();
    if (m != 0xD0 + expected) corrupt("missing restart marker");
    expected = (expected + 1) & 7;
    bits.p = data + pos;
  }

  void read_scan() {
    if (!sof_seen) corrupt("scan before frame header");
    int seg = u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp || seg != 6 + 2 * ns) corrupt("bad SOS");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int cid = u8(), tables = u8();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) found = &comp[j];
      if (!found) corrupt("scan names an unknown component");
      found->dc_tbl = tables >> 4;
      found->ac_tbl = tables & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3 || !dc[found->dc_tbl].defined ||
          !ac[found->ac_tbl].defined)
        corrupt("scan uses an undefined Huffman table");
      if (!quant_defined[found->tq]) corrupt("component uses an undefined quantization table");
      found->pred = 0;
      found->decoded = true;
      sc[i] = found;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) corrupt("bad spectral selection for a sequential scan");

    Bits bits{data + pos, data + len};
    int restarts_to_go = restart_interval, expected = 0;
    auto restart = [&]() {
      if (!restart_interval) return;
      if (restarts_to_go == 0) {
        read_restart(bits, expected);
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        restarts_to_go = restart_interval;
      }
      --restarts_to_go;
    };
    if (ns == 1) {
      // non-interleaved: one block an MCU over the component's own blocks
      Component& c = *sc[0];
      int bw = (c.dw + 7) / 8, bh = (c.dh + 7) / 8;
      for (int by = 0; by < bh; ++by)
        for (int bx = 0; bx < bw; ++bx) {
          restart();
          decode_block(bits, c, bx, by);
        }
    } else {
      for (int my = 0; my < mcus_y; ++my)
        for (int mx = 0; mx < mcus_x; ++mx) {
          restart();
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) decode_block(bits, c, mx * c.h + h, my * c.v + v);
          }
        }
    }
    pos = static_cast<size_t>(bits.p - data);
  }

  // Reads the headers and, with decode, every scan up to EOI.
  void run(bool decode) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1) {
        read_sof(m);
        if (!decode) return;
      } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
        unsupported("progressive JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xC3 || m == 0xC5 || m == 0xC7) {
        unsupported("lossless or hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xC9 || m == 0xCB || m == 0xCD || m == 0xCF) {
        unsupported("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) corrupt("bad DRI length");
        restart_interval = u16();
      } else if (m == 0xDA) {
        read_scan();
      } else if (m == 0xD9) {
        break;
      } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // markers without a length
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else {
        skip_segment();
      }
    }
    if (!sof_seen) corrupt("no frame header");
    for (int i = 0; i < ncomp; ++i)
      if (!comp[i].decoded) corrupt("a component has no scan");
  }

  // The component's samples upsampled to the image's size (jdsample.c).
  std::vector<uint8_t> upsample(const Component& c) const {
    std::vector<uint8_t> out(static_cast<size_t>(width) * height);
    const int rh = hmax / c.h, rv = vmax / c.v;
    const uint8_t* pl = c.plane.data();
    auto row = [&](int y) {
      y = y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y);   // the context rows
      return pl + static_cast<size_t>(y) * c.stride;
    };
    const int pad_w = 2 * c.dw + 2;
    std::vector<uint8_t> tmp(pad_w);
    for (int oy = 0; oy < height; ++oy) {
      uint8_t* o = out.data() + static_cast<size_t>(oy) * width;
      if (rh == 1 && rv == 1) {
        std::memcpy(o, row(oy), width);
      } else if (rh == 2 && rv == 1) {
        const uint8_t* in = row(oy);
        if (c.dw > 2) {   // h2v1_fancy_upsample
          uint8_t* t = tmp.data();
          int inv = in[0];
          *t++ = static_cast<uint8_t>(inv);
          *t++ = static_cast<uint8_t>((inv * 3 + in[1] + 2) >> 2);
          for (int x = 1; x < c.dw - 1; ++x) {
            inv = in[x] * 3;
            *t++ = static_cast<uint8_t>((inv + in[x - 1] + 1) >> 2);
            *t++ = static_cast<uint8_t>((inv + in[x + 1] + 2) >> 2);
          }
          inv = in[c.dw - 1];
          *t++ = static_cast<uint8_t>((inv * 3 + in[c.dw - 2] + 1) >> 2);
          *t++ = static_cast<uint8_t>(inv);
          std::memcpy(o, tmp.data(), width);
        } else {
          for (int x = 0; x < width; ++x) o[x] = in[x >> 1];
        }
      } else if (rh == 1 && rv == 2) {   // h1v2_fancy_upsample
        int iy = oy >> 1, v = oy & 1;
        const uint8_t* in0 = row(iy);
        const uint8_t* in1 = row(v ? iy + 1 : iy - 1);
        int bias = v ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else {   // rh == 2 && rv == 2
        int iy = oy >> 1, v = oy & 1;
        if (c.dw > 2) {   // h2v2_fancy_upsample
          const uint8_t* in0 = row(iy);
          const uint8_t* in1 = row(v ? iy + 1 : iy - 1);
          uint8_t* t = tmp.data();
          int thiscol = in0[0] * 3 + in1[0];
          int nextcol = in0[1] * 3 + in1[1];
          *t++ = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
          *t++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          int lastcol = thiscol;
          thiscol = nextcol;
          for (int x = 2; x < c.dw; ++x) {
            nextcol = in0[x] * 3 + in1[x];
            *t++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
            *t++ = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
            lastcol = thiscol;
            thiscol = nextcol;
          }
          *t++ = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          *t++ = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
          std::memcpy(o, tmp.data(), width);
        } else {
          const uint8_t* in = row(iy);
          for (int x = 0; x < width; ++x) o[x] = in[x >> 1];
        }
      }
    }
    return out;
  }

  bool rgb_colorspace() const {
    if (jfif) return false;
    if (adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  void to_bgr(uint8_t* out) const {
    const size_t n = static_cast<size_t>(width) * height;
    if (ncomp == 1) {
      std::vector<uint8_t> y = upsample(comp[0]);
      for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    std::vector<uint8_t> a = upsample(comp[0]), b = upsample(comp[1]), c = upsample(comp[2]);
    if (rgb_colorspace()) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = c[i];
        out[3 * i + 1] = b[i];
        out[3 * i + 2] = a[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < n; ++i) {
      int y = a[i], cb = b[i], cr = c[i];
      out[3 * i + 2] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB));
      out[3 * i] = clamp(y + cb_b[cb]);
    }
  }
};

int fail(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// The image's height, width and component count from its frame header.
int seevcn_jpeg_info(const uint8_t* data, int64_t len, int32_t* height, int32_t* width,
                     int32_t* components, char* err, int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(len));
    d.run(false);
    *height = d.height;
    *width = d.width;
    *components = d.ncomp;
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

// Decodes into out, (height, width, 3) BGR uint8; out_len is its size.
int seevcn_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, int64_t out_len,
                       char* err, int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(len));
    d.run(true);
    if (out_len != static_cast<int64_t>(d.width) * d.height * 3)
      throw Error{2, "output buffer of the wrong size"};
    d.to_bgr(out);
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

}  // extern "C"
