// A JPEG decoder for hosts without an imaging library (the H100 host has no
// OpenCV or PIL).
//
// It is the counterpart of cv2.imread(path, IMREAD_COLOR) on a JPEG: BGR
// uint8 rows, a grayscale image replicated to three channels. To give the
// same bytes as OpenCV's libjpeg-turbo it follows libjpeg's decompressor
// step for step:
//   * the frame types libjpeg decodes: sequential (SOF0, SOF1, SOF9),
//     progressive (SOF2, SOF10) and lossless (SOF3), with Huffman
//     (jdhuff.c, jdphuff.c, jdlhuff.c) or arithmetic coding (jdarith.c:
//     the QM decoder, its statistics bins, DAC conditioning), interleaved or
//     one component a scan, DRI restart intervals and their RSTn markers;
//   * progressive scans into a whole-image coefficient buffer (DC first and
//     refine, AC first and refine, EOB runs), and libjpeg-turbo's block
//     smoothing of a progressive image whose first AC coefficients are not
//     fully refined (jdcoefct.c: decompress_smooth_data, the 5x5
//     neighbourhood of DC values, DC interpolation when no AC is known);
//   * dequantization and the accurate integer inverse DCT (jidctint.c,
//     "islow": 13-bit constants, two passes, the 1024-entry range limit);
//   * the upsampler jinit_upsampler picks for each component's ratio
//     (jdsample.c): the h2v1, h1v2 and h2v2 "fancy" triangle filters with
//     their alternating rounding biases, the rows above the first and below
//     the last replicated as jdmainct.c's context pointers do; plain
//     replication where the component is two samples wide or less, and for
//     every other integral ratio (int_upsample), sampling factors 1 to 4;
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c (16 fraction bits),
//     YCCK -> CMYK (ycck_cmyk_convert), and OpenCV's own CMYK -> BGR;
//   * OpenCV's EXIF orientation (the first APP1 segment's IFD0 tag 0x0112),
//     reported to the caller, which flips and transposes the decoded image.
// The colour space is guessed as jdapimin.c does: JFIF or component ids
// 1, 2, 3 -> YCbCr; an Adobe marker's transform 0 or ids 'R', 'G', 'B' -> RGB;
// four components are CMYK, or YCCK under an Adobe transform other than 0.
//
// What libjpeg (and so cv2.imread, which returns None) refuses as well
// raises "refused": hierarchical frames (SOF5-7, SOF13-15), lossless
// arithmetic coding (SOF11), a height given by a DNL marker, a sample
// precision cv2 cannot return as 8 bits, component counts other than 1, 3
// and 4, sampling factors outside 1..4 or in a ratio that is not an
// integer, more than 10 blocks in an MCU, a side above 65500, a lossless
// frame that needs a colour conversion (grayscale, YCbCr, YCCK), and a
// progressive or lossless scan whose Huffman table is missing (only the
// sequential decoder has standard tables to fall back on). Corrupt or
// truncated data raises "corrupt" where libjpeg would warn and fill with
// zeros.
//
// C ABI (ctypes): seevcn_jpeg_info and seevcn_jpeg_decode; each returns 0,
// 2 (corrupt) or 3 (refused) and writes a message into err.
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
[[noreturn]] void refused(const std::string& msg) { throw Error{3, msg}; }

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

// jstdhuff.c: the tables of K.3 that libjpeg-turbo's sequential Huffman
// decoder puts in slots 0 and 1 left empty when decoding starts (Motion
// JPEG frames leave them out). Counts for lengths 1..16, then symbols.
const uint8_t kStdDcLuma[16 + 12] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0,
                                     0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdDcChroma[16 + 12] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
                                       0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[16 + 162] = {
    0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125,
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129, 145, 161, 8,
    35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130, 9, 10, 22, 23, 24, 25, 26, 37,
    38, 39, 40, 41, 42, 52, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85,
    86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151, 152, 153,
    154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185,
    186, 194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217,
    218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245, 246, 247,
    248, 249, 250};
const uint8_t kStdAcChroma[16 + 162] = {
    0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119,
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8, 20, 66, 145,
    161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36, 52, 225, 37, 241, 23, 24,
    25, 26, 38, 39, 40, 41, 42, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84,
    85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119,
    120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150, 151,
    152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181, 182, 183,
    184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215,
    216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246, 247,
    248, 249, 250};

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

// jaricom.c's table D.2: Qe << 16 | next index after an MPS << 8 | switch
// flag << 7 | next index after an LPS; the last entry is the fixed 0.5 bin.
const int32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder: the C and A registers, the bit counter, zero data
// after a marker (legal in arithmetic coding: the encoder drops trailing
// zero bytes).
struct Arith {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;
  const uint8_t* marker = nullptr;   // where the marker that ended the data starts

  int byte() {
    if (p >= end) corrupt("premature end of entropy-coded data");
    return *p++;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!marker) {
          const uint8_t* at = p;
          data = byte();
          if (data == 0xFF) {
            do data = byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = at;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;   // two first bytes read: A = 0x10000 below
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // Where the data of this interval ends: at its marker, or at the bytes
  // not read yet (which the marker reader then skips).
  const uint8_t* stop() const { return marker ? marker : p; }
  void restart(const uint8_t* at) {
    p = at;
    c = a = 0;
    ct = -16;
    marker = nullptr;
  }
};

struct Component {
  int id, h, v, tq;
  int dw, dh;               // downsampled width and height (jdinput.c)
  int wb, hb;               // blocks holding samples: width_in_blocks, height_in_blocks
  int bw, bh;               // blocks of the MCU grid across and down
  int stride;
  std::vector<uint8_t> plane;
  std::vector<int16_t> coef;   // progressive: every block's coefficients, natural order
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;             // DC prediction
  int dc_context = 0;       // arithmetic DC conditioning category
  bool decoded = false;
  int coef_bits[64];        // progressive: the bit each coefficient is known to, -1 before any

  int16_t* block(int bx, int by) { return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64; }
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
  bool sof_seen = false, jfif = false, adobe = false, progressive = false, arith = false;
  bool lossless = false;
  int precision = 8;
  int adobe_transform = -1;
  int orientation = 1;
  bool app1_seen = false;
  int scans = 0;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  uint8_t dac_l[16], dac_u[16], dac_k[16];   // arithmetic conditioning (DAC)
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};   // the fixed 0.5 estimate (table entry 113)
  Component comp[4];
  uint8_t range_limit[1024];   // jdmaster.c's post-IDCT table

  Decoder(const uint8_t* d, size_t n) : data(d), len(n) {
    // indexed by the IDCT's output & 1023: the output read as a signed
    // 10-bit number, plus 128, clamped (libjpeg's table entry for entry)
    for (int t = 0; t < 1024; ++t) {
      int x = (t < 512 ? t : t - 1024) + 128;
      range_limit[t] = static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
    }
    // jdmarker.c get_soi: the conditioning defaults
    for (int i = 0; i < 16; ++i) {
      dac_l[i] = 0;
      dac_u[i] = 1;
      dac_k[i] = 5;
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
    if (sof_seen) corrupt("a second frame header");
    int seg = u16();
    size_t stop = pos + seg - 2;
    precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    std::string sof = "SOF" + std::to_string(marker - 0xC0);
    if (lossless ? precision < 2 || precision > 8 : precision != 8)
      refused(sof + " with " + std::to_string(precision) + "-bit samples (cv2 reads " +
              (lossless ? "2- to 8-bit lossless samples)" : "8-bit samples only)"));
    if (height == 0) refused("a height given by a DNL marker");
    if (width == 0) refused("zero image width");
    if (width > 65500 || height > 65500) refused("an image side above libjpeg's 65500");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      refused(std::to_string(ncomp) + " components (cv2 reads 1, 3 or 4)");
    if (stop != pos + 3 * static_cast<size_t>(ncomp)) corrupt("bad SOF length");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        refused("sampling factor " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                " (libjpeg takes factors 1 to 4)");
      if (c.tq > 3) corrupt("bad quantization table index");
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    for (int i = 0; i < ncomp; ++i)
      if (hmax % comp[i].h || vmax % comp[i].v)
        refused("fractional sampling ratio " + std::to_string(hmax) + "/" +
                std::to_string(comp[i].h) + " x " + std::to_string(vmax) + "/" +
                std::to_string(comp[i].v) + " (jdsample.c has no upsampler for it)");
    int unit = lossless ? 1 : 8;   // samples a block edge
    mcus_x = (width + unit * hmax - 1) / (unit * hmax);
    mcus_y = (height + unit * vmax - 1) / (unit * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.wb = (c.dw + unit - 1) / unit;
      c.hb = (c.dh + unit - 1) / unit;
      c.bw = mcus_x * c.h;
      c.bh = mcus_y * c.v;
      c.stride = unit * c.bw;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    sof_seen = true;
  }

  // The sample planes (and a progressive frame's coefficients), zeroed.
  void allocate() {
    int unit = lossless ? 1 : 8;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.plane.assign(static_cast<size_t>(c.stride) * unit * c.bh, 0);
      if (progressive) c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
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

  // jdmarker.c get_dac: L and U of a DC conditioning table, Kx of an AC one.
  void read_dac() {
    int seg = u16();
    size_t stop = pos + seg - 2;
    while (pos + 1 < stop) {
      int index = u8(), val = u8();
      if (index >= 32) corrupt("bad DAC index");
      if (index >= 16) {
        dac_k[index - 16] = static_cast<uint8_t>(val);
      } else {
        dac_l[index] = static_cast<uint8_t>(val & 15);
        dac_u[index] = static_cast<uint8_t>(val >> 4);
        if (dac_l[index] > dac_u[index]) corrupt("bad DAC value");
      }
    }
    if (pos != stop) corrupt("bad DAC length");
  }

  void skip_segment() {
    int seg = u16();
    if (seg < 2 || pos + seg - 2 > len) corrupt("bad segment length");
    pos += seg - 2;
  }

  // OpenCV's ExifReader on the first APP1 segment: its first 6 bytes
  // skipped ("Exif\0\0"), the TIFF header's byte order and 0x2A, then IFD0's
  // entries, the first orientation tag (0x0112) taken; reading past the
  // segment ends the walk.
  void read_exif(const uint8_t* b, int n) {
    if (n <= 6) return;
    b += 6;
    n -= 6;
    if (n < 2) return;
    bool intel = b[0] == 'I' && b[1] == 'I', moto = b[0] == 'M' && b[1] == 'M';
    if (!intel && !moto) return;
    auto u16at = [&](int64_t o) -> int {
      if (o < 0 || o + 1 >= n) return -1;
      return intel ? b[o] | (b[o + 1] << 8) : (b[o] << 8) | b[o + 1];
    };
    auto u32at = [&](int64_t o) -> int64_t {
      if (o < 0 || o + 3 >= n) return -1;
      uint32_t v = intel ? b[o] | (b[o + 1] << 8) | (b[o + 2] << 16) | (uint32_t(b[o + 3]) << 24)
                         : (uint32_t(b[o]) << 24) | (b[o + 1] << 16) | (b[o + 2] << 8) | b[o + 3];
      return v;
    };
    if (u16at(2) != 0x2A) return;
    int64_t off = u32at(4);
    int entries = u16at(off);
    if (off < 0 || entries < 0) return;
    off += 2;
    for (int e = 0; e < entries; ++e, off += 12) {
      int tag = u16at(off);
      if (tag < 0) return;
      if (tag == 0x0112) {
        int v = u16at(off + 8);
        if (v < 0) return;
        orientation = v;
        return;
      }
    }
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
    if (marker == 0xE1 && !app1_seen && scans == 0) {
      app1_seen = true;
      read_exif(b, n);
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

  uint8_t* block_out(Component& c, int bx, int by) {
    return c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8;
  }

  // jinit_huff_decoder's std_huff_tables: slots 0 and 1 still empty get
  // the standard tables (sequential Huffman only; jdphuff.c has no such
  // default).
  void standard_tables() {
    const uint8_t* spec[4] = {kStdDcLuma, kStdDcChroma, kStdAcLuma, kStdAcChroma};
    for (int t = 0; t < 4; ++t) {
      Huffman& h = t < 2 ? dc[t] : ac[t - 2];
      if (h.defined) continue;
      uint8_t counts[17] = {0};
      int n = 0;
      for (int l = 1; l <= 16; ++l) n += counts[l] = spec[t][l - 1];
      h.build(counts, spec[t] + 16, n);
    }
  }

  // --- Huffman: a sequential block (jdhuff.c decode_mcu) ---

  void huff_block(Bits& bits, Component& c, int16_t* coef) {
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
  }

  // --- Huffman: the four progressive block decoders (jdphuff.c) ---

  void huff_dc_first(Bits& bits, Component& c, int16_t* blk, int al) {
    int s = bits.decode(dc[c.dc_tbl]);
    if (s > 15) corrupt("bad DC magnitude category");
    if (s) s = extend(bits.get(s), s);
    c.pred += s;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
  }

  void huff_dc_refine(Bits& bits, int16_t* blk, int al) {
    if (bits.get(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void huff_ac_first(Bits& bits, Component& c, int16_t* blk, int ss, int se, int al,
                     int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int rs = bits.decode(ac[c.ac_tbl]);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(bits.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += bits.get(r);
        --eobrun;
        break;
      }
    }
  }

  void huff_ac_refine(Bits& bits, Component& c, int16_t* blk, int ss, int se, int al,
                      int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    auto correct = [&](int16_t& coef) {
      if (bits.get(1) && (coef & p1) == 0) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = bits.decode(ac[c.ac_tbl]);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) corrupt("bad Huffman code in an AC refinement");
          s = bits.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += bits.get(r);
          break;
        }
        do {
          int16_t& coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun;
    }
  }

  // --- arithmetic coding (jdarith.c) ---

  // Figures F.21-F.24 after the sign: the magnitude category from st, then
  // its bits from st + 14; -> the value v >= 1, and its category (the top
  // bit of v - 1) in *category. tbl_k is the AC table's Kx, which picks
  // the bins of the category's later steps (189 or 217); -1 for DC (bin 20).
  int arith_magnitude(Arith& ar, uint8_t* st, uint8_t* stats, int tbl_k, int k,
                      int* category = nullptr) {
    int m = ar.decode(st);
    if (m != 0) {
      if (tbl_k < 0) {
        st = stats + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) corrupt("arithmetic magnitude overflow");
          ++st;
        }
      } else if (ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= tbl_k ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) corrupt("arithmetic magnitude overflow");
          ++st;
        }
      }
    }
    if (category) *category = m;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    return v + 1;
  }

  // A DC difference (figure F.19 and the conditioning of F.1.4.4.1.2);
  // -> the difference, 0 if none.
  int arith_dc_diff(Arith& ar, Component& c) {
    uint8_t* stats = dc_stats[c.dc_tbl];
    uint8_t* st = stats + c.dc_context;
    if (ar.decode(st) == 0) {
      c.dc_context = 0;
      return 0;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m;
    int v = arith_magnitude(ar, st, stats, -1, 0, &m);
    if (m < static_cast<int>((1L << dac_l[c.dc_tbl]) >> 1))
      c.dc_context = 0;
    else if (m > static_cast<int>((1L << dac_u[c.dc_tbl]) >> 1))
      c.dc_context = 12 + sign * 4;
    else
      c.dc_context = 4 + sign * 4;
    return sign ? -v : v;
  }

  // AC coefficients ss..se of a first (or sequential) pass, each scaled by
  // << al (figure F.20).
  void arith_ac(Arith& ar, Component& c, int16_t* blk, int ss, int se, int al) {
    uint8_t* stats = ac_stats[c.ac_tbl];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;   // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) corrupt("arithmetic spectral overflow");
      }
      int sign = ar.decode(fixed_bin);
      int v = arith_magnitude(ar, st + 2, stats, dac_k[c.ac_tbl], k);
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
  }

  void arith_block(Arith& ar, Component& c, int16_t* coef) {
    c.pred = (c.pred + arith_dc_diff(ar, c)) & 0xffff;
    coef[0] = static_cast<int16_t>(c.pred);
    arith_ac(ar, c, coef, 1, 63, 0);
  }

  void arith_dc_first(Arith& ar, Component& c, int16_t* blk, int al) {
    c.pred += arith_dc_diff(ar, c);
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al);
  }

  void arith_ac_refine(Arith& ar, Component& c, int16_t* blk, int ss, int se, int al) {
    uint8_t* stats = ac_stats[c.ac_tbl];
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;   // EOB
      for (;;) {
        int16_t& coef = blk[kNatural[k]];
        if (coef) {
          if (ar.decode(st + 2)) coef = static_cast<int16_t>(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          coef = static_cast<int16_t>(ar.decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) corrupt("arithmetic spectral overflow");
      }
    }
  }

  // --- scans ---

  void read_restart(const uint8_t* at, int& expected) {
    pos = static_cast<size_t>(at - data);
    int m = next_marker();
    if (m != 0xD0 + expected) corrupt("missing restart marker");
    expected = (expected + 1) & 7;
  }

  // Calls block(i, bx, by) for every block of the scan in order, and
  // restart() before each MCU (jdinput.c per_scan_setup: one block an MCU
  // over a lone component's own blocks, else the frame's MCU grid).
  template <class Restart, class Block>
  void for_each_block(int ns, Component** sc, Restart restart, Block block) {
    if (ns == 1) {
      Component& c = *sc[0];
      for (int by = 0; by < c.hb; ++by)
        for (int bx = 0; bx < c.wb; ++bx) {
          restart();
          block(0, bx, by);
        }
      return;
    }
    for (int my = 0; my < mcus_y; ++my)
      for (int mx = 0; mx < mcus_x; ++mx) {
        restart();
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int v = 0; v < c.v; ++v)
            for (int h = 0; h < c.h; ++h) block(i, mx * c.h + h, my * c.v + v);
        }
      }
  }

  void read_scan() {
    if (!sof_seen) corrupt("scan before frame header");
    ++scans;
    int seg = u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp || seg != 6 + 2 * ns) corrupt("bad SOS");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      int cid = u8(), tables = u8();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) found = &comp[j];
      if (!found) corrupt("scan names an unknown component");
      found->dc_tbl = tables >> 4;
      found->ac_tbl = tables & 15;
      if (!lossless && !quant_defined[found->tq])
        corrupt("component uses an undefined quantization table");
      found->pred = 0;
      found->dc_context = 0;
      found->decoded = true;
      sc[i] = found;
    }
    int ss = u8(), se = u8(), ahal = u8();
    int ah = ahal >> 4, al = ahal & 15;
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10) refused("more than 10 blocks in an MCU");
    }
    if (scans == 1 && !arith && !progressive && !lossless) standard_tables();
    // which tables this scan reads
    bool need_dc = !progressive || (ss == 0 && ah == 0);
    bool need_ac = !lossless && (!progressive || ss != 0);
    if (lossless) {
      if (scans == 1) check_lossless_colour();
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision)
        corrupt("bad lossless scan parameters");
    } else if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13) bad = true;
      if (bad) corrupt("bad progressive scan parameters");
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) sc[i]->coef_bits[k] = al;
    } else if (ss != 0 || se != 63 || ahal != 0) {
      corrupt("bad spectral selection for a sequential scan");
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      int lim = arith ? 15 : 3;
      if ((need_dc && c.dc_tbl > lim) || (need_ac && c.ac_tbl > lim))
        corrupt("bad entropy table index");
      if (!arith && ((need_dc && !dc[c.dc_tbl].defined) || (need_ac && !ac[c.ac_tbl].defined)))
        refused("scan uses an undefined Huffman table");
      if (arith) {
        if (need_dc) std::memset(dc_stats[c.dc_tbl], 0, 64);
        if (need_ac) std::memset(ac_stats[c.ac_tbl], 0, 256);
      }
    }

    if (lossless) {
      lossless_scan(ns, sc, ss, al);
      return;
    }
    int restarts_to_go = restart_interval, expected = 0, eobrun = 0;
    if (arith) {
      Arith ar{data + pos, data + len};
      auto restart = [&]() {
        if (!restart_interval) return;
        if (restarts_to_go == 0) {
          read_restart(ar.stop(), expected);
          ar.restart(data + pos);
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            if (need_dc) {
              std::memset(dc_stats[c.dc_tbl], 0, 64);
              c.pred = 0;
              c.dc_context = 0;
            }
            if (need_ac) std::memset(ac_stats[c.ac_tbl], 0, 256);
          }
          restarts_to_go = restart_interval;
        }
        --restarts_to_go;
      };
      if (!progressive) {
        int16_t coef[64];
        for_each_block(ns, sc, restart, [&](int i, int bx, int by) {
          std::memset(coef, 0, sizeof(coef));
          arith_block(ar, *sc[i], coef);
          idct_islow(coef, quant[sc[i]->tq], block_out(*sc[i], bx, by), sc[i]->stride);
        });
      } else {
        for_each_block(ns, sc, restart, [&](int i, int bx, int by) {
          Component& c = *sc[i];
          int16_t* blk = c.block(bx, by);
          if (ss == 0 && ah == 0) arith_dc_first(ar, c, blk, al);
          else if (ss == 0) {
            if (ar.decode(fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
          } else if (ah == 0) arith_ac(ar, c, blk, ss, se, al);
          else arith_ac_refine(ar, c, blk, ss, se, al);
        });
      }
      pos = static_cast<size_t>(ar.stop() - data);
      return;
    }
    Bits bits{data + pos, data + len};
    auto restart = [&]() {
      if (!restart_interval) return;
      if (restarts_to_go == 0) {
        bits.reset();
        read_restart(bits.p, expected);
        bits.p = data + pos;
        for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
        eobrun = 0;
        restarts_to_go = restart_interval;
      }
      --restarts_to_go;
    };
    if (!progressive) {
      int16_t coef[64];
      for_each_block(ns, sc, restart, [&](int i, int bx, int by) {
        std::memset(coef, 0, sizeof(coef));
        huff_block(bits, *sc[i], coef);
        idct_islow(coef, quant[sc[i]->tq], block_out(*sc[i], bx, by), sc[i]->stride);
      });
    } else {
      for_each_block(ns, sc, restart, [&](int i, int bx, int by) {
        Component& c = *sc[i];
        int16_t* blk = c.block(bx, by);
        if (ss == 0 && ah == 0) huff_dc_first(bits, c, blk, al);
        else if (ss == 0) huff_dc_refine(bits, blk, al);
        else if (ah == 0) huff_ac_first(bits, c, blk, ss, se, al, eobrun);
        else huff_ac_refine(bits, c, blk, ss, se, al, eobrun);
      });
    }
    pos = static_cast<size_t>(bits.p - data);
  }

  // libjpeg-turbo converts no colour in lossless mode but RGB to BGR and
  // CMYK to CMYK, so cv2's BGR request fails for the other colour spaces.
  void check_lossless_colour() const {
    if (ncomp == 1) refused("lossless grayscale JPEG (no colour conversion in lossless mode)");
    if (ncomp == 3 && !rgb_colorspace())
      refused("lossless YCbCr JPEG (no colour conversion in lossless mode)");
    if (ncomp == 4 && adobe && adobe_transform != 0)
      refused("lossless YCCK JPEG (no colour conversion in lossless mode)");
  }

  // A lossless scan (jdlhuff.c decode_mcus, jddiffct.c, jdpred.c): Huffman-
  // coded differences of every sample of the MCU grid, then each
  // component's rows undifferenced over its own width with predictor psv;
  // the first row of the scan, and of an iMCU row reached by a restart,
  // predicts from the left (its first sample from 2^(P - Pt - 1)), a
  // row's first sample from above. Samples are kept mod 2^16 and written
  // << Pt (jdlossls.c's scaler).
  void lossless_scan(int ns, Component** sc, int psv, int pt) {
    int per_row = ns == 1 ? sc[0]->wb : mcus_x;
    if (restart_interval % per_row) refused("a lossless restart interval that splits an MCU row");
    std::vector<std::vector<int32_t>> diff(ns);
    std::vector<std::vector<char>> fresh(ns);   // iMCU rows that start after a restart
    for (int i = 0; i < ns; ++i) {
      diff[i].assign(static_cast<size_t>(sc[i]->bw) * sc[i]->bh, 0);
      fresh[i].assign(sc[i]->bh / sc[i]->v + 1, 0);
    }
    Bits bits{data + pos, data + len};
    int restarts_to_go = restart_interval, expected = 0, mcu = 0;
    auto restart = [&]() {
      if (restart_interval) {
        if (restarts_to_go == 0) {
          bits.reset();
          read_restart(bits.p, expected);
          bits.p = data + pos;
          int mcu_row = mcu / per_row;
          for (int i = 0; i < ns; ++i) fresh[i][ns == 1 ? mcu_row / sc[i]->v : mcu_row] = 1;
          restarts_to_go = restart_interval;
        }
        --restarts_to_go;
      }
      ++mcu;
    };
    for_each_block(ns, sc, restart, [&](int i, int x, int y) {
      Component& c = *sc[i];
      int s = bits.decode(dc[c.dc_tbl]);
      if (s > 16) corrupt("bad lossless difference category");
      diff[i][static_cast<size_t>(y) * c.bw + x] = s == 16 ? 32768 : (s ? extend(bits.get(s), s) : 0);
    });
    pos = static_cast<size_t>(bits.p - data);
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      int rows = ns == 1 ? c.hb : c.bh, w = c.wb;
      std::vector<int32_t> prev(w), cur(w);
      for (int y = 0; y < rows; ++y) {
        const int32_t* d = diff[i].data() + static_cast<size_t>(y) * c.bw;
        bool first = y == 0 || (y % c.v == 0 && fresh[i][y / c.v]);
        if (first) {
          int ra = (d[0] + (1 << (precision - pt - 1))) & 0xFFFF;
          cur[0] = ra;
          for (int x = 1; x < w; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
        } else {
          int rb = prev[0], rc;
          int ra = (d[0] + rb) & 0xFFFF;
          cur[0] = ra;
          for (int x = 1; x < w; ++x) {
            rc = rb;
            rb = prev[x];
            int pred;
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
            cur[x] = ra = (d[x] + pred) & 0xFFFF;
          }
        }
        uint8_t* o = c.plane.data() + static_cast<size_t>(y) * c.stride;
        for (int x = 0; x < w; ++x) o[x] = static_cast<uint8_t>(cur[x] << pt);
        std::swap(prev, cur);
      }
    }
  }

  // Reads the headers and, with decode, every scan up to EOI.
  void run(bool decode) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG file (no SOI)");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC9 || m == 0xCA) {
        progressive = m == 0xC2 || m == 0xCA;
        arith = m >= 0xC9;
        read_sof(m);
        if (!decode) return;
        allocate();
      } else if (m == 0xC3) {
        lossless = true;
        read_sof(m);
        if (!decode) {
          check_lossless_colour();
          return;
        }
        allocate();
      } else if (m == 0xCB) {
        refused("lossless arithmetic-coded JPEG (SOF11)");
      } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xC8 || m == 0xCD || m == 0xCE ||
                 m == 0xCF) {
        refused("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xCC) {
        read_dac();
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
    if (progressive) output_coefficients();
  }

  // --- the output pass of a progressive image (jdcoefct.c) ---

  // smoothing_ok: every quantizer the estimates divide by is nonzero, every
  // component has its DC, and some component lacks a bit of AC 1..9.
  bool smoothing_ok() const {
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      for (int k = 0; k < 10; ++k)
        if (quant[c.tq][kPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  void output_coefficients() {
    bool smooth = smoothing_ok();
    std::vector<int16_t> ws(64);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      for (int by = 0; by < c.hb; ++by)
        for (int bx = 0; bx < c.wb; ++bx) {
          const int16_t* blk = c.block(bx, by);
          if (smooth) {
            std::memcpy(ws.data(), blk, 64 * sizeof(int16_t));
            smooth_block(c, bx, by, ws.data());
            blk = ws.data();
          }
          idct_islow(blk, quant[c.tq], block_out(c, bx, by), c.stride);
        }
    }
  }

  // The block rows decompress_smooth_data reads around block row r (b of
  // iMCU row R). Its tests count rows as R * block_rows + b against
  // block_rows * total_iMCU_rows, where block_rows is the iMCU row's own
  // count (fewer in the last one): so below the last full iMCU row it may
  // read a padding row of the MCU grid, and in a short last iMCU row a row
  // next to r stands in for one two away.
  void neighbour_rows(const Component& c, int r, int rows[5]) const {
    int total = mcus_y, R = r / c.v, b = r % c.v;
    int block_rows = c.v;
    if (R == total - 1) {
      block_rows = c.hb % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    int row = R * block_rows + b, count = block_rows * total;
    rows[1] = row > 0 ? r - 1 : r;
    rows[0] = row > 1 ? r - 2 : rows[1];
    rows[2] = r;
    rows[3] = row < count - 1 ? r + 1 : r;
    rows[4] = row < count - 2 ? r + 2 : rows[3];
  }

  // decompress_smooth_data for one block: estimates of the AC coefficients
  // 1..9 (zigzag) that are still zero and not fully known, from the 5x5
  // DC values around the block, and of the DC itself where no AC is known.
  void smooth_block(Component& c, int bx, int by, int16_t* ws) {
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; ++k)
      if (bits[k] != -1) change_dc = false;
    const uint16_t* q = quant[c.tq];
    const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2];
    int64_t Q03 = 0, Q12 = 0, Q21 = 0, Q30 = 0;
    if (change_dc) {
      Q03 = q[3];
      Q12 = q[10];
      Q21 = q[17];
      Q30 = q[24];
    }
    int rows[5];
    neighbour_rows(c, by, rows);
    int last_col = c.wb - 1;
    int64_t D[26];
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x) {
        int cx = bx + x - 2;
        cx = cx < 0 ? 0 : (cx > last_col ? last_col : cx);
        D[1 + y * 5 + x] = c.block(cx, rows[y])[0];
      }
    auto estimate = [&](int64_t qk, int al, int64_t num) {
      int64_t pred;
      if (num >= 0) {
        pred = ((qk << 7) + num) / (qk << 8);
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = ((qk << 7) - num) / (qk << 8);
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return static_cast<int16_t>(pred);
    };
    int al;
    if ((al = bits[1]) != 0 && ws[1] == 0) {
      int64_t num = Q00 * (change_dc
          ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] - 13 * D[9] + 3 * D[10] -
             3 * D[11] + 38 * D[12] - 38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
             13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] + D[25])
          : (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]));
      ws[1] = estimate(Q01, al, num);
    }
    if ((al = bits[2]) != 0 && ws[8] == 0) {
      int64_t num = Q00 * (change_dc
          ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] + 13 * D[7] + 38 * D[8] +
             13 * D[9] - D[10] + D[16] - 13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] +
             D[21] + 3 * D[22] + 3 * D[23] + 3 * D[24] + D[25])
          : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]));
      ws[8] = estimate(Q10, al, num);
    }
    if ((al = bits[3]) != 0 && ws[16] == 0) {
      int64_t num = Q00 * (change_dc
          ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] - 14 * D[13] - 5 * D[14] +
             2 * D[17] + 7 * D[18] + 2 * D[19] + D[23])
          : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]));
      ws[16] = estimate(Q20, al, num);
    }
    if ((al = bits[4]) != 0 && ws[9] == 0) {
      int64_t num = Q00 * (change_dc
          ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] + 9 * D[19] + D[21] - D[25])
          : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] - D[20] + D[22] - D[24] + D[4] -
             D[6] + 10 * D[7] - 10 * D[9]));
      ws[9] = estimate(Q11, al, num);
    }
    if ((al = bits[5]) != 0 && ws[2] == 0) {
      int64_t num = Q00 * (change_dc
          ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] - 14 * D[13] + 7 * D[14] +
             D[15] + 2 * D[17] - 5 * D[18] + 2 * D[19])
          : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] - D[15]));
      ws[2] = estimate(Q02, al, num);
    }
    if (!change_dc) return;
    if ((al = bits[6]) != 0 && ws[3] == 0)
      ws[3] = estimate(Q03, al, Q00 * (D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]));
    if ((al = bits[7]) != 0 && ws[10] == 0)
      ws[10] = estimate(Q12, al, Q00 * (D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]));
    if ((al = bits[8]) != 0 && ws[17] == 0)
      ws[17] = estimate(Q21, al, Q00 * (D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]));
    if ((al = bits[9]) != 0 && ws[24] == 0)
      ws[24] = estimate(Q30, al, Q00 * (D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]));
    int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] - 6 * D[6] +
                         6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] - 8 * D[11] +
                         42 * D[12] + 152 * D[13] + 42 * D[14] - 8 * D[15] - 6 * D[16] +
                         6 * D[17] + 42 * D[18] + 6 * D[19] - 6 * D[20] - 2 * D[21] -
                         6 * D[22] - 8 * D[23] - 6 * D[24] - 2 * D[25]);
    ws[0] = estimate(Q00, 0, num);
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
      } else if (lossless) {   // no fancy upsampling without the DCT
        const uint8_t* in = row(oy / rv);
        for (int x = 0; x < width; ++x) o[x] = in[x / rh];
      } else if (rh == 2 && rv == 1 && c.dw > 2) {   // h2v1_fancy_upsample
        const uint8_t* in = row(oy);
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
      } else if (rh == 1 && rv == 2) {   // h1v2_fancy_upsample
        int iy = oy >> 1, v = oy & 1;
        const uint8_t* in0 = row(iy);
        const uint8_t* in1 = row(v ? iy + 1 : iy - 1);
        int bias = v ? 2 : 1;
        for (int x = 0; x < width; ++x)
          o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      } else if (rh == 2 && rv == 2 && c.dw > 2) {   // h2v2_fancy_upsample
        int iy = oy >> 1, v = oy & 1;
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
      } else {   // h2v1_upsample, h2v2_upsample, int_upsample: replication
        const uint8_t* in = row(oy / rv);
        for (int x = 0; x < width; ++x) o[x] = in[x / rh];
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
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    if (ncomp == 3 && rgb_colorspace()) {
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
    if (ncomp == 3) {
      for (size_t i = 0; i < n; ++i) {
        int y = a[i], cb = b[i], cr = c[i];
        out[3 * i + 2] = clamp(y + cr_r[cr]);
        out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB));
        out[3 * i] = clamp(y + cb_b[cb]);
      }
      return;
    }
    // four components: CMYK, or YCCK turned into CMYK by ycck_cmyk_convert
    // (255 - the YCbCr -> RGB result, range-limited); then OpenCV's
    // icvCvt_CMYK2BGR_8u_C4C3R
    std::vector<uint8_t> k = upsample(comp[3]);
    bool ycck = adobe && adobe_transform != 0;
    for (size_t i = 0; i < n; ++i) {
      int cc = a[i], mm = b[i], yy = c[i], kk = k[i];
      if (ycck) {
        int y = a[i], cb = b[i], cr = c[i];
        cc = clamp(255 - (y + cr_r[cr]));
        mm = clamp(255 - (y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB)));
        yy = clamp(255 - (y + cb_b[cb]));
      }
      out[3 * i + 2] = static_cast<uint8_t>(kk - (((255 - cc) * kk) >> 8));
      out[3 * i + 1] = static_cast<uint8_t>(kk - (((255 - mm) * kk) >> 8));
      out[3 * i] = static_cast<uint8_t>(kk - (((255 - yy) * kk) >> 8));
    }
  }
};

int fail(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// The image's height, width and component count from its frame header, and
// the EXIF orientation OpenCV applies (1 where there is none).
int seevcn_jpeg_info(const uint8_t* data, int64_t len, int32_t* height, int32_t* width,
                     int32_t* components, int32_t* orientation, char* err, int errlen) {
  try {
    Decoder d(data, static_cast<size_t>(len));
    d.run(false);
    *height = d.height;
    *width = d.width;
    *components = d.ncomp;
    *orientation = d.orientation;
    return 0;
  } catch (const Error& e) {
    return fail(e, err, errlen);
  }
}

// Decodes into out, (height, width, 3) BGR uint8 in the frame's own
// orientation; out_len is its size.
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
