// A JPEG decoder and encoder for grey frames, in the integer arithmetic of
// libjpeg(-turbo), with a plain C interface for ctypes.
//
// Decoding gives what libjpeg gives for out_color_space = JCS_GRAYSCALE
// (what `cv2.imread(path, cv2.IMREAD_GRAYSCALE)` asks for):
//   - Huffman-coded 8-bit frames: SOF0 (baseline), SOF1 (extended
//     sequential) and SOF2 (progressive: spectral selection, successive
//     approximation, EOB runs);
//   - 1 or 3 components with sampling factors up to 4x4, restart
//     intervals, 8- and 16-bit quantization tables;
//   - the islow inverse DCT of jidctint.c with its range-limit table;
//   - a YCbCr frame gives its Y plane (the chroma is entropy-decoded and
//     dropped); an RGB frame (Adobe transform 0, or component ids 'R', 'G',
//     'B' without JFIF) gives libjpeg's rgb_gray_convert; a component
//     smaller than the largest is upsampled as jdsample.c does (fancy h2v1,
//     h1v2 and h2v2, box otherwise);
//   - the EXIF orientation tag of an APP1 segment, applied as cv2 applies it.
// A stream that ends before its EOI, a scan that runs out of data or holds
// a bad Huffman code raises (libjpeg warns and pads). Arithmetic coding,
// 12-bit, lossless and hierarchical frames, 2- and 4-component frames, DNL
// and a progressive file whose AC coefficients 1-9 of an output component
// are not all complete (where libjpeg smooths between blocks) are refused
// as not implemented.
//
// Encoding gives what libjpeg writes for a grey image with
// jpeg_set_defaults + jpeg_set_quality(q, TRUE): SOI, a JFIF 1.01 APP0,
// one DQT (jpeg_quality_scaling of the standard luminance table), SOF0,
// the standard DC and AC luminance Huffman tables, one sequential scan
// (the islow forward DCT of jfdctint.c, libjpeg-turbo's reciprocal
// quantizer), EOI. Edges are padded by replicating the last column and row.
//
// The library also undoes PNG's row filters (`png_unfilter`), whose Average
// and Paeth forms run serially along a row; the PNG reader is
// `utils/image_io.py`.
//
// No global state: every call owns its buffers, so threads may call it at
// the same time.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum { OK = 0, BAD = 1, UNSUPPORTED = 2 };

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void bad(const std::string& m) { throw Error{BAD, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Error{UNSUPPORTED, m}; }

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------- Huffman

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << 9];  // (length << 8) | value, 0 when the code is longer

  void derive() {
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    int n = p, code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) bad("bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    for (int i = 0; i < n; i++) {
      int l = huffsize[i];
      if (l > 9) break;
      int lo = huffcode[i] << (9 - l);
      for (int j = 0; j < (1 << (9 - l)); j++) look[lo + j] = uint16_t((l << 8) | vals[i]);
    }
    defined = true;
  }
};

// ------------------------------------------------------------- bit reader

struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos;         // next byte to load
  size_t marker_at;   // offset of the 0xFF of the marker that stopped loading
  bool at_marker = false;
  uint64_t buf = 0;   // bits left-aligned
  int cnt = 0;        // bits in buf
  int fake = 0;       // zero bits padded after a marker or the end of data

  void fill() {
    while (cnt <= 56) {
      if (!at_marker) {
        if (pos >= n) {
          at_marker = true;
          marker_at = n;
          continue;
        }
        uint8_t c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) q++;
          if (q >= n) {
            at_marker = true;
            marker_at = n;
            continue;
          }
          if (d[q] != 0) {
            at_marker = true;
            marker_at = q - 1;
            continue;
          }
          pos = q + 1;
        } else {
          pos++;
        }
        buf |= uint64_t(c) << (56 - cnt);
      } else {
        fake += 8;
      }
      cnt += 8;
    }
  }
  void consume(int k) {
    if (cnt - fake < k) bad("scan data ends early: truncated or corrupt stream");
    buf <<= k;
    cnt -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = int(buf >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huff& h) {
    if (cnt < 16) fill();
    int e = h.look[buf >> (64 - 9)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = int32_t(buf >> (64 - l));
    while (code > h.maxcode[l]) {
      l++;
      if (l > 16) bad("bad Huffman code");
      code = int32_t(buf >> (64 - l));
    }
    consume(l);
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // The offset of the marker after the scan (skipping stray bytes).
  size_t next_marker() {
    size_t p = at_marker ? marker_at : pos;
    while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0 && d[p + 1] != 0xFF)) p++;
    if (p + 1 >= n) bad("stream ends before its EOI: truncated file");
    return p;
  }
  void reset(size_t at) {
    pos = at;
    at_marker = false;
    buf = 0;
    cnt = fake = 0;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// --------------------------------------------------------------- decoder

struct Comp {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int wib, hib;  // width/height in blocks (libjpeg's width_in_blocks)
  int dsw, dsh;  // downsampled width/height
  int bw, bh;    // coefficient buffer size in blocks (MCU-padded)
  std::vector<int16_t> coef;
  int dc_pred = 0;
  int coef_bits[64];
  int16_t* block(int by, int bx) { return &coef[(size_t(by) * bw + bx) * 64]; }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  uint16_t qt[4][64];
  bool qdef[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int W = 0, H = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[4];
  bool have_frame = false, progressive = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1, restart_interval = 0, orientation = 1;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u16(size_t p) const {
    if (p + 1 >= n) bad("stream ends inside a marker: truncated file");
    return (d[p] << 8) | d[p + 1];
  }

  void read_dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      p++;
      if (tq > 3 || pq > 1) bad("bad DQT");
      if (p + (pq ? 128 : 64) > end) bad("DQT runs past its segment");
      for (int i = 0; i < 64; i++) {
        qt[tq][kNatural[i]] = pq ? uint16_t((d[p] << 8) | d[p + 1]) : d[p];
        p += pq ? 2 : 1;
      }
      qdef[tq] = true;
    }
  }

  void read_dht(size_t p, size_t end) {
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      p++;
      if (tc > 1 || th > 3 || p + 16 > end) bad("bad DHT");
      Huff& h = tc ? ac[th] : dc[th];
      int total = 0;
      h.bits[0] = 0;
      for (int i = 1; i <= 16; i++) total += (h.bits[i] = d[p + i - 1]);
      p += 16;
      if (total > 256 || p + total > end) bad("bad DHT");
      std::memcpy(h.vals, d + p, total);
      p += total;
      h.derive();
    }
  }

  void read_sof(size_t p, size_t end, int marker) {
    if (have_frame) bad("a second SOF marker");
    if (end - p < 6) bad("SOF runs past its segment");
    if (d[p] != 8) unsupported("a " + std::to_string(d[p]) + "-bit JPEG frame");
    H = u16(p + 1);
    W = u16(p + 3);
    ncomp = d[p + 5];
    if (H == 0) unsupported("a frame whose height comes in a DNL marker");
    if (W == 0) bad("a frame of width 0");
    if (ncomp != 1 && ncomp != 3)
      unsupported("a JPEG frame of " + std::to_string(ncomp) + " components");
    if (p + 6 + 3 * ncomp > end) bad("SOF runs past its segment");
    progressive = marker == 0xC2;
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) bad("bad sampling factors");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; i++) {
      Comp& c = comp[i];
      c.wib = int((int64_t(W) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.hib = int((int64_t(H) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.dsw = int((int64_t(W) * c.h + hmax - 1) / hmax);
      c.dsh = int((int64_t(H) * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame = true;
  }

  void read_app(size_t p, size_t end, int marker) {
    size_t len = end - p;
    if (marker == 0xE0 && len >= 14 && std::memcmp(d + p, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && std::memcmp(d + p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[p + 11];
    }
    if (marker == 0xE1 && len >= 14 && std::memcmp(d + p, "Exif\0\0", 6) == 0)
      read_exif(p + 6, end);
  }

  void read_exif(size_t t, size_t end) {
    // A TIFF header, then IFD0; only the orientation tag (0x0112) is read.
    if (t + 8 > end) return;
    bool le = d[t] == 'I' && d[t + 1] == 'I';
    bool be = d[t] == 'M' && d[t + 1] == 'M';
    if (!le && !be) return;
    auto rd16 = [&](size_t q) -> uint32_t {
      return le ? d[q] | (d[q + 1] << 8) : (d[q] << 8) | d[q + 1];
    };
    auto rd32 = [&](size_t q) -> uint32_t {
      return le ? rd16(q) | (rd16(q + 2) << 16) : (rd16(q) << 16) | rd16(q + 2);
    };
    size_t ifd = t + rd32(t + 4);
    if (ifd + 2 > end) return;
    uint32_t count = rd16(ifd);
    for (uint32_t i = 0; i < count; i++) {
      size_t e = ifd + 2 + 12 * size_t(i);
      if (e + 12 > end) return;
      if (rd16(e) == 0x0112 && rd16(e + 2) == 3) {
        uint32_t o = rd16(e + 8);
        if (o >= 1 && o <= 8) orientation = int(o);
        return;
      }
    }
  }

  void decode_scan(size_t p, size_t end, size_t data_start, size_t* data_end) {
    if (!have_frame) bad("SOS before SOF");
    if (p >= end) bad("bad SOS");
    int ns = d[p];
    if (ns < 1 || ns > 4 || p + 1 + 2 * ns + 3 > end) bad("bad SOS");
    Comp* sc[4];
    for (int i = 0; i < ns; i++) {
      int id = d[p + 1 + 2 * i], t = d[p + 2 + 2 * i];
      Comp* c = nullptr;
      for (int j = 0; j < ncomp; j++)
        if (comp[j].id == id) c = &comp[j];
      if (!c) bad("SOS names a component the frame has not");
      for (int j = 0; j < i; j++)
        if (sc[j] == c) bad("SOS names a component twice");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3) bad("bad SOS table index");
      sc[i] = c;
    }
    size_t q = p + 1 + 2 * ns;
    int Ss = d[q], Se = d[q + 1], Ah = d[q + 2] >> 4, Al = d[q + 2] & 15;
    if (progressive) {
      if (Ss > Se || Se > 63 || Al > 13 || Ah > 13 || (Ss == 0 && Se != 0) ||
          (Ss > 0 && ns != 1))
        bad("bad progressive scan parameters");
    } else if (Ss != 0 || Se != 63 || Ah != 0 || Al != 0) {
      // libjpeg ignores these in a sequential scan; so does this decoder.
      Ss = 0, Se = 63, Ah = 0, Al = 0;
    }
    for (int i = 0; i < ns; i++) {
      Comp* c = sc[i];
      if (!qdef[c->tq]) bad("a component's quantization table is not defined");
      bool need_dc = !progressive || (Ss == 0 && Ah == 0);
      bool need_ac = !progressive || Ss > 0;
      if (need_dc && !dc[c->td].defined) bad("a scan's DC Huffman table is not defined");
      if (need_ac && !ac[c->ta].defined) bad("a scan's AC Huffman table is not defined");
      if (progressive)
        for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
    }

    Bits bits{d, n, data_start, 0};
    for (int i = 0; i < ncomp; i++) comp[i].dc_pred = 0;
    eobrun = 0;
    int units_x, units_y;
    if (ns == 1) {
      units_x = sc[0]->wib;
      units_y = sc[0]->hib;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    long total = long(units_x) * units_y, todo = restart_interval, rst = 0;
    for (long m = 0; m < total; m++) {
      if (restart_interval && todo == 0) {
        size_t mk = bits.next_marker();
        if (d[mk + 1] != 0xD0 + (rst & 7)) bad("a restart marker is missing or out of order");
        rst++;
        bits.reset(mk + 2);
        for (int i = 0; i < ncomp; i++) comp[i].dc_pred = 0;
        eobrun = 0;
        todo = restart_interval;
      }
      int ux = int(m % units_x), uy = int(m / units_x);
      if (ns == 1) {
        decode_block(bits, *sc[0], sc[0]->block(uy, ux), Ss, Se, Ah, Al);
      } else {
        for (int i = 0; i < ns; i++) {
          Comp& c = *sc[i];
          for (int yy = 0; yy < c.v; yy++)
            for (int xx = 0; xx < c.h; xx++)
              decode_block(bits, c, c.block(uy * c.v + yy, ux * c.h + xx), Ss, Se, Ah, Al);
        }
      }
      todo--;
    }
    *data_end = bits.next_marker();
  }

  void decode_block(Bits& b, Comp& c, int16_t* blk, int Ss, int Se, int Ah, int Al) {
    if (!progressive) {
      int s = b.decode(dc[c.td]);
      int diff = s ? extend(b.get(s), s) : 0;
      c.dc_pred += diff;
      blk[0] = int16_t(c.dc_pred);
      const Huff& h = ac[c.ta];
      for (int k = 1; k < 64; k++) {
        int rs = b.decode(h), r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          if (k > 63) bad("an AC run past the end of a block");
          blk[kNatural[k]] = int16_t(extend(b.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (Ss == 0) {  // DC scans
      if (Ah == 0) {
        int s = b.decode(dc[c.td]);
        int diff = s ? extend(b.get(s), s) : 0;
        c.dc_pred += diff;
        blk[0] = int16_t(uint32_t(c.dc_pred) << Al);
      } else if (b.get(1)) {
        blk[0] = int16_t(blk[0] | (1 << Al));
      }
      return;
    }
    const Huff& h = ac[c.ta];
    if (Ah == 0) {  // AC first pass
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int k = Ss; k <= Se; k++) {
        int rs = b.decode(h), r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          if (k > Se) bad("an AC run past the end of a band");
          blk[kNatural[k]] = int16_t(uint32_t(extend(b.get(s), s)) << Al);
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          eobrun--;
          break;
        }
      }
      return;
    }
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; k++) {
        int rs = b.decode(h), r = rs >> 4, s = rs & 15;
        if (s) {
          s = b.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += b.get(r);
          break;
        }
        do {
          int16_t* t = blk + kNatural[k];
          if (*t != 0) {
            if (b.get(1) && (*t & p1) == 0) *t = int16_t(*t >= 0 ? *t + p1 : *t + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= Se);
        if (s) {
          if (k > Se) bad("an AC refinement past the end of a band");
          blk[kNatural[k]] = int16_t(s);
        }
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* t = blk + kNatural[k];
        if (*t != 0 && b.get(1) && (*t & p1) == 0) *t = int16_t(*t >= 0 ? *t + p1 : *t + m1);
      }
      eobrun--;
    }
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) bad("not a JPEG stream (no SOI)");
    size_t p = 2;
    for (;;) {
      while (p < n && d[p] != 0xFF) p++;  // libjpeg skips stray bytes, warning
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) bad("stream ends before its EOI: truncated file");
      int m = d[p++];
      if (m == 0xD9) break;
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      int len = u16(p);
      if (len < 2) bad("bad marker length");
      size_t body = p + 2, end = p + len;
      if (end > n) bad("stream ends inside a marker: truncated file");
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(body, end, m);
      } else if (m == 0xC3) {
        unsupported("a lossless JPEG frame (SOF3)");
      } else if ((m >= 0xC5 && m <= 0xC7) || m == 0xDE || m == 0xDF) {
        unsupported("a hierarchical JPEG frame");
      } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF) || m == 0xCC) {
        unsupported("an arithmetic-coded JPEG frame");
      } else if (m == 0xC4) {
        read_dht(body, end);
      } else if (m == 0xDB) {
        read_dqt(body, end);
      } else if (m == 0xDD) {
        if (len < 4) bad("bad DRI");
        restart_interval = u16(body);
      } else if (m == 0xDC) {
        unsupported("a DNL marker");
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(body, end, m);
      } else if (m == 0xDA) {
        size_t next;
        decode_scan(body, end, end, &next);
        p = next;
        continue;
      }
      p = end;
    }
    if (!have_frame) bad("no frame in the stream");
  }

  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  void check_smoothing(int nneeded) const {
    if (!progressive) return;
    for (int i = 0; i < ncomp; i++)
      if (comp[i].coef_bits[0] < 0) return;  // libjpeg smooths only when all DCs are known
    for (int i = 0; i < nneeded; i++)
      for (int k = 1; k < 10; k++)
        if (comp[i].coef_bits[k] != 0)
          unsupported("a progressive file whose AC coefficients 1-9 are not complete "
                      "(libjpeg smooths between blocks there)");
  }
};

// ------------------------------------------------------------------- IDCT

const int CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) { return int32_t((x + (int64_t(1) << (n - 1))) >> n); }

// libjpeg's post-IDCT range limit: (x + 128) for x in [-128, 127] after a
// wrap to 10 bits, 255 above, 0 below.
inline uint8_t range_limit(int32_t x) {
  int idx = x & 1023;
  if (idx < 128) return uint8_t(idx + 128);
  if (idx < 512) return 255;
  if (idx < 896) return 0;
  return uint8_t(idx - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int32_t dcv = int32_t(ip[0]) * qp[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dcv;
      continue;
    }
    int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(ip[0]) * qp[0];
    z3 = int64_t(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(ip[56]) * qp[56];
    tmp1 = int64_t(ip[40]) * qp[40];
    tmp2 = int64_t(ip[24]) * qp[24];
    tmp3 = int64_t(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, sh);
    wp[56] = descale(tmp10 - tmp3, sh);
    wp[8] = descale(tmp11 + tmp2, sh);
    wp[48] = descale(tmp11 - tmp2, sh);
    wp[16] = descale(tmp12 + tmp1, sh);
    wp[40] = descale(tmp12 - tmp1, sh);
    wp[24] = descale(tmp13 + tmp0, sh);
    wp[32] = descale(tmp13 - tmp0, sh);
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + size_t(r) * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = range_limit(descale(wp[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = range_limit(descale(tmp10 + tmp3, sh));
    op[7] = range_limit(descale(tmp10 - tmp3, sh));
    op[1] = range_limit(descale(tmp11 + tmp2, sh));
    op[6] = range_limit(descale(tmp11 - tmp2, sh));
    op[2] = range_limit(descale(tmp12 + tmp1, sh));
    op[5] = range_limit(descale(tmp12 - tmp1, sh));
    op[3] = range_limit(descale(tmp13 + tmp0, sh));
    op[4] = range_limit(descale(tmp13 - tmp0, sh));
  }
}

// One component's samples at full resolution: [H, W] after the inverse DCT
// and, where the component is smaller than the largest, jdsample.c's
// upsampling.
std::vector<uint8_t> component_plane(Decoder& dec, Comp& c) {
  int pw = c.wib * 8, ph = c.hib * 8;
  std::vector<uint8_t> plane(size_t(pw) * ph);
  const uint16_t* q = dec.qt[c.tq];
  for (int by = 0; by < c.hib; by++)
    for (int bx = 0; bx < c.wib; bx++)
      idct_islow(c.block(by, bx), q, &plane[size_t(by) * 8 * pw + bx * 8], pw);
  const int W = dec.W, H = dec.H, hx = dec.hmax / c.h, vx = dec.vmax / c.v;
  if (dec.hmax % c.h || dec.vmax % c.v) unsupported("non-integral sampling ratios");
  std::vector<uint8_t> out(size_t(W) * H);
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; y++) std::memcpy(&out[size_t(y) * W], &plane[size_t(y) * pw], W);
    return out;
  }
  const int dw = c.dsw, dh = c.dsh;
  auto in = [&](int y, int x) -> int {
    y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);  // context rows replicate the edge rows
    return plane[size_t(y) * pw + x];
  };
  std::vector<uint8_t> row(size_t(std::max(dw * hx, W) + 8));
  for (int y = 0; y < H; y++) {
    int iy = y / vx, v = y % vx;
    if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
      int x = 0;
      int iv = in(iy, 0);
      row[x++] = uint8_t(iv);
      row[x++] = uint8_t((iv * 3 + in(iy, 1) + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        iv = in(iy, i) * 3;
        row[x++] = uint8_t((iv + in(iy, i - 1) + 1) >> 2);
        row[x++] = uint8_t((iv + in(iy, i + 1) + 2) >> 2);
      }
      iv = in(iy, dw - 1);
      row[x++] = uint8_t((iv * 3 + in(iy, dw - 2) + 1) >> 2);
      row[x++] = uint8_t(iv);
    } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      int other = v == 0 ? iy - 1 : iy + 1, bias = v == 0 ? 1 : 2;
      for (int i = 0; i < dw; i++) row[i] = uint8_t((in(iy, i) * 3 + in(other, i) + bias) >> 2);
    } else if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
      int other = v == 0 ? iy - 1 : iy + 1;
      auto colsum = [&](int i) { return in(iy, i) * 3 + in(other, i); };
      int x = 0;
      int this_s = colsum(0), next_s = colsum(1), last_s;
      row[x++] = uint8_t((this_s * 4 + 8) >> 4);
      row[x++] = uint8_t((this_s * 3 + next_s + 7) >> 4);
      last_s = this_s;
      this_s = next_s;
      for (int i = 2; i < dw; i++) {
        next_s = colsum(i);
        row[x++] = uint8_t((this_s * 3 + last_s + 8) >> 4);
        row[x++] = uint8_t((this_s * 3 + next_s + 7) >> 4);
        last_s = this_s;
        this_s = next_s;
      }
      row[x++] = uint8_t((this_s * 3 + last_s + 8) >> 4);
      row[x++] = uint8_t((this_s * 4 + 7) >> 4);
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: boxes
      for (int i = 0; i < dw; i++) {
        uint8_t s = uint8_t(in(iy, i));
        for (int j = 0; j < hx; j++) row[size_t(i) * hx + j] = s;
      }
    }
    std::memcpy(&out[size_t(y) * W], row.data(), W);
  }
  return out;
}

std::vector<uint8_t> decode(const uint8_t* data, size_t n, int* oh, int* ow) {
  Decoder dec(data, n);
  dec.parse();
  bool rgb = dec.is_rgb();
  int needed = rgb ? 3 : 1;
  dec.check_smoothing(needed);
  const int W = dec.W, H = dec.H;
  std::vector<uint8_t> grey;
  if (!rgb) {
    grey = component_plane(dec, dec.comp[0]);
  } else {  // jdcolor.c rgb_gray_convert
    std::vector<uint8_t> r = component_plane(dec, dec.comp[0]);
    std::vector<uint8_t> g = component_plane(dec, dec.comp[1]);
    std::vector<uint8_t> b = component_plane(dec, dec.comp[2]);
    grey.resize(r.size());
    const int32_t fr = 19595, fg = 38470, fb = 7471, half = 1 << 15;  // FIX(0.299) ... at 16 bits
    for (size_t i = 0; i < r.size(); i++)
      grey[i] = uint8_t((fr * r[i] + fg * g[i] + fb * b[i] + half) >> 16);
  }
  // EXIF orientation, as cv2's ExifTransform: 2 flip x, 3 flip both,
  // 4 flip y, 5 transpose, 6 transpose + flip x, 7 transpose + flip both,
  // 8 transpose + flip y.
  int o = dec.orientation;
  bool tr = o >= 5;
  bool fx = o == 2 || o == 3 || o == 6 || o == 7;
  bool fy = o == 3 || o == 4 || o == 7 || o == 8;
  int oH = tr ? W : H, oW = tr ? H : W;
  *oh = oH;
  *ow = oW;
  if (o == 1) return grey;
  std::vector<uint8_t> out(grey.size());
  for (int y = 0; y < oH; y++)
    for (int x = 0; x < oW; x++) {
      int sy = fy ? oH - 1 - y : y, sx = fx ? oW - 1 - x : x;
      out[size_t(y) * oW + x] = tr ? grey[size_t(sx) * W + sy] : grey[size_t(sy) * W + sx];
    }
  return out;
}

// --------------------------------------------------------------- encoder

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kDcBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int c = 0, p = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < bits[l]; i++, p++) {
        code[vals[p]] = uint16_t(c++);
        size[vals[p]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t v, int k) {
    if (!k) return;
    acc = (acc << k) | (v & ((1u << k) - 1));
    n += k;
    while (n >= 8) {
      uint8_t b = uint8_t(acc >> (n - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      n -= 8;
    }
  }
  void flush() {
    if (n) put(0x7F, 8 - n);  // pad the last byte with ones
  }
};

void fdct_islow(int32_t* data) {
  for (int r = 0; r < 8; r++) {
    int32_t* p = data + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7], tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5], tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int32_t((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = int32_t((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int c = 0; c < 8; c++) {
    int32_t* p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56], tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40], tmp3 = p[24] + p[32],
            tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// libjpeg-turbo's quantizer (jcdctmgr.c compute_reciprocal + quantize):
// a divide by q * 8, rounded, as a multiply by a 16-bit reciprocal.
struct Divisor {
  uint32_t recip, corr;
  int shift;
  explicit Divisor(uint32_t divisor) {
    if (divisor == 1) {
      recip = 1, corr = 0, shift = -16;
      return;
    }
    int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
    int r = 16 + b;
    uint32_t fq = uint32_t((uint64_t(1) << r) / divisor);
    uint32_t fr = uint32_t((uint64_t(1) << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2) {
      c++;
    } else {
      fq++;
    }
    recip = fq & 0xFFFF, corr = c & 0xFFFF, shift = r - 16;
  }
  int quantize(int32_t v) const {
    uint32_t a = uint32_t(v < 0 ? -v : v) & 0xFFFF;
    uint32_t prod = ((a + corr) & 0xFFFF) * recip;
    int q = int(prod >> (shift + 16));
    return v < 0 ? -q : q;
  }
};

std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int quality) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535) bad("image size out of JPEG's range");
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t q[64];
  for (int i = 0; i < 64; i++) {
    long t = (long(kStdLumaQ[i]) * scale + 50) / 100;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;  // force_baseline
    q[i] = uint16_t(t);
  }
  std::vector<uint8_t> out;
  auto marker = [&](int m, int len) {
    out.push_back(0xFF);
    out.push_back(uint8_t(m));
    out.push_back(uint8_t(len >> 8));
    out.push_back(uint8_t(len & 0xFF));
  };
  out.push_back(0xFF);
  out.push_back(0xD8);
  marker(0xE0, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  out.insert(out.end(), jfif, jfif + 14);
  marker(0xDB, 67);
  out.push_back(0);
  for (int i = 0; i < 64; i++) out.push_back(uint8_t(q[kNatural[i]]));
  marker(0xC0, 11);
  const uint8_t sof[9] = {8, uint8_t(H >> 8), uint8_t(H), uint8_t(W >> 8), uint8_t(W), 1, 1,
                          0x11, 0};
  out.insert(out.end(), sof, sof + 9);
  marker(0xC4, 2 + 1 + 16 + 12);
  out.push_back(0x00);
  out.insert(out.end(), kDcBits + 1, kDcBits + 17);
  out.insert(out.end(), kDcVals, kDcVals + 12);
  marker(0xC4, 2 + 1 + 16 + 162);
  out.push_back(0x10);
  out.insert(out.end(), kAcBits + 1, kAcBits + 17);
  out.insert(out.end(), kAcVals, kAcVals + 162);
  marker(0xDA, 8);
  const uint8_t sos[6] = {1, 1, 0x00, 0, 63, 0};
  out.insert(out.end(), sos, sos + 6);

  static_assert(sizeof(int32_t) == 4, "");
  std::vector<Divisor> div;
  for (int i = 0; i < 64; i++) div.emplace_back(uint32_t(q[i]) << 3);
  EncTable dct(kDcBits, kDcVals), act(kAcBits, kAcVals);
  BitWriter bw(out);
  int last_dc = 0;
  const int bxs = (W + 7) / 8, bys = (H + 7) / 8;
  int32_t blk[64];
  int coef[64];
  for (int by = 0; by < bys; by++)
    for (int bx = 0; bx < bxs; bx++) {
      for (int r = 0; r < 8; r++) {
        int y = std::min(by * 8 + r, H - 1);
        for (int c = 0; c < 8; c++) {
          int x = std::min(bx * 8 + c, W - 1);
          blk[8 * r + c] = int32_t(img[size_t(y) * W + x]) - 128;
        }
      }
      fdct_islow(blk);
      for (int i = 0; i < 64; i++) coef[i] = div[i].quantize(blk[i]);
      int diff = coef[0] - last_dc;
      last_dc = coef[0];
      int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff, nb = 0;
      while (t) nb++, t >>= 1;
      bw.put(dct.code[nb], dct.size[nb]);
      bw.put(uint32_t(t2), nb);
      int run = 0;
      for (int k = 1; k < 64; k++) {
        int v = coef[kNatural[k]];
        if (v == 0) {
          run++;
          continue;
        }
        while (run > 15) {
          bw.put(act.code[0xF0], act.size[0xF0]);
          run -= 16;
        }
        int a = v < 0 ? -v : v, v2 = v < 0 ? v - 1 : v;
        nb = 0;
        while (a) nb++, a >>= 1;
        int sym = (run << 4) | nb;
        bw.put(act.code[sym], act.size[sym]);
        bw.put(uint32_t(v2), nb);
        run = 0;
      }
      if (run) bw.put(act.code[0], act.size[0]);
    }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

void set_error(const Error& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, e.msg.c_str(), size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// Decode a JPEG stream into a malloc'd [H, W] grey buffer (free it with
// jpg_free). Returns 0, 1 for a corrupt or truncated stream, 2 for a form
// this decoder does not implement; err holds the message.
int jpg_decode_grey(const uint8_t* data, int64_t n, uint8_t** out, int* h, int* w, char* err,
                    int errlen) {
  try {
    std::vector<uint8_t> img = decode(data, size_t(n), h, w);
    *out = static_cast<uint8_t*>(std::malloc(img.size() ? img.size() : 1));
    if (!*out) throw Error{BAD, "out of memory"};
    std::memcpy(*out, img.data(), img.size());
    return OK;
  } catch (const Error& e) {
    set_error(e, err, errlen);
    return e.code;
  } catch (const std::exception& e) {
    set_error(Error{BAD, e.what()}, err, errlen);
    return BAD;
  }
}

// Encode a [H, W] grey image as a baseline JPEG at `quality` into a
// malloc'd buffer of *n bytes (free it with jpg_free).
int jpg_encode_grey(const uint8_t* img, int h, int w, int quality, uint8_t** out, int64_t* n,
                    char* err, int errlen) {
  try {
    std::vector<uint8_t> bytes = encode(img, h, w, quality);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) throw Error{BAD, "out of memory"};
    std::memcpy(*out, bytes.data(), bytes.size());
    *n = int64_t(bytes.size());
    return OK;
  } catch (const Error& e) {
    set_error(e, err, errlen);
    return e.code;
  } catch (const std::exception& e) {
    set_error(Error{BAD, e.what()}, err, errlen);
    return BAD;
  }
}

void jpg_free(uint8_t* p) { std::free(p); }

// Undo the PNG filters of `rows` filtered rows (a filter byte, then
// `rowbytes` bytes) into out [rows, rowbytes]; `bpp` is the bytes of a
// whole pixel (at least 1). Returns 0, or 1 for an unknown filter type.
int png_unfilter(const uint8_t* raw, int64_t rows, int64_t rowbytes, int bpp, uint8_t* out) {
  for (int64_t y = 0; y < rows; y++) {
    const uint8_t* in = raw + y * (rowbytes + 1) + 1;
    uint8_t* o = out + y * rowbytes;
    const uint8_t* up = y ? o - rowbytes : nullptr;
    switch (raw[y * (rowbytes + 1)]) {
      case 0:
        std::memcpy(o, in, size_t(rowbytes));
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; i++) o[i] = uint8_t(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; i++) o[i] = uint8_t(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          o[i] = uint8_t(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (i >= bpp && up) ? up[i - bpp] : 0;
          int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          o[i] = uint8_t(in[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default:
        return 1;
    }
  }
  return 0;
}

}  // extern "C"
