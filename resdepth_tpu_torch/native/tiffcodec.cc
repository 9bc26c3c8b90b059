// Native TIFF codec hot paths for ResDepth-TPU.
//
// The port's copy of resdepth_tpu/native/tiffcodec.cc, unchanged but for
// these comments.
//
// The reference delegates raster IO to libgdal (C++) via Python bindings
// (the reference's lib/rasterutils.py:2). This framework ships its own
// GeoTIFF codec (resdepth_tpu_torch/geo/tiff.py); the byte-sequential algorithms
// that are slow in Python — TIFF-variant LZW decode/encode and PackBits —
// live here. Built as a shared library, bound via ctypes
// (resdepth_tpu_torch/geo/_native.py), with pure-Python fallbacks.
//
// TIFF LZW specifics implemented (TIFF 6.0 spec, section 13):
//   * MSB-first variable-width codes, 9 -> 12 bits,
//   * Clear code 256 / EndOfInformation 257,
//   * "early change": the code width bumps one code BEFORE the table fills.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kMaxCode = 4096;

struct DecodeTable {
  // Each code stores its prefix code and final byte; strings are emitted by
  // walking prefixes backwards through a scratch stack.
  int16_t prefix[kMaxCode];
  uint8_t suffix[kMaxCode];
  int32_t length[kMaxCode];
  int next;

  void reset() {
    for (int i = 0; i < 256; ++i) {
      prefix[i] = -1;
      suffix[i] = static_cast<uint8_t>(i);
      length[i] = 1;
    }
    next = kFirst;
  }
};

}  // namespace

extern "C" {

// Decode TIFF LZW. Returns bytes written, or -1 if dst is too small,
// -2 on malformed input.
long rd_lzw_decode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  static thread_local DecodeTable table;
  table.reset();

  uint32_t bitbuf = 0;
  int bitcnt = 0;
  int code_width = 9;
  long pos = 0;
  long out = 0;
  int prev = -1;
  uint8_t stack[kMaxCode];

  while (true) {
    while (bitcnt < code_width) {
      if (pos >= n) return out;  // ran out of input: EOI omitted by writer
      bitbuf = (bitbuf << 8) | src[pos++];
      bitcnt += 8;
    }
    int code = (bitbuf >> (bitcnt - code_width)) & ((1 << code_width) - 1);
    bitcnt -= code_width;

    if (code == kEoi) return out;
    if (code == kClear) {
      table.reset();
      code_width = 9;
      prev = -1;
      continue;
    }

    int emit_code;
    if (prev < 0) {
      if (code >= 256) return -2;
      emit_code = code;
    } else if (code < table.next) {
      emit_code = code;
      if (table.next < kMaxCode) {
        table.prefix[table.next] = static_cast<int16_t>(prev);
        // suffix = first byte of the string for `code`
        int walk = code;
        while (table.prefix[walk] >= 0) walk = table.prefix[walk];
        table.suffix[table.next] = table.suffix[walk];
        table.length[table.next] = table.length[prev] + 1;
        ++table.next;
      }
    } else if (code == table.next && table.next < kMaxCode) {
      // KwKwK case: new string = prev + first byte of prev
      int walk = prev;
      while (table.prefix[walk] >= 0) walk = table.prefix[walk];
      table.prefix[table.next] = static_cast<int16_t>(prev);
      table.suffix[table.next] = table.suffix[walk];
      table.length[table.next] = table.length[prev] + 1;
      emit_code = table.next;
      ++table.next;
    } else {
      return -2;
    }

    // Emit the string for emit_code.
    int len = table.length[emit_code];
    if (out + len > cap) return -1;
    int walk = emit_code;
    for (int i = len - 1; i >= 0; --i) {
      stack[i] = table.suffix[walk];
      walk = table.prefix[walk];
    }
    std::memcpy(dst + out, stack, static_cast<size_t>(len));
    out += len;
    prev = emit_code;

    // Early change: widen one code before the table is actually full.
    if (table.next + 1 >= (1 << code_width) && code_width < 12) {
      ++code_width;
    }
  }
}

// Encode TIFF LZW. Returns bytes written, or -1 if dst is too small.
long rd_lzw_encode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  // Transition table: state (code) x next byte -> code; 4096*256 entries.
  static thread_local int32_t* trans = nullptr;
  if (trans == nullptr) {
    trans = new int32_t[kMaxCode * 256];
  }

  long out = 0;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  int code_width = 9;
  int next = kFirst;

  auto put = [&](int code) -> bool {
    bitbuf = (bitbuf << code_width) | static_cast<uint32_t>(code);
    bitcnt += code_width;
    while (bitcnt >= 8) {
      if (out >= cap) return false;
      dst[out++] = static_cast<uint8_t>((bitbuf >> (bitcnt - 8)) & 0xFF);
      bitcnt -= 8;
    }
    return true;
  };

  auto reset = [&]() {
    std::memset(trans, -1, sizeof(int32_t) * kMaxCode * 256);
    next = kFirst;
    code_width = 9;
  };

  reset();
  if (!put(kClear)) return -1;

  long pos = 0;
  if (n == 0) {
    if (!put(kEoi)) return -1;
    if (bitcnt > 0) {
      if (out >= cap) return -1;
      dst[out++] = static_cast<uint8_t>((bitbuf << (8 - bitcnt)) & 0xFF);
    }
    return out;
  }

  int w = src[pos++];
  while (pos < n) {
    uint8_t byte = src[pos++];
    int t = trans[w * 256 + byte];
    if (t >= 0) {
      w = t;
      continue;
    }
    if (!put(w)) return -1;
    trans[w * 256 + byte] = next++;
    // Early change on the encoder side mirrors the decoder.
    if (next + 1 > (1 << code_width)) {
      if (code_width < 12) {
        ++code_width;
      } else {
        if (!put(kClear)) return -1;
        reset();
      }
    }
    w = byte;
  }
  if (!put(w)) return -1;
  // The decoder adds a table entry for this final code and applies the
  // early-change width bump BEFORE reading the next code, so EOI must be
  // written at the width the decoder will read it with (libtiff's
  // LZWPostEncode). `next` was NOT incremented here, hence >= where the
  // mid-stream check uses >.
  if (next + 1 >= (1 << code_width) && code_width < 12) ++code_width;
  if (!put(kEoi)) return -1;
  if (bitcnt > 0) {
    if (out >= cap) return -1;
    dst[out++] = static_cast<uint8_t>((bitbuf << (8 - bitcnt)) & 0xFF);
  }
  return out;
}

// PackBits decode (TIFF 6.0 section 9). Returns bytes written or -1.
long rd_packbits_decode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  long i = 0;
  long out = 0;
  while (i < n) {
    int header = static_cast<int8_t>(src[i++]);
    if (header >= 0) {
      long count = header + 1;
      if (i + count > n || out + count > cap) return -1;
      std::memcpy(dst + out, src + i, static_cast<size_t>(count));
      i += count;
      out += count;
    } else if (header != -128) {
      long count = 1 - header;
      if (i >= n || out + count > cap) return -1;
      std::memset(dst + out, src[i++], static_cast<size_t>(count));
      out += count;
    }
  }
  return out;
}

}  // extern "C"
