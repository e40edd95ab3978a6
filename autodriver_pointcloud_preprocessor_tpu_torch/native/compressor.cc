// Delta + zigzag + LEB128 varint streams — native hot loop of the codec.
//
// The reference intended Draco (C++) through point_cloud_transport
// (reference: pointcloud_compressor.py:12-23); SURVEY.md §2b assigns the
// compressor's byte-level stage to a C++ component of this repo. The
// Python layer (io/compressor.py) owns quantization (numpy) and DEFLATE
// (zlib); this file owns the per-point sequential loop Python can't
// vectorize cheaply. Wire format matches the numpy version bit-for-bit.
//
// Copy of the reference package's native/compressor.cc. Built at first use by
// native/__init__.py (g++ -O3 -std=c++17 -fPIC -shared -fwrapv).

#include <cstdint>

extern "C" {

// int32 values -> delta(prev) -> zigzag -> varint bytes.
// Returns bytes written, or -1 if `capacity` is too small.
int64_t apc_delta_zigzag_varint_encode(const int32_t* values, int64_t count,
                                       uint8_t* out, int64_t capacity) {
  int64_t pos = 0;
  int32_t prev = 0;
  for (int64_t i = 0; i < count; ++i) {
    const int32_t delta = values[i] - prev;
    prev = values[i];
    uint32_t z = (static_cast<uint32_t>(delta) << 1) ^
                 static_cast<uint32_t>(delta >> 31);
    do {
      if (pos >= capacity) return -1;
      uint8_t byte = z & 0x7F;
      z >>= 7;
      if (z != 0) byte |= 0x80;
      out[pos++] = byte;
    } while (z != 0);
  }
  return pos;
}

// Inverse: varint bytes -> unzigzag -> cumulative sum. Returns values
// decoded (== count on success), or -1 on truncated input.
int64_t apc_delta_zigzag_varint_decode(const uint8_t* data, int64_t size,
                                       int32_t* out, int64_t count) {
  int64_t pos = 0;
  int32_t acc = 0;
  for (int64_t i = 0; i < count; ++i) {
    uint32_t z = 0;
    int shift = 0;
    while (true) {
      if (pos >= size) return -1;
      const uint8_t byte = data[pos++];
      z |= static_cast<uint32_t>(byte & 0x7F) << shift;
      if ((byte & 0x80) == 0) break;
      shift += 7;
    }
    const int32_t delta =
        static_cast<int32_t>(z >> 1) ^ -static_cast<int32_t>(z & 1);
    acc += delta;
    out[i] = acc;
  }
  return count;
}

}  // extern "C"
