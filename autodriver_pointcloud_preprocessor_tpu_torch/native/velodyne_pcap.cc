// Velodyne PCAP packet extractor — native sidecar.
//
// The reference delegates byte-level packet work to stubs it never built
// (reference: pcap_player.py empty, pointcloud_loader.py:1-5 declares the
// capability); SURVEY.md §2b assigns it to a C++ component of this repo.
// This parser walks a pcap container without libpcap, filters UDP packets to
// port 2368 with 1206-byte Velodyne payloads, and hands raw payload bytes +
// timestamps to Python over a flat ctypes ABI; the trigonometric decode
// happens vectorized in numpy (io/pcap.py) where it is already memory-bound.
//
// Copy of the reference package's native/velodyne_pcap.cc. Built at first use by
// native/__init__.py (g++ -O3 -std=c++17 -fPIC -shared -fwrapv).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kMagicUsLE = 0xA1B2C3D4;
constexpr uint32_t kMagicNsLE = 0xA1B23C4D;
constexpr uint32_t kMagicUsBE = 0xD4C3B2A1;
constexpr uint32_t kMagicNsBE = 0x4D3CB2A1;
constexpr uint16_t kVelodynePort = 2368;
constexpr int64_t kPayloadSize = 1206;

struct PcapFormat {
  bool swap = false;
  double ts_scale = 1e-6;
  uint32_t linktype = 1;
};

uint32_t Swap32(uint32_t v) { return __builtin_bswap32(v); }
uint16_t ReadBE16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

// Extracts the UDP payload of a Velodyne data packet from a link-layer
// frame; returns nullptr when the frame is not one.
const uint8_t* ExtractPayload(const uint8_t* frame, int64_t len,
                              uint32_t linktype) {
  int64_t ip_off = 0;
  if (linktype == 1) {  // Ethernet
    if (len < 14) return nullptr;
    uint16_t ethertype = ReadBE16(frame + 12);
    ip_off = 14;
    if (ethertype == 0x8100) {  // 802.1Q VLAN
      if (len < 18) return nullptr;
      ethertype = ReadBE16(frame + 16);
      ip_off = 18;
    }
    if (ethertype != 0x0800) return nullptr;
  } else if (linktype == 101) {  // raw IP
    ip_off = 0;
  } else {
    return nullptr;
  }
  if (len < ip_off + 20) return nullptr;
  const uint8_t* ip = frame + ip_off;
  const int64_t ihl = (ip[0] & 0x0F) * 4;
  if (ip[9] != 17) return nullptr;  // not UDP
  const int64_t udp_off = ip_off + ihl;
  if (len < udp_off + 8) return nullptr;
  const uint16_t dport = ReadBE16(frame + udp_off + 2);
  if (dport != kVelodynePort) return nullptr;
  const int64_t payload_off = udp_off + 8;
  if (len - payload_off != kPayloadSize) return nullptr;
  return frame + payload_off;
}

// Memory-maps-free whole-file read; pcaps are replay artifacts, not
// gigabyte streams, and one read keeps the parser trivially portable.
bool ReadFile(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  const size_t got = size ? std::fread(out->data(), 1, out->size(), f) : 0;
  std::fclose(f);
  return got == out->size();
}

bool ParseHeader(const std::vector<uint8_t>& data, PcapFormat* fmt) {
  if (data.size() < 24) return false;
  uint32_t magic;
  std::memcpy(&magic, data.data(), 4);
  switch (magic) {
    case kMagicUsLE: fmt->swap = false; fmt->ts_scale = 1e-6; break;
    case kMagicNsLE: fmt->swap = false; fmt->ts_scale = 1e-9; break;
    case kMagicUsBE: fmt->swap = true; fmt->ts_scale = 1e-6; break;
    case kMagicNsBE: fmt->swap = true; fmt->ts_scale = 1e-9; break;
    default: return false;
  }
  uint32_t linktype;
  std::memcpy(&linktype, data.data() + 20, 4);
  fmt->linktype = fmt->swap ? Swap32(linktype) : linktype;
  return true;
}

template <typename Fn>
int64_t ForEachPacket(const std::vector<uint8_t>& data, const PcapFormat& fmt,
                      Fn&& fn) {
  int64_t count = 0;
  size_t off = 24;
  while (off + 16 <= data.size()) {
    uint32_t raw[4];
    std::memcpy(raw, data.data() + off, 16);
    if (fmt.swap)
      for (auto& v : raw) v = Swap32(v);
    const uint32_t ts_sec = raw[0], ts_frac = raw[1], incl = raw[2];
    off += 16;
    if (off + incl > data.size()) break;
    const uint8_t* payload =
        ExtractPayload(data.data() + off, incl, fmt.linktype);
    if (payload != nullptr) {
      const double stamp = ts_sec + ts_frac * fmt.ts_scale;
      fn(payload, stamp);
      ++count;
    }
    off += incl;
  }
  return count;
}

}  // namespace

extern "C" {

// Number of Velodyne data packets in the capture; -1 on error.
int64_t vp_count_packets(const char* path) {
  std::vector<uint8_t> data;
  PcapFormat fmt;
  if (!ReadFile(path, &data) || !ParseHeader(data, &fmt)) return -1;
  return ForEachPacket(data, fmt, [](const uint8_t*, double) {});
}

// Copies up to `capacity` payloads (1206 bytes each) and stamps (seconds);
// returns the number written, -1 on error.
int64_t vp_extract_payloads(const char* path, uint8_t* payloads,
                            double* stamps, int64_t capacity) {
  std::vector<uint8_t> data;
  PcapFormat fmt;
  if (!ReadFile(path, &data) || !ParseHeader(data, &fmt)) return -1;
  int64_t written = 0;
  ForEachPacket(data, fmt, [&](const uint8_t* payload, double stamp) {
    if (written >= capacity) return;
    std::memcpy(payloads + written * kPayloadSize, payload, kPayloadSize);
    stamps[written] = stamp;
    ++written;
  });
  return written;
}

}  // extern "C"
