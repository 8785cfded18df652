// CRC32C (Castagnoli), the checksum of the compressed-update frame and of
// every log chunk on the wire. The same function as the JAX package's
// native runtime: SSE4.2's crc32 instruction eight bytes at a time where
// the host compiler targets it, a 256-entry table otherwise.
#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

struct Crc32cTable {
  uint32_t t[256];
  Crc32cTable() {
    // bit-reflected polynomial 0x1EDC6F41 -> 0x82F63B78
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j) {
        crc = (crc >> 1) ^ (0x82F63B78u & (~(crc & 1u) + 1u));
      }
      t[i] = crc;
    }
  }
};

// Thread-safe one-time init: ctypes calls arrive with the GIL released.
const uint32_t* crc32c_table() {
  static const Crc32cTable tbl;
  return tbl.t;
}

}  // namespace

extern "C" uint32_t fedcrack_torch_crc32c(const uint8_t* data, size_t len, uint32_t init) {
  uint32_t crc = ~init;
#if defined(__SSE4_2__)
  while (len >= 8) {
    uint64_t v;  // memcpy: a well-defined unaligned load
    std::memcpy(&v, data, 8);
    crc = static_cast<uint32_t>(_mm_crc32_u64(crc, v));
    data += 8;
    len -= 8;
  }
  while (len > 0) {
    crc = _mm_crc32_u8(crc, *data++);
    --len;
  }
#else
  const uint32_t* table = crc32c_table();
  for (size_t i = 0; i < len; ++i) {
    crc = (crc >> 8) ^ table[(crc ^ data[i]) & 0xFF];
  }
#endif
  return ~crc;
}
