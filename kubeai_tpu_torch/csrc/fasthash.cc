// fasthash: xxHash64 + consistent-hash-ring primitives (the port's copy of
// the JAX package's native/fasthash.cc; host C++, not a CUDA kernel).
//
// The request-routing hot loop (CHWBL prefix hashing: one xxh64 of up to
// ~100 chars per request plus a ring binary search; cf. the reference's
// use of github.com/cespare/xxhash in its balancer) and pod-spec hashing
// run through these instead of pure Python. Built by
// kubeai_tpu_torch.utils.native with g++ and bound via ctypes; the Python
// implementation remains as a fallback and as the reference for tests.

#include <cstdint>
#include <cstring>

static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t round1(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

static inline uint64_t merge_round(uint64_t h, uint64_t v) {
  return (h ^ round1(0, v)) * P1 + P4;
}

static inline uint64_t read64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86_64/aarch64)
}

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

extern "C" uint64_t xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  uint64_t h;

  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round1(v1, read64(p));
      v2 = round1(v2, read64(p + 8));
      v3 = round1(v3, read64(p + 16));
      v4 = round1(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + P5;
  }

  h += len;
  while (p + 8 <= end) {
    h ^= round1(0, read64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(read32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }

  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// Hash `replication` virtual nodes for an endpoint name ("<name>/<i>").
extern "C" void ring_hashes(const uint8_t* name, uint64_t name_len,
                            uint64_t replication, uint64_t* out) {
  uint8_t buf[512];
  if (name_len > 480) name_len = 480;
  std::memcpy(buf, name, name_len);
  for (uint64_t i = 0; i < replication; ++i) {
    uint64_t n = name_len;
    buf[n++] = '/';
    // decimal of i
    char tmp[24];
    int t = 0;
    uint64_t x = i;
    do {
      tmp[t++] = '0' + static_cast<char>(x % 10);
      x /= 10;
    } while (x);
    while (t) buf[n++] = tmp[--t];
    out[i] = xxh64(buf, n, 0);
  }
}

// First index in the sorted ring with value >= h, wrapping to 0.
extern "C" uint64_t ring_search(const uint64_t* sorted, uint64_t n, uint64_t h) {
  uint64_t lo = 0, hi = n;
  while (lo < hi) {
    uint64_t mid = (lo + hi) / 2;
    if (sorted[mid] < h)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo >= n ? 0 : lo;
}
