// dfnative: C-ABI hot-path library for the daemon's storage.
//
// Covers the work the reference delegates to native code (the Rust
// client-rs data plane) and Go's optimized runtime: piece hashing
// (sha256 / md5 / crc32c) and positioned file IO. Exposed as a plain C ABI
// consumed via ctypes (dragonfly2_tpu_torch/storage/native.py, which
// builds this file at first use).
//
// All hash implementations are from the public specifications
// (FIPS 180-4, RFC 1321, RFC 3720 / Castagnoli).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>
#include <cerrno>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- sha256

struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buf_len = 0;

  Sha256() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

  void block(const uint8_t* p) {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
        0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
        0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
        0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
        0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
        0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
        0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
        0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
             (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + s1 + ch + k[i] + w[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* data, size_t n) {
    len += n;
    if (buf_len) {
      size_t take = 64 - buf_len;
      if (take > n) take = n;
      memcpy(buf + buf_len, data, take);
      buf_len += take;
      data += take;
      n -= take;
      if (buf_len == 64) {
        block(buf);
        buf_len = 0;
      }
    }
    while (n >= 64) {
      block(data);
      data += 64;
      n -= 64;
    }
    if (n) {
      memcpy(buf, data, n);
      buf_len = n;
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buf_len != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (56 - i * 8));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[i * 4] = uint8_t(h[i] >> 24);
      out[i * 4 + 1] = uint8_t(h[i] >> 16);
      out[i * 4 + 2] = uint8_t(h[i] >> 8);
      out[i * 4 + 3] = uint8_t(h[i]);
    }
  }
};

// ---------------------------------------------------------------- md5

struct Md5 {
  uint32_t a0 = 0x67452301, b0 = 0xefcdab89, c0 = 0x98badcfe, d0 = 0x10325476;
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buf_len = 0;

  static uint32_t rotl(uint32_t x, int c) { return (x << c) | (x >> (32 - c)); }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
        0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
        0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
        0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
        0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
        0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
        0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
        0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
        0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
        0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
        0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
    static const int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                              7, 12, 17, 22, 5, 9,  14, 20, 5, 9,  14, 20,
                              5, 9,  14, 20, 5, 9,  14, 20, 4, 11, 16, 23,
                              4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                              6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21,
                              6, 10, 15, 21};
    uint32_t m[16];
    for (int i = 0; i < 16; i++)
      m[i] = uint32_t(p[i * 4]) | (uint32_t(p[i * 4 + 1]) << 8) |
             (uint32_t(p[i * 4 + 2]) << 16) | (uint32_t(p[i * 4 + 3]) << 24);
    uint32_t A = a0, B = b0, C = c0, D = d0;
    for (int i = 0; i < 64; i++) {
      uint32_t F;
      int g;
      if (i < 16) { F = (B & C) | (~B & D); g = i; }
      else if (i < 32) { F = (D & B) | (~D & C); g = (5 * i + 1) % 16; }
      else if (i < 48) { F = B ^ C ^ D; g = (3 * i + 5) % 16; }
      else { F = C ^ (B | ~D); g = (7 * i) % 16; }
      F = F + A + K[i] + m[g];
      A = D; D = C; C = B;
      B = B + rotl(F, S[i]);
    }
    a0 += A; b0 += B; c0 += C; d0 += D;
  }

  void update(const uint8_t* data, size_t n) {
    len += n;
    if (buf_len) {
      size_t take = 64 - buf_len;
      if (take > n) take = n;
      memcpy(buf + buf_len, data, take);
      buf_len += take;
      data += take;
      n -= take;
      if (buf_len == 64) {
        block(buf);
        buf_len = 0;
      }
    }
    while (n >= 64) {
      block(data);
      data += 64;
      n -= 64;
    }
    if (n) {
      memcpy(buf, data, n);
      buf_len = n;
    }
  }

  void final(uint8_t out[16]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buf_len != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bits >> (i * 8));
    update(lenb, 8);
    uint32_t hs[4] = {a0, b0, c0, d0};
    for (int i = 0; i < 4; i++) {
      out[i * 4] = uint8_t(hs[i]);
      out[i * 4 + 1] = uint8_t(hs[i] >> 8);
      out[i * 4 + 2] = uint8_t(hs[i] >> 16);
      out[i * 4 + 3] = uint8_t(hs[i] >> 24);
    }
  }
};

// ---------------------------------------------------------------- crc32c

uint32_t crc32c_table[256];
bool crc32c_init_done = false;

void crc32c_init() {
  if (crc32c_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++)
      c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    crc32c_table[i] = c;
  }
  crc32c_init_done = true;
}

uint32_t crc32c(const uint8_t* data, size_t n, uint32_t crc) {
  crc = crc ^ 0xFFFFFFFFu;
#if defined(__SSE4_2__)
  while (n >= 8) {
    crc = uint32_t(_mm_crc32_u64(crc, *reinterpret_cast<const uint64_t*>(data)));
    data += 8;
    n -= 8;
  }
  while (n--) crc = _mm_crc32_u8(crc, *data++);
#else
  crc32c_init();
  while (n--) crc = crc32c_table[(crc ^ *data++) & 0xFF] ^ (crc >> 8);
#endif
  return crc ^ 0xFFFFFFFFu;
}

void to_hex(const uint8_t* digest, size_t n, char* out) {
  static const char* hex = "0123456789abcdef";
  for (size_t i = 0; i < n; i++) {
    out[i * 2] = hex[digest[i] >> 4];
    out[i * 2 + 1] = hex[digest[i] & 0xF];
  }
  out[n * 2] = 0;
}

}  // namespace

extern "C" {

// Hex digest of data under algo ("sha256" | "md5" | "crc32c").
// Returns 0 on success, -1 on unknown algo / small buffer.
int df_hash(const char* algo, const uint8_t* data, size_t n, char* hex_out,
            size_t hex_cap) {
  if (strcmp(algo, "sha256") == 0) {
    if (hex_cap < 65) return -1;
    Sha256 h;
    h.update(data, n);
    uint8_t d[32];
    h.final(d);
    to_hex(d, 32, hex_out);
    return 0;
  }
  if (strcmp(algo, "md5") == 0) {
    if (hex_cap < 33) return -1;
    Md5 h;
    h.update(data, n);
    uint8_t d[16];
    h.final(d);
    to_hex(d, 16, hex_out);
    return 0;
  }
  if (strcmp(algo, "crc32c") == 0) {
    if (hex_cap < 9) return -1;
    uint32_t c = crc32c(data, n, 0);
    snprintf(hex_out, hex_cap, "%08x", c);
    return 0;
  }
  return -1;
}

// Chainable crc32c: feed chunks with the previous call's return as seed.
// Matches the pure-Python _crc32c_py(data, crc) contract.
uint32_t df_crc32c(const uint8_t* data, size_t n, uint32_t seed) {
  return crc32c(data, n, seed);
}

// ---------------------------------------------------------------- piece IO

// Verify-and-persist in ONE pass: pwrite() the piece at its content offset
// while folding the bytes into crc32c. The Python path hashes the buffer
// and then writes it (two full memory traversals plus file-object
// overhead); fusing them halves memory traffic on the piece-landing hot
// path. Returns 0 and the final crc via *crc_out, or -errno.
int df_piece_write(const char* path, uint64_t offset, const uint8_t* data,
                   size_t n, uint32_t* crc_out) {
  int fd = open(path, O_WRONLY);
  if (fd < 0) return -errno;
  size_t done = 0;
  uint32_t crc = 0;
  const size_t kChunk = 4u << 20;
  while (done < n) {
    size_t want = n - done < kChunk ? n - done : kChunk;
    ssize_t w = pwrite(fd, data + done, want, (off_t)(offset + done));
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;   // PEP 475 parity
      int err = errno ? errno : 5;
      close(fd);
      return -err;
    }
    crc = crc32c(data + done, (size_t)w, crc);
    done += (size_t)w;
  }
  close(fd);
  if (crc_out) *crc_out = crc;
  return 0;
}

// Fused SPAN landing: pwrite() a whole contiguous multi-piece span at its
// content offset through an ALREADY-OPEN fd (the Python side caches one
// per task — open/close per piece was measurable at fan-out) while folding
// each piece's crc32c in the SAME traversal. One buffer walk verifies and
// persists N pieces; per-piece crcs land in crcs_out[i] so the caller can
// reject a corrupt piece without failing its groupmates (the bytes of a
// rejected piece are on disk but never recorded, so the region stays
// "absent" and the retry re-writes it — same safety story as
// df_piece_write). Returns 0, or -errno on IO failure.
int df_span_write(int fd, uint64_t offset, const uint8_t* data,
                  const uint64_t* piece_sizes, size_t n_pieces,
                  uint32_t* crcs_out) {
  size_t pos = 0;
  const size_t kChunk = 4u << 20;
  for (size_t i = 0; i < n_pieces; i++) {
    size_t n = (size_t)piece_sizes[i];
    uint32_t crc = 0;
    size_t done = 0;
    while (done < n) {
      size_t want = n - done < kChunk ? n - done : kChunk;
      ssize_t w = pwrite(fd, data + pos + done, want,
                         (off_t)(offset + pos + done));
      if (w <= 0) {
        if (w < 0 && errno == EINTR) continue;   // PEP 475 parity
        return -(errno ? errno : 5);
      }
      crc = crc32c(data + pos + done, (size_t)w, crc);
      done += (size_t)w;
    }
    if (crcs_out) crcs_out[i] = crc;
    pos += n;
  }
  return 0;
}

// pread() a piece straight into the caller's buffer (no Python file
// object, no intermediate copies). Returns bytes read or -errno; short
// reads past EOF return what was available.
int64_t df_piece_read(const char* path, uint64_t offset, uint8_t* out,
                      size_t n) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  size_t done = 0;
  while (done < n) {
    ssize_t r = pread(fd, out + done, n - done, (off_t)(offset + done));
    if (r < 0) {
      if (errno == EINTR) continue;            // PEP 475 parity
      int err = errno ? errno : 5;
      close(fd);
      return -err;
    }
    if (r == 0) break;
    done += (size_t)r;
  }
  close(fd);
  return (int64_t)done;
}



}  // extern "C"
