// The gear rolling hash shared by kernels B3-B6.
//
// h = (h << 1) + g(b) on a native 64-bit state, with
// g(b) = ((b+1)*C1 mod 2^32) | ((b+1)*C2 mod 2^32) << 32 from two 32-bit
// multiplies, and a candidate where (h >> 32) & (2^avg_bits - 1) == 0
// (the reference's ops/rabin.py _gear_step and hit test, :89-145).
//
// Rows are the (T, S) byte rows of rabin._build_rows; the state is zero
// at each row start.  A byte leaves the state after 64 steps, so a thread
// may start a scan anywhere in a row once it has replayed the 64 bytes
// before its start from a zero state (gear_warm): the state it reaches
// is bit-identical to the serial chain's.  A scan at the row start needs
// no warm-up, as the chain itself starts from zero there.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dat {

// The multipliers are plain hex literals (unsigned by their size) under
// the Python names, so the wire-constant check holds them to ops/rabin.py.
constexpr uint32_t GEAR_C1 = 0x9E3779B1;
constexpr uint32_t GEAR_C2 = 0x85EBCA77;
constexpr int kGearWindow = 64;  // bytes the state remembers
constexpr int kGroup = 256;      // bytes per scan group
constexpr int kPack = 32;        // candidate bits per packed word
constexpr uint32_t kNoHit = kGroup;         // B4: group without a hit
constexpr uint32_t kEmptyWindow = 1u << 30; // B5/B6: window without a hit

__device__ __forceinline__ uint64_t gear_step(uint64_t h, uint32_t byte) {
  const uint32_t v = byte + 1u;
  const uint64_t g = (static_cast<uint64_t>(v * GEAR_C2) << 32) | (v * GEAR_C1);
  return (h << 1) + g;
}

__device__ __forceinline__ bool gear_hit(uint64_t h, uint32_t mask) {
  return (static_cast<uint32_t>(h >> 32) & mask) == 0u;
}

// Steps the four bytes of a little-endian word; returns their hit bits
// in bits 0-3.
__device__ __forceinline__ uint32_t gear_word(uint64_t& h, uint32_t w,
                                              uint32_t mask) {
  uint32_t bits = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    h = gear_step(h, (w >> (8 * s)) & 0xFFu);
    bits |= static_cast<uint32_t>(gear_hit(h, mask)) << s;
  }
  return bits;
}

// The state just before byte p of a row (p a multiple of 16): zero at the
// row start, else the 64 bytes before p replayed from zero.
__device__ __forceinline__ uint64_t gear_warm(const uint4* __restrict__ row,
                                              int p) {
  uint64_t h = 0;
  if (p == 0) return h;
  const uint4* src = row + (p - kGearWindow) / 16;
#pragma unroll
  for (int q = 0; q < kGearWindow / 16; ++q) {
    const uint4 v = src[q];
    gear_word(h, v.x, 0u);
    gear_word(h, v.y, 0u);
    gear_word(h, v.z, 0u);
    gear_word(h, v.w, 0u);
  }
  return h;
}

// Scans one 256-byte group starting at row byte p (a multiple of 16),
// 16 bytes a load, and hands each packed word of 32 hit bits to
// on_word(k, bits), k = 0..7.
template <class F>
__device__ __forceinline__ void gear_group(const uint4* __restrict__ row,
                                           int p, uint64_t& h, uint32_t mask,
                                           F&& on_word) {
  const uint4* src = row + p / 16;
#pragma unroll
  for (int k = 0; k < kGroup / kPack; ++k) {
    const uint4 a = src[2 * k];
    const uint4 b = src[2 * k + 1];
    uint32_t bits = gear_word(h, a.x, mask);
    bits |= gear_word(h, a.y, mask) << 4;
    bits |= gear_word(h, a.z, mask) << 8;
    bits |= gear_word(h, a.w, mask) << 12;
    bits |= gear_word(h, b.x, mask) << 16;
    bits |= gear_word(h, b.y, mask) << 20;
    bits |= gear_word(h, b.z, mask) << 24;
    bits |= gear_word(h, b.w, mask) << 28;
    on_word(k, bits);
  }
}

// The group-local offset of the first set bit of a group's eight packed
// hit words (its first candidate), or kNoHit; taken after the group is
// scanned, off the gear chain.
__device__ __forceinline__ uint32_t group_first(
    const uint32_t (&w)[kGroup / kPack]) {
  uint32_t out = kNoHit;
#pragma unroll
  for (int k = kGroup / kPack - 1; k >= 0; --k)
    if (w[k] != 0u) out = k * kPack + (__ffs(w[k]) - 1);
  return out;
}

// B5 and B6: the first candidate of payload window w of a row (window w
// covers row bytes [256 + w*2^thin_bits, 256 + (w+1)*2^thin_bits): group
// 0 is warm-up and never counts), scanned by one thread after a 64-byte
// warm-up.  Each group's eight packed hit words stay in registers until
// the group is scanned, so nothing but the gear chain sits between the
// loads and ptxas can hoist them; the group's first hit is taken after
// it and kept while the window has none.  kOcc (B6) also ORs the raw
// words into *occ, on a path that never reads the first-hit state, so
// the two cross-check each other.  Returns the in-window byte offset of
// the first candidate, or kEmptyWindow.
template <bool kOcc>
__device__ __forceinline__ uint32_t gear_window_scan(
    const uint4* __restrict__ row, int w, int thin_bits, uint32_t mask,
    uint32_t* occ) {
  const int gpw = (1 << thin_bits) / kGroup;
  const int p0 = kGroup + (w << thin_bits);
  uint64_t h = gear_warm(row, p0);
  uint32_t f = kEmptyWindow, any = 0;
  for (int g = 0; g < gpw; ++g) {
    uint32_t wd[kGroup / kPack];
    gear_group(row, p0 + g * kGroup, h, mask,
               [&](int k, uint32_t b) { wd[k] = b; });
    const uint32_t gf = group_first(wd);
    if (f == kEmptyWindow && gf != kNoHit) f = g * kGroup + gf;
    if constexpr (kOcc)
      any |= wd[0] | wd[1] | wd[2] | wd[3] | wd[4] | wd[5] | wd[6] | wd[7];
  }
  if constexpr (kOcc) *occ = any;
  return f;
}

}  // namespace dat
