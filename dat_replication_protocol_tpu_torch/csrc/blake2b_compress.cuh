// One RFC 7693 BLAKE2b compression on native 64-bit words, shared by the
// batched hash kernel (blake2b.cu) and the Merkle level kernel
// (merkle_level.cu).  The JAX package emulates 64-bit lanes as (hi, lo)
// uint32 pairs because the TPU's vector unit has no 64-bit integers
// (dat_replication_protocol_tpu/ops/u64.py); on Hopper a uint64_t lives in
// a register pair and every rotate below is two funnel shifts (or a free
// swap for 32), so the pair emulation is not carried over.
//
// Every index into v[] and m[] is a compile-time constant after the round
// macros expand, so both arrays stay in registers: 16 + 16 words of state
// and message, 64 registers, plus temporaries.
#pragma once

#include <stdint.h>

namespace dat {

__device__ __forceinline__ uint64_t rotr64(uint64_t x, const int n) {
  const uint32_t lo = static_cast<uint32_t>(x);
  const uint32_t hi = static_cast<uint32_t>(x >> 32);
  uint32_t nlo, nhi;
  if (n == 32) {
    nlo = hi;
    nhi = lo;
  } else if (n < 32) {
    nlo = __funnelshift_r(lo, hi, n);
    nhi = __funnelshift_r(hi, lo, n);
  } else {
    nlo = __funnelshift_r(hi, lo, n - 32);
    nhi = __funnelshift_r(lo, hi, n - 32);
  }
  return (static_cast<uint64_t>(nhi) << 32) | nlo;
}

// one G mix on one column or diagonal (the four-lanes-per-item kernel runs
// one of these per lane)
#define DAT_B2B_G(a, b, c, d, x, y) \
  do {                              \
    a = a + b + (x);                \
    d = rotr64(d ^ a, 32);          \
    c = c + d;                      \
    b = rotr64(b ^ c, 24);          \
    a = a + b + (y);                \
    d = rotr64(d ^ a, 16);          \
    c = c + d;                      \
    b = rotr64(b ^ c, 63);          \
  } while (0)

// The four G mixes of a half-round in lockstep: each step of G is applied
// to all four columns (or diagonals) before the next step, so the four
// independent dependence chains sit side by side for ptxas to interleave.
// One G is a chain of 15 dependent 32-bit instructions (a 64-bit add is
// two, low word then high word through the carry); the lockstep form
// leaves four instructions of other mixes beside each of them.
__device__ __forceinline__ void g4(uint64_t& a0, uint64_t& a1, uint64_t& a2,
                                   uint64_t& a3, uint64_t& b0, uint64_t& b1,
                                   uint64_t& b2, uint64_t& b3, uint64_t& c0,
                                   uint64_t& c1, uint64_t& c2, uint64_t& c3,
                                   uint64_t& d0, uint64_t& d1, uint64_t& d2,
                                   uint64_t& d3, uint64_t x0, uint64_t x1,
                                   uint64_t x2, uint64_t x3, uint64_t y0,
                                   uint64_t y1, uint64_t y2, uint64_t y3) {
  a0 = a0 + b0 + x0; a1 = a1 + b1 + x1; a2 = a2 + b2 + x2; a3 = a3 + b3 + x3;
  d0 = rotr64(d0 ^ a0, 32); d1 = rotr64(d1 ^ a1, 32);
  d2 = rotr64(d2 ^ a2, 32); d3 = rotr64(d3 ^ a3, 32);
  c0 = c0 + d0; c1 = c1 + d1; c2 = c2 + d2; c3 = c3 + d3;
  b0 = rotr64(b0 ^ c0, 24); b1 = rotr64(b1 ^ c1, 24);
  b2 = rotr64(b2 ^ c2, 24); b3 = rotr64(b3 ^ c3, 24);
  a0 = a0 + b0 + y0; a1 = a1 + b1 + y1; a2 = a2 + b2 + y2; a3 = a3 + b3 + y3;
  d0 = rotr64(d0 ^ a0, 16); d1 = rotr64(d1 ^ a1, 16);
  d2 = rotr64(d2 ^ a2, 16); d3 = rotr64(d3 ^ a3, 16);
  c0 = c0 + d0; c1 = c1 + d1; c2 = c2 + d2; c3 = c3 + d3;
  b0 = rotr64(b0 ^ c0, 63); b1 = rotr64(b1 ^ c1, 63);
  b2 = rotr64(b2 ^ c2, 63); b3 = rotr64(b3 ^ c3, 63);
}

// one round: the four column mixes in lockstep, then the four diagonal
// mixes, with the message schedule of RFC 7693 section 2.7 spelled out as
// literals
#define DAT_B2B_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, \
                      s13, s14, s15)                                          \
  do {                                                                        \
    g4(v0, v1, v2, v3, v4, v5, v6, v7, v8, v9, v10, v11, v12, v13, v14, v15,  \
       m[s0], m[s2], m[s4], m[s6], m[s1], m[s3], m[s5], m[s7]);               \
    g4(v0, v1, v2, v3, v5, v6, v7, v4, v10, v11, v8, v9, v15, v12, v13, v14,  \
       m[s8], m[s10], m[s12], m[s14], m[s9], m[s11], m[s13], m[s15]);         \
  } while (0)

// RFC 7693 section 2.6
#define DAT_B2B_IV0 0x6A09E667F3BCC908ULL
#define DAT_B2B_IV1 0xBB67AE8584CAA73BULL
#define DAT_B2B_IV2 0x3C6EF372FE94F82BULL
#define DAT_B2B_IV3 0xA54FF53A5F1D36F1ULL
#define DAT_B2B_IV4 0x510E527FADE682D1ULL
#define DAT_B2B_IV5 0x9B05688C2B3E6C1FULL
#define DAT_B2B_IV6 0x1F83D9ABFB41BD6BULL
#define DAT_B2B_IV7 0x5BE0CD19137E2179ULL

// h0 = IV ^ parameter block (sequential mode, no key): digest length in
// byte 0, fanout 1 and depth 1 in bytes 2 and 3
__device__ __forceinline__ void blake2b_init(uint64_t h[8], int digest_size) {
  h[0] = DAT_B2B_IV0 ^ (0x01010000ULL ^ static_cast<uint64_t>(digest_size));
  h[1] = DAT_B2B_IV1;
  h[2] = DAT_B2B_IV2;
  h[3] = DAT_B2B_IV3;
  h[4] = DAT_B2B_IV4;
  h[5] = DAT_B2B_IV5;
  h[6] = DAT_B2B_IV6;
  h[7] = DAT_B2B_IV7;
}

// h <- F(h, m, t, last): t is the byte count after this block (the high
// counter word is zero: every item is under 2 GiB)
__device__ __forceinline__ void blake2b_compress(uint64_t h[8],
                                                 const uint64_t m[16],
                                                 uint64_t t, bool last) {
  uint64_t v0 = h[0], v1 = h[1], v2 = h[2], v3 = h[3];
  uint64_t v4 = h[4], v5 = h[5], v6 = h[6], v7 = h[7];
  uint64_t v8 = DAT_B2B_IV0, v9 = DAT_B2B_IV1, v10 = DAT_B2B_IV2,
           v11 = DAT_B2B_IV3;
  uint64_t v12 = DAT_B2B_IV4 ^ t, v13 = DAT_B2B_IV5;
  uint64_t v14 = last ? ~DAT_B2B_IV6 : DAT_B2B_IV6, v15 = DAT_B2B_IV7;

  DAT_B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  DAT_B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  DAT_B2B_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  DAT_B2B_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  DAT_B2B_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  DAT_B2B_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  DAT_B2B_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  DAT_B2B_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  DAT_B2B_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  DAT_B2B_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
  // rounds 10 and 11 reuse schedules 0 and 1
  DAT_B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  DAT_B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);

  h[0] ^= v0 ^ v8;
  h[1] ^= v1 ^ v9;
  h[2] ^= v2 ^ v10;
  h[3] ^= v3 ^ v11;
  h[4] ^= v4 ^ v12;
  h[5] ^= v5 ^ v13;
  h[6] ^= v6 ^ v14;
  h[7] ^= v7 ^ v15;
}

// message word k of a block: hi/lo uint32 halves -> one uint64_t
__device__ __forceinline__ uint64_t join64(uint32_t hi, uint32_t lo) {
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

}  // namespace dat
