// Kernel B1: batched RFC 7693 BLAKE2b over B items of variable length.
//
// Replaces the TPU kernel dat_replication_protocol_tpu/ops/blake2b_pallas.py
// blake2b_native (body _kernel, :128), which walks a (batch tile, block)
// grid with the chaining state in VMEM scratch and the batch split (8, B/8)
// across vector sublanes.  None of that layout carries over.  Blocks past
// an item's end are skipped, which is what the reference's active mask
// makes of them; the final flag and the counter t = min(len, (k+1)*128)
// are computed as in blake2b_pallas.py:157-167.
//
// Input: mh/ml (B, nblocks, 16) uint32 hi/lo message words (int32 storage
// on the PyTorch side), lengths (B,) int32.  Output: hh/hl (B, 8) hi/lo
// digest words.  The kernels allocate nothing and launch on the caller's
// stream; dat_blake2b_packed returns cudaGetLastError().
//
// What bounds it: the serial chain.  Each block's compression chains into
// the next, so an item's blocks never run in parallel, and one compression
// is 24 half-rounds of a G mix whose 15 32-bit instructions depend on each
// other: 363 dependent steps in the one-thread variant's SASS.  An item of
// n blocks therefore takes at least n x that path x the dependent-issue
// latency of the integer pipes, whatever the card's throughput.  For the
// digest session's blob bucket (32 items of 8,192 blocks) that chain bound
// lies two orders of magnitude above the operation and byte bounds; only
// when many short items fill the card (entry()'s 2^20 items of 2 blocks)
// does the rate of the integer pipes bound it (chip_smoke.py b1_bound).
//
// A warp issues in order, so one warp alone on a scheduler waits out every
// dependent step that its instruction order does not fill with independent
// work.  The design, in two variants (ops/blake2b_cuda.py lanes_per_item
// picks one from the batch size):
//
// * blake2b_thread_kernel, one thread per item, for large batches.  The
//   four G mixes of a half-round are written in lockstep
//   (blake2b_compress.cuh g4), state and message stay in registers, and
//   block k+1's message is loaded into a second register set while block
//   k is compressed.  ptxas still orders the four chains so that a lone
//   warp issues on fewer than half of its cycles (PERF.md); with
//   many warps a scheduler fills the rest from other warps, and the
//   integer pipes bound it.
// * blake2b_quad_kernel, four lanes per item (the SIMD BLAKE2b layout), for
//   batches of at most 16,384 items.  Lane c holds column c of the state
//   and runs one G per half-round, a quarter of the instructions, so four
//   times as many warps share the work of few items.  Between the column
//   and diagonal steps rows a, c and d move across the four lanes with
//   __shfl_sync while row b stays: b is the last word a G finishes and the
//   first the next G needs, so no shuffle sits at the head of a mix.  A
//   warp holds 8 items; their message blocks are staged into a two-stage
//   shared-memory ring with cp.async, kStage blocks an item at a time in
//   coalesced 256-byte runs, and each lane reads its words through the RFC
//   7693 schedule from there.
//
// The chained entry, dat_blake2b_update, replaces the reference's streaming
// core dat_replication_protocol_tpu/ops/blake2b.py blake2b_update (:383), a
// jax.jit scan over compress_soa rather than a Pallas kernel.  It runs the
// same two variants on the same round code (the kChained instances of the
// bodies below): each item starts from its own chaining state and 64-bit
// byte counter instead of the IV, sets the final flag only when its segment
// is the last, and hands back all eight state words and the advanced
// counter.  Its rules are the reference's: block k's counter is
// t + min(seg_len, (k+1)*128); non-final segments are whole blocks; the
// empty message (a zero-length last segment at t = 0) compresses one zero
// block, and blocks past a segment's end are not compressed.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blake2b_compress.cuh"

namespace {

using dat::rotr64;

constexpr int kThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

// Blocks an item compresses: ceil(len/128), and one for the empty message
// (a zero-length last segment at counter 0).  The one-shot hash is the case
// t0 = 0, last.
__device__ __forceinline__ int item_block_count(uint64_t len, uint64_t t0,
                                                bool last) {
  const int n = static_cast<int>((len + 127) >> 7);
  return n == 0 && last && t0 == 0 ? 1 : n;
}

// The chained entry's operands per item; unused by the one-shot hash.
struct Chain {
  const uint32_t* state_h;  // (B, 8) chaining state in
  const uint32_t* state_l;
  const int32_t* t_hi;      // (B,) byte counter in
  const int32_t* t_lo;
  const uint8_t* is_last;   // (B,) bool
  int32_t* out_t_hi;        // (B,) byte counter out
  int32_t* out_t_lo;
};

// item i's starting state, counter and last flag
template <bool kChained>
__device__ __forceinline__ void item_start(const Chain& ch, int i,
                                           int digest_size, uint64_t (&h)[8],
                                           uint64_t& t0, bool& last) {
  if (kChained) {
#pragma unroll
    for (int w = 0; w < 8; ++w)
      h[w] = dat::join64(ch.state_h[i * 8 + w], ch.state_l[i * 8 + w]);
    t0 = dat::join64(static_cast<uint32_t>(ch.t_hi[i]),
                     static_cast<uint32_t>(ch.t_lo[i]));
    last = ch.is_last[i] != 0;
  } else {
    dat::blake2b_init(h, digest_size);
    t0 = 0;
    last = true;
  }
}

template <bool kChained>
__device__ __forceinline__ void item_counter_out(const Chain& ch, int i,
                                                 uint64_t t) {
  if (kChained) {
    ch.out_t_hi[i] = static_cast<int32_t>(t >> 32);
    ch.out_t_lo[i] = static_cast<int32_t>(t);
  }
}

__device__ __forceinline__ void load_block(const uint4* ph, const uint4* pl,
                                           int k, uint4 (&bh)[4],
                                           uint4 (&bl)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bh[q] = __ldg(ph + k * 4 + q);
    bl[q] = __ldg(pl + k * 4 + q);
  }
}

template <bool kChained>
__device__ __forceinline__ void thread_body(const uint32_t* __restrict__ mh,
                                            const uint32_t* __restrict__ ml,
                                            const int32_t* __restrict__ lengths,
                                            uint32_t* __restrict__ out_h,
                                            uint32_t* __restrict__ out_l,
                                            int batch, int nblocks,
                                            int digest_size, const Chain& ch) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch) return;
  const uint64_t len = static_cast<uint32_t>(lengths[i]);
  uint64_t h[8], t0;
  bool last;
  item_start<kChained>(ch, i, digest_size, h, t0, last);
  const int item_blocks = item_block_count(len, t0, last);
  // a length past the padded width never reaches its final block, as in
  // the reference's masked scan
  const int steps = item_blocks < nblocks ? item_blocks : nblocks;

  const size_t row = static_cast<size_t>(i) * nblocks * 16;
  const uint4* ph = reinterpret_cast<const uint4*>(mh + row);
  const uint4* pl = reinterpret_cast<const uint4*>(ml + row);
  uint4 bh[4], bl[4];
  load_block(ph, pl, 0, bh, bl);
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    uint64_t m[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      m[4 * q + 0] = dat::join64(bh[q].x, bl[q].x);
      m[4 * q + 1] = dat::join64(bh[q].y, bl[q].y);
      m[4 * q + 2] = dat::join64(bh[q].z, bl[q].z);
      m[4 * q + 3] = dat::join64(bh[q].w, bl[q].w);
    }
    // block k+1's message is in flight while block k is compressed
    if (k + 1 < steps) load_block(ph, pl, k + 1, bh, bl);
    const uint64_t cap = static_cast<uint64_t>(k + 1) << 7;
    const uint64_t t = t0 + (cap < len ? cap : len);
    dat::blake2b_compress(h, m, t, last && k == item_blocks - 1);
  }

#pragma unroll
  for (int w = 0; w < 8; ++w) {
    out_h[i * 8 + w] = static_cast<uint32_t>(h[w] >> 32);
    out_l[i * 8 + w] = static_cast<uint32_t>(h[w]);
  }
  item_counter_out<kChained>(ch, i, t0 + len);
}

__global__ void __launch_bounds__(kThreads)
blake2b_thread_kernel(const uint32_t* __restrict__ mh,
                      const uint32_t* __restrict__ ml,
                      const int32_t* __restrict__ lengths,
                      uint32_t* __restrict__ out_h,
                      uint32_t* __restrict__ out_l, int batch, int nblocks,
                      int digest_size) {
  thread_body<false>(mh, ml, lengths, out_h, out_l, batch, nblocks,
                     digest_size, Chain{});
}

__global__ void __launch_bounds__(kThreads)
blake2b_update_thread_kernel(const uint32_t* __restrict__ mh,
                             const uint32_t* __restrict__ ml,
                             const int32_t* __restrict__ lengths,
                             uint32_t* __restrict__ out_h,
                             uint32_t* __restrict__ out_l, int batch,
                             int nblocks, Chain ch) {
  thread_body<true>(mh, ml, lengths, out_h, out_l, batch, nblocks, 0, ch);
}

// ---------------------------------------------------------------------------
// four lanes per item
// ---------------------------------------------------------------------------

constexpr int kQuadItems = 8;  // items per warp; one warp per block
constexpr int kStage = 4;      // blocks of each item in one ring stage
// an item's slot in a stage: kStage blocks of hi words, then of lo words,
// then 4 words of padding.  The 8 items of a warp read the same schedule
// positions at once; a stride of 132 words (4 banks apart) spreads them to
// about 2-way bank conflicts over the schedule, against 8-way at 128.
constexpr int kItemWords = 2 * kStage * 16 + 4;

__constant__ uint64_t kIV[8] = {DAT_B2B_IV0, DAT_B2B_IV1, DAT_B2B_IV2,
                                DAT_B2B_IV3, DAT_B2B_IV4, DAT_B2B_IV5,
                                DAT_B2B_IV6, DAT_B2B_IV7};
// RFC 7693 section 2.7; rounds 10 and 11 reuse rows 0 and 1
__constant__ uint8_t kSigma[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};

// x from lane `from` (mod 4) of the same item's four
__device__ __forceinline__ uint64_t from_lane(uint64_t x, int from) {
  return __shfl_sync(kFullMask, static_cast<unsigned long long>(x), from & 3,
                     4);
}

// message word idx of a staged block: hi at bh[idx], lo kStage blocks on
__device__ __forceinline__ uint64_t staged_word(const uint32_t* bh,
                                                uint32_t idx) {
  return dat::join64(bh[idx], bh[kStage * 16 + idx]);
}

// Stage blocks [chunk*kStage, chunk*kStage + kStage) of the warp's items
// into one ring slot with cp.async: per item a 256-byte run of hi words and
// one of lo words, 16 bytes a lane, so each run is one coalesced request.
// Blocks at or past an item's step count are not copied.
__device__ __forceinline__ void stage_chunk(uint32_t* slot_base,
                                            const uint32_t* __restrict__ mh,
                                            const uint32_t* __restrict__ ml,
                                            int item0, int nblocks, int steps,
                                            int chunk, int lane) {
  const int half = lane >> 4;       // 0: hi words, 1: lo words
  const int piece = lane & 15;      // 16-byte piece of the run
  const int blk = chunk * kStage + (piece >> 2);
  const uint32_t* src = half ? ml : mh;
#pragma unroll
  for (int s = 0; s < kQuadItems; ++s) {
    const int item_steps = __shfl_sync(kFullMask, steps, s * 4);
    if (blk < item_steps) {
      const size_t at = (static_cast<size_t>(item0 + s) * nblocks + blk) * 16 +
                        (piece & 3) * 4;
      __pipeline_memcpy_async(
          slot_base + s * kItemWords + half * kStage * 16 + piece * 4,
          src + at, 16);
    }
  }
  __pipeline_commit();
}

template <bool kChained>
__device__ __forceinline__ void quad_body(const uint32_t* __restrict__ mh,
                                          const uint32_t* __restrict__ ml,
                                          const int32_t* __restrict__ lengths,
                                          uint32_t* __restrict__ out_h,
                                          uint32_t* __restrict__ out_l,
                                          int batch, int nblocks,
                                          int digest_size, const Chain& ch) {
  __shared__ __align__(16) uint32_t ring[2][kQuadItems * kItemWords];
  const int lane = threadIdx.x;
  const int col = lane & 3;
  const int slot = lane >> 2;
  const int item0 = blockIdx.x * kQuadItems;
  const int i = item0 + slot;
  const bool live = i < batch;
  const uint64_t len = live ? static_cast<uint32_t>(lengths[i]) : 0;
  uint64_t t0 = 0;
  bool last = true;
  if (kChained && live) {
    t0 = dat::join64(static_cast<uint32_t>(ch.t_hi[i]),
                     static_cast<uint32_t>(ch.t_lo[i]));
    last = ch.is_last[i] != 0;
  }
  const int item_blocks = item_block_count(len, t0, last);
  const int steps = !live ? 0 : item_blocks < nblocks ? item_blocks : nblocks;
  int warp_steps = steps;
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    const int other = __shfl_xor_sync(kFullMask, warp_steps, off);
    warp_steps = other > warp_steps ? other : warp_steps;
  }

  // Lane col runs column mix col, then diagonal mix (col + 3) & 3: the one
  // whose b word, v[4 + col], the lane already holds, so row b never
  // moves.  This lane's message schedule: four 4-bit word indices a round
  // (x and y of its column mix, x and y of its diagonal mix), two rounds a
  // word.
  const int diag = (col + 3) & 3;
  uint32_t sched[6];
#pragma unroll
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = kSigma[r % 10];
    const uint32_t q = s[2 * col] | (s[2 * col + 1] << 4) |
                       (s[8 + 2 * diag] << 8) | (s[9 + 2 * diag] << 12);
    sched[r >> 1] = (r & 1) ? sched[r >> 1] | (q << 16) : q;
  }

  // column col of the chaining state: h[col] and h[4 + col]
  uint64_t h0, h1;
  if (kChained) {
    h0 = live ? dat::join64(ch.state_h[i * 8 + col], ch.state_l[i * 8 + col])
              : 0;
    h1 = live ? dat::join64(ch.state_h[i * 8 + 4 + col],
                            ch.state_l[i * 8 + 4 + col])
              : 0;
  } else {
    h0 = kIV[col] ^
         (col == 0 ? 0x01010000ULL ^ static_cast<uint64_t>(digest_size)
                   : 0ULL);
    h1 = kIV[4 + col];
  }
  const uint64_t iv_c = kIV[col];
  const uint64_t iv_d = kIV[4 + col];

  const int nchunks = (warp_steps + kStage - 1) / kStage;
  stage_chunk(ring[0], mh, ml, item0, nblocks, steps, 0, lane);
  stage_chunk(ring[1], mh, ml, item0, nblocks, steps, 1, lane);
  for (int c = 0; c < nchunks; ++c) {
    __pipeline_wait_prior(1);  // this lane's copies of chunk c have landed
    __syncwarp();              // and every other lane's
    const uint32_t* staged = ring[c & 1] + slot * kItemWords;
#pragma unroll 1
    for (int j = 0; j < kStage; ++j) {
      const int k = c * kStage + j;
      if (k >= warp_steps) break;
      const uint32_t* bh = staged + j * 16;
      const uint64_t cap = static_cast<uint64_t>(k + 1) << 7;
      const uint64_t t = t0 + (cap < len ? cap : len);
      uint64_t a = h0, b = h1, cc = iv_c;
      uint64_t d = iv_d ^ (col == 0 ? t : 0ULL) ^
                   (col == 2 && last && k == item_blocks - 1 ? ~0ULL : 0ULL);
#pragma unroll
      for (int r = 0; r < 12; ++r) {
        const uint32_t q = sched[r >> 1] >> ((r & 1) * 16);
        DAT_B2B_G(a, b, cc, d, staged_word(bh, q & 15),
                  staged_word(bh, (q >> 4) & 15));
        // diagonal (col + 3) & 3 is v[col - 1], v[4 + col], v[8 + col + 1],
        // v[12 + col + 2]: a, c and d come from the lanes of those columns.
        // a is final six dependent steps before the mix ends, c and d need
        // not arrive before the mix's third and fifth steps, so the
        // shuffles' latency overlaps the chain instead of adding to it.
        a = from_lane(a, col + 3);
        cc = from_lane(cc, col + 1);
        d = from_lane(d, col + 2);
        DAT_B2B_G(a, b, cc, d, staged_word(bh, (q >> 8) & 15),
                  staged_word(bh, (q >> 12) & 15));
        // back to columns: v[col] is in lane col + 1, v[8 + col] in lane
        // col - 1, v[12 + col] in lane col + 2
        a = from_lane(a, col + 1);
        cc = from_lane(cc, col + 3);
        d = from_lane(d, col + 2);
      }
      if (k < steps) {
        h0 ^= a ^ cc;
        h1 ^= b ^ d;
      }
    }
    __syncwarp();  // every lane is done with this ring slot
    stage_chunk(ring[c & 1], mh, ml, item0, nblocks, steps, c + 2, lane);
  }
  if (live) {
    out_h[i * 8 + col] = static_cast<uint32_t>(h0 >> 32);
    out_l[i * 8 + col] = static_cast<uint32_t>(h0);
    out_h[i * 8 + 4 + col] = static_cast<uint32_t>(h1 >> 32);
    out_l[i * 8 + 4 + col] = static_cast<uint32_t>(h1);
    if (col == 0) item_counter_out<kChained>(ch, i, t0 + len);
  }
}

__global__ void __launch_bounds__(32)
blake2b_quad_kernel(const uint32_t* __restrict__ mh,
                    const uint32_t* __restrict__ ml,
                    const int32_t* __restrict__ lengths,
                    uint32_t* __restrict__ out_h,
                    uint32_t* __restrict__ out_l, int batch, int nblocks,
                    int digest_size) {
  quad_body<false>(mh, ml, lengths, out_h, out_l, batch, nblocks, digest_size,
                   Chain{});
}

__global__ void __launch_bounds__(32)
blake2b_update_quad_kernel(const uint32_t* __restrict__ mh,
                           const uint32_t* __restrict__ ml,
                           const int32_t* __restrict__ lengths,
                           uint32_t* __restrict__ out_h,
                           uint32_t* __restrict__ out_l, int batch,
                           int nblocks, Chain ch) {
  quad_body<true>(mh, ml, lengths, out_h, out_l, batch, nblocks, 0, ch);
}

}  // namespace

// lanes: 1 (blake2b_thread_kernel) or 4 (blake2b_quad_kernel)
extern "C" int dat_blake2b_packed(const void* mh, const void* ml,
                                  const void* lengths, void* out_h,
                                  void* out_l, int batch, int nblocks,
                                  int digest_size, int lanes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint32_t*>(mh);
  const auto* l = static_cast<const uint32_t*>(ml);
  const auto* n = static_cast<const int32_t*>(lengths);
  auto* oh = static_cast<uint32_t*>(out_h);
  auto* ol = static_cast<uint32_t*>(out_l);
  if (lanes != 1 && lanes != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && lanes == 1) {
    const int grid = (batch + kThreads - 1) / kThreads;
    blake2b_thread_kernel<<<grid, kThreads, 0, s>>>(h, l, n, oh, ol, batch,
                                                    nblocks, digest_size);
  } else if (batch > 0) {
    const int grid = (batch + kQuadItems - 1) / kQuadItems;
    blake2b_quad_kernel<<<grid, 32, 0, s>>>(h, l, n, oh, ol, batch, nblocks,
                                            digest_size);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chained entry: advance B chaining states over one packed segment each.
// state_h/state_l (B, 8) and t_hi/t_lo (B,) in; out_h/out_l (B, 8) and
// out_t_hi/out_t_lo (B,) out; is_last (B,) bool.  lanes: 1
// (blake2b_update_thread_kernel) or 4 (blake2b_update_quad_kernel).
extern "C" int dat_blake2b_update(const void* state_h, const void* state_l,
                                  const void* t_hi, const void* t_lo,
                                  const void* mh, const void* ml,
                                  const void* seg_lengths, const void* is_last,
                                  void* out_h, void* out_l, void* out_t_hi,
                                  void* out_t_lo, int batch, int nblocks,
                                  int lanes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* h = static_cast<const uint32_t*>(mh);
  const auto* l = static_cast<const uint32_t*>(ml);
  const auto* n = static_cast<const int32_t*>(seg_lengths);
  auto* oh = static_cast<uint32_t*>(out_h);
  auto* ol = static_cast<uint32_t*>(out_l);
  const Chain ch{static_cast<const uint32_t*>(state_h),
                 static_cast<const uint32_t*>(state_l),
                 static_cast<const int32_t*>(t_hi),
                 static_cast<const int32_t*>(t_lo),
                 static_cast<const uint8_t*>(is_last),
                 static_cast<int32_t*>(out_t_hi),
                 static_cast<int32_t*>(out_t_lo)};
  if (lanes != 1 && lanes != 4) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && lanes == 1) {
    const int grid = (batch + kThreads - 1) / kThreads;
    blake2b_update_thread_kernel<<<grid, kThreads, 0, s>>>(h, l, n, oh, ol,
                                                           batch, nblocks, ch);
  } else if (batch > 0) {
    const int grid = (batch + kQuadItems - 1) / kQuadItems;
    blake2b_update_quad_kernel<<<grid, 32, 0, s>>>(h, l, n, oh, ol, batch,
                                                   nblocks, ch);
  }
  return static_cast<int>(cudaGetLastError());
}
