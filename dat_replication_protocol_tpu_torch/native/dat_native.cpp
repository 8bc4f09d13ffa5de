// Host codec loops of dat_replication_protocol_tpu_torch (plain C ABI,
// loaded with ctypes by runtime/native.py).
//
// A trimmed copy of the JAX package's native/dat_native.cpp: the frame
// splitter, the greedy CDC cut pass, the columnar Change codec and the
// batched-syscall wire pump.  The hash, sketch, rateless and gear
// engines of that file are not here: the port runs that work on the
// card (kernels B1-B6).
//
//   dat_split_frames          multibuffer framing: varint(len+1) | id | payload
//   dat_greedy_select         min/max cut pass over sorted CDC candidates
//   dat_decode_changes[_mt]   proto2 `Change` records -> columnar arrays
//                             (strings/bytes as (offset, len) views)
//   dat_encode_changes[_mt]   columnar arrays -> framed `Change` records
//   dat_encode_change_batch   columnar arrays -> one ChangeBatch payload
//   dat_pump_probe            which batched syscalls the kernel serves
//   dat_pump_recv_scan        batched receive + frame index of the slab
//   dat_pump_send[_nb]        gather-send of (address, length) spans
//
// Two differences from the JAX package's copy: the columnar decoder
// checks that every key and subset occurrence is UTF-8, as the port's
// per-record codec does, so a record the Python route rejects is
// rejected here too (the JAX package's dat_decode_changes accepts it);
// and a blocking gather-send returns -EAGAIN when the fd's SO_SNDTIMEO
// runs out, where the JAX package's retries forever.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (runtime/native.py,
// at first use, into build/torch_host/).

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

namespace {

// Decode one unsigned LEB128 varint at buf[i..len).  Returns the number of
// bytes consumed (0 = truncated, -1 = overlong/>10 bytes).
// The 10-byte cap is the wire limit shared with wire/varint.py; datlint's
// wire-constant-parity rule cross-checks it:  // wire: MAX_VARINT_LEN = 10
inline int read_uvarint(const uint8_t* buf, int64_t i, int64_t len,
                        uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  for (int k = 0; k < 10; ++k) {
    if (i + k >= len) return 0;
    uint8_t b = buf[i + k];
    // 10th byte may only contribute bit 63: anything else encodes a
    // value >= 2^64 (overlong — matches the Python decoder's rejection).
    if (k == 9 && (b & 0x7F) > 1) return -1;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return k + 1;
    }
    shift += 7;
  }
  return -1;
}

// Whether p[0..n) is UTF-8 as Python's strict codec reads it: no
// overlong forms, no surrogates, nothing past U+10FFFF.
inline bool valid_utf8(const uint8_t* p, int64_t n) {
  int64_t i = 0;
  while (i < n) {
    const uint8_t c = p[i];
    if (c < 0x80) {
      ++i;
      continue;
    }
    int need;
    uint32_t cp;
    if (c >= 0xC2 && c <= 0xDF) {
      need = 1;
      cp = c & 0x1F;
    } else if (c >= 0xE0 && c <= 0xEF) {
      need = 2;
      cp = c & 0x0F;
    } else if (c >= 0xF0 && c <= 0xF4) {
      need = 3;
      cp = c & 0x07;
    } else {
      return false;
    }
    if (n - i - 1 < need) return false;
    for (int k = 1; k <= need; ++k) {
      const uint8_t b = p[i + k];
      if ((b & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (b & 0x3F);
    }
    if (need == 2 && (cp < 0x800 || (cp >= 0xD800 && cp <= 0xDFFF)))
      return false;
    if (need == 3 && (cp < 0x10000 || cp > 0x10FFFF)) return false;
    i += need + 1;
  }
  return true;
}

inline int pick_threads(int64_t requested, int64_t n, int64_t min_per) {
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (hw <= 0) hw = 1;
  // an explicit request may exceed the core count (bounded
  // oversubscription is merely slower, and it lets the parallel paths
  // be exercised on small test machines), but never unboundedly; only
  // the auto default (0) clamps to the hardware
  int64_t t = requested > 0 ? requested : hw;
  int64_t ceil_t = hw * 4 < 64 ? hw * 4 : 64;
  if (requested > 0 && t > ceil_t) t = ceil_t;
  if (t > n / min_per) t = n / min_per;  // don't spawn for tiny batches
  return static_cast<int>(t < 1 ? 1 : t);
}

// Run work(lo, hi) over [0, n) split across threads (serial when one
// suffices).
template <class F>
void parallel_for(int64_t n, int64_t nthreads, int64_t min_per, F work) {
  int nt = pick_threads(nthreads, n, min_per);
  if (nt <= 1) {
    work(static_cast<int64_t>(0), n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + nt - 1) / nt;
  for (int64_t k = 0; k < nt; ++k) {
    int64_t lo = k * per, hi = lo + per > n ? n : lo + per;
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Error codes shared by every entry point (runtime/native.py ERR_*).
enum {
  DAT_ERR_TRUNCATED = -1,
  DAT_ERR_CAPACITY = -2,
  DAT_ERR_BAD_VARINT = -3,
  DAT_ERR_BAD_RECORD = -4,
  DAT_ERR_NOMEM = -5,
};

// Split a multibuffer stream into frames.
//
// Returns the count of complete valid frames (<= cap) and fills, per
// frame:
//   starts[f]  byte offset of the payload (after the id byte)
//   lens[f]    payload length (framed length minus the id byte)
//   ids[f]     the 1-byte type id (unvalidated; policy lives above)
// `consumed` gets the offset one past the last complete frame (a partial
// trailing frame is not an error — streaming callers re-feed the tail).
// A malformed header (overlong varint / zero framed length) STOPS the
// scan at that frame: the valid prefix is still returned and `err` gets
// the error code (0 otherwise), so a streaming caller can deliver the
// prefix and surface the error at exactly the offending frame.  Only a
// capacity overflow (caller bug) is a negative return.
int64_t dat_split_frames(const uint8_t* buf, int64_t len, int64_t* starts,
                         int64_t* lens, uint8_t* ids, int64_t cap,
                         int64_t* consumed, int64_t* err) {
  int64_t i = 0;
  int64_t n = 0;
  *consumed = 0;
  *err = 0;
  while (i < len) {
    uint64_t framed;
    int used = read_uvarint(buf, i, len, &framed);
    if (used == 0) break;  // partial header at tail
    if (used < 0) {
      *err = DAT_ERR_BAD_VARINT;
      break;
    }
    if (framed == 0) {  // must include the id byte
      *err = DAT_ERR_BAD_RECORD;
      break;
    }
    // Unsigned compare BEFORE any int64 cast: a hostile length >= 2^63
    // must not wrap negative and walk the cursor backwards.
    uint64_t remaining = static_cast<uint64_t>(len - i) - used;
    if (framed > remaining) break;  // partial frame at tail
    int64_t payload = static_cast<int64_t>(framed) - 1;
    int64_t frame_end = i + used + 1 + payload;
    if (n >= cap) return DAT_ERR_CAPACITY;
    ids[n] = buf[i + used];
    starts[n] = i + used + 1;
    lens[n] = payload;
    ++n;
    i = frame_end;
    *consumed = i;
  }
  return n;
}

// Greedy min/max chunk-size pass over sorted candidate byte offsets (the
// sequential tail of content-defined chunking; ops/rabin.py documents the
// algorithm).  Writes chunk end-offsets (exclusive), always ending with
// `length`.  Returns the cut count, or DAT_ERR_CAPACITY.
int64_t dat_greedy_select(const int64_t* cands, int64_t n, int64_t length,
                          int64_t min_size, int64_t max_size, int64_t* out,
                          int64_t cap) {
  int64_t start = 0, i = 0, m = 0;
  while (length - start > max_size) {
    int64_t lo = start + min_size;
    int64_t hi = start + max_size;
    while (i < n && cands[i] < lo) ++i;
    int64_t cut;
    if (i < n && cands[i] <= hi) {
      cut = cands[i];
      ++i;
    } else {
      cut = hi;
    }
    if (m >= cap) return DAT_ERR_CAPACITY;
    out[m++] = cut;
    start = cut;
  }
  if (m >= cap) return DAT_ERR_CAPACITY;
  out[m++] = length;
  return m;
}

// Proto2 tags for the Change message (reference: messages/schema.proto:1-8).
enum {
  TAG_SUBSET = (1 << 3) | 2,
  TAG_KEY = (2 << 3) | 2,
  TAG_CHANGE = (3 << 3) | 0,
  TAG_FROM = (4 << 3) | 0,
  TAG_TO = (5 << 3) | 0,
  TAG_VALUE = (6 << 3) | 2,
};

}  // extern "C"

namespace {

// Decode Change payloads [lo, hi) into columnar arrays; returns the index
// of the first corrupt record in the range, or -1 if all decode.  The
// rows are independent, so ranges parallelize (dat_decode_changes_mt).
int64_t decode_changes_range(
    const uint8_t* buf, const int64_t* starts, const int64_t* lens,
    int64_t lo, int64_t hi, uint32_t* change, uint32_t* from_v,
    uint32_t* to_v, int64_t* key_off, int64_t* key_len, int64_t* sub_off,
    int64_t* sub_len, int64_t* val_off, int64_t* val_len) {
  for (int64_t r = lo; r < hi; ++r) {
    int64_t i = starts[r];
    const int64_t end = i + lens[r];
    bool has_key = false, has_change = false, has_from = false, has_to = false;
    sub_len[r] = -1;
    val_len[r] = -1;
    sub_off[r] = 0;
    val_off[r] = 0;
    while (i < end) {
      uint64_t tag;
      int used = read_uvarint(buf, i, end, &tag);
      if (used <= 0) goto bad;
      i += used;
      switch (tag & 7) {
        case 0: {  // varint
          uint64_t v;
          used = read_uvarint(buf, i, end, &v);
          if (used <= 0) goto bad;
          i += used;
          if (tag == TAG_CHANGE) {
            change[r] = static_cast<uint32_t>(v);
            has_change = true;
          } else if (tag == TAG_FROM) {
            from_v[r] = static_cast<uint32_t>(v);
            has_from = true;
          } else if (tag == TAG_TO) {
            to_v[r] = static_cast<uint32_t>(v);
            has_to = true;
          }
          break;
        }
        case 2: {  // length-delimited
          uint64_t ln;
          used = read_uvarint(buf, i, end, &ln);
          if (used <= 0) goto bad;
          i += used;
          // Unsigned compare before the cast: ln >= 2^63 would go
          // negative as int64 and slip past the bounds check below.
          if (ln > static_cast<uint64_t>(end - i)) goto bad;
          if (tag == TAG_SUBSET) {
            // every occurrence is text, as the per-record codec reads it
            if (!valid_utf8(buf + i, static_cast<int64_t>(ln))) goto bad;
            sub_off[r] = i;
            sub_len[r] = static_cast<int64_t>(ln);
          } else if (tag == TAG_KEY) {
            if (!valid_utf8(buf + i, static_cast<int64_t>(ln))) goto bad;
            key_off[r] = i;
            key_len[r] = static_cast<int64_t>(ln);
            has_key = true;
          } else if (tag == TAG_VALUE) {
            val_off[r] = i;
            val_len[r] = static_cast<int64_t>(ln);
          }
          i += static_cast<int64_t>(ln);
          break;
        }
        case 5:  // fixed32 (unknown field)
          if (i + 4 > end) goto bad;
          i += 4;
          break;
        case 1:  // fixed64 (unknown field)
          if (i + 8 > end) goto bad;
          i += 8;
          break;
        default:
          goto bad;
      }
    }
    if (!has_key || !has_change || !has_from || !has_to) goto bad;
    continue;
  bad:
    return r;
  }
  return -1;
}

inline int uvarint_size(uint64_t v) {
  int n = 1;
  while (v >= 0x80) {
    v >>= 7;
    ++n;
  }
  return n;
}

inline int64_t write_uvarint(uint8_t* dst, int64_t i, uint64_t v) {
  while (v >= 0x80) {
    dst[i++] = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  dst[i++] = static_cast<uint8_t>(v);
  return i;
}

// proto payload size of record r (fields in ascending field-number order,
// absent optionals omitted) — shared by the serial and parallel encoders.
inline int64_t change_payload_size(int64_t r, const uint32_t* change,
                                   const uint32_t* from_v,
                                   const uint32_t* to_v,
                                   const int64_t* key_len,
                                   const int64_t* sub_len,
                                   const int64_t* val_len) {
  int64_t psize = 0;
  if (sub_len[r] >= 0) psize += 1 + uvarint_size(sub_len[r]) + sub_len[r];
  psize += 1 + uvarint_size(key_len[r]) + key_len[r];
  psize += 1 + uvarint_size(change[r]);
  psize += 1 + uvarint_size(from_v[r]);
  psize += 1 + uvarint_size(to_v[r]);
  if (val_len[r] >= 0) psize += 1 + uvarint_size(val_len[r]) + val_len[r];
  return psize;
}

// Encode record r's full frame at dst[w]; returns the new write offset.
int64_t encode_change_at(const uint8_t* src, int64_t r, int64_t psize,
                         const uint32_t* change, const uint32_t* from_v,
                         const uint32_t* to_v, const int64_t* key_off,
                         const int64_t* key_len, const int64_t* sub_off,
                         const int64_t* sub_len, const int64_t* val_off,
                         const int64_t* val_len, uint8_t* dst, int64_t w) {
  w = write_uvarint(dst, w, psize + 1);
  dst[w++] = 1;  // TYPE_CHANGE
  if (sub_len[r] >= 0) {
    dst[w++] = TAG_SUBSET;
    w = write_uvarint(dst, w, sub_len[r]);
    std::memcpy(dst + w, src + sub_off[r], static_cast<size_t>(sub_len[r]));
    w += sub_len[r];
  }
  dst[w++] = TAG_KEY;
  w = write_uvarint(dst, w, key_len[r]);
  std::memcpy(dst + w, src + key_off[r], static_cast<size_t>(key_len[r]));
  w += key_len[r];
  dst[w++] = TAG_CHANGE;
  w = write_uvarint(dst, w, change[r]);
  dst[w++] = TAG_FROM;
  w = write_uvarint(dst, w, from_v[r]);
  dst[w++] = TAG_TO;
  w = write_uvarint(dst, w, to_v[r]);
  if (val_len[r] >= 0) {
    dst[w++] = TAG_VALUE;
    w = write_uvarint(dst, w, val_len[r]);
    std::memcpy(dst + w, src + val_off[r], static_cast<size_t>(val_len[r]));
    w += val_len[r];
  }
  return w;
}

}  // namespace

extern "C" {

// Decode n Change payloads into columnar arrays (serial entry point).
//
// Absent optional fields get len -1 (host maps to ''/b'').  Unknown fields
// are skipped per proto2.  Returns 0, or DAT_ERR_BAD_RECORD with
// err_index set to the first offending record.
int64_t dat_decode_changes(const uint8_t* buf, const int64_t* starts,
                           const int64_t* lens, int64_t n, uint32_t* change,
                           uint32_t* from_v, uint32_t* to_v, int64_t* key_off,
                           int64_t* key_len, int64_t* sub_off,
                           int64_t* sub_len, int64_t* val_off,
                           int64_t* val_len, int64_t* err_index) {
  int64_t bad = decode_changes_range(buf, starts, lens, 0, n, change, from_v,
                                     to_v, key_off, key_len, sub_off, sub_len,
                                     val_off, val_len);
  if (bad >= 0) {
    *err_index = bad;
    return DAT_ERR_BAD_RECORD;
  }
  return 0;
}

// Thread-parallel dat_decode_changes: rows are independent, so ranges
// decode concurrently; the reported error is the MINIMUM offending index
// across ranges (atomic fetch-min), the serial entry point's
// first-corrupt-record semantics.  nthreads <= 0 = auto.
int64_t dat_decode_changes_mt(const uint8_t* buf, const int64_t* starts,
                              const int64_t* lens, int64_t n,
                              uint32_t* change, uint32_t* from_v,
                              uint32_t* to_v, int64_t* key_off,
                              int64_t* key_len, int64_t* sub_off,
                              int64_t* sub_len, int64_t* val_off,
                              int64_t* val_len, int64_t* err_index,
                              int64_t nthreads) {
  std::atomic<int64_t> first(INT64_MAX);
  parallel_for(n, nthreads, 4096, [&](int64_t lo, int64_t hi) {
    int64_t bad = decode_changes_range(buf, starts, lens, lo, hi, change,
                                       from_v, to_v, key_off, key_len,
                                       sub_off, sub_len, val_off, val_len);
    if (bad >= 0) {
      int64_t cur = first.load(std::memory_order_relaxed);
      while (bad < cur &&
             !first.compare_exchange_weak(cur, bad,
                                          std::memory_order_relaxed)) {
      }
    }
  });
  if (first.load() != INT64_MAX) {
    *err_index = first.load();
    return DAT_ERR_BAD_RECORD;
  }
  return 0;
}

// Bulk-encode n Change records (columnar, offsets into `src`) as framed
// wire bytes: varint(len+1) | 0x01 | proto payload, fields in ascending
// field-number order matching the Python encoder (wire/change_codec.py).
// sub_len/val_len -1 = absent optional.  Returns bytes written into
// `dst` (capacity `cap`), or DAT_ERR_CAPACITY.
int64_t dat_encode_changes(const uint8_t* src, int64_t n,
                           const uint32_t* change, const uint32_t* from_v,
                           const uint32_t* to_v, const int64_t* key_off,
                           const int64_t* key_len, const int64_t* sub_off,
                           const int64_t* sub_len, const int64_t* val_off,
                           const int64_t* val_len, uint8_t* dst,
                           int64_t cap) {
  int64_t w = 0;
  for (int64_t r = 0; r < n; ++r) {
    int64_t psize = change_payload_size(r, change, from_v, to_v, key_len,
                                        sub_len, val_len);
    int64_t need = uvarint_size(psize + 1) + 1 + psize;
    if (w + need > cap) return DAT_ERR_CAPACITY;
    w = encode_change_at(src, r, psize, change, from_v, to_v, key_off,
                         key_len, sub_off, sub_len, val_off, val_len, dst, w);
  }
  return w;
}

// Thread-parallel bulk encode: pass 1 sizes every frame concurrently, a
// serial prefix sum assigns offsets, pass 2 writes every frame at its
// offset concurrently.  Byte-identical to dat_encode_changes (same
// helpers).  Returns bytes written, DAT_ERR_CAPACITY or DAT_ERR_NOMEM.
int64_t dat_encode_changes_mt(const uint8_t* src, int64_t n,
                              const uint32_t* change, const uint32_t* from_v,
                              const uint32_t* to_v, const int64_t* key_off,
                              const int64_t* key_len, const int64_t* sub_off,
                              const int64_t* sub_len, const int64_t* val_off,
                              const int64_t* val_len, uint8_t* dst,
                              int64_t cap, int64_t nthreads) {
  int64_t* offs = new (std::nothrow) int64_t[static_cast<size_t>(n) + 1];
  if (offs == nullptr) return DAT_ERR_NOMEM;
  parallel_for(n, nthreads, 4096, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t psize = change_payload_size(r, change, from_v, to_v, key_len,
                                          sub_len, val_len);
      offs[r] = uvarint_size(psize + 1) + 1 + psize;
    }
  });
  int64_t total = 0;
  for (int64_t r = 0; r < n; ++r) {
    int64_t sz = offs[r];
    offs[r] = total;
    total += sz;
  }
  offs[n] = total;
  if (total > cap) {
    delete[] offs;
    return DAT_ERR_CAPACITY;
  }
  parallel_for(n, nthreads, 4096, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t psize = change_payload_size(r, change, from_v, to_v, key_len,
                                          sub_len, val_len);
      encode_change_at(src, r, psize, change, from_v, to_v, key_off, key_len,
                       sub_off, sub_len, val_off, val_len, dst, offs[r]);
    }
  });
  delete[] offs;
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Columnar ChangeBatch payload encoder (wire/batch_codec.py documents the
// layout; the frame rides type id  // wire: TYPE_CHANGE_BATCH = 3
// and is only emitted to peers advertising the capability).  The per-row
// work numpy cannot vectorize is the dictionary build — dedup of key /
// subset byte spans — so that is what lives here: an open-addressing
// FNV-1a span hash, first-appearance order, then one sequential pass
// writing every section.
// ---------------------------------------------------------------------------

namespace {

constexpr int BATCH_VERSION = 1;  // wire: BATCH_VERSION = 1

inline uint64_t span_hash(const uint8_t* p, int64_t len) {
  uint64_t h = 1469598103934665603ULL;  // FNV-1a 64
  for (int64_t i = 0; i < len; ++i) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h | 1;  // 0 marks an empty slot
}

// Open-addressing span dictionary over (off, len) extents of one buffer.
// Insert returns the span's first-appearance index.
struct SpanDict {
  const uint8_t* src;
  int64_t cap = 0;      // power of two
  uint64_t* hashes = nullptr;
  int64_t* slots = nullptr;   // slot -> unique index
  int64_t* u_off = nullptr;   // unique -> span
  int64_t* u_len = nullptr;
  int64_t count = 0;

  bool init(const uint8_t* s, int64_t max_entries) {
    src = s;
    cap = 16;
    while (cap < max_entries * 2) cap <<= 1;
    hashes = new (std::nothrow) uint64_t[cap]();
    slots = new (std::nothrow) int64_t[cap];
    u_off = new (std::nothrow) int64_t[max_entries > 0 ? max_entries : 1];
    u_len = new (std::nothrow) int64_t[max_entries > 0 ? max_entries : 1];
    return hashes != nullptr && slots != nullptr && u_off != nullptr &&
           u_len != nullptr;
  }
  ~SpanDict() {
    delete[] hashes;
    delete[] slots;
    delete[] u_off;
    delete[] u_len;
  }
  int64_t insert(int64_t off, int64_t len) {
    uint64_t h = span_hash(src + off, len);
    int64_t i = static_cast<int64_t>(h) & (cap - 1);
    while (true) {
      if (hashes[i] == 0) {
        hashes[i] = h;
        slots[i] = count;
        u_off[count] = off;
        u_len[count] = len;
        return count++;
      }
      if (hashes[i] == h) {
        int64_t u = slots[i];
        if (u_len[u] == len && std::memcmp(src + u_off[u], src + off,
                                           static_cast<size_t>(len)) == 0)
          return u;
      }
      i = (i + 1) & (cap - 1);
    }
  }
};

inline int batch_width(int64_t max_value) {
  // smallest width whose all-ones value strictly exceeds max_value (the
  // all-ones sentinel must stay unambiguous) — mirrors _pick_width
  if (max_value < 0xFF) return 1;
  if (max_value < 0xFFFF) return 2;
  return 4;
}

inline int64_t put_le(uint8_t* dst, int64_t w, uint64_t v, int width) {
  for (int k = 0; k < width; ++k) {
    dst[w + k] = static_cast<uint8_t>(v >> (8 * k));
  }
  return w + width;
}

}  // namespace

extern "C" {

// Encode n records (columnar spans over `src`, the ChangeColumns
// layout; sub_len/val_len -1 = absent) as ONE ChangeBatch payload into
// dst.  Returns payload bytes written, DAT_ERR_CAPACITY if cap is too
// small, DAT_ERR_BAD_RECORD past the width ladder, or DAT_ERR_NOMEM.
int64_t dat_encode_change_batch(const uint8_t* src, int64_t n,
                                const uint32_t* change,
                                const uint32_t* from_v, const uint32_t* to_v,
                                const int64_t* key_off,
                                const int64_t* key_len,
                                const int64_t* sub_off,
                                const int64_t* sub_len,
                                const int64_t* val_off,
                                const int64_t* val_len, uint8_t* dst,
                                int64_t cap) {
  SpanDict keys, subs;
  if (!keys.init(src, n) || !subs.init(src, n)) return DAT_ERR_NOMEM;
  std::vector<int64_t> kidx, sidx;
  try {
    kidx.resize(static_cast<size_t>(n));
    sidx.resize(static_cast<size_t>(n));
  } catch (const std::bad_alloc&) {
    return DAT_ERR_NOMEM;
  }
  int64_t max_vlen = -1, vheap = 0, max_dlen = 0;
  for (int64_t r = 0; r < n; ++r) {
    kidx[r] = keys.insert(key_off[r], key_len[r]);
    sidx[r] = sub_len[r] >= 0 ? subs.insert(sub_off[r], sub_len[r]) : -1;
    if (val_len[r] >= 0) {
      if (val_len[r] > max_vlen) max_vlen = val_len[r];
      vheap += val_len[r];
    }
  }
  int64_t kheap = 0, sheap = 0;
  for (int64_t u = 0; u < keys.count; ++u) {
    kheap += keys.u_len[u];
    if (keys.u_len[u] > max_dlen) max_dlen = keys.u_len[u];
  }
  for (int64_t u = 0; u < subs.count; ++u) {
    sheap += subs.u_len[u];
    if (subs.u_len[u] > max_dlen) max_dlen = subs.u_len[u];
  }
  // width-ladder bound, mirroring the Python tier's _pick_width raise:
  // a value that would need the 4-byte all-ones sentinel as a REAL
  // length/index must be rejected, never silently encoded as absent
  if (max_vlen >= 0xFFFFFFFFLL || max_dlen >= 0xFFFFFFFFLL ||
      keys.count > 0xFFFFFFFELL || subs.count > 0xFFFFFFFELL)
    return DAT_ERR_BAD_RECORD;
  const int kw = batch_width(keys.count > 0 ? keys.count - 1 : 0);
  const int sw = subs.count == 0 ? 0 : batch_width(subs.count - 1);
  const int vw = max_vlen < 0 ? 0 : batch_width(max_vlen);
  const int dw = batch_width(max_dlen);
  int64_t need = 5 + 4 * 10  // header + 4 varints (10-byte worst case)
                 + (keys.count + subs.count) * dw + kheap + sheap
                 + n * (12 + kw + sw + vw) + vheap;
  if (need > cap) return DAT_ERR_CAPACITY;
  int64_t w = 0;
  dst[w++] = BATCH_VERSION;
  dst[w++] = static_cast<uint8_t>(kw);
  dst[w++] = static_cast<uint8_t>(sw);
  dst[w++] = static_cast<uint8_t>(vw);
  dst[w++] = static_cast<uint8_t>(dw);
  w = write_uvarint(dst, w, n);
  w = write_uvarint(dst, w, keys.count);
  w = write_uvarint(dst, w, subs.count);
  w = write_uvarint(dst, w, vheap);
  for (int64_t u = 0; u < keys.count; ++u)
    w = put_le(dst, w, keys.u_len[u], dw);
  for (int64_t u = 0; u < keys.count; ++u) {
    std::memcpy(dst + w, src + keys.u_off[u],
                static_cast<size_t>(keys.u_len[u]));
    w += keys.u_len[u];
  }
  for (int64_t u = 0; u < subs.count; ++u)
    w = put_le(dst, w, subs.u_len[u], dw);
  for (int64_t u = 0; u < subs.count; ++u) {
    std::memcpy(dst + w, src + subs.u_off[u],
                static_cast<size_t>(subs.u_len[u]));
    w += subs.u_len[u];
  }
  std::memcpy(dst + w, change, static_cast<size_t>(n) * 4);
  w += n * 4;
  std::memcpy(dst + w, from_v, static_cast<size_t>(n) * 4);
  w += n * 4;
  std::memcpy(dst + w, to_v, static_cast<size_t>(n) * 4);
  w += n * 4;
  for (int64_t r = 0; r < n; ++r) w = put_le(dst, w, kidx[r], kw);
  if (sw) {
    const uint64_t sent = (1ULL << (8 * sw)) - 1;
    for (int64_t r = 0; r < n; ++r)
      w = put_le(dst, w, sidx[r] < 0 ? sent : sidx[r], sw);
  }
  if (vw) {
    const uint64_t sent = (1ULL << (8 * vw)) - 1;
    for (int64_t r = 0; r < n; ++r)
      w = put_le(dst, w, val_len[r] < 0 ? sent : val_len[r], vw);
  }
  for (int64_t r = 0; r < n; ++r) {
    if (val_len[r] > 0) {
      std::memcpy(dst + w, src + val_off[r],
                  static_cast<size_t>(val_len[r]));
      w += val_len[r];
    }
  }
  return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// The wire pump: batched-syscall socket loops (session/pump.py).
//
// The Python pumps (session/transport.py) make one interpreter round
// trip per read or write.  These entry points move whole batches of wire
// bytes per ctypes call, with the GIL released for the call's whole
// duration, so the interpreter sees one wakeup per multi-megabyte slab:
//
//   dat_pump_probe      which batched syscalls this kernel serves
//   dat_pump_recv_scan  blocking first read + MSG_DONTWAIT recvmmsg
//                       drain + frame index over the received prefix
//                       (dat_split_frames above: one scanner, so the
//                       pump cannot fork the framing)
//   dat_pump_send       gather-send spans to a blocking fd
//                       (sendmmsg batches; writev on fds without them)
//   dat_pump_send_nb    gather-send until EAGAIN on a non-blocking fd
//                       (the fan-out's path: the spans are BroadcastLog
//                       segment memory, never copies)
//
// Each call degrades per fd: ENOSYS / ENOTSOCK / EOPNOTSUPP / EINVAL
// take plain read/writev batches, so pipes (the sidecar's --stdio) and
// kernels without the mmsg syscalls carry the same byte stream.
//
// One difference from the JAX package's copy: on a BLOCKING fd, EAGAIN
// means SO_SNDTIMEO ran out (a peer that stopped reading), so the
// blocking send returns -EAGAIN, as a timed-out send(2) does, where the
// JAX package's retries it forever.

#include <errno.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

// geometry of one batched syscall: messages per mmsg call x iovecs per
// message.  16 x 64 = up to 1,024 spans (or 16 receive slices) a call.
constexpr int PUMP_MSGS = 16;
constexpr int PUMP_IOV = 64;

// errno says this fd or kernel cannot serve the mmsg syscall at all (the
// degrade decision, distinct from a transient EAGAIN / EINTR)
inline bool mmsg_unsupported(int e) {
  return e == ENOSYS || e == ENOTSOCK || e == EOPNOTSUPP || e == EINVAL;
}

struct SpanCursor {
  const int64_t* addrs;
  const int64_t* lens;
  int64_t n;
  int64_t si = 0;   // current span
  int64_t off = 0;  // bytes of span si already sent
  bool done() const { return si >= n; }
  // fill up to `cap` iovecs from the cursor; returns the count
  int fill(struct iovec* iov, int cap) const {
    int k = 0;
    int64_t s = si, o = off;
    while (k < cap && s < n) {
      if (lens[s] <= o) {
        ++s;
        o = 0;
        continue;
      }
      iov[k].iov_base =
          reinterpret_cast<void*>(static_cast<uintptr_t>(addrs[s]) + o);
      iov[k].iov_len = static_cast<size_t>(lens[s] - o);
      ++k;
      ++s;
      o = 0;
    }
    return k;
  }
  void advance(int64_t nbytes) {
    while (nbytes > 0 && si < n) {
      int64_t left = lens[si] - off;
      if (nbytes < left) {
        off += nbytes;
        return;
      }
      nbytes -= left;
      ++si;
      off = 0;
    }
  }
};

}  // namespace

extern "C" {

// Runtime probe: bit 0 = recvmmsg served, bit 1 = sendmmsg served.  A
// call on fd -1 tells "the syscall exists" (EBADF) from "the kernel does
// not serve it" (ENOSYS) without touching a real descriptor.
int64_t dat_pump_probe(void) {
  int64_t caps = 0;
  errno = 0;
  if (recvmmsg(-1, nullptr, 0, 0, nullptr) < 0 && errno != ENOSYS)
    caps |= 1;
  errno = 0;
  if (sendmmsg(-1, nullptr, 0, 0) < 0 && errno != ENOSYS) caps |= 2;
  return caps;
}

// Batched receive + frame scan, one GIL-released call:
//
//   1. ONE read() (the wakeup; blocks on a blocking fd, -EAGAIN on a
//      non-blocking one; works on sockets and pipes);
//   2. drain what the kernel already buffered with MSG_DONTWAIT
//      recvmmsg batches (never blocks; pipes and old kernels skip it);
//   3. index the received prefix's complete frames with
//      dat_split_frames (the decoder's bulk entry takes the index).
//
// Returns the bytes received (0 = EOF before any byte; after an EOF
// mid-batch the next call sees it), or -errno.  nframes / consumed / err
// are dat_split_frames' outputs over the prefix (a malformed header
// leaves nframes 0, so the decoder's streaming scanner meets it and
// raises its own error); stats[0] counts syscalls made, stats[1]
// messages (reads) landed: stats[1] - stats[0] is what batching saved.
//
// cap must hold at least one maximal frame header or the scan could
// never make progress:  // wire: MAX_HEADER_LEN = 11
int64_t dat_pump_recv_scan(int64_t fd, uint8_t* dst, int64_t cap,
                           int64_t slice, int64_t* starts, int64_t* lens,
                           uint8_t* ids, int64_t icap, int64_t* nframes,
                           int64_t* consumed, int64_t* err,
                           int64_t* stats) {
  *nframes = 0;
  *consumed = 0;
  *err = 0;
  stats[0] = 0;
  stats[1] = 0;
  if (cap < 11 || slice < 1) return DAT_ERR_CAPACITY;
  if (slice > cap) slice = cap;
  int64_t total = 0;
  for (;;) {  // the wakeup read
    ssize_t r = read(static_cast<int>(fd), dst, static_cast<size_t>(slice));
    ++stats[0];
    if (r < 0) {
      if (errno == EINTR) continue;
      return -static_cast<int64_t>(errno);
    }
    total = r;
    break;
  }
  if (total == 0) return 0;  // EOF
  ++stats[1];
  // drain only when the wakeup read filled its slice: a short first read
  // means the kernel buffer is (for now) empty, and a recvmmsg would only
  // buy an EAGAIN, the very syscall this pump exists to save
  bool more = total >= slice;
  while (more && cap - total > 0) {
    struct mmsghdr hdrs[PUMP_MSGS];
    struct iovec iov[PUMP_MSGS];
    int k = 0;
    int64_t off = total;
    while (k < PUMP_MSGS && off < cap) {
      int64_t take = cap - off < slice ? cap - off : slice;
      iov[k].iov_base = dst + off;
      iov[k].iov_len = static_cast<size_t>(take);
      std::memset(&hdrs[k].msg_hdr, 0, sizeof(hdrs[k].msg_hdr));
      hdrs[k].msg_hdr.msg_iov = &iov[k];
      hdrs[k].msg_hdr.msg_iovlen = 1;
      hdrs[k].msg_len = 0;
      off += take;
      ++k;
    }
    int r = recvmmsg(static_cast<int>(fd), hdrs, static_cast<unsigned>(k),
                     MSG_DONTWAIT, nullptr);
    ++stats[0];
    // EAGAIN: drained.  Unsupported (a pipe, an old kernel): the wakeup
    // read stands alone.  EINTR and hard errors: deliver what came; the
    // bytes already received reach the decoder before the next call can
    // surface anything
    if (r < 0) break;
    // STREAM semantics: each message is its own recvmsg into a fixed
    // offset, so a short message followed by a non-empty one (bytes that
    // landed between the two) leaves a HOLE at the layout offsets.
    // Compact every message down to the running cursor: the wire must be
    // contiguous in dst
    int64_t w = total;
    for (int m2 = 0; m2 < r; ++m2) {
      int64_t got = hdrs[m2].msg_len;
      if (got == 0) {  // EOF: deliver the prefix
        more = false;
        break;
      }
      if (dst + w != static_cast<uint8_t*>(iov[m2].iov_base))
        std::memmove(dst + w, iov[m2].iov_base, static_cast<size_t>(got));
      w += got;
      ++stats[1];
      if (got < static_cast<int64_t>(iov[m2].iov_len))
        more = false;  // a short message: the kernel buffer is drained
    }
    total = w;
    if (r < k) more = false;
  }
  int64_t nf = dat_split_frames(dst, total, starts, lens, ids, icap,
                                consumed, err);
  if (nf == DAT_ERR_CAPACITY) {
    // the filled prefix is a whole, valid index (frames [0, icap), with
    // `consumed` one past the last stored frame): the unindexed tail
    // re-enters the decoder's queue, so callers size the index for the
    // typical frame density, not the 2-byte worst case
    nf = icap;
    *err = 0;
  } else if (nf < 0) {
    nf = 0;
    *consumed = 0;
    *err = 0;
  }
  *nframes = nf;
  return total;
}

}  // extern "C"

namespace {

// The gather-send core.  Walks the span cursor with sendmmsg batches
// (PUMP_MSGS messages x PUMP_IOV iovecs a syscall; a stream socket
// concatenates them in order) and takes writev batches when the fd or
// kernel cannot serve sendmmsg.  A partial acceptance (short msg_len,
// short writev) resumes mid-span.  `stop_on_block`: return the accepted
// total at EAGAIN (a non-blocking fan-out peer).  Without it EAGAIN is
// an error: on a blocking fd it means SO_SNDTIMEO ran out.  Returns the
// bytes the kernel accepted, or -errno on an error (bytes accepted
// before it are gone either way, as with a failed os.writev).
int64_t pump_send_core(const int64_t* addrs, const int64_t* lens, int64_t n,
                       int fd, bool stop_on_block, int64_t* stats) {
  SpanCursor cur{addrs, lens, n};
  int64_t total = 0;
  bool use_mmsg = true;
  while (!cur.done()) {
    if (use_mmsg) {
      struct mmsghdr hdrs[PUMP_MSGS];
      struct iovec iov[PUMP_MSGS * PUMP_IOV];
      SpanCursor peek = cur;
      int m = 0;
      int filled = 0;
      while (m < PUMP_MSGS && !peek.done()) {
        int k = peek.fill(iov + filled, PUMP_IOV);
        if (k == 0) break;
        std::memset(&hdrs[m].msg_hdr, 0, sizeof(hdrs[m].msg_hdr));
        hdrs[m].msg_hdr.msg_iov = iov + filled;
        hdrs[m].msg_hdr.msg_iovlen = static_cast<size_t>(k);
        hdrs[m].msg_len = 0;
        int64_t span_bytes = 0;
        for (int i = 0; i < k; ++i)
          span_bytes += static_cast<int64_t>(iov[filled + i].iov_len);
        peek.advance(span_bytes);
        filled += k;
        ++m;
      }
      if (m == 0) break;
      int r = sendmmsg(fd, hdrs, static_cast<unsigned>(m),
                       stop_on_block ? MSG_DONTWAIT : 0);
      ++stats[0];
      if (r < 0) {
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          if (stop_on_block) return total;
          return -static_cast<int64_t>(errno);  // SO_SNDTIMEO ran out
        }
        if (mmsg_unsupported(errno)) {
          use_mmsg = false;  // degrade to the writev loop
          continue;
        }
        return -static_cast<int64_t>(errno);
      }
      bool partial = false;
      for (int i = 0; i < r; ++i) {
        int64_t sent = hdrs[i].msg_len;
        total += sent;
        cur.advance(sent);
        ++stats[1];
        int64_t msg_total = 0;
        for (size_t v = 0; v < hdrs[i].msg_hdr.msg_iovlen; ++v)
          msg_total +=
              static_cast<int64_t>(hdrs[i].msg_hdr.msg_iov[v].iov_len);
        if (sent < msg_total) {
          partial = true;
          break;
        }
      }
      // a partial message (or fewer messages than asked) means the kernel
      // stopped accepting: non-blocking callers return the accepted total,
      // blocking ones re-enter from the cursor
      if ((partial || r < m) && stop_on_block) return total;
      continue;
    }
    struct iovec iov[PUMP_IOV];
    int k = cur.fill(iov, PUMP_IOV);
    if (k == 0) break;
    ssize_t w = writev(fd, iov, k);
    ++stats[0];
    if (w < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        if (stop_on_block) return total;
        return -static_cast<int64_t>(errno);  // SO_SNDTIMEO ran out
      }
      return -static_cast<int64_t>(errno);
    }
    ++stats[1];
    total += w;
    cur.advance(w);
  }
  return total;
}

}  // namespace

extern "C" {

// Gather-send `n` (address, length) spans to a BLOCKING fd.  Returns the
// bytes written (the sum of lens on success) or -errno; -EAGAIN when the
// fd's SO_SNDTIMEO ran out.  stats[0] = syscalls, stats[1] = messages /
// writevs accepted.
int64_t dat_pump_send(const int64_t* addrs, const int64_t* lens, int64_t n,
                      int64_t fd, int64_t* stats) {
  stats[0] = 0;
  stats[1] = 0;
  return pump_send_core(addrs, lens, n, static_cast<int>(fd), false, stats);
}

// Gather-send to a NON-BLOCKING fd: push batches until the kernel stops
// accepting (EAGAIN, a partial acceptance) and return the bytes accepted
// so far (>= 0), as a short os.writev does.  Hard errors are -errno
// (EPIPE, EBADF: the caller sheds the peer as a disconnect).
int64_t dat_pump_send_nb(const int64_t* addrs, const int64_t* lens,
                         int64_t n, int64_t fd, int64_t* stats) {
  stats[0] = 0;
  stats[1] = 0;
  return pump_send_core(addrs, lens, n, static_cast<int>(fd), true, stats);
}

}  // extern "C"
