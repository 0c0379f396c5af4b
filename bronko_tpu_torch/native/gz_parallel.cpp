// Parallel inflate for plain single-member gzip.
//
// Plain gzip (gzip/pigz output; the dominant FASTQ container) is one
// deflate stream with no internal index, so decompression is nominally
// serial — and it is the k-mer counter's only remaining single-threaded
// section (BGZF inputs already inflate in parallel via the 'BC' subfield
// scan in kmer_count.cpp). This file parallelizes the plain case with the
// speculation scheme introduced by pugz (Kerbiriou & Chikhi 2019,
// "Parallel decompression of gzip-compressed files and random access to
// DNA sequences"; algorithm re-implemented from the paper's idea, no code
// reuse):
//
//   1. Split the compressed body into C chunks. For each chunk boundary,
//      SCAN bit offsets for a deflate dynamic-Huffman block header that
//      parses cleanly (two valid canonical code sets + a block body that
//      decodes to its end-of-block symbol). A random bit position has
//      vanishingly small probability of surviving all of that, so the
//      first surviving offset is taken as the chunk's anchor.
//   2. Decode every chunk in parallel from its anchor. Back-references
//      reaching before the chunk's start can't be resolved yet — the
//      32 KB LZ77 window is primed with 32768 distinct 16-bit MARKERS, and
//      copies propagate markers like bytes (the decode ring holds uint16
//      symbols). Each chunk emits plain bytes plus a sparse fixup list
//      (position, marker); beyond the first ~32 KB of output, marker
//      density decays to ~zero, so memory stays ~1x the inflated size.
//   3. Chunks must CHAIN: chunk i's block walk has to land exactly on
//      chunk i+1's anchor bit. Any mismatch, decode error, or premature
//      final block aborts the whole attempt.
//   4. Concatenate chunk outputs (parallel memcpy), resolve fixups in
//      chunk order (marker m = byte m of the 32 KB preceding the chunk),
//      then verify the gzip footer: CRC32 (computed in parallel slices +
//      crc32_combine) and ISIZE. ONLY a byte-perfect stream returns true.
//
// The verification step is the safety story: speculation can misfire in
// principle (an anchor that is not a real block boundary), but a misfire
// cannot produce the stream's own CRC32 — the caller falls back to the
// serial path and correctness is preserved unconditionally.
//
// Env knobs: BRONKO_PARALLEL_GZ=0 disables; BRONKO_PARALLEL_GZ_MIN sets
// the minimum compressed size in bytes (default 4 MB; tests set 0).

#include "gz_parallel.h"

#include <zlib.h>

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <thread>

namespace bronko_gzp {
namespace {

// ---------------------------------------------------------------- bits --

struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0;      // input bytes
  size_t next = 0;   // next byte index to load (may run past n, padding 0)
  uint64_t buf = 0;
  unsigned cnt = 0;  // bits in buf

  void init(const uint8_t* data, size_t size, size_t bitoff) {
    d = data;
    n = size;
    next = bitoff >> 3;
    buf = 0;
    cnt = 0;
    fill();
    unsigned drop = (unsigned)(bitoff & 7);
    buf >>= drop;
    cnt -= drop;
  }
  inline void fill() {
    if (next + 8 <= n) {
      // branch-light refill (Giesen's variant-4): splice a whole 64-bit
      // load above the cnt valid bits — the extra bits are valid stream
      // bits either way — and advance by the whole bytes that fit
      uint64_t w;
      memcpy(&w, d + next, 8);
      buf |= w << cnt;
      next += (63 - cnt) >> 3;
      cnt |= 56;
      return;
    }
    while (cnt <= 56) {
      uint64_t b = next < n ? d[next] : 0;  // zero-pad past end; the
      buf |= b << cnt;                      // caller bounds-checks via
      cnt += 8;                             // bit_offset() at block ends
      ++next;
    }
  }
  inline uint32_t peek(unsigned k) {
    if (cnt < k) fill();
    return (uint32_t)(buf & ((1ull << k) - 1));
  }
  inline void consume(unsigned k) {
    buf >>= k;
    cnt -= k;
  }
  inline uint32_t get(unsigned k) {
    uint32_t v = peek(k);
    consume(k);
    return v;
  }
  inline void align_byte() {
    unsigned off = (unsigned)(bit_offset() & 7);
    if (off) consume(8 - off);
  }
  // absolute bit position of the next unread bit
  inline size_t bit_offset() const { return next * 8 - cnt; }
};

// ------------------------------------------------------------- huffman --

constexpr int kFastBits = 10;

struct Huff {
  uint16_t fast[1 << kFastBits];  // (sym << 4) | len; 0 = slow path
  uint16_t cnt_[16];
  uint32_t first_[16];  // first canonical (MSB-first) code per length
  uint16_t off_[16];    // index into syms_ of first symbol per length
  uint16_t syms_[288];
  int ncodes = 0;

  // Build from code lengths. Oversubscribed sets always fail; incomplete
  // sets fail iff require_complete (deflate permits an incomplete distance
  // code with a single entry; zlib's own encoder emits exactly that when a
  // block has no matches).
  bool build(const uint8_t* lens, int n, bool require_complete) {
    memset(cnt_, 0, sizeof(cnt_));
    for (int i = 0; i < n; ++i) {
      if (lens[i] > 15) return false;
      ++cnt_[lens[i]];
    }
    cnt_[0] = 0;
    ncodes = 0;
    for (int l = 1; l <= 15; ++l) ncodes += cnt_[l];
    int left = 1;
    for (int l = 1; l <= 15; ++l) {
      left = (left << 1) - cnt_[l];
      if (left < 0) return false;  // oversubscribed
    }
    if (left != 0) {
      if (require_complete || ncodes > 1) return false;
    }
    uint32_t code = 0;
    uint16_t off = 0;
    uint32_t next_code[16];
    for (int l = 1; l <= 15; ++l) {
      code = (code + cnt_[l - 1]) << 1;
      first_[l] = code;
      next_code[l] = code;
      off_[l] = off;
      off += cnt_[l];
    }
    memset(fast, 0, sizeof(fast));
    uint16_t fill_pos[16];
    memcpy(fill_pos, off_, sizeof(fill_pos));
    for (int i = 0; i < n; ++i) {
      int l = lens[i];
      if (!l) continue;
      syms_[fill_pos[l]++] = (uint16_t)i;
      uint32_t c = next_code[l]++;
      if (l <= kFastBits) {
        // reverse the MSB-first canonical code into the LSB-first bit
        // order deflate streams use, then replicate across the high bits
        uint32_t rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1u) << (l - 1 - b);
        for (uint32_t idx = rev; idx < (1u << kFastBits); idx += 1u << l)
          fast[idx] = (uint16_t)((i << 4) | l);
      }
    }
    return true;
  }

  inline int decode(BitReader& br) const {
    uint16_t e = fast[br.peek(kFastBits)];
    if (e) {
      br.consume(e & 15);
      return e >> 4;
    }
    // slow path: accumulate the code MSB-first, bit by bit
    uint32_t code = 0;
    for (int l = 1; l <= 15; ++l) {
      code = (code << 1) | br.get(1);
      uint32_t idx = code - first_[l];
      if (code >= first_[l] && idx < cnt_[l]) return syms_[off_[l] + idx];
    }
    return -1;
  }
};

// -------------------------------------------------------- deflate decode --

const uint16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                               15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                               67, 83, 99, 115, 131, 163, 195, 227, 258};
const uint8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                               2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const uint16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,    9,
                                13,   17,   25,   33,   49,   65,   97,
                                129,  193,  257,  385,  513,  769,  1025,
                                1537, 2049, 3073, 4097, 6145, 8193, 12289,
                                16385, 24577};
const uint8_t kDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const int kClOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                          11, 4,  12, 3, 13, 2, 14, 1, 15};

bool parse_dynamic(BitReader& br, Huff& lit, Huff& dist) {
  unsigned hlit = br.get(5) + 257;
  unsigned hdist = br.get(5) + 1;
  unsigned hclen = br.get(4) + 4;
  if (hlit > 286 || hdist > 30) return false;
  uint8_t cl[19] = {0};
  for (unsigned i = 0; i < hclen; ++i) cl[kClOrder[i]] = (uint8_t)br.get(3);
  Huff clh;
  if (!clh.build(cl, 19, true)) return false;
  uint8_t lens[286 + 30];
  unsigned i = 0;
  const unsigned total = hlit + hdist;
  while (i < total) {
    int s = clh.decode(br);
    if (s < 0) return false;
    if (s < 16) {
      lens[i++] = (uint8_t)s;
    } else if (s == 16) {
      if (i == 0) return false;
      unsigned r = 3 + br.get(2);
      if (i + r > total) return false;
      uint8_t prev = lens[i - 1];
      while (r--) lens[i++] = prev;
    } else if (s == 17) {
      unsigned r = 3 + br.get(3);
      if (i + r > total) return false;
      while (r--) lens[i++] = 0;
    } else {
      unsigned r = 11 + br.get(7);
      if (i + r > total) return false;
      while (r--) lens[i++] = 0;
    }
  }
  if (lens[256] == 0) return false;  // end-of-block must be codable
  if (!lit.build(lens, (int)hlit, true)) return false;
  if (!dist.build(lens + hlit, (int)hdist, false)) return false;
  return br.bit_offset() <= br.n * 8;
}

bool build_static(Huff& lit, Huff& dist) {
  uint8_t lens[288];
  for (int i = 0; i < 144; ++i) lens[i] = 8;
  for (int i = 144; i < 256; ++i) lens[i] = 9;
  for (int i = 256; i < 280; ++i) lens[i] = 7;
  for (int i = 280; i < 288; ++i) lens[i] = 8;
  // RFC 1951 3.2.6: the fixed distance code is THIRTY-TWO 5-bit codes —
  // 30-31 never appear in valid data but are part of the code space (a
  // 30-entry build is an incomplete code and fails). decode_huff_block's
  // ds > 29 check rejects the two reserved symbols.
  uint8_t dl[32];
  for (int i = 0; i < 32; ++i) dl[i] = 5;
  return lit.build(lens, 288, true) && dist.build(dl, 32, true);
}

// Speculative decode sink.
//
// TAINTED mode (chunks after the first): output is a uint16 SYMBOL stream
// — 0..255 resolved byte, 256+m a marker for byte m of the 32 KB that
// precedes the chunk — and matches copy symbols straight out of the
// stream itself (distance <= 32768 always lands inside it once 32 KB have
// been emitted; before that, inside the marker-primed ring prefix, which
// is simply the stream's virtual [-32768, 0) prefix). On genomic FASTQ
// taint NEVER decays (every region's first in-chunk occurrence copies
// from the pre-chunk window, then gets recopied forever — ~half of all
// bytes), so a sparse fixup list degenerates; the dense u16 stream +
// a branchless translation pass at assembly is the pugz representation.
//
// CLEAN mode: chunk 0 (no markers can exist) emits plain bytes into a
// char buffer and copies matches from it directly.
struct ChunkSink {
  std::vector<uint16_t> syms;  // tainted-mode output (manually sized)
  std::vector<char> bytes;     // clean-mode output (chunk 0)
  size_t len = 0;              // symbols/bytes emitted
  bool tainted = false;

  void init(bool with_markers) {
    len = 0;
    tainted = with_markers;
  }
  // pre-size the output so the decode loop never pays the vector's
  // doubling ladder (each doubling memcpys the whole stream so far —
  // ~2x the chunk's output re-moved across ~9 steps from the 64 KB
  // start at bench shapes)
  void reserve_hint(size_t n_syms) {
    if (tainted) {
      if (syms.size() < n_syms) syms.resize(n_syms);
    } else if (bytes.size() < n_syms) {
      bytes.resize(n_syms);
    }
  }
  inline void ensure(size_t extra) {
    if (tainted) {
      if (len + extra > syms.size())
        syms.resize(std::max(syms.size() * 2, len + extra + (64u << 10)));
    } else {
      if (len + extra > bytes.size())
        bytes.resize(std::max(bytes.size() * 2, len + extra + (64u << 10)));
    }
  }
  inline void push_lit(uint8_t b) {  // caller ensure()d capacity
    if (tainted)
      syms[len++] = b;
    else
      bytes[len++] = (char)b;
  }
  // caller ensure()d n + kCopySlack and validated dist (clean:
  // dist <= len). Overlapping matches (dist < n) take chunked copies
  // with OVERSHOOT (up to kCopySlack elements past n, inside the
  // ensure()d slack; len only advances by n so overshoot bytes are
  // rewritten by the next emit): FASTQ decode is match-dominated (66 MB
  // from 8 MB of input on the bench-shaped file), so the per-match loop
  // is the decoder's hot path, not the Huffman tables (the fast-table
  // experiments measured a wash; see docs/roadmap.md).
  static constexpr unsigned kCopySlack = 16;
  inline void copy(unsigned dist, unsigned n) {
    if (tainted) {
      // virtual prefix: position p < 0 is marker 256 + (32768 + p)
      uint16_t* dst = syms.data() + len;
      if (len >= dist) {
        const uint16_t* src = dst - dist;
        len += n;
        if (dist >= 8) {
          // CONSTANT-size 16-byte blocks stepping 8 symbols (overlap OK:
          // each block's read window ends >= dist >= 8 symbols behind its
          // write window, so sequential blocks read only settled data;
          // the final block overshoots into the ensure()d slack). The
          // constant size inlines to two vector moves — the old
          // variable-length memcpy call was the decoder's per-match tax
          // at the measured avg match of ~18 bytes (3.8M matches/66 MB)
          for (unsigned i = 0; i < n; i += 8) {
            memcpy(dst, src, 16);
            dst += 8;
            src += 8;
          }
        } else if (dist == 1) {
          // RLE run (constant-quality lines): broadcast fill
          uint16_t v = src[0];
          for (unsigned i = 0; i < n; ++i) dst[i] = v;
        } else {
          // 2..7: double the period (each copy distance stays a multiple
          // of dist, so the periodic region extends correctly), then
          // finish in 16-byte blocks from the widened distance
          unsigned have = 0, step = dist;
          while (have < n && step < 8) {
            memcpy(dst + have, dst + have - step, (size_t)step * 2);
            have += step;
            step *= 2;
          }
          for (; have < n; have += 8)
            memcpy(dst + have, dst + have - step, 16);
        }
      } else {
        size_t p = len - (size_t)dist;  // wraps; treat as signed
        len += n;
        while (n--) {
          ptrdiff_t sp = (ptrdiff_t)p;
          *dst++ = sp < 0 ? (uint16_t)(256 + 32768 + sp) : syms[sp];
          ++p;
        }
      }
    } else {
      const char* src = bytes.data() + len - dist;
      char* dst = bytes.data() + len;
      len += n;
      if (dist >= 16) {
        for (unsigned i = 0; i < n; i += 16) {
          memcpy(dst, src, 16);
          dst += 16;
          src += 16;
        }
      } else if (dist == 1) {
        memset(dst, src[0], n);
      } else {
        unsigned have = 0, step = dist;
        while (have < n && step < 16) {
          memcpy(dst + have, dst + have - step, step);
          have += step;
          step *= 2;
        }
        for (; have < n; have += 16)
          memcpy(dst + have, dst + have - step, 16);
      }
    }
  }
};

// Decode one block body (header's 3 bits already consumed for stored /
// tables already built for huffman blocks). first_chunk forbids reaching
// before the stream start. Returns 0 on end-of-block, 1 if out_cap was
// reached mid-block (anchor probing treats that as "valid enough"),
// -1 on any invalid symbol/distance.
int decode_huff_block(BitReader& br, const Huff& lit, const Huff& dist,
                      ChunkSink& co, bool first_chunk, size_t out_cap) {
  const size_t in_bits = br.n * 8;
  for (;;) {
    // one refill covers the worst-case symbol: litlen 15 + len-extra 5 +
    // dist 15 + dist-extra 13 = 48 bits — and, on the literal fast path,
    // up to two more <=10-bit literals from the same 64-bit buffer
    br.fill();
    co.ensure(4);  // single slack reservation for the fast literals below
    uint16_t e = lit.fast[br.peek(kFastBits)];
    if (e && (e >> 4) < 256) {  // literal via fast table: chain a couple
      br.consume(e & 15);       // more from the already-filled buffer
      co.push_lit((uint8_t)(e >> 4));
      e = lit.fast[br.peek(kFastBits)];
      if (e && (e >> 4) < 256) {
        br.consume(e & 15);
        co.push_lit((uint8_t)(e >> 4));
        e = lit.fast[br.peek(kFastBits)];
        if (e && (e >> 4) < 256) {
          br.consume(e & 15);
          co.push_lit((uint8_t)(e >> 4));
        }
      }
      if (co.len >= out_cap) return 1;
      if (br.bit_offset() > in_bits) return -1;
      continue;
    }
    int s;
    if (e) {
      // the fast entry already identified a non-literal symbol (length
      // or end-of-block) — consume it directly instead of re-walking
      // lit.decode's second table lookup (matches dominate FASTQ
      // streams: ~3.8M matches vs 1.4M literals per 66 MB measured)
      br.consume(e & 15);
      s = e >> 4;
    } else {
      s = lit.decode(br);
    }
    if (s < 0) return -1;
    if (s < 256) {
      co.push_lit((uint8_t)s);
    } else if (s == 256) {
      return br.bit_offset() <= in_bits ? 0 : -1;
    } else {
      if (s > 285) return -1;
      unsigned li = (unsigned)s - 257;
      unsigned len = kLenBase[li] + br.get(kLenExtra[li]);
      int ds = dist.decode(br);
      if (ds < 0 || ds > 29) return -1;
      unsigned d = kDistBase[ds] + br.get(kDistExtra[ds]);
      if (first_chunk && d > co.len) return -1;
      co.ensure(len + ChunkSink::kCopySlack);  // chunked copies overshoot
      co.copy(d, len);
    }
    if (co.len >= out_cap) return 1;
    if (br.bit_offset() > in_bits) return -1;
  }
}

int decode_stored_block(BitReader& br, ChunkSink& co) {
  br.align_byte();
  unsigned len = br.get(16);
  unsigned nlen = br.get(16);
  if (len != ((~nlen) & 0xFFFFu)) return -1;
  if (br.bit_offset() + (size_t)len * 8 > br.n * 8) return -1;
  co.ensure(len);
  while (len--) co.push_lit((uint8_t)br.get(8));
  return 0;
}

// --------------------------------------------------------------- anchors --

size_t parse_gzip_header(const uint8_t* p, size_t n) {
  if (n < 20 || p[0] != 0x1f || p[1] != 0x8b || p[2] != 8) return 0;
  uint8_t flg = p[3];
  size_t pos = 10;
  if (flg & 4) {  // FEXTRA
    if (pos + 2 > n) return 0;
    size_t xlen = p[pos] | ((size_t)p[pos + 1] << 8);
    pos += 2 + xlen;
  }
  if (flg & 8) {  // FNAME
    while (pos < n && p[pos]) ++pos;
    if (pos >= n) return 0;
    ++pos;
  }
  if (flg & 16) {  // FCOMMENT
    while (pos < n && p[pos]) ++pos;
    if (pos >= n) return 0;
    ++pos;
  }
  if (flg & 2) pos += 2;  // FHCRC
  return pos < n ? pos : 0;
}

constexpr size_t kProbeCap = 512 << 10;  // accept a probe block once it has
                                         // produced this much output
constexpr size_t kScanLimit = 2u << 20;  // bytes of anchor scan per chunk

// First bit offset >= start_byte*8 that looks like a dynamic-Huffman block
// boundary: header parses, both code sets build, and the block body decodes
// to end-of-block (or the probe cap). SIZE_MAX when none found.
size_t find_anchor(const uint8_t* d, size_t n, size_t start_byte,
                   const std::atomic<bool>& abort) {
  size_t limit = std::min(n, start_byte + kScanLimit) * 8;
  ChunkSink probe;
  for (size_t bit = start_byte * 8; bit < limit; ++bit) {
    if (abort.load(std::memory_order_relaxed)) return SIZE_MAX;
    BitReader br;
    br.init(d, n, bit);
    br.consume(1);  // bfinal: either value is plausible mid-stream
    if (br.get(2) != 2) continue;
    Huff lit, dist;
    if (!parse_dynamic(br, lit, dist)) continue;
    probe.init(true);  // resets len; keeps buffer capacity across tries
    int rc = decode_huff_block(br, lit, dist, probe, false, kProbeCap);
    if (rc < 0) continue;
    return bit;
  }
  return SIZE_MAX;
}

// ---------------------------------------------------------------- driver --

struct ChunkResult {
  ChunkSink sink;
  size_t reserve_syms = 0;  // pre-size hint (ISIZE/nchunks x slack)
  size_t end_bit = 0;   // bit after the chunk's last block
  bool saw_final = false;
  bool ok = false;
};

// Decode chunk [anchor, stop_anchor): walk whole blocks; every block start
// must not overshoot stop_anchor. stop_anchor==SIZE_MAX means "decode to
// the stream's final block" (last chunk). out_cap bounds the sink (a
// false anchor must not balloon memory before its decode errors out; a
// cap hit counts as failure here, unlike the anchor probe).
void decode_chunk(const uint8_t* d, size_t n, size_t anchor,
                  size_t stop_anchor, bool first_chunk, size_t out_cap,
                  ChunkResult& out, std::atomic<bool>& abort) {
  BitReader br;
  br.init(d, n, anchor);
  out.sink.init(!first_chunk);
  out.sink.reserve_hint(out.reserve_syms);
  Huff lit, dist;
  for (;;) {
    size_t at = br.bit_offset();
    if (at == stop_anchor) {
      out.ok = true;
      out.end_bit = at;
      return;
    }
    if (at > stop_anchor || at >= n * 8) break;
    if (abort.load(std::memory_order_relaxed)) break;
    if (out.sink.len > out_cap) break;
    unsigned bfinal = br.get(1);
    unsigned btype = br.get(2);
    int rc;
    if (btype == 0) {
      rc = decode_stored_block(br, out.sink);
    } else if (btype == 1) {
      if (!build_static(lit, dist)) break;
      // a cap hit returns 1 -> `rc != 0` -> failure (unlike probing)
      rc = decode_huff_block(br, lit, dist, out.sink, first_chunk, out_cap);
    } else if (btype == 2) {
      if (!parse_dynamic(br, lit, dist)) break;
      rc = decode_huff_block(br, lit, dist, out.sink, first_chunk, out_cap);
    } else {
      break;
    }
    if (rc != 0) break;
    if (bfinal) {
      // only the LAST chunk may own the stream's final block
      out.saw_final = true;
      out.ok = stop_anchor == SIZE_MAX;
      out.end_bit = br.bit_offset();
      if (!out.ok) break;
      return;
    }
  }
  abort.store(true, std::memory_order_relaxed);
}

std::atomic<int64_t> g_runs{0};

// BRONKO_PARALLEL_GZ: 0/false/off/no = never, 1/on/... = always, unset =
// AUTO: engage only at >= 8 hardware threads. Measured on the 4-core dev
// host (90 MB FASTQ, gzip -6): serial libdeflate 0.155 s vs 0.29-0.37 s
// parallel — four slow cores cannot beat one fast serial decoder while
// paying the u16 marker representation; per-thread decode scales with
// cores (pugz reports wins from ~8 threads), so the auto gate starts
// there and CRC verification keeps every outcome safe.
int env_mode() {
  const char* e = getenv("BRONKO_PARALLEL_GZ");
  if (!e) return -1;  // auto
  if (strcmp(e, "0") == 0 || strcasecmp(e, "false") == 0 ||
      strcasecmp(e, "off") == 0 || strcasecmp(e, "no") == 0)
    return 0;
  return 1;
}

size_t env_size(const char* name, size_t dflt) {
  const char* e = getenv(name);
  if (e) {
    char* end = nullptr;
    unsigned long long v = strtoull(e, &end, 10);
    if (end && end != e) return (size_t)v;
  }
  return dflt;
}

template <class F>
void parallel_for(int n, int nt, F&& fn) {
  std::atomic<int> next{0};
  std::vector<std::thread> ws;
  for (int t = 0; t < nt; ++t)
    ws.emplace_back([&]() {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        fn(i);
      }
    });
  for (auto& w : ws) w.join();
}

}  // namespace

int64_t runs() { return g_runs.load(); }

bool parallel_inflate(const uint8_t* in, size_t n, std::vector<char>& out) {
  int mode = env_mode();
  // BRONKO_PARALLEL_GZ_THREADS substitutes the detected hardware thread
  // count (gate AND worker pool): the >=8-thread auto gate ships untested
  // on narrow CI hosts otherwise — tests cap/raise it to drive both sides
  // of the gate on a 4-core box (VERDICT r4 item 7)
  unsigned hw = (unsigned)env_size("BRONKO_PARALLEL_GZ_THREADS",
                                   std::thread::hardware_concurrency());
  if (mode == 0 || (mode < 0 && hw < 8)) return false;
  if (n < env_size("BRONKO_PARALLEL_GZ_MIN", 4u << 20)) return false;
  size_t hdr = parse_gzip_header(in, n);
  if (!hdr) return false;

  int nt = (int)std::min<unsigned>(std::max(1u, hw), 16);
  size_t body = n - hdr;
  int nchunks = (int)std::min<size_t>((size_t)nt, body / (2u << 20));
  if (nchunks < 2) return false;

  // anchors (parallel scan; chunk 0's anchor is the first block itself)
  std::vector<size_t> anchors(nchunks, SIZE_MAX);
  anchors[0] = hdr * 8;
  std::atomic<bool> abort{false};
  parallel_for(nchunks - 1, nt, [&](int i) {
    size_t start = hdr + body * (size_t)(i + 1) / (size_t)nchunks;
    anchors[i + 1] = find_anchor(in, n, start, abort);
    if (anchors[i + 1] == SIZE_MAX) abort.store(true);
  });
  if (abort.load()) return false;
  for (int i = 1; i < nchunks; ++i)  // distinct + increasing, else merge
    if (anchors[i] <= anchors[i - 1]) return false;

  // per-chunk output cap from the trailing ISIZE (single-member gzip puts
  // it in the last 4 bytes; if this is multi-member the cap is wrong and
  // the decode aborts to the serial path, which handles those anyway).
  // Streams >4 GB wrap ISIZE, but such files exceed the whole-buffer cap
  // long before reaching here.
  uint32_t isize_hint;
  memcpy(&isize_hint, in + n - 4, 4);
  size_t out_cap = (size_t)isize_hint + (64u << 10);
  // u16 symbol streams hold ~3x the inflated size while chunks are in
  // flight (pre-sized to 1.5x the equal share each, 2 B/symbol); bound
  // the peak (BRONKO_PARALLEL_GZ_MAX_OUT overrides)
  if ((size_t)isize_hint > env_size("BRONKO_PARALLEL_GZ_MAX_OUT", 512u << 20))
    return false;

  // speculative decode (parallel); chunks pre-size to an equal share of
  // ISIZE plus slack (skewed chunks just fall back to ensure()'s growth)
  std::vector<ChunkResult> res(nchunks);
  size_t hint = std::min(out_cap,
                         ((size_t)isize_hint / (size_t)nchunks) * 3 / 2
                             + (256u << 10));
  parallel_for(nchunks, nt, [&](int i) {
    size_t stop = i + 1 < nchunks ? anchors[i + 1] : SIZE_MAX;
    res[i].reserve_syms = hint;
    decode_chunk(in, n, anchors[i], stop, i == 0, out_cap, res[i], abort);
  });
  if (abort.load()) return false;
  for (int i = 0; i < nchunks; ++i)
    if (!res[i].ok || (i + 1 < nchunks && res[i].saw_final)) return false;
  if (!res[nchunks - 1].saw_final) return false;

  // trailer: byte-align after the final block, then CRC32 + ISIZE; any
  // bytes beyond the trailer mean multi-member -> serial handles it
  size_t end_byte = (res[nchunks - 1].end_bit + 7) / 8;
  if (end_byte + 8 != n) return false;
  uint32_t want_crc, want_isize;
  memcpy(&want_crc, in + end_byte, 4);
  memcpy(&want_isize, in + end_byte + 4, 4);

  // assemble: chunk 0 is plain bytes; each later chunk translates its
  // u16 symbol stream against the 32 KB window that precedes it in the
  // final buffer — marker m = window byte m. Chunks resolve in ORDER
  // (chunk i's window is chunk i-1's resolved tail) but each chunk's
  // translation is itself data-parallel.
  std::vector<size_t> offs(nchunks + 1, 0);
  for (int i = 0; i < nchunks; ++i)
    offs[i + 1] = offs[i] + res[i].sink.len;
  const size_t total = offs[nchunks];
  if ((uint32_t)total != want_isize) return false;
  if (res[0].sink.tainted) return false;  // defensive: chunk 0 is clean
  for (int i = 1; i < nchunks; ++i)
    if (res[i].sink.len && offs[i] < 32768)
      return false;  // markers would precede the stream
  out.resize(total);
  if (res[0].sink.len)  // empty chunk-0 sink: bytes.data() may be null
    memcpy(out.data(), res[0].sink.bytes.data(), res[0].sink.len);

  // Marker m of chunk i = byte m of out[offs[i]-32768, offs[i]). Only the
  // 32 KB TAIL of chunk i-1 feeds chunk i, so resolve the tails first —
  // a sequential chain of 32 KB translations (~us each) — after which
  // every chunk BODY translates independently, in parallel.
  auto translate = [&](int i, size_t lo, size_t hi) {
    if (lo >= hi) return;
    const unsigned char* W =
        (const unsigned char*)out.data() + offs[i] - 32768;
    const uint16_t* s = res[i].sink.syms.data();
    char* o = out.data() + offs[i];
    for (size_t j = lo; j < hi; ++j) {
      uint16_t v = s[j];
      o[j] = v < 256 ? (char)v : (char)W[v - 256];
    }
  };
  for (int i = 1; i < nchunks; ++i) {
    size_t len = res[i].sink.len;
    translate(i, len > 32768 ? len - 32768 : 0, len);
  }
  parallel_for(nchunks - 1, nt, [&](int ci) {
    int i = ci + 1;
    size_t len = res[i].sink.len;
    translate(i, 0, len > 32768 ? len - 32768 : 0);
  });

  // CRC32 in parallel slices, combined in order
  std::vector<unsigned long> crcs(nchunks, 0);
  parallel_for(nchunks, nt, [&](int i) {
    unsigned long c = crc32(0L, Z_NULL, 0);
    size_t len = offs[i + 1] - offs[i];
    const unsigned char* p = (const unsigned char*)out.data() + offs[i];
    while (len > (1u << 30)) {  // crc32 takes uInt lengths
      c = crc32(c, p, 1u << 30);
      p += 1u << 30;
      len -= 1u << 30;
    }
    crcs[i] = crc32(c, p, (uInt)len);
  });
  unsigned long crc = crcs[0];
  for (int i = 1; i < nchunks; ++i)
    crc = crc32_combine(crc, crcs[i], (long)(offs[i + 1] - offs[i]));
  if ((uint32_t)crc != want_crc) return false;

  g_runs.fetch_add(1);
  return true;
}

}  // namespace bronko_gzp

extern "C" {
// test hook: how many inflates took the parallel path in this process
int64_t bronko_gz_parallel_runs(void) { return bronko_gzp::runs(); }
}
