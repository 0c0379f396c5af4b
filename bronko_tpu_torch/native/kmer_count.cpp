// Host-side streaming k-mer counter (KMC3-equivalent semantics).
//
// Counts non-canonical k-mers (KMC -b) from FASTQ, skipping windows that
// contain non-ACGT bases, flooring at ci and capping at cs
// (reference invocation: call.rs:1166-1181).
//
// Three front ends feed the same per-thread open-addressing tables:
//
//  * whole-buffer, for a file under the whole-buffer cap whose inflate is
//    parallel or absent: uncompressed FASTQ, and BGZF when libdeflate
//    loads (its blocks inflate in parallel). The file is read once,
//    inflated in one shot, cut into record-aligned slices by newline
//    phase (a newline count per region + <=3 memchr steps to reach the
//    next 4-line boundary), and the slices are parsed AND counted by all
//    the threads.
//  * pipelined, for every other file: gzip (single- or multi-member, and
//    BGZF when libdeflate is missing) and any file past the cap. One
//    reader thread inflates with zlib into record-aligned blocks while
//    threads-1 workers parse AND count them with the same slice parser,
//    so the parse runs beside the inflate instead of after it. It beats
//    the whole buffer even where that inflate is the pugz-style parallel
//    one (8 threads on an H100 machine's 8-CPU host: 0.55 against 0.59 s
//    for 126 MB of text). Its acceptance is read_inflate's.
//  * text (bronko_counter_count_text): an already-inflated buffer from
//    bronko_read_inflate, parsed like the whole-buffer path's; the
//    engine's inflate-ahead worker made it on another thread.
//
// Both finalizes share one merge (merge_parts): each table is scanned once,
// one thread a table, into 8 sorted key-range partitions that merge one
// thread a partition. finalize() concatenates them; finalize_part() hands
// them out a slice at a time. This is the IO-optimal front end when
// host<->device bandwidth is scarce: only the unique (k-mer, count) pairs
// ship to the device mapper.

#include <dlfcn.h>
#include <sys/stat.h>
#include <zlib.h>

#include "gz_parallel.h"

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Table {
  std::vector<uint64_t> keys;
  std::vector<uint32_t> vals;
  size_t mask = 0;
  size_t used = 0;

  static constexpr uint64_t kEmpty = ~0ull;

  Table() { reset(1ull << 20); }
  explicit Table(size_t n) { reset(n); }

  void reset(size_t n) {
    keys.assign(n, kEmpty);
    vals.assign(n, 0);
    mask = n - 1;
    used = 0;
  }

  static inline uint64_t mix(uint64_t z) {
    z ^= z >> 30; z *= 0xbf58476d1ce4e5b9ull;
    z ^= z >> 27; z *= 0x94d049bb133111ebull;
    return z ^ (z >> 31);
  }

  void grow() {
    std::vector<uint64_t> ok = std::move(keys);
    std::vector<uint32_t> ov = std::move(vals);
    keys.assign(ok.size() * 2, kEmpty);
    vals.assign(ok.size() * 2, 0);
    mask = keys.size() - 1;
    used = 0;
    for (size_t i = 0; i < ok.size(); ++i)
      if (ok[i] != kEmpty) insert(ok[i], ov[i]);
  }

  inline void insert(uint64_t key, uint32_t add) {
    insert_at(key, mix(key) & mask, add);
  }

  // Saturating variant for cross-table merges: per-table values are each
  // < 2^32, but their SUM across tables can exceed it (the old finalize
  // summed in uint64). Saturation preserves the min(sum, cs)/>=ci
  // semantics for any uint32 cs/ci. (grow() re-inserts each key once into
  // an empty table, so saturated values survive growth unchanged.)
  inline void insert_sat(uint64_t key, uint32_t add) {
    size_t i = mix(key) & mask;
    while (true) {
      if (keys[i] == key) {
        uint64_t v = (uint64_t)vals[i] + add;
        vals[i] = v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
        return;
      }
      if (keys[i] == kEmpty) {
        keys[i] = key; vals[i] = add;
        if (++used * 5 > keys.size() * 3) grow();
        return;
      }
      i = (i + 1) & mask;
    }
  }

  inline void insert_at(uint64_t key, size_t i, uint32_t add) {
    while (true) {
      if (keys[i] == key) {
        // saturate: the pipelined front end has no input-size cap, and one
        // ultra-abundant k-mer (poly-A in a >100 GB stream) can exceed
        // 2^32 in a single table — a wrapped count would then beat the
        // ci floor or misreport cs. One predictable extra op.
        uint64_t v = (uint64_t)vals[i] + add;
        vals[i] = v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
        return;
      }
      if (keys[i] == kEmpty) {
        keys[i] = key; vals[i] = add;
        if (++used * 5 > keys.size() * 3) grow();
        return;
      }
      i = (i + 1) & mask;
    }
  }
};

// Insert a run of k-mers with a software prefetch pipeline: the table is
// tens of MB (cache-miss-bound at ~50 ns/insert measured); hashing PF
// k-mers ahead and prefetching their slots overlaps the misses. Depth 32
// measured ~25% faster than 8 on the bench workload (39M inserts into
// ~1M-slot tables): enough outstanding lines to fill the LFB queue.
constexpr int kPrefetch = 32;

inline void flush_kmers(Table& t, const uint64_t* kb, int n) {
  size_t slots[kPrefetch];
  const size_t mask0 = t.mask;
  int i = 0;
  for (; i < n && i < kPrefetch; ++i) {
    slots[i & (kPrefetch - 1)] = Table::mix(kb[i]) & mask0;
    __builtin_prefetch(&t.keys[slots[i & (kPrefetch - 1)]], 1);
    __builtin_prefetch(&t.vals[slots[i & (kPrefetch - 1)]], 1);
  }
  for (int j = 0; j < n; ++j) {
    size_t slot = slots[j & (kPrefetch - 1)];
    if (i < n) {
      slots[i & (kPrefetch - 1)] = Table::mix(kb[i]) & mask0;
      __builtin_prefetch(&t.keys[slots[i & (kPrefetch - 1)]], 1);
      __builtin_prefetch(&t.vals[slots[i & (kPrefetch - 1)]], 1);
      ++i;
    }
    if (t.mask != mask0) slot = Table::mix(kb[j]) & t.mask;  // grew mid-run
    t.insert_at(kb[j], slot, 1);
  }
}

// A block of the pipelined front end: record-aligned FASTQ text in
// data[0, len). Blocks go back to the counter's spares once parsed, so a
// count touches the memory of a few blocks and not of the whole text.
struct Block {
  std::unique_ptr<char[]> data;
  size_t cap = 0, len = 0;
};

// One sorted key-range partition of the merged output: the ci-surviving
// (key, min(count, cs)) pairs and the number of distinct keys counted
struct MergedPart {
  std::vector<uint64_t> keys;
  std::vector<uint32_t> vals;
  int64_t unique = 0;
};

struct Counter {
  int k = 21;
  int n_threads = 1;
  std::vector<Table> tables;
  std::vector<int64_t> thread_kmers;
  int64_t total_reads = 0;
  unsigned char code[256];

  // merged output
  std::vector<uint64_t> out_keys;
  std::vector<uint32_t> out_vals;
  int64_t n_unique = 0;
  // merge_parts' partitions, until a finalize hands them out
  std::vector<MergedPart> parts;
  bool merged = false;

  // pipelined front end's state
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<Block> queue;
  std::vector<Block> spare;
  bool done = false;
  static constexpr size_t kMaxQueue = 8;
  double inflate_s = 0;  // the reader's read and inflate, wall seconds

  explicit Counter(int k_, int threads) : k(k_), n_threads(threads) {
    memset(code, 4, sizeof(code));
    code[(unsigned char)'A'] = 0; code[(unsigned char)'a'] = 0;
    code[(unsigned char)'C'] = 1; code[(unsigned char)'c'] = 1;
    code[(unsigned char)'G'] = 2; code[(unsigned char)'g'] = 2;
    code[(unsigned char)'T'] = 3; code[(unsigned char)'t'] = 3;
    tables.resize(n_threads);
    thread_kmers.assign(n_threads, 0);
  }

  void count_seq(Table& t, int64_t& nk, const char* s, int64_t len) {
    const uint64_t kmask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
    uint64_t cur = 0;
    int valid = 0;
    uint64_t kbuf[1024];
    int n = 0;
    for (int64_t i = 0; i < len; ++i) {
      unsigned char b = code[(unsigned char)s[i]];
      if (b >= 4) { valid = 0; cur = 0; continue; }
      cur = ((cur << 2) | b) & kmask;
      if (++valid >= k) {
        kbuf[n++] = cur;
        if (n == 1024) { flush_kmers(t, kbuf, n); nk += n; n = 0; }
      }
    }
    if (n) { flush_kmers(t, kbuf, n); nk += n; }
  }
};

// whole-buffer front-end input caps (compressed gz ~8x smaller than text);
// BRONKO_WHOLEBUF_MAX (bytes) overrides both — tests use it to force the
// pipelined front end on small fixtures of any kind
constexpr size_t kWholeBufMaxGz = 192ull << 20;     // ~1.5 GB inflated
constexpr size_t kWholeBufMaxPlain = 1536ull << 20;

size_t whole_buf_cap(bool gz) {
  const char* env = getenv("BRONKO_WHOLEBUF_MAX");
  if (env) {
    char* end = nullptr;
    unsigned long long v = strtoull(env, &end, 10);
    if (end && end != env) return (size_t)v;
  }
  return gz ? kWholeBufMaxGz : kWholeBufMaxPlain;
}

// ---------- optional libdeflate (dlopen'd; zlib fallback) ----------

struct LibDeflate {
  void* (*alloc_d)(void) = nullptr;
  void (*free_d)(void*) = nullptr;
  // returns 0 on success, 3 on insufficient output space
  int (*gzip_ex)(void*, const void*, size_t, void*, size_t, size_t*,
                 size_t*) = nullptr;
  bool ok = false;

  LibDeflate() {
    void* h = dlopen("libdeflate.so.0", RTLD_NOW | RTLD_LOCAL);
    if (!h) h = dlopen("libdeflate.so", RTLD_NOW | RTLD_LOCAL);
    if (!h) return;
    alloc_d = reinterpret_cast<void* (*)(void)>(
        dlsym(h, "libdeflate_alloc_decompressor"));
    free_d = reinterpret_cast<void (*)(void*)>(
        dlsym(h, "libdeflate_free_decompressor"));
    gzip_ex = reinterpret_cast<int (*)(void*, const void*, size_t, void*,
                                       size_t, size_t*, size_t*)>(
        dlsym(h, "libdeflate_gzip_decompress_ex"));
    ok = alloc_d && free_d && gzip_ex;
  }
};

const LibDeflate& libdeflate() {
  static LibDeflate ld;
  return ld;
}

bool is_gzip(const std::vector<char>& buf) {
  return buf.size() >= 2 && (unsigned char)buf[0] == 0x1f &&
         (unsigned char)buf[1] == 0x8b;
}

// ---------- parallel BGZF inflate ----------
//
// BGZF (bgzip/htslib, the blocked gzip variant ubiquitous in genomics
// archives) stores each <=64 KB member's total size in a 'BC' FEXTRA
// subfield, so member boundaries are knowable WITHOUT inflating — the
// blocks then inflate in parallel into a preallocated buffer at ISIZE
// prefix-sum offsets. Plain single-member gzip has no such boundaries and
// stays on the serial one-shot path.

struct BgzfBlock {
  size_t in_off, in_len, out_off, out_len;
};

bool scan_bgzf(const std::vector<char>& in, std::vector<BgzfBlock>& blocks,
               size_t& total_out) {
  const unsigned char* p = (const unsigned char*)in.data();
  const size_t n = in.size();
  size_t pos = 0, out = 0;
  while (pos < n) {
    if (pos + 18 > n) return false;
    if (p[pos] != 0x1f || p[pos + 1] != 0x8b || p[pos + 2] != 8 ||
        !(p[pos + 3] & 4))
      return false;  // not a FEXTRA gzip member -> not BGZF
    size_t xlen = p[pos + 10] | ((size_t)p[pos + 11] << 8);
    if (pos + 12 + xlen > n) return false;
    size_t sub = pos + 12;
    const size_t sub_end = sub + xlen;
    size_t bsize = 0;
    while (sub + 4 <= sub_end) {
      size_t slen = p[sub + 2] | ((size_t)p[sub + 3] << 8);
      if (p[sub] == 'B' && p[sub + 1] == 'C' && slen == 2) {
        if (sub + 6 > sub_end) return false;
        bsize = (size_t)(p[sub + 4] | ((size_t)p[sub + 5] << 8)) + 1;
        break;
      }
      sub += 4 + slen;
    }
    if (bsize < 26 || pos + bsize > n) return false;
    uint32_t isize;
    memcpy(&isize, p + pos + bsize - 4, 4);
    // BGZF blocks inflate to <= 64 KB; a corrupt ISIZE would otherwise
    // balloon total_out and throw bad_alloc through the C ABI
    if (isize > (1u << 16)) return false;
    blocks.push_back({pos, bsize, out, (size_t)isize});
    out += isize;
    pos += bsize;
  }
  total_out = out;
  return !blocks.empty();
}

bool inflate_bgzf_parallel(const std::vector<char>& in,
                           std::vector<char>& out) {
  const LibDeflate& ld = libdeflate();
  if (!ld.ok) return false;
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (!scan_bgzf(in, blocks, total)) return false;
  if (blocks.size() < 4) return false;  // serial path is fine
  out.resize(total);
  unsigned hw = std::thread::hardware_concurrency();
  int nt = (int)std::min<size_t>(std::max(1u, hw), 8);
  std::atomic<size_t> next{0};
  std::atomic<bool> bad{false};
  std::vector<std::thread> workers;
  for (int t = 0; t < nt; ++t) {
    workers.emplace_back([&]() {
      void* d = ld.alloc_d();
      if (!d) { bad.store(true); return; }
      while (!bad.load()) {
        size_t i = next.fetch_add(1);
        if (i >= blocks.size()) break;
        const BgzfBlock& b = blocks[i];
        size_t ain = 0, aout = 0;
        int r = ld.gzip_ex(d, in.data() + b.in_off, b.in_len,
                           out.data() + b.out_off, b.out_len, &ain, &aout);
        if (r != 0 || aout != b.out_len) bad.store(true);
      }
      ld.free_d(d);
    });
  }
  for (auto& w : workers) w.join();
  return !bad.load();
}

// Inflate a whole in-memory gzip stream (possibly multi-member). Returns
// false on corrupt data before any member decoded.
bool inflate_all(const std::vector<char>& in, std::vector<char>& out) {
  const LibDeflate& ld = libdeflate();
  if (inflate_bgzf_parallel(in, out)) return true;
  // plain single-member gzip: pugz-style speculative parallel inflate
  // (gz_parallel.cpp). Returns true ONLY on a CRC32+ISIZE-verified
  // byte-perfect stream; everything else falls through to serial.
  if (is_gzip(in) &&
      bronko_gzp::parallel_inflate((const uint8_t*)in.data(), in.size(), out))
    return true;
  out.clear();
  if (ld.ok) {
    // capacity guess: single-member ISIZE footer (mod 2^32), else ratio
    uint32_t isize = 0;
    if (in.size() >= 4)
      memcpy(&isize, in.data() + in.size() - 4, 4);
    size_t cap = std::max<size_t>(isize, in.size() * 4 + (1 << 20));
    out.resize(cap);
    void* d = ld.alloc_d();
    if (!d) return false;
    size_t pos = 0, out_pos = 0;
    while (pos < in.size()) {
      size_t ain = 0, aout = 0;
      int r = ld.gzip_ex(d, in.data() + pos, in.size() - pos,
                         out.data() + out_pos, out.size() - out_pos,
                         &ain, &aout);
      if (r == 3) {  // LIBDEFLATE_INSUFFICIENT_SPACE
        out.resize(out.size() * 2);
        continue;
      }
      if (r != 0 || ain == 0) {
        // fatal if nothing decoded. After >=1 member, only TRAILING
        // GARBAGE (no gzip magic at pos) is tolerated; if the remaining
        // bytes start a real member, this is a truncated/corrupt
        // multi-member file and accepting it would silently drop its
        // tail (counts from a prefix, wrong variant calls)
        bool looks_like_member =
            in.size() - pos >= 2 && (unsigned char)in[pos] == 0x1f &&
            (unsigned char)in[pos + 1] == 0x8b;
        if (out_pos == 0 || looks_like_member) { ld.free_d(d); return false; }
        break;
      }
      pos += ain;
      out_pos += aout;
    }
    ld.free_d(d);
    out.resize(out_pos);
    return true;
  }
  // zlib streaming fallback into one buffer. Input feeds in <1 GB bites
  // (avail_in is 32-bit; a single (uInt) cast of a >4 GB buffer would
  // wrap and silently decode size mod 2^32 bytes).
  z_stream zs{};
  if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return false;
  out.resize(std::max<size_t>(in.size() * 4, 8 << 20));
  size_t out_pos = 0, in_pos = 0;
  size_t member_start = 0;  // absolute offset of the current member
  // the only tolerated stop mid-stream is TRAILING GARBAGE: whatever sits
  // at member_start has no gzip magic. A failure while a REAL member was
  // decoding (magic at its start — including the first member) means a
  // truncated/corrupt file; accepting it would call variants on a prefix.
  auto member_is_real = [&]() {
    return in.size() - member_start >= 2 &&
           (unsigned char)in[member_start] == 0x1f &&
           (unsigned char)in[member_start + 1] == 0x8b;
  };
  while (true) {
    if (out_pos == out.size()) out.resize(out.size() * 2);
    if (zs.avail_in == 0 && in_pos < in.size()) {
      size_t bite = std::min<size_t>(in.size() - in_pos, 1u << 30);
      zs.next_in = (Bytef*)(in.data() + in_pos);
      zs.avail_in = (uInt)bite;
      in_pos += bite;
    }
    zs.next_out = (Bytef*)(out.data() + out_pos);
    zs.avail_out = (uInt)std::min<size_t>(out.size() - out_pos, 1u << 30);
    int r = inflate(&zs, Z_NO_FLUSH);
    out_pos = (size_t)((char*)zs.next_out - out.data());
    size_t remaining = (size_t)zs.avail_in + (in.size() - in_pos);
    if (r == Z_STREAM_END) {
      member_start = in.size() - remaining;
      if (remaining == 0) break;
      if (inflateReset2(&zs, 16 + MAX_WBITS) != Z_OK) break;  // next member
      continue;
    }
    if (r != Z_OK || (remaining == 0 && zs.avail_out != 0)) {
      // data error, or input exhausted mid-member (truncation)
      if (out_pos == 0 || member_is_real()) {
        inflateEnd(&zs);
        return false;
      }
      break;
    }
  }
  inflateEnd(&zs);
  out.resize(out_pos);
  return true;
}

// ---------- whole-buffer front end ----------

// Cut [lo, hi) into record-aligned slices: each boundary sits right after
// a newline whose cumulative index from lo is a multiple of 4 (FASTQ =
// 4 lines/record; lo itself must be a record start). The newline counts
// of the FIXED regions [t_i, t_{i+1}) are independent, so they run on
// worker threads (the count was the serial section: a full pass over the
// text before any parsing starts); the boundary walk then needs only the
// cumulative count mod 4 at each t_i plus <=4 memchr line steps.
std::vector<const char*> record_cuts(const char* lo, const char* hi,
                                     int n_slices, int n_threads) {
  const size_t total = (size_t)(hi - lo);
  std::vector<const char*> targets(n_slices + 1);
  for (int i = 0; i <= n_slices; ++i)
    targets[i] = lo + total * (size_t)i / (size_t)n_slices;

  std::vector<size_t> region_cnt(n_slices, 0);
  {
    std::atomic<int> next{0};
    std::vector<std::thread> workers;
    for (int t = 0; t < std::max(1, n_threads); ++t)
      workers.emplace_back([&]() {
        while (true) {
          int i = next.fetch_add(1);
          if (i >= n_slices) break;
          size_t cnt = 0;
          for (const char* p = targets[i]; p < targets[i + 1]; ++p)
            cnt += (*p == '\n');
          region_cnt[i] = cnt;
        }
      });
    for (auto& w : workers) w.join();
  }

  std::vector<const char*> cuts;
  cuts.reserve(n_slices + 1);
  cuts.push_back(lo);
  const char* cur = lo;
  size_t cum = 0;  // newlines in [lo, targets[i])
  for (int i = 1; i < n_slices; ++i) {
    cum += region_cnt[i - 1];
    const char* target = targets[i];
    if (target <= cur) { cuts.push_back(cur); continue; }
    // cumulative phase 0 alone is not enough: target may sit MID-line of
    // a record's header; a record boundary needs phase 0 AND a line
    // start. Otherwise advance whole lines until both hold (up to 4).
    int need = (int)((4 - (cum & 3)) & 3);
    if (need == 0 && !(target > lo && target[-1] == '\n')) need = 4;
    const char* p2 = target;
    while (need > 0 && p2 < hi) {
      const char* nl = (const char*)memchr(p2, '\n', (size_t)(hi - p2));
      if (!nl) { p2 = hi; break; }
      p2 = nl + 1;
      --need;
    }
    if (need > 0) p2 = hi;
    cuts.push_back(p2);
    cur = p2;
  }
  cuts.push_back(hi);
  return cuts;
}

// Parse + count one record-aligned slice. Returns the number of reads, or
// -1 on malformed input. Record-acceptance semantics match the pipelined
// reader: a record needs its header/seq/plus newlines; the final quality
// newline is optional at EOF; a record truncated earlier is dropped.
int64_t parse_count(Counter* c, Table& t, int64_t& nk,
                    const char* p, const char* end) {
  int64_t reads = 0;
  while (p < end) {
    if (*p != '@') return -1;
    const char* h = (const char*)memchr(p, '\n', (size_t)(end - p));
    if (!h) break;
    const char* s0 = h + 1;
    const char* s1 = (const char*)memchr(s0, '\n', (size_t)(end - s0));
    if (!s1) break;
    const char* pl = (const char*)memchr(s1 + 1, '\n',
                                         (size_t)(end - s1 - 1));
    if (!pl) break;
    const char* seq_end = s1;
    while (seq_end > s0 && seq_end[-1] == '\r') --seq_end;
    c->count_seq(t, nk, s0, (int64_t)(seq_end - s0));
    ++reads;
    const char* q = (const char*)memchr(pl + 1, '\n',
                                        (size_t)(end - pl - 1));
    p = q ? q + 1 : end;
  }
  return reads;
}

// Parse + count an already-inflated FASTQ text buffer (the whole-buffer
// back end). The buffer is only read; the caller keeps ownership.
int count_text(Counter* c, const char* text, size_t size) {
  if (size == 0) return 0;

  const int n_slices = c->n_threads * 8;
  std::vector<const char*> cuts =
      record_cuts(text, text + size, n_slices, c->n_threads);

  std::atomic<int> next{0};
  std::atomic<bool> malformed{false};
  std::vector<int64_t> reads_per_thread(c->n_threads, 0);
  std::vector<std::thread> workers;
  for (int tid = 0; tid < c->n_threads; ++tid) {
    workers.emplace_back([&, tid]() {
      Table& t = c->tables[tid];
      int64_t& nk = c->thread_kmers[tid];
      int64_t reads = 0;
      while (true) {
        int s = next.fetch_add(1);
        if (s >= (int)cuts.size() - 1) break;
        int64_t r = parse_count(c, t, nk, cuts[s], cuts[s + 1]);
        if (r < 0) { malformed.store(true); break; }
        reads += r;
      }
      reads_per_thread[tid] = reads;
    });
  }
  for (auto& w : workers) w.join();
  if (malformed.load()) return -2;
  for (int64_t r : reads_per_thread) c->total_reads += r;
  return 0;
}

// What the head of a file says: its byte size, whether it is gzip (the
// magic), and whether that gzip is BGZF (its first member carries the
// 'BC' subfield). False on open failure.
struct FileHead {
  int64_t size = 0;
  bool gz = false, bgzf = false;
};

bool read_head(const char* path, FileHead& fh) {
  struct stat st;
  if (stat(path, &st) != 0) return false;
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char h[12];
  size_t got = fread(h, 1, sizeof(h), f);
  fh.size = (int64_t)st.st_size;
  fh.gz = got >= 2 && h[0] == 0x1f && h[1] == 0x8b;
  if (fh.gz && got == sizeof(h) && (h[3] & 4)) {  // FEXTRA
    std::vector<unsigned char> x(h[10] | ((size_t)h[11] << 8));
    x.resize(fread(x.data(), 1, x.size(), f));
    for (size_t sub = 0; sub + 4 <= x.size();
         sub += 4 + (x[sub + 2] | ((size_t)x[sub + 3] << 8)))
      if (x[sub] == 'B' && x[sub + 1] == 'C' && x[sub + 2] == 2 && !x[sub + 3]) {
        fh.bgzf = true;
        break;
      }
  }
  fclose(f);
  return true;
}

// Whole-buffer eligibility: the file's byte size when it fits the
// front-end cap for its kind, -1 when it must stream, -2 on open failure.
// Shared by count_fastq and read_inflate so their cap decisions cannot
// drift.
int64_t whole_buf_size(const char* path) {
  FileHead fh;
  if (!read_head(path, fh)) return -2;
  return (size_t)fh.size <= whole_buf_cap(fh.gz) ? fh.size : -1;
}

// Whether count_fastq takes the pipelined front end for the file: past
// the cap, or gzip but for BGZF that libdeflate inflates in parallel. 1
// or 0, with the file's size in *size; -1 on open failure.
int pipes(const char* path, int64_t* size) {
  FileHead fh;
  if (!read_head(path, fh)) return -1;
  *size = fh.size;
  if ((size_t)fh.size > whole_buf_cap(fh.gz)) return 1;
  return fh.gz && !(fh.bgzf && libdeflate().ok);
}

// Read a file and (if gzip) inflate it. Returns 0 and the text in `out`,
// -1 on open failure, -2 on corrupt gzip.
int read_inflate(const char* path, size_t fsize, std::vector<char>& out) {
  std::vector<char> in(fsize);
  {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    size_t got = fread(in.data(), 1, fsize, f);
    fclose(f);
    in.resize(got);
  }
  if (is_gzip(in)) {
    if (!inflate_all(in, out)) return -2;
  } else {
    out = std::move(in);
  }
  return 0;
}

int count_wholebuf(Counter* c, const char* path, size_t fsize) {
  std::vector<char> text;
  int rc = read_inflate(path, fsize, text);
  if (rc != 0) return rc;
  return count_text(c, text.data(), text.size());
}

// ---------- pipelined front end ----------
//
// The reader's only serial work is the read and inflate: it inflates with
// zlib straight into a block and, once the block is full, cuts it after
// the newline whose count since the block start (itself a record
// boundary) is a multiple of 4, hands the record-aligned part to the
// workers, and carries the tail (less than a record) into the next
// block. The workers run the same parse_count the whole-buffer path uses.
// Acceptance is read_inflate's: every gzip member is read; after at least
// one, trailing bytes without gzip magic end the stream; a truncated or
// corrupt member fails the count.

// 1 MB blocks: the last block still parses after the inflate has ended,
// ~13 ms on one worker at ~75 MB/s of FASTQ text
constexpr size_t kBlockBytes = 1 << 20;
constexpr size_t kInBytes = 1 << 20;  // compressed bytes a read

// '\n' bytes in [p, p + n): the reader's one pass over its text, 16
// bytes a step where SSE2 is there
size_t count_newlines(const char* p, size_t n) {
  size_t cnt = 0, i = 0;
#if defined(__SSE2__)
  const __m128i nl = _mm_set1_epi8('\n');
  const __m128i zero = _mm_setzero_si128();
  while (n - i >= 16) {
    // byte lanes count up to 255 matches, then fold into the total
    const size_t stop = i + std::min<size_t>((n - i) / 16, 255) * 16;
    __m128i acc = zero;
    for (; i < stop; i += 16)
      acc = _mm_sub_epi8(acc, _mm_cmpeq_epi8(
          _mm_loadu_si128((const __m128i*)(p + i)), nl));
    const __m128i sums = _mm_sad_epu8(acc, zero);
    cnt += (size_t)_mm_cvtsi128_si32(sums) +
           (size_t)_mm_cvtsi128_si32(_mm_unpackhi_epi64(sums, sums));
  }
#endif
  for (; i < n; ++i) cnt += p[i] == '\n';
  return cnt;
}

int count_pipelined(Counter* c, const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  using Clock = std::chrono::steady_clock;
  const Clock::time_point t0 = Clock::now();
  double waited = 0;  // the reader's waits for room in the queue

  const int n_workers = std::max(1, c->n_threads - 1);
  c->done = false;
  std::atomic<bool> malformed{false};
  std::vector<int64_t> reads_w(n_workers, 0);
  std::vector<std::thread> workers;
  for (int t = 0; t < n_workers; ++t)
    workers.emplace_back([&, t]() {
      Table& tab = c->tables[t];
      int64_t& nk = c->thread_kmers[t];
      while (true) {
        Block b;
        {
          std::unique_lock<std::mutex> lk(c->mu);
          c->cv_get.wait(lk, [&] { return !c->queue.empty() || c->done; });
          if (c->queue.empty()) return;
          b = std::move(c->queue.front());
          c->queue.pop_front();
        }
        c->cv_put.notify_one();
        int64_t r = parse_count(c, tab, nk, b.data.get(), b.data.get() + b.len);
        if (r < 0) malformed.store(true);
        else reads_w[t] += r;
        b.len = 0;
        std::lock_guard<std::mutex> lk(c->mu);
        c->spare.push_back(std::move(b));
      }
    });

  auto take_block = [&](size_t at_least) {
    Block b;
    {
      std::lock_guard<std::mutex> lk(c->mu);
      if (!c->spare.empty()) {
        b = std::move(c->spare.back());
        c->spare.pop_back();
      }
    }
    if (b.cap < at_least) {
      b.cap = std::max(kBlockBytes, at_least);
      b.data.reset(new char[b.cap]);
    }
    return b;
  };
  auto push_block = [&](Block&& b) {
    {
      std::unique_lock<std::mutex> lk(c->mu);
      if (c->queue.size() >= Counter::kMaxQueue) {
        const Clock::time_point w0 = Clock::now();
        c->cv_put.wait(lk, [&] { return c->queue.size() < Counter::kMaxQueue; });
        waited += std::chrono::duration<double>(Clock::now() - w0).count();
      }
      c->queue.push_back(std::move(b));
    }
    c->cv_get.notify_one();
  };

  Block blk = take_block(kBlockBytes);
  size_t nl_cnt = 0;   // newlines in blk.data[0, scanned)
  size_t scanned = 0;
  // blk is full: hand its record-aligned part to the workers and carry
  // the tail into a fresh block; a block holding no whole record grows
  auto cut_full = [&]() {
    nl_cnt += count_newlines(blk.data.get() + scanned, blk.len - scanned);
    scanned = blk.len;
    // step back (nl_cnt % 4) newlines from the last one
    const int back = (int)(nl_cnt & 3);
    const char* last_ok = nullptr;
    size_t q = blk.len;
    for (int i = 0; i <= back; ++i) {
      last_ok = (const char*)memrchr(blk.data.get(), '\n', q);
      if (!last_ok) break;
      q = (size_t)(last_ok - blk.data.get());
    }
    if (!last_ok) {
      Block big = take_block(blk.cap * 2);
      memcpy(big.data.get(), blk.data.get(), blk.len);
      big.len = blk.len;
      blk = std::move(big);
      return;
    }
    const size_t cut = (size_t)(last_ok - blk.data.get()) + 1;
    Block next = take_block(blk.len - cut + 1);
    next.len = blk.len - cut;
    memcpy(next.data.get(), blk.data.get() + cut, next.len);
    blk.len = cut;
    push_block(std::move(blk));
    blk = std::move(next);
    nl_cnt = (size_t)back;  // the tail holds exactly the stepped-back newlines
    scanned = blk.len;
  };

  int rc = 0;
  unsigned char magic[2] = {0, 0};
  const size_t head = fread(magic, 1, 2, f);
  if (head == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
    z_stream zs{};
    std::unique_ptr<unsigned char[]> in(new unsigned char[kInBytes]);
    memcpy(in.get(), magic, 2);
    zs.next_in = in.get();
    zs.avail_in = 2;
    bool in_eof = false;
    // keep what inflate has not consumed, then fill the rest of `in`
    auto refill = [&]() {
      memmove(in.get(), zs.next_in, zs.avail_in);
      const size_t want = kInBytes - zs.avail_in;
      const size_t got = fread(in.get() + zs.avail_in, 1, want, f);
      in_eof = got < want;
      zs.next_in = in.get();
      zs.avail_in += (uInt)got;
    };
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) {
      rc = -2;
    } else {
      size_t produced = 0;
      // whether the member being inflated starts with gzip magic (the
      // first does): only such a member's failure fails the count
      bool member_real = true;
      while (!malformed.load()) {
        if (zs.avail_in == 0 && !in_eof) refill();
        if (blk.len == blk.cap) cut_full();
        zs.next_out = (Bytef*)(blk.data.get() + blk.len);
        zs.avail_out = (uInt)std::min<size_t>(blk.cap - blk.len, 1u << 30);
        const int r = inflate(&zs, Z_NO_FLUSH);
        const size_t got = (size_t)((char*)zs.next_out - (blk.data.get() + blk.len));
        blk.len += got;
        produced += got;
        if (r == Z_STREAM_END) {
          if (zs.avail_in < 2 && !in_eof) refill();
          if (zs.avail_in == 0) break;  // the last member ended the file
          member_real = zs.avail_in >= 2 && zs.next_in[0] == 0x1f &&
                        zs.next_in[1] == 0x8b;
          if (inflateReset2(&zs, 16 + MAX_WBITS) != Z_OK) break;
          continue;
        }
        // a data error, or the input ran out mid-member (Z_BUF_ERROR):
        // tolerated only as trailing garbage after a decoded member
        if (r != Z_OK) {
          if (produced == 0 || member_real) rc = -2;
          break;
        }
      }
      inflateEnd(&zs);
    }
  } else {
    // plain text (only past the cap): the read is the reader's work
    blk.len = head;
    memcpy(blk.data.get(), magic, head);
    while (head == 2 && !malformed.load()) {
      if (blk.len == blk.cap) cut_full();
      const size_t got = fread(blk.data.get() + blk.len, 1, blk.cap - blk.len, f);
      if (got == 0) break;
      blk.len += got;
    }
  }
  if (ferror(f)) rc = -2;
  fclose(f);
  if (rc == 0 && blk.len && !malformed.load())
    push_block(std::move(blk));  // the last records (EOF truncation
                                 // semantics live in parse_count)
  c->inflate_s +=
      std::chrono::duration<double>(Clock::now() - t0).count() - waited;
  {
    std::lock_guard<std::mutex> lk(c->mu);
    c->done = true;
  }
  c->cv_get.notify_all();
  for (auto& w : workers) w.join();
  c->spare.clear();
  if (rc == 0 && malformed.load()) rc = -2;
  for (int64_t r : reads_w) c->total_reads += r;
  return rc;
}

// (key, val) items of one partition, gathered per source table
using PartItems = std::vector<std::pair<uint64_t, uint32_t>>;

// Merge one key-range partition of the per-thread tables into sorted
// (key, count) survivors. Duplicates across tables merge through a small
// per-partition hash table (L2/L3-resident), and ONLY the ci-surviving
// keys are sorted — on deep-coverage data that is ~10x fewer items than
// sorting the raw (key, val) multiset (error k-mers are singletons and
// die at the ci floor; measured 0.16 s -> 0.06 s for the whole finalize).
// uint32 count accumulation saturates (insert_sat), matching the old
// uint64-sum-then-clamp semantics for any uint32 ci/cs.
void merge_items(const std::vector<const PartItems*>& srcs, uint32_t ci,
                 uint32_t cs, MergedPart& out) {
  size_t total = 0;
  for (const PartItems* s : srcs) total += s->size();
  size_t slots = 1ull << 14;
  while (slots * 3 < total * 5) slots <<= 1;  // load factor <= 0.6 up front
  Table pt(slots);
  for (const PartItems* s : srcs)
    for (auto& kv : *s) pt.insert_sat(kv.first, kv.second);
  out.unique = (int64_t)pt.used;
  PartItems items;
  items.reserve(pt.used / 4);
  for (size_t i = 0; i < pt.keys.size(); ++i)
    if (pt.keys[i] != Table::kEmpty && pt.vals[i] >= ci)
      items.emplace_back(pt.keys[i], std::min(pt.vals[i], cs));
  std::sort(items.begin(), items.end());
  out.keys.reserve(items.size());
  out.vals.reserve(items.size());
  for (auto& kv : items) {
    out.keys.push_back(kv.first);
    out.vals.push_back(kv.second);
  }
}

// Scan ONE source table once, bucketing its entries into per-partition
// item lists (scanning every table once per partition instead would read
// each table P times — 8x the memory traffic).
void scatter_table(const Table& t, int shift, int n_parts,
                   std::vector<PartItems>& parts_out) {
  parts_out.assign(n_parts, PartItems());
  for (auto& p : parts_out) p.reserve(t.used / n_parts + 16);
  for (size_t i = 0; i < t.keys.size(); ++i) {
    uint64_t key = t.keys[i];
    if (key != Table::kEmpty)
      parts_out[(int)(key >> shift)].emplace_back(key, t.vals[i]);
  }
}

constexpr int kParts = 8;  // partitions of merge_parts; a power of two

// Merge the per-thread tables into c->parts, kParts sorted key-range
// partitions: partition p owns the keys whose top 3 USED bits equal p
// (keys < 2^(2k), so a fixed 64-bit shift would put everything in
// partition 0), so the merges are independent and the partitions in order
// ARE the globally sorted output (the device path and oracle tests depend
// on sorted extraction order). Pass 1 scans each source table once, one
// thread a table; pass 2 hash-merges each partition and sorts its
// survivors, one thread a partition.
void merge_parts(Counter* c, uint32_t ci, uint32_t cs) {
  const int shift = 2 * c->k - 3;
  const size_t T = c->tables.size();
  std::vector<std::vector<PartItems>> bufs(T);
  {
    std::vector<std::thread> scanners;
    for (size_t t = 0; t < T; ++t)
      scanners.emplace_back(scatter_table, std::cref(c->tables[t]), shift,
                            kParts, std::ref(bufs[t]));
    for (auto& w : scanners) w.join();
  }
  c->parts.assign(kParts, MergedPart());
  std::vector<std::thread> workers;
  for (int p = 0; p < kParts; ++p)
    workers.emplace_back([&, p]() {
      std::vector<const PartItems*> srcs;
      for (size_t t = 0; t < T; ++t) srcs.push_back(&bufs[t][p]);
      merge_items(srcs, ci, cs, c->parts[p]);
    });
  for (auto& w : workers) w.join();
  c->merged = true;
}

// Concatenate partitions [lo, hi) of c->parts into out_keys/out_vals,
// freeing each; returns their distinct keys.
int64_t take_parts(Counter* c, int lo, int hi) {
  size_t total = 0;
  for (int p = lo; p < hi; ++p) total += c->parts[p].keys.size();
  c->out_keys.clear();
  c->out_vals.clear();
  c->out_keys.reserve(total);
  c->out_vals.reserve(total);
  int64_t unique = 0;
  for (int p = lo; p < hi; ++p) {
    MergedPart& m = c->parts[p];
    unique += m.unique;
    c->out_keys.insert(c->out_keys.end(), m.keys.begin(), m.keys.end());
    c->out_vals.insert(c->out_vals.end(), m.vals.begin(), m.vals.end());
    m = MergedPart();
  }
  return unique;
}

}  // namespace

extern "C" {

void* bronko_counter_create(int k, int threads) {
  // k > 32 cannot pack into u64 (count_seq would silently count
  // truncated 32-mers and finalize's key >> (2k-3) shift becomes UB);
  // reject instead — the CLI validates k in [15,31], this guards
  // library embedders
  if (k < 1 || k > 32) return nullptr;
  if (threads < 1) threads = 1;
  if (threads > 16) threads = 16;
  return new Counter(k, threads);
}

void bronko_counter_destroy(void* h) { delete static_cast<Counter*>(h); }

// Count one FASTQ file (gz or plain) through the front end pipes()
// picks. `threads` at create time is the TOTAL budget: the whole-buffer
// front end parses+counts on all of them (the producer is idle after the
// one-shot inflate); the pipelined one runs one reader + threads-1
// counters. Returns 0 on success, -1 on open failure, -2 on malformed
// input.
int bronko_counter_count_fastq(void* h, const char* path) {
  auto* c = static_cast<Counter*>(h);
  int64_t fsize = 0;
  const int piped = pipes(path, &fsize);
  if (piped < 0) return -1;
  if (piped) return count_pipelined(c, path);
  return count_wholebuf(c, path, (size_t)fsize);
}

// 1 when bronko_counter_count_fastq counts the file while it inflates
// (the pipelined front end), 0 when it inflates first (whole buffer), -1
// when the file cannot be opened.
int bronko_counter_pipes(const char* path) {
  int64_t fsize = 0;
  return pipes(path, &fsize);
}

// Wall seconds the pipelined front end's reader spent reading and
// inflating for this handle, its waits for the workers left out; 0 when
// the handle counted no file that way.
double bronko_counter_inflate_seconds(void* h) {
  return static_cast<Counter*>(h)->inflate_s;
}

// Read + inflate a FASTQ file into a buffer for a later
// bronko_counter_count_text call — lets the caller overlap one sample's
// single-threaded inflate with another sample's parse/count (the engine's
// inflate-ahead worker). Returns an opaque buffer handle (free with
// bronko_buffer_free) and writes the text size to *out_size; returns NULL
// with *out_size = -1 when the file exceeds the whole-buffer cap (caller
// falls back to bronko_counter_count_fastq's pipelined front end) or -2 on
// open/corrupt failure.
void* bronko_read_inflate(const char* path, int64_t* out_size) {
  int64_t fsize = whole_buf_size(path);
  *out_size = fsize < 0 ? fsize : 0;
  if (fsize < 0) return nullptr;
  auto* buf = new std::vector<char>();
  if (read_inflate(path, (size_t)fsize, *buf) != 0) {
    *out_size = -2;
    delete buf;
    return nullptr;
  }
  *out_size = (int64_t)buf->size();
  return buf;
}

const char* bronko_buffer_data(void* buf) {
  return static_cast<std::vector<char>*>(buf)->data();
}

void bronko_buffer_free(void* buf) {
  delete static_cast<std::vector<char>*>(buf);
}

// Count an already-inflated FASTQ text buffer (from bronko_read_inflate).
// Returns 0 on success, -2 on malformed input.
int bronko_counter_count_text(void* h, const void* text, int64_t size) {
  return count_text(static_cast<Counter*>(h),
                    static_cast<const char*>(text), (size_t)size);
}

// Merge per-thread tables; apply ci floor and cs cap. Returns kept count,
// all kParts partitions of merge_parts in order.
int64_t bronko_counter_finalize(void* h, uint32_t ci, uint32_t cs) {
  auto* c = static_cast<Counter*>(h);
  if (!c->merged) {
    merge_parts(c, ci, cs);
    c->n_unique = take_parts(c, 0, kParts);
  }
  return (int64_t)c->out_keys.size();
}

// Streaming variant: returns ONE of n_parts key-range partitions
// (partition id = top log2(n_parts) used bits; n_parts a power of two in
// [1, 8]). Those bits nest inside merge_parts' top 3, so partition `part`
// is merge_parts' partitions [part*8/n_parts, (part+1)*8/n_parts). The
// first call of a handle runs the whole threaded merge, so partition 0
// waits for all 8 merges (tens of milliseconds a mate of 150,000 reads)
// and the later calls only copy. The caller dispatches device work on
// partition p before it asks for p+1; that work is a fraction of a
// millisecond a sample, so merging one partition a call to overlap it
// would gain nothing and cost a serial scan of every table per partition.
// Partitions concatenated in order 0..n_parts-1 equal the full finalize
// output, and n_unique after the last one equals its count. Returns -1
// for a part or n_parts outside that range.
int64_t bronko_counter_finalize_part(void* h, int part, int n_parts,
                                     uint32_t ci, uint32_t cs) {
  auto* c = static_cast<Counter*>(h);
  if (n_parts < 1 || n_parts > kParts || (n_parts & (n_parts - 1)) ||
      part < 0 || part >= n_parts)
    return -1;
  if (!c->merged) merge_parts(c, ci, cs);
  const int per = kParts / n_parts;
  c->n_unique += take_parts(c, part * per, (part + 1) * per);
  return (int64_t)c->out_keys.size();
}

int64_t bronko_counter_total_reads(void* h) { return static_cast<Counter*>(h)->total_reads; }

int64_t bronko_counter_total_kmers(void* h) {
  auto* c = static_cast<Counter*>(h);
  int64_t n = 0;
  for (auto v : c->thread_kmers) n += v;
  return n;
}

int64_t bronko_counter_unique(void* h) { return static_cast<Counter*>(h)->n_unique; }

void bronko_counter_extract(void* h, uint64_t* out_kmers, uint32_t* out_counts) {
  auto* c = static_cast<Counter*>(h);
  memcpy(out_kmers, c->out_keys.data(), c->out_keys.size() * sizeof(uint64_t));
  memcpy(out_counts, c->out_vals.data(), c->out_vals.size() * sizeof(uint32_t));
}

}  // extern "C"
