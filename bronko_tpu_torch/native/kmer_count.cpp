// Host-side streaming k-mer counter (KMC3-equivalent semantics).
//
// Counts non-canonical k-mers (KMC -b) from FASTQ, skipping windows that
// contain non-ACGT bases, flooring at ci and capping at cs
// (reference invocation: call.rs:1166-1181).
//
// Two front ends feed the same per-thread open-addressing tables:
//
//  * whole-buffer (the common case, files up to a few hundred MB
//    compressed): the file is read once, inflated in one shot (libdeflate
//    via dlopen when present — measured ~2.5x zlib — else zlib), cut into
//    record-aligned slices by newline phase (a vectorized newline count
//    per region + <=3 memchr steps to reach the next 4-line boundary),
//    and the slices are parsed AND counted by the worker threads. The
//    producer thread does no per-record work at all, so the pipeline's
//    serial section is just inflate.
//  * streaming (large-file fallback): one reader thread decompresses and
//    cuts the stream into record-aligned raw blocks; workers parse AND
//    count the blocks with the same slice parser the whole-buffer path
//    uses, so inflate is the reader's only serial work.
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

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
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
        // saturate: the streaming path has no input-size cap, and one
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

struct Batch {
  std::vector<char> seq;  // record-aligned raw FASTQ text
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

  // streaming-pipeline state
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  std::deque<Batch> queue;
  bool done = false;
  static constexpr size_t kMaxQueue = 8;

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

constexpr size_t kReadBlock = 8 << 20;
// whole-buffer front-end input caps (compressed gz ~8x smaller than text);
// BRONKO_WHOLEBUF_MAX (bytes) overrides both — tests use it to force the
// streaming path on small fixtures
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
// -1 on malformed input. Record-acceptance semantics match the streaming
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

// Whole-buffer eligibility: the file's byte size when it fits the
// front-end cap for its kind (gzip sniffed from the magic), -1 when it
// must stream, -2 on open failure. Shared by count_fastq and
// read_inflate so their wholebuf-vs-streaming decisions cannot drift.
int64_t whole_buf_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -2;
  bool gz = false;
  {
    FILE* f = fopen(path, "rb");
    if (!f) return -2;
    unsigned char head[2];
    size_t got = fread(head, 1, 2, f);
    fclose(f);
    gz = got == 2 && head[0] == 0x1f && head[1] == 0x8b;
  }
  return (size_t)st.st_size <= whole_buf_cap(gz) ? (int64_t)st.st_size : -1;
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

// ---------- streaming fallback (large files) ----------
//
// The reader's ONLY serial work is inflate: it emits record-ALIGNED raw
// text blocks (boundary = after the newline whose count since the block
// start — itself a record boundary — is a multiple of 4), and the workers
// run the same parse_count the whole-buffer path uses. The old reader
// split and copied every record itself, which bottlenecked the pipeline
// on one thread.

int count_streaming(Counter* c, const char* path) {
  gzFile gz = gzopen(path, "rb");
  if (!gz) return -1;
  gzbuffer(gz, 1 << 20);

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
        Batch b;
        {
          std::unique_lock<std::mutex> lk(c->mu);
          c->cv_get.wait(lk, [&] { return !c->queue.empty() || c->done; });
          if (c->queue.empty()) return;
          b = std::move(c->queue.front());
          c->queue.pop_front();
        }
        c->cv_put.notify_one();
        int64_t r = parse_count(c, tab, nk, b.seq.data(),
                                b.seq.data() + b.seq.size());
        if (r < 0) malformed.store(true);
        else reads_w[t] += r;
      }
    });

  auto push_block = [&](std::vector<char>&& text) {
    Batch b;
    b.seq = std::move(text);
    {
      std::unique_lock<std::mutex> lk(c->mu);
      c->cv_put.wait(lk, [&] { return c->queue.size() < Counter::kMaxQueue; });
      c->queue.push_back(std::move(b));
    }
    c->cv_get.notify_one();
  };

  int rc = 0;
  std::vector<char> buf;  // always begins at a record boundary
  size_t nl_cnt = 0;      // newlines in buf (incremental)
  bool eof = false;
  while (!eof && rc == 0 && !malformed.load()) {
    size_t old = buf.size();
    buf.resize(old + kReadBlock);
    int n = gzread(gz, buf.data() + old, (unsigned)kReadBlock);
    if (n < 0) { rc = -2; break; }
    buf.resize(old + (size_t)n);
    if (n == 0) {
      // a TRUNCATED gzip stream surfaces as n==0 with a pending zlib
      // error (Z_BUF_ERROR "unexpected end of file"), not as n<0 —
      // treating it as EOF would silently count a prefix of the sample
      int errnum = Z_OK;
      gzerror(gz, &errnum);
      if (errnum != Z_OK && errnum != Z_STREAM_END) rc = -2;
      eof = true;
      break;
    }
    for (size_t i = old; i < buf.size(); ++i) nl_cnt += (buf[i] == '\n');
    // cut after the newline whose count from the block start is the
    // largest multiple of 4: step back (nl_cnt % 4) newlines from the last
    int back = (int)(nl_cnt & 3);
    const char* last_ok = nullptr;
    size_t q = buf.size();
    for (int i = 0; i <= back; ++i) {
      const void* nl = memrchr(buf.data(), '\n', q);
      if (!nl) { last_ok = nullptr; break; }
      last_ok = (const char*)nl;
      q = (size_t)((const char*)nl - buf.data());
    }
    if (!last_ok) continue;  // no full record yet; keep reading
    size_t cut = (size_t)(last_ok - buf.data()) + 1;
    if (cut == 0) continue;
    std::vector<char> tail(buf.begin() + cut, buf.end());
    buf.resize(cut);
    push_block(std::move(buf));
    buf = std::move(tail);
    nl_cnt = back;  // the tail holds exactly the stepped-back newlines
  }
  if (rc == 0 && !buf.empty() && !malformed.load())
    push_block(std::move(buf));  // final partial block (EOF truncation
                                 // semantics live in parse_count)
  {
    std::lock_guard<std::mutex> lk(c->mu);
    c->done = true;
  }
  c->cv_get.notify_all();
  for (auto& w : workers) w.join();
  gzclose(gz);
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

// Count one FASTQ file (gz or plain). `threads` at create time is the
// TOTAL budget: the whole-buffer front end parses+counts on all of them
// (the producer is idle after the one-shot inflate); the streaming
// fallback runs one reader + threads-1 counters.
// Returns 0 on success, -1 on open failure, -2 on malformed input.
int bronko_counter_count_fastq(void* h, const char* path) {
  auto* c = static_cast<Counter*>(h);
  int64_t fsize = whole_buf_size(path);
  if (fsize == -2) return -1;
  if (fsize >= 0) return count_wholebuf(c, path, (size_t)fsize);
  return count_streaming(c, path);
}

// Read + inflate a FASTQ file into a buffer for a later
// bronko_counter_count_text call — lets the caller overlap one sample's
// single-threaded inflate with another sample's parse/count (the engine's
// inflate-ahead worker). Returns an opaque buffer handle (free with
// bronko_buffer_free) and writes the text size to *out_size; returns NULL
// with *out_size = -1 when the file exceeds the whole-buffer cap (caller
// falls back to bronko_counter_count_fastq's streaming path) or -2 on
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
