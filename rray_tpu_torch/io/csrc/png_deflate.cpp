// The host half of a PNG whose deflate matches were searched on the card
// (kernels/deflate.py): the lazy parse of zlib's deflate_slow over the
// per-position match tables, trees.c's blocks, the zlib wrapper and the
// PNG chunks. The bytes are compress2(..., 6)'s, which
// io/csrc/rray_host.cpp::png_encode writes, bit for bit.
//
// Why that holds: at level 6 (good 8, lazy 16, nice 128, chain 128,
// windowBits 15, memLevel 8) deflate_slow inserts every position into
// the hash chains, so the chain of a position depends on the bytes
// alone, and longest_match depends on the parse only through its chain
// limit (128 links, or 32 once prev_length >= good_match) and through
// prev_length, which only decides whether the best match is taken. The
// tables give each position's best match under both limits; this file
// is the sequential rest of deflate.c (zlib 1.2.x, 1.3.x) and trees.c:
//   * deflate_slow's parse: prev_length, match_available, the TOO_FAR
//     (4096) demotion of 3-byte matches, max_lazy 16, and fill_window's
//     slides, replayed for their timing alone: a slide turns the window
//     base into NIL, which matters to a head at exactly MAX_DIST
//     (32,506) only when the input ends within MIN_LOOKAHEAD bytes;
//   * _tr_tally's flush at lit_bufsize - 1 = 16,383 symbols;
//   * _tr_flush_block: build_tree's heap with its depth tie-break,
//     gen_bitlen's overflow repair, the bit-length tree, and the
//     stored / static / dynamic choice, stored only while block_start
//     lies in the window (>= 0 after the slides);
//   * the zlib header 78 9C, zlib's adler32(), and the PNG chunks with
//     zlib's crc32().
// Where trees.c aliases Freq with Code and Dad with Len (ct_data's
// unions), Ct keeps one field for each pair, so the aliasing is the same.
//
// Three threads: the parse fills blocks of symbols, a second thread codes
// them in order as they fill (Ring), and a third sums adler32. On an H100
// machine's host, config 5's 8.3 MB stream took 15.4 ms so, 22.1 ms with
// the blocks coded by the parse's thread, and 25.8 ms on one thread.
#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>

namespace {

constexpr int kLiterals = 256;
constexpr int kLengthCodes = 29;
constexpr int kLCodes = kLiterals + 1 + kLengthCodes;  // 286
constexpr int kDCodes = 30;
constexpr int kBlCodes = 19;
constexpr int kHeapSize = 2 * kLCodes + 1;
constexpr int kMaxBits = 15;
constexpr int kMaxBlBits = 7;
constexpr int kEndBlock = 256;
constexpr int kRep3_6 = 16, kRepz3_10 = 17, kRepz11_138 = 18;

constexpr int64_t kWSize = 32768;
constexpr int64_t kWindowSize = 2 * kWSize;
constexpr int kMinMatch = 3;
constexpr int64_t kMinLookahead = 258 + kMinMatch + 1;  // 262
constexpr int64_t kMaxDist = kWSize - kMinLookahead;    // 32506
constexpr int kTooFar = 4096;
constexpr int kGoodMatch = 8, kMaxLazy = 16;
constexpr int kSymLimit = (1 << (8 + 6)) - 1;  // lit_bufsize - 1

// The match tables' words (kernels/deflate.py): length in bits 0-8 (0 or
// 3..258), distance in bits 9-23, then the flags. A listed word's 32-link
// result is a row (position, word) of its slab of 1024 positions.
constexpr uint32_t kHeadAtMaxDist = 1u << 24;  // the head is 32,506 back
constexpr uint32_t kListed = 1u << 25;   // the 32-link result is listed
constexpr uint32_t kShort32 = 1u << 26;  // the 32-link result is <= 8
constexpr int kSlabBits = 10;

// The listed rows: each slab's rows in position order, where the
// directory says (first row, count).
struct Listed {
  const int32_t* rows;
  const int32_t* directory;

  // The 32-link word of a listed position, or 0 and *missing set.
  uint32_t word(int64_t p, bool* missing) const {
    const int64_t slab = p >> kSlabBits;
    int64_t lo = directory[2 * slab], hi = lo + directory[2 * slab + 1];
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (rows[2 * mid] < p) lo = mid + 1;
      else hi = mid;
    }
    if (lo < directory[2 * slab] + directory[2 * slab + 1] &&
        rows[2 * lo] == p)
      return (uint32_t)rows[2 * lo + 1];
    *missing = true;
    return 0;
  }
};

const int kExtraLBits[kLengthCodes] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                       1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                       4, 4, 4, 4, 5, 5, 5, 5, 0};
const int kExtraDBits[kDCodes] = {0, 0, 0, 0, 1, 1, 2,  2,  3,  3,
                                  4, 4, 5, 5, 6, 6, 7,  7,  8,  8,
                                  9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
const int kExtraBlBits[kBlCodes] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                    0, 0, 0, 0, 0, 0, 2, 3, 7};
const uint8_t kBlOrder[kBlCodes] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                    11, 4,  12, 3, 13, 2, 14, 1, 15};

struct Ct {
  uint16_t fc;  // Freq, then Code
  uint16_t dl;  // Dad, then Len
};

struct StaticDesc {
  const Ct* static_tree;
  const int* extra_bits;
  int extra_base;
  int elems;
  int max_length;
};

struct Statics {
  Ct ltree[kLCodes + 2];
  Ct dtree[kDCodes];
  uint8_t dist_code[512];
  uint8_t length_code[256];
  int base_length[kLengthCodes];
  int base_dist[kDCodes];
};

unsigned bi_reverse(unsigned code, int len) {
  unsigned res = 0;
  do {
    res |= code & 1;
    code >>= 1, res <<= 1;
  } while (--len > 0);
  return res >> 1;
}

void gen_codes(Ct* tree, int max_code, const uint16_t* bl_count) {
  uint16_t next_code[kMaxBits + 1];
  unsigned code = 0;
  for (int bits = 1; bits <= kMaxBits; bits++) {
    code = (code + bl_count[bits - 1]) << 1;
    next_code[bits] = (uint16_t)code;
  }
  for (int n = 0; n <= max_code; n++) {
    int len = tree[n].dl;
    if (len == 0) continue;
    tree[n].fc = (uint16_t)bi_reverse(next_code[len]++, len);
  }
}

Statics make_statics() {
  Statics s{};
  int length = 0, code;
  for (code = 0; code < kLengthCodes - 1; code++) {
    s.base_length[code] = length;
    for (int n = 0; n < (1 << kExtraLBits[code]); n++)
      s.length_code[length++] = (uint8_t)code;
  }
  s.length_code[length - 1] = (uint8_t)code;
  int dist = 0;
  for (code = 0; code < 16; code++) {
    s.base_dist[code] = dist;
    for (int n = 0; n < (1 << kExtraDBits[code]); n++)
      s.dist_code[dist++] = (uint8_t)code;
  }
  dist >>= 7;
  for (; code < kDCodes; code++) {
    s.base_dist[code] = dist << 7;
    for (int n = 0; n < (1 << (kExtraDBits[code] - 7)); n++)
      s.dist_code[256 + dist++] = (uint8_t)code;
  }
  uint16_t bl_count[kMaxBits + 1] = {0};
  int n = 0;
  while (n <= 143) s.ltree[n++].dl = 8, bl_count[8]++;
  while (n <= 255) s.ltree[n++].dl = 9, bl_count[9]++;
  while (n <= 279) s.ltree[n++].dl = 7, bl_count[7]++;
  while (n <= 287) s.ltree[n++].dl = 8, bl_count[8]++;
  gen_codes(s.ltree, kLCodes + 1, bl_count);
  for (n = 0; n < kDCodes; n++) {
    s.dtree[n].dl = 5;
    s.dtree[n].fc = (uint16_t)bi_reverse((unsigned)n, 5);
  }
  return s;
}

const Statics& statics() {
  static const Statics s = make_statics();
  return s;
}

// LSB-first bits into a byte buffer, as send_bits and bi_windup leave
// them in pending_buf.
struct Bits {
  uint8_t* out;
  uint64_t buf = 0;
  int n = 0;

  void send(unsigned value, int length) {
    buf |= (uint64_t)value << n;
    n += length;
    if (n >= 32) {
      uint32_t w = (uint32_t)buf;
      memcpy(out, &w, 4);  // little-endian hosts only (x86-64, aarch64)
      out += 4;
      buf >>= 32;
      n -= 32;
    }
  }
  void windup() {
    while (n > 0) {
      *out++ = (uint8_t)buf;
      buf >>= 8;
      n -= 8;
    }
    buf = 0;
    n = 0;
  }
  void put_byte(uint8_t b) { *out++ = b; }  // only when aligned
};

struct TreeDesc {
  Ct* dyn_tree;
  int max_code;
  const StaticDesc* stat_desc;
};

unsigned d_code(unsigned dist) {
  const Statics& st = statics();
  return dist < 256 ? st.dist_code[dist] : st.dist_code[256 + (dist >> 7)];
}

// One block's symbols and frequencies as _tr_tally leaves them, with what
// _tr_flush_block is then given.
struct Block {
  uint16_t dist[kSymLimit];
  uint8_t lc[kSymLimit];
  int n;
  uint16_t lfreq[kLCodes];
  uint16_t dfreq[kDCodes];
  const uint8_t* buf;  // null where block_start has left the window
  uint64_t stored_len;
  int last;

  // init_block's counts.
  void reset() {
    n = 0;
    memset(lfreq, 0, sizeof lfreq);
    memset(dfreq, 0, sizeof dfreq);
    lfreq[kEndBlock] = 1;
  }
  // _tr_tally; true when the block must be flushed.
  bool tally_lit(uint8_t c) {
    dist[n] = 0;
    lc[n++] = c;
    lfreq[c]++;
    return n == kSymLimit;
  }
  bool tally_dist(unsigned d, unsigned len) {
    dist[n] = (uint16_t)d;
    lc[n++] = (uint8_t)len;
    lfreq[statics().length_code[len] + kLiterals + 1]++;
    dfreq[d_code(d - 1)]++;
    return n == kSymLimit;
  }
};

// trees.c: each block's trees, the choice of block type, and its bits.
class Coder {
 public:
  explicit Coder(uint8_t* out) : bits_{out} {
    const Statics& st = statics();
    l_sd_ = {st.ltree, kExtraLBits, kLiterals + 1, kLCodes, kMaxBits};
    d_sd_ = {st.dtree, kExtraDBits, 0, kDCodes, kMaxBits};
    bl_sd_ = {nullptr, kExtraBlBits, 0, kBlCodes, kMaxBlBits};
    l_desc_ = {dyn_ltree_, 0, &l_sd_};
    d_desc_ = {dyn_dtree_, 0, &d_sd_};
    bl_desc_ = {bl_tree_, 0, &bl_sd_};
  }

  uint8_t* end() const { return bits_.out; }

  // _tr_flush_block, from the block's counts (init_block and _tr_tally).
  void flush_block(const Block& b) {
    for (int n = 0; n < kLCodes; n++) dyn_ltree_[n].fc = b.lfreq[n];
    for (int n = 0; n < kDCodes; n++) dyn_dtree_[n].fc = b.dfreq[n];
    for (int n = 0; n < kBlCodes; n++) bl_tree_[n].fc = 0;
    opt_len_ = static_len_ = 0;
    const uint8_t* buf = b.buf;
    const uint64_t stored_len = b.stored_len;
    const int last = b.last;
    build_tree(&l_desc_);
    build_tree(&d_desc_);
    int max_blindex = build_bl_tree();
    uint64_t opt_lenb = (opt_len_ + 3 + 7) >> 3;
    uint64_t static_lenb = (static_len_ + 3 + 7) >> 3;
    if (static_lenb <= opt_lenb) opt_lenb = static_lenb;
    const Statics& st = statics();
    if (stored_len + 4 <= opt_lenb && buf != nullptr) {
      stored_block(buf, stored_len, last);
    } else if (static_lenb == opt_lenb) {
      bits_.send((1 << 1) + last, 3);
      compress_block(b, st.ltree, st.dtree);
    } else {
      bits_.send((2 << 1) + last, 3);
      send_all_trees(l_desc_.max_code + 1, d_desc_.max_code + 1,
                     max_blindex + 1);
      compress_block(b, dyn_ltree_, dyn_dtree_);
    }
    if (last) bits_.windup();
  }

 private:

  bool smaller(const Ct* tree, int n, int m) const {
    return tree[n].fc < tree[m].fc ||
           (tree[n].fc == tree[m].fc && depth_[n] <= depth_[m]);
  }

  void pqdownheap(const Ct* tree, int k) {
    int v = heap_[k];
    int j = k << 1;
    while (j <= heap_len_) {
      if (j < heap_len_ && smaller(tree, heap_[j + 1], heap_[j])) j++;
      if (smaller(tree, v, heap_[j])) break;
      heap_[k] = heap_[j];
      k = j;
      j <<= 1;
    }
    heap_[k] = v;
  }

  void gen_bitlen(TreeDesc* desc) {
    Ct* tree = desc->dyn_tree;
    int max_code = desc->max_code;
    const Ct* stree = desc->stat_desc->static_tree;
    const int* extra = desc->stat_desc->extra_bits;
    int base = desc->stat_desc->extra_base;
    int max_length = desc->stat_desc->max_length;
    int h, n, m, bits, xbits;
    uint16_t f;
    int overflow = 0;
    for (bits = 0; bits <= kMaxBits; bits++) bl_count_[bits] = 0;
    tree[heap_[heap_max_]].dl = 0;
    for (h = heap_max_ + 1; h < kHeapSize; h++) {
      n = heap_[h];
      bits = tree[tree[n].dl].dl + 1;
      if (bits > max_length) bits = max_length, overflow++;
      tree[n].dl = (uint16_t)bits;
      if (n > max_code) continue;
      bl_count_[bits]++;
      xbits = 0;
      if (n >= base) xbits = extra[n - base];
      f = tree[n].fc;
      opt_len_ += (uint64_t)f * (unsigned)(bits + xbits);
      if (stree) static_len_ += (uint64_t)f * (unsigned)(stree[n].dl + xbits);
    }
    if (overflow == 0) return;
    do {
      bits = max_length - 1;
      while (bl_count_[bits] == 0) bits--;
      bl_count_[bits]--;
      bl_count_[bits + 1] += 2;
      bl_count_[max_length]--;
      overflow -= 2;
    } while (overflow > 0);
    for (bits = max_length; bits != 0; bits--) {
      n = bl_count_[bits];
      while (n != 0) {
        m = heap_[--h];
        if (m > max_code) continue;
        if ((unsigned)tree[m].dl != (unsigned)bits) {
          opt_len_ += ((uint64_t)bits - tree[m].dl) * tree[m].fc;
          tree[m].dl = (uint16_t)bits;
        }
        n--;
      }
    }
  }

  void build_tree(TreeDesc* desc) {
    Ct* tree = desc->dyn_tree;
    const Ct* stree = desc->stat_desc->static_tree;
    int elems = desc->stat_desc->elems;
    int n, m, max_code = -1, node;
    heap_len_ = 0, heap_max_ = kHeapSize;
    for (n = 0; n < elems; n++) {
      if (tree[n].fc != 0) {
        heap_[++heap_len_] = max_code = n;
        depth_[n] = 0;
      } else {
        tree[n].dl = 0;
      }
    }
    while (heap_len_ < 2) {
      node = heap_[++heap_len_] = (max_code < 2 ? ++max_code : 0);
      tree[node].fc = 1;
      depth_[node] = 0;
      opt_len_--;
      if (stree) static_len_ -= stree[node].dl;
    }
    desc->max_code = max_code;
    for (n = heap_len_ / 2; n >= 1; n--) pqdownheap(tree, n);
    node = elems;
    do {
      n = heap_[1];
      heap_[1] = heap_[heap_len_--];
      pqdownheap(tree, 1);
      m = heap_[1];
      heap_[--heap_max_] = n;
      heap_[--heap_max_] = m;
      tree[node].fc = tree[n].fc + tree[m].fc;
      depth_[node] = (uint8_t)((depth_[n] >= depth_[m] ? depth_[n]
                                                        : depth_[m]) + 1);
      tree[n].dl = tree[m].dl = (uint16_t)node;
      heap_[1] = node++;
      pqdownheap(tree, 1);
    } while (heap_len_ >= 2);
    heap_[--heap_max_] = heap_[1];
    gen_bitlen(desc);
    gen_codes(tree, max_code, bl_count_);
  }

  void scan_tree(Ct* tree, int max_code) {
    int prevlen = -1, curlen, nextlen = tree[0].dl, count = 0;
    int max_count = 7, min_count = 4;
    if (nextlen == 0) max_count = 138, min_count = 3;
    tree[max_code + 1].dl = (uint16_t)0xffff;  // guard
    for (int n = 0; n <= max_code; n++) {
      curlen = nextlen;
      nextlen = tree[n + 1].dl;
      if (++count < max_count && curlen == nextlen) {
        continue;
      } else if (count < min_count) {
        bl_tree_[curlen].fc += count;
      } else if (curlen != 0) {
        if (curlen != prevlen) bl_tree_[curlen].fc++;
        bl_tree_[kRep3_6].fc++;
      } else if (count <= 10) {
        bl_tree_[kRepz3_10].fc++;
      } else {
        bl_tree_[kRepz11_138].fc++;
      }
      count = 0;
      prevlen = curlen;
      if (nextlen == 0) {
        max_count = 138, min_count = 3;
      } else if (curlen == nextlen) {
        max_count = 6, min_count = 3;
      } else {
        max_count = 7, min_count = 4;
      }
    }
  }

  void send_code(int c, const Ct* tree) { bits_.send(tree[c].fc, tree[c].dl); }

  void send_tree(const Ct* tree, int max_code) {
    int prevlen = -1, curlen, nextlen = tree[0].dl, count = 0;
    int max_count = 7, min_count = 4;
    if (nextlen == 0) max_count = 138, min_count = 3;
    for (int n = 0; n <= max_code; n++) {
      curlen = nextlen;
      nextlen = tree[n + 1].dl;
      if (++count < max_count && curlen == nextlen) {
        continue;
      } else if (count < min_count) {
        do {
          send_code(curlen, bl_tree_);
        } while (--count != 0);
      } else if (curlen != 0) {
        if (curlen != prevlen) {
          send_code(curlen, bl_tree_);
          count--;
        }
        send_code(kRep3_6, bl_tree_);
        bits_.send(count - 3, 2);
      } else if (count <= 10) {
        send_code(kRepz3_10, bl_tree_);
        bits_.send(count - 3, 3);
      } else {
        send_code(kRepz11_138, bl_tree_);
        bits_.send(count - 11, 7);
      }
      count = 0;
      prevlen = curlen;
      if (nextlen == 0) {
        max_count = 138, min_count = 3;
      } else if (curlen == nextlen) {
        max_count = 6, min_count = 3;
      } else {
        max_count = 7, min_count = 4;
      }
    }
  }

  int build_bl_tree() {
    scan_tree(dyn_ltree_, l_desc_.max_code);
    scan_tree(dyn_dtree_, d_desc_.max_code);
    build_tree(&bl_desc_);
    int max_blindex;
    for (max_blindex = kBlCodes - 1; max_blindex >= 3; max_blindex--)
      if (bl_tree_[kBlOrder[max_blindex]].dl != 0) break;
    opt_len_ += 3 * ((uint64_t)max_blindex + 1) + 5 + 5 + 4;
    return max_blindex;
  }

  void send_all_trees(int lcodes, int dcodes, int blcodes) {
    bits_.send(lcodes - 257, 5);
    bits_.send(dcodes - 1, 5);
    bits_.send(blcodes - 4, 4);
    for (int rank = 0; rank < blcodes; rank++)
      bits_.send(bl_tree_[kBlOrder[rank]].dl, 3);
    send_tree(dyn_ltree_, lcodes - 1);
    send_tree(dyn_dtree_, dcodes - 1);
  }

  void compress_block(const Block& b, const Ct* ltree, const Ct* dtree) {
    const Statics& st = statics();
    for (int i = 0; i < b.n; i++) {
      unsigned dist = b.dist[i];
      int lc = b.lc[i];
      if (dist == 0) {
        send_code(lc, ltree);
        continue;
      }
      unsigned code = st.length_code[lc];
      send_code(code + kLiterals + 1, ltree);
      int extra = kExtraLBits[code];
      if (extra != 0) bits_.send(lc - st.base_length[code], extra);
      dist--;
      code = d_code(dist);
      send_code(code, dtree);
      extra = kExtraDBits[code];
      if (extra != 0) bits_.send(dist - (unsigned)st.base_dist[code], extra);
    }
    send_code(kEndBlock, ltree);
  }

  void stored_block(const uint8_t* buf, uint64_t stored_len, int last) {
    bits_.send((0 << 1) + last, 3);
    bits_.windup();
    uint16_t len = (uint16_t)stored_len, nlen = (uint16_t)~stored_len;
    bits_.put_byte(len & 0xff);
    bits_.put_byte(len >> 8);
    bits_.put_byte(nlen & 0xff);
    bits_.put_byte(nlen >> 8);
    memcpy(bits_.out, buf, stored_len);
    bits_.out += stored_len;
  }

  Bits bits_;
  Ct dyn_ltree_[kHeapSize];
  Ct dyn_dtree_[2 * kDCodes + 1];
  Ct bl_tree_[2 * kBlCodes + 1];
  StaticDesc l_sd_, d_sd_, bl_sd_;
  TreeDesc l_desc_, d_desc_, bl_desc_;
  uint16_t bl_count_[kMaxBits + 1];
  int heap_[2 * kLCodes + 1];
  int heap_len_ = 0, heap_max_ = 0;
  uint8_t depth_[2 * kLCodes + 1];
  uint64_t opt_len_ = 0, static_len_ = 0;
};

// The parse fills blocks and a second thread codes them, in order, through
// a ring of kRing blocks: the parse waits only while every block is full
// and not yet coded.
class Ring {
 public:
  static constexpr int kRing = 4;

  explicit Ring(uint8_t* out) : coder_(out), thread_([this] { code(); }) {
    blocks_[0].reset();
  }
  ~Ring() {
    if (thread_.joinable()) thread_.join();
  }

  Block& current() { return blocks_[filled_ % kRing]; }

  // Hand the current block to the coder and start the next one.
  void submit(const uint8_t* buf, uint64_t stored_len, int last) {
    Block& b = current();
    b.buf = buf, b.stored_len = stored_len, b.last = last;
    std::unique_lock<std::mutex> lock(mutex_);
    filled_++;
    changed_.notify_all();
    if (last) return;
    changed_.wait(lock, [this] { return filled_ - coded_ < kRing; });
    lock.unlock();
    current().reset();
  }

  // Wait for the last block's bits; the end of the stream.
  uint8_t* finish() {
    thread_.join();
    return coder_.end();
  }

 private:
  void code() {
    for (;;) {
      std::unique_lock<std::mutex> lock(mutex_);
      changed_.wait(lock, [this] { return coded_ < filled_; });
      lock.unlock();
      Block& b = blocks_[coded_ % kRing];
      coder_.flush_block(b);
      const bool last = b.last;
      lock.lock();
      coded_++;
      changed_.notify_all();
      if (last) return;
    }
  }

  Block blocks_[kRing];
  Coder coder_;
  std::mutex mutex_;
  std::condition_variable changed_;
  int64_t filled_ = 0, coded_ = 0;  // guarded by mutex_
  std::thread thread_;
};

// deflate_slow over the tables, into `out`; returns the end of the
// deflate stream (header and adler32 excluded), or null where a listed
// position has no row.
uint8_t* deflate_raw(const uint8_t* raw, int64_t n, const uint32_t* table,
                     const Listed& listed, uint8_t* out) {
  bool missing = false;
  Ring* ring = new Ring(out);
  // fill_window's state, replayed: strstart (absolute), the slides so
  // far, the window's read end and what is left to read.
  int64_t pos = 0, slides = 0, read_end = 0, avail_in = n;
  int64_t block_start = 0;  // absolute
  int prev_length, match_length = kMinMatch - 1;
  int64_t prev_match, match_start = 0;
  bool match_available = false;
  auto fill_window = [&]() {
    do {
      int64_t more = kWindowSize - (read_end - slides * kWSize);
      if (pos - slides * kWSize >= kWSize + kMaxDist) {
        slides++;
        more += kWSize;
      }
      if (avail_in == 0) break;
      int64_t got = avail_in < more ? avail_in : more;
      read_end += got;
      avail_in -= got;
    } while (read_end - pos < kMinLookahead && avail_in != 0);
  };
  auto flush = [&](int last) {
    const uint8_t* buf = block_start - slides * kWSize >= 0
                             ? raw + block_start : nullptr;
    ring->submit(buf, (uint64_t)(pos - block_start), last);
    block_start = pos;
  };
  for (;;) {
    if (read_end - pos < kMinLookahead) {
      fill_window();
      if (read_end - pos == 0) break;
    }
    int64_t lookahead = read_end - pos;
    prev_length = match_length;
    prev_match = match_start;
    match_length = kMinMatch - 1;
    if (lookahead >= kMinMatch && prev_length < kMaxLazy) {
      uint32_t e = table[pos];
      // After a slide the window base is NIL: a head there, 32,506 back,
      // is no head, and longest_match is not called.
      bool nil_head = (e & kHeadAtMaxDist) && slides > 0 &&
                      pos - slides * kWSize == kMaxDist;
      if (!nil_head) {
        if (prev_length >= kGoodMatch) {
          if (e & kShort32) e = 0;
          else if (e & kListed) e = listed.word(pos, &missing);
        }
        int len = (int)(e & 511);
        if (len > prev_length) {
          int64_t dist = (e >> 9) & 0x7fff;
          match_length = len;
          match_start = pos - dist;
          if (len == kMinMatch && dist > kTooFar) match_length = kMinMatch - 1;
        }
      }
    }
    if (prev_length >= kMinMatch && match_length <= prev_length) {
      bool bflush = ring->current().tally_dist(
          (unsigned)(pos - 1 - prev_match), (unsigned)(prev_length - kMinMatch));
      pos += prev_length - 1;
      match_available = false;
      match_length = kMinMatch - 1;
      if (bflush) flush(0);
    } else if (match_available) {
      if (ring->current().tally_lit(raw[pos - 1])) flush(0);
      pos++;
    } else {
      match_available = true;
      pos++;
    }
  }
  if (match_available) ring->current().tally_lit(raw[pos - 1]);
  flush(1);
  uint8_t* end = ring->finish();
  delete ring;
  return missing ? nullptr : end;
}

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = v >> 24, p[1] = v >> 16, p[2] = v >> 8, p[3] = v;
}

}  // namespace

extern "C" {

// Encode the raw PNG stream `raw` (height rows of a filter byte 0 and
// width RGBA8 pixels, n bytes) as PNG bytes, from its match tables:
// table[p] for every p < n, the listed rows (position, 32-link word) and
// their directory, [ceil(n / 1024), 2] (first row, count) per slab.
// zlib's adler32 of the stream runs on a second thread beside the parse.
// Returns the byte count and a malloc'd buffer in *out (free with
// png_deflate_free), or -1.
int64_t png_deflate_encode(const uint8_t* raw, int64_t n,
                           const uint32_t* table, const int32_t* rows,
                           const int32_t* directory, int64_t width,
                           int64_t height, uint8_t** out) {
  if (n != height * (4 * width + 1) || n <= 0) return -1;
  // compressBound's stored-block worst case, the zlib wrapper and the
  // chunks around it.
  uint64_t cap = compressBound((uLong)n) + 8 + 25 + 12 + 12 + 64;
  uint8_t* png = (uint8_t*)malloc(cap);
  if (!png) return -1;
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a,
                                   0x0a};
  uint8_t* p = png;
  memcpy(p, magic, 8);
  p += 8;
  put_be32(p, 13);
  memcpy(p + 4, "IHDR", 4);
  put_be32(p + 8, (uint32_t)width);
  put_be32(p + 12, (uint32_t)height);
  p[16] = 8, p[17] = 6, p[18] = 0, p[19] = 0, p[20] = 0;
  put_be32(p + 21, (uint32_t)crc32(0, p + 4, 17));
  p += 25;
  uint8_t* idat = p;
  memcpy(idat + 4, "IDAT", 4);
  uint8_t* z = idat + 8;
  z[0] = 0x78, z[1] = 0x9c;
  uLong adler = adler32(0, nullptr, 0);
  std::thread sum([&] { adler = adler32(adler, raw, (uInt)n); });
  uint8_t* zend = deflate_raw(raw, n, table, Listed{rows, directory}, z + 2);
  sum.join();
  if (!zend) {
    free(png);
    return -1;
  }
  put_be32(zend, (uint32_t)adler);
  zend += 4;
  uint32_t idat_len = (uint32_t)(zend - z);
  put_be32(idat, idat_len);
  put_be32(zend, (uint32_t)crc32(0, idat + 4, idat_len + 4));
  p = zend + 4;
  put_be32(p, 0);
  memcpy(p + 4, "IEND", 4);
  put_be32(p + 8, (uint32_t)crc32(0, p + 4, 4));
  p += 12;
  *out = png;
  return (int64_t)(p - png);
}

void png_deflate_free(uint8_t* buf) { free(buf); }

const char* png_deflate_zlib_version() { return zlibVersion(); }

}  // extern "C"
