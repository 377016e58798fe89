// The PNG of a CLI frame whose image lies on the card: its raw stream and
// the match search of zlib's deflate_slow at level 6, for every position
// at once (kernels/deflate.py; the host's emitter, io/csrc/png_deflate.cpp,
// turns the tables into compress2's bytes).
//
// It replaces no TPU kernel: rray_tpu quantizes and deflates on the host
// (native/rray_host.cpp::png_encode, compress2 at level 6). There,
// deflate_slow inserts every position into zlib's hash chains and walks a
// chain at every position it reaches; at config 5's 1920x1080 (8,295,480
// raw bytes) that search was ~85% of a 128-ms deflate on one host thread.
// A position's chain depends only on the bytes, so every position is
// searched here in parallel, and the host keeps only the lazy parse and
// the Huffman blocks over ~400 k symbols.
//
//   png_quantize_kernel   [h, w, 3] float32 -> h rows of a filter byte 0
//                         and RGBA8 (alpha 255), quantize_rgba's cast;
//                         one thread per output byte.
//   deflate_match_kernel  longest_match under the chain limits 128 and 32
//                         for every position (kernels/deflate.py says what
//                         a table word holds).
//
// What bounds the match search on an H100: neither bytes nor arithmetic
// units but the walks themselves, data-dependent loops of dependent
// shared-memory reads. A flat region ends its walk at its first
// candidate after a 258-byte comparison; a textured one walks up to 128
// links of short comparisons. The least work is what these inputs need:
// the 4-byte words compared (one at scan_end for each candidate once a
// match is held, and the whole comparison of each candidate that passes
// it) and the links followed. The design:
//   * a block takes a tile of kTile positions and stages in shared memory
//     everything its walks can touch: the bytes from MAX_DIST before the
//     tile to 258 past it, and the links from MAX_DIST before it (122 KB),
//     so no walk reads device memory;
//   * a comparison takes 4 bytes at a time from two aligned words and a
//     funnel shift, and the first differing byte from the xor's lowest
//     set bit; a candidate is first checked at the 4 bytes that end at
//     the best length so far (it can only win if they agree), as
//     longest_match checks scan_end;
//   * each thread walks its own positions, neighbours in one warp, so a
//     warp's walks see the same texture and diverge little;
//   * the 32-link exceptions (a fifth of the positions of a rendered
//     frame) are compacted in order within each slab of 1024 positions,
//     whose rows one atomic add reserves; a directory gives each slab's
//     rows, so the host looks up the few it needs by binary search.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxMatch = 258;
constexpr int kMaxDist = 32506;
constexpr int kNiceMatch = 128;
constexpr int kMaxChain = 128;
constexpr int kGoodChain = kMaxChain >> 2;
constexpr int kGoodMatch = 8;
constexpr uint32_t kHeadAtMaxDist = 1u << 24;
constexpr uint32_t kListed = 1u << 25;
constexpr uint32_t kShort32 = 1u << 26;

constexpr int kTile = 8192;
constexpr int kThreads = 1024;
constexpr int kSlabBits = 10;  // a slab: kThreads positions, one per thread
static_assert(kThreads == 1 << kSlabBits, "one slab per pass of the block");
constexpr int kBack = 32512;  // >= kMaxDist, a multiple of 4
constexpr int kByteSpan = kBack + kTile + 272;
constexpr int kLinkSpan = kBack + kTile;
constexpr int kSmemBytes = kByteSpan + 2 * kLinkSpan;

__global__ void png_quantize_kernel(const float* __restrict__ image,
                                    uint8_t* __restrict__ raw, int w,
                                    int64_t n) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = 4 * w + 1;
  const int64_t y = i / row;
  const int r = (int)(i - y * row);
  uint8_t v = 0;
  if (r != 0) {
    const int c = (r - 1) & 3;
    if (c == 3) {
      v = 255;
    } else {
      float f = image[(y * w + ((r - 1) >> 2)) * 3 + c] * 255.0f;
      if (!(f > 0.0f)) f = 0.0f;  // NaN -> 0, as quantize_rgba
      if (f > 255.0f) f = 255.0f;
      v = (uint8_t)f;  // truncation toward zero
    }
  }
  raw[i] = v;
}

// Bytes off..off+3 of the staged window, little-endian.
__device__ __forceinline__ uint32_t load4(const uint32_t* words, int off) {
  const int i = off >> 2;
  return __funnelshift_r(words[i], words[i + 1], (off & 3) << 3);
}

// How many bytes at a and b agree, at most cap (cap >= 1; bytes past the
// stream are staged as zeros and the cap cuts them off).
__device__ __forceinline__ int match_len(const uint32_t* words, int a, int b,
                                         int cap) {
  int len = 0;
  for (;;) {
    const uint32_t x = load4(words, a + len) ^ load4(words, b + len);
    if (x) {
      len += (__ffs(x) - 1) >> 3;
      break;
    }
    len += 4;
    if (len >= cap) break;
  }
  return len < cap ? len : cap;
}

__global__ void __launch_bounds__(kThreads)
    deflate_match_kernel(const uint8_t* __restrict__ raw,
                         const int16_t* __restrict__ link, int n,
                         uint32_t* __restrict__ table,
                         int32_t* __restrict__ exceptions,
                         int32_t* __restrict__ directory, int n_slabs,
                         int* __restrict__ count) {
  extern __shared__ uint32_t smem[];
  __shared__ int warp_rows[kThreads / 32];
  __shared__ int slab_base;
  uint32_t* words = smem;
  uint16_t* links = reinterpret_cast<uint16_t*>(smem + kByteSpan / 4);
  const int s = blockIdx.x * kTile;
  const int base = s > kBack ? s - kBack : 0;
  // Stage the bytes [base, s + kTile + 272), zero past the stream, and
  // the links [base, s + kTile).
  const int n_words = (s + kTile + 272 - base) >> 2;
  for (int i = threadIdx.x; i < n_words; i += kThreads) {
    const int at = base + 4 * i;
    uint32_t v = 0;
    if (at + 4 <= n) {
      v = reinterpret_cast<const uint32_t*>(raw)[at >> 2];
    } else {
      for (int k = 0; k < 4 && at + k < n; k++)
        v |= (uint32_t)raw[at + k] << (8 * k);
    }
    words[i] = v;
  }
  const int n_links = s + kTile - base;
  for (int i = threadIdx.x; i < n_links; i += kThreads)
    links[i] = base + i < n ? (uint16_t)link[base + i] : 0;
  __syncthreads();

  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = 0; j < kTile / kThreads; j++) {
    const int p = s + j * kThreads + threadIdx.x;
    const int pl = p - base;
    const int l = p < n ? links[pl] : 0;
    uint32_t word = 0, alt = 0;
    bool listed = false;
    if (l > 0) {
      const int left = n - p;
      const int cap = left < kMaxMatch ? left : kMaxMatch;
      const int nice = left < kNiceMatch ? left : kNiceMatch;
      int best = 2, best_d = 0, best32 = -1, best_d32 = 0;
      int cur = pl - l;
      for (int k = 1;; k++) {
        if (best < 3 || load4(words, cur + best - 3) ==
                            load4(words, pl + best - 3)) {
          const int len = match_len(words, cur, pl, cap);
          if (len > best) {
            best = len;
            best_d = pl - cur;
            if (len >= nice) break;
          }
        }
        if (k == kGoodChain) best32 = best, best_d32 = best_d;
        if (k == kMaxChain) break;
        const int step = links[cur];
        if (step == 0) break;
        cur -= step;
        if (pl - cur >= kMaxDist) break;
      }
      if (best >= 3) word = (uint32_t)best | ((uint32_t)best_d << 9);
      if (l == kMaxDist) word |= kHeadAtMaxDist;
      if (best32 >= 0 && best32 != best) {
        if (best32 > kGoodMatch) {
          word |= kListed;
          listed = true;
          alt = (uint32_t)best32 | ((uint32_t)best_d32 << 9);
        } else {
          word |= kShort32;
        }
      }
    }
    if (p < n) table[p] = word;
    // This slab's listed rows, in position order, at a range reserved
    // with one atomic add; the directory says where.
    const unsigned mask = __ballot_sync(0xffffffffu, listed);
    if (lane == 0) warp_rows[warp] = __popc(mask);
    __syncthreads();
    if (warp == 0) {
      const int own = warp_rows[lane];
      int before = own;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, before, d);
        if (lane >= (unsigned)d) before += v;
      }
      if (lane == 31) {
        slab_base = before ? atomicAdd(count, before) : 0;
        const int slab = (s >> kSlabBits) + j;
        if (slab < n_slabs) {
          directory[2 * slab] = slab_base;
          directory[2 * slab + 1] = before;
        }
      }
      warp_rows[lane] = before - own;
    }
    __syncthreads();
    if (listed) {
      const int row = slab_base + warp_rows[warp] +
                      __popc(mask & ((1u << lane) - 1));
      exceptions[2 * row] = p;
      exceptions[2 * row + 1] = (int32_t)alt;
    }
  }
}

}  // namespace

// Launches on `stream` and returns a CUDA error code (0 on success).
// image: contiguous float32 [h, w, 3] on the card; raw: h * (4w + 1)
// bytes, written whole.
extern "C" int png_quantize_launch(const void* image, void* raw, int w,
                                   int h, void* stream) {
  const int64_t n = (int64_t)h * (4 * w + 1);
  if (n <= 0) return 0;
  const int threads = 256;
  png_quantize_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<uint8_t*>(raw), w, n);
  return static_cast<int>(cudaGetLastError());
}

// raw: the n-byte stream; link: int16 [n] (kernels/deflate.py::
// chain_links); table: int32 [n], written whole; exceptions: int32 [n, 2],
// of which the first *count rows are written (count must read 0 at the
// launch, and the device's 4-byte alignment of raw is assumed);
// directory: int32 [ceil(n / 1024), 2], each slab's first row and count.
extern "C" int deflate_match_launch(const void* raw, const void* link, int n,
                                    void* table, void* exceptions,
                                    void* directory, void* count,
                                    void* stream) {
  if (n <= 0) return 0;
  // Per launch: the attribute belongs to the current device.
  const cudaError_t err = cudaFuncSetAttribute(
      deflate_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = (unsigned)((n + kTile - 1) / kTile);
  deflate_match_kernel<<<blocks, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const int16_t*>(link), n,
      static_cast<uint32_t*>(table), static_cast<int32_t*>(exceptions),
      static_cast<int32_t*>(directory), (n + kThreads - 1) / kThreads,
      static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}
