// Kernel A: k-mer window extraction + canonicalization -> int64 sort keys.
//
// Replaces the Pallas TPU kernel make_extract_pallas
// (genometester4_tpu/ops/extract_pallas.py:55, kernel body :78). Plain
// PyTorch version with the same contract: genometester4_tpu_torch/ops/
// kmers.py:extract_kmers. Wrapper: ops/extract_cuda.py.
//
// Contract: for n 2-bit codes (uint8, 255 = invalid base or record
// separator) emit n keys. Key i is the window of k codes starting at i,
// packed big-endian into 2k bits, made canonical (unsigned min of the word
// and its reverse complement) when asked, with bit 63 flipped so signed
// int64 order is unsigned word order. A window holding a 255, or running
// past the end (the trailing k-1 positions), is invalid: its word is 0 and
//   k <= 31: the flag bit 2k is set, so it sorts after every valid key;
//   k == 32: no bit is free, so valid[i] = 0 is written to a mask instead.
//
// What bounds it. The function moves 9 B per window (1 code byte in, one
// 8-byte key out; +1 mask byte at k = 32), 0.090 ms for 2^25 windows at
// 3.35 TB/s. The first form (one window per thread, a k-step loop of a
// shared-memory byte load, a compare and a 64-bit shift and OR per base)
// spent ~7 instructions per base, ~175 per window at k = 25: ~6 G integer
// operations for 2^25 windows, 0.35-0.40 ms at 16.7 T op/s of the
// measured 0.464 ms on an H100 80GB HBM3 (700 W). It was bound by
// instructions, not bytes. This form measures ~0.11 ms per call at 2^25,
// k = 25, with calls queued back to back (~82% of the bytes bound; ~0.13
// ms for one call alone, the wrapper's host work included): it is bound
// by memory, as designed (tools/time_kernels.py, chip_smoke.py).
//
// Design: a streaming pass with a rolling word, k a template parameter.
//   1. Load. A block of 128 threads owns a tile of 4096 windows. It copies
//      the tile's codes and a 32-code halo (k - 1 <= 31) into shared
//      memory as 16-byte chunks. A codes pointer that is not 16-byte
//      aligned is read as two aligned chunks funnel-shifted together;
//      chunks that reach past n are read byte by byte, and positions past
//      n read as 255, which invalidates the trailing k - 1 windows.
//   2. Roll. Thread t owns the 32 consecutive windows at 32t. It reads its
//      32 + k - 1 codes as four 16-byte words, primes its forward word with
//      k - 1 codes, then per window shifts in one code (fwd), shifts the
//      complement in at the top of the reverse complement (rc, taken whole
//      by bit reversal for the first window only) and keeps the position
//      of the last 255 seen: a window is valid iff that lies before its
//      start. About 20 integer operations per window plus (k - 1) x 6 / 32
//      for priming, all with compile-time shifts.
//   3. Store. Keys are staged in shared memory as 16-byte pairs, XOR-
//      swizzled so that both the thread-strided writes and the contiguous
//      reads are free of bank conflicts, then written with 16-byte stores,
//      neighbouring lanes on neighbouring addresses. The k = 32 mask bytes
//      go out the same way.
// The TPU kernel's two-roll lane shifts and int32 flag arithmetic exist
// only because of Mosaic's layout and type limits and are not carried
// over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                  // threads per block
constexpr int kWin = 32;                       // windows per thread
constexpr int kTile = kThreads * kWin;         // windows per block
constexpr int kHalo = 32;                      // codes past the tile (>= 31)
constexpr int kChunks = (kTile + kHalo) / 16;  // 16-byte code chunks
constexpr int kKeyUnits = kTile / 2;           // 16-byte pairs of keys
constexpr int kMaskUnits = kTile / 16;         // 16-byte units of mask bytes

__device__ __forceinline__ uint64_t reverse_complement(uint64_t w, int k) {
  // reversing all 64 bits also swaps the two bits inside every base;
  // swap them back, then drop the 64 - 2k bits that were above the word
  uint64_t x = __brevll(~w);
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return x >> (64 - 2 * k);
}

// Bytes [off, off + 16) of the 32 bytes lo:hi (0 <= off < 16).
__device__ __forceinline__ uint4 shift_bytes(uint4 lo, uint4 hi, int off) {
  const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int s = off >> 2, b = 8 * (off & 3);
  uint32_t y[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    y[j] = s == 0 ? x[j] : s == 1 ? x[j + 1] : s == 2 ? x[j + 2] : x[j + 3];
  return make_uint4(__funnelshift_r(y[0], y[1], b),
                    __funnelshift_r(y[1], y[2], b),
                    __funnelshift_r(y[2], y[3], b),
                    __funnelshift_r(y[3], y[4], b));
}

// Codes [g, g + 16) as one 16-byte chunk, 255 past n. `off` is the codes
// pointer's misalignment (its address mod 16), the same for every chunk.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* __restrict__ codes,
                                            long long n, long long g,
                                            int off) {
  if (off == 0 && g + 16 <= n)
    return *reinterpret_cast<const uint4*>(codes + g);
  if (off != 0 && g >= off && g - off + 32 <= n) {
    const uint4* p = reinterpret_cast<const uint4*>(codes + g - off);
    return shift_bytes(p[0], p[1], off);
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t b = g + j < n ? codes[g + j] : 255u;
    w[j >> 2] |= b << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Physical slot of a thread's pair m of keys (conflict-free both ways).
__device__ __forceinline__ int key_slot(int t, int m) {
  return t * (kWin / 2) + (m ^ (t & 7));
}

// Physical slot of a thread's 16-byte half h of its 32 mask bytes.
__device__ __forceinline__ int mask_slot(int t, int h) {
  return 2 * t + (h ^ ((t >> 2) & 1));
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    extract_kernel(const uint8_t* __restrict__ codes,
                   int64_t* __restrict__ keys, uint8_t* __restrict__ valid,
                   long long n, int canonical) {
  __shared__ uint4 s_codes[kChunks];
  __shared__ uint4 s_keys[kKeyUnits];
  __shared__ uint4 s_mask[K == 32 ? kMaskUnits : 1];

  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int tid = threadIdx.x;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  for (int i = tid; i < kChunks; i += kThreads)
    s_codes[i] = load_chunk(codes, n, base + 16ll * i, off);
  __syncthreads();

  // this thread's codes [32 tid, 32 tid + 64) as 16 words, 4 codes each
  uint32_t c[16];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint4 u = s_codes[2 * tid + v];
    c[4 * v] = u.x;
    c[4 * v + 1] = u.y;
    c[4 * v + 2] = u.z;
    c[4 * v + 3] = u.w;
  }

  constexpr uint64_t kMask = ~0ull >> (64 - 2 * K);
  uint64_t fwd = 0, rc = 0, prev = 0;
  int last = -1;   // index of the last 255 among the codes read
#pragma unroll
  for (int q = 0; q < K - 1; ++q) {
    const uint32_t b = (c[q >> 2] >> (8 * (q & 3))) & 0xffu;
    if (b == 255u) last = q;
    fwd = (fwd << 2) | (b & 3u);
  }
  uint32_t mask_words[K == 32 ? kWin / 4 : 1] = {};
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const int q = j + K - 1;
    const uint32_t b = (c[q >> 2] >> (8 * (q & 3))) & 0xffu;
    if (b == 255u) last = q;
    const uint64_t code = b & 3u;
    fwd = ((fwd << 2) | code) & kMask;
    rc = j == 0 ? reverse_complement(fwd, K)
                : (rc >> 2) | ((code ^ 3u) << (2 * K - 2));
    uint64_t word = canonical && rc < fwd ? rc : fwd;
    const bool ok = last < j;
    if constexpr (K < 32) {
      word = ok ? word : 1ull << (2 * K);
    } else {
      word = ok ? word : 0;
      mask_words[j >> 2] |= static_cast<uint32_t>(ok) << (8 * (j & 3));
    }
    word ^= 1ull << 63;
    if (j & 1)
      s_keys[key_slot(tid, j >> 1)] = make_uint4(
          static_cast<uint32_t>(prev), static_cast<uint32_t>(prev >> 32),
          static_cast<uint32_t>(word), static_cast<uint32_t>(word >> 32));
    prev = word;
  }
  if constexpr (K == 32) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      s_mask[mask_slot(tid, h)] =
          make_uint4(mask_words[4 * h], mask_words[4 * h + 1],
                     mask_words[4 * h + 2], mask_words[4 * h + 3]);
  }
  __syncthreads();

  for (int v = tid; v < kKeyUnits; v += kThreads) {
    const long long p = base + 2ll * v;
    if (p >= n) break;
    const uint4 u = s_keys[key_slot(v / (kWin / 2), v % (kWin / 2))];
    if (p + 2 <= n) {
      *reinterpret_cast<uint4*>(keys + p) = u;
    } else {
      keys[p] = static_cast<int64_t>(
          (static_cast<uint64_t>(u.y) << 32) | u.x);
    }
  }
  if constexpr (K == 32) {
    for (int v = tid; v < kMaskUnits; v += kThreads) {
      const long long p = base + 16ll * v;
      if (p >= n) break;
      const uint4 u = s_mask[mask_slot(v >> 1, v & 1)];
      if (p + 16 <= n) {
        *reinterpret_cast<uint4*>(valid + p) = u;
      } else {
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
        for (int j = 0; p + j < n; ++j)
          valid[p + j] = static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
}

using Kernel = void (*)(const uint8_t*, int64_t*, uint8_t*, long long, int);

template <int K>
Kernel kernel_for(int k) {
  if constexpr (K > 32) {
    return nullptr;
  } else {
    return k == K ? extract_kernel<K> : kernel_for<K + 1>(k);
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. `keys` and `valid` must be
// 16-byte aligned (the wrapper allocates them); `codes` may have any
// alignment. `valid` is written only for k == 32 and may be null
// otherwise. Returns cudaGetLastError().
extern "C" int gt4_extract(const void* codes, void* keys, void* valid,
                           long long n, int k, int canonical, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 32 || (k == 32 && valid == nullptr) ||
      (reinterpret_cast<uintptr_t>(keys) & 15) ||
      (reinterpret_cast<uintptr_t>(valid) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kTile - 1) / kTile;
  kernel_for<1>(k)<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<int64_t*>(keys),
      static_cast<uint8_t*>(valid), n, canonical);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
