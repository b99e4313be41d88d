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
// Design target: bound by memory bandwidth. Each window reads 1 code byte
// (plus a 31-byte halo per 256-window tile, ~12%) and writes one 8-byte key
// (+1 mask byte at k = 32): about 9 B/window. The design reads every code
// from device memory once: a block stages its tile and halo in shared
// memory, and each thread builds its 2k-bit word from there in a uint64_t
// register. What bounds it as measured has not been profiled; at k = 25 it
// moves well under peak bandwidth, so the per-thread k-step loop may. The TPU
// kernel's two-roll lane shifts and int32 flag arithmetic exist only
// because of Mosaic's layout and type limits and are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;   // windows (threads) per block
constexpr int kHalo = 31;    // k - 1 <= 31 lookahead codes

__device__ __forceinline__ uint64_t reverse_complement(uint64_t w, int k) {
  // reversing all 64 bits also swaps the two bits inside every base;
  // swap them back, then drop the 64 - 2k bits that were above the word
  uint64_t x = __brevll(~w);
  x = ((x >> 1) & 0x5555555555555555ull) | ((x & 0x5555555555555555ull) << 1);
  return x >> (64 - 2 * k);
}

__global__ void extract_kernel(const uint8_t* __restrict__ codes,
                               int64_t* __restrict__ keys,
                               uint8_t* __restrict__ valid, long long n,
                               int k, int canonical) {
  __shared__ uint8_t tile[kTile + kHalo];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const int t = threadIdx.x;
  const long long i = base + t;
  // positions past the end read as 255, which invalidates the trailing
  // k - 1 windows exactly like the Pallas kernel's poisoned halo
  tile[t] = i < n ? codes[i] : 255;
  if (t < kHalo) {
    const long long h = base + kTile + t;
    tile[kTile + t] = h < n ? codes[h] : 255;
  }
  __syncthreads();
  if (i >= n) return;

  uint64_t word = 0;
  bool bad = false;
  for (int j = 0; j < k; ++j) {
    const uint8_t c = tile[t + j];
    bad |= c == 255;
    word = (word << 2) | (c & 3u);
  }
  if (canonical) {
    const uint64_t rc = reverse_complement(word, k);
    word = rc < word ? rc : word;
  }
  if (bad) word = 0;
  if (k < 32) {
    word |= static_cast<uint64_t>(bad) << (2 * k);
  } else {
    valid[i] = !bad;
  }
  keys[i] = static_cast<int64_t>(word ^ (1ull << 63));
}

}  // namespace

// Launches on `stream`; allocates nothing. `valid` is written only for
// k == 32 and may be null otherwise. Returns cudaGetLastError().
extern "C" int gt4_extract(const void* codes, void* keys, void* valid,
                           long long n, int k, int canonical, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > 32 || (k == 32 && valid == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kTile - 1) / kTile;
  extract_kernel<<<static_cast<unsigned>(blocks), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<int64_t*>(keys),
      static_cast<uint8_t*>(valid), n, k, canonical);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gt4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
