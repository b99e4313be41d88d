// Kernel B: run head/tail marks and run statistics over a sorted key stream.
//
// Replaces the Pallas TPU kernel make_run_marks
// (genometester4_tpu/ops/runmarks_pallas.py:32, kernel body :56), whose
// contract is the mark step of ops/sortcount.count_unique(compact=False).
// Plain PyTorch version with the same contract:
// genometester4_tpu_torch/ops/sortcount.py:run_marks. Wrapper:
// ops/runmarks_cuda.py.
//
// Contract: keys[0:n] are sorted int64 keys (bit 63 flipped words), of
// which the first n_valid are valid. For every i:
//   head[i] = i < n_valid and (i == 0 or keys[i-1] != keys[i])
//   tail[i] = i < n_valid and (i == n_valid-1 or keys[i+1] != keys[i])
// and, summed over the grid with uint32 wrap-around,
//   stats[0] = sum(head)  (n_unique)    stats[1] = n_valid entries seen (total)
//   stats[2] = sum(tail * x * (i+1)) - sum(head * x * i)   (checksum)
// with x = hi32(word) ^ lo32(word): the bench checksum of the TPU kernel.
//
// Bound: memory bandwidth, ~10 B/element (one 8-byte key read; the
// neighbour loads hit L1/L2 because adjacent threads share them; two
// 1-byte marks written). Validity comes from the valid-prefix length, not
// from a flag bit, so k = 32 needs no special case. Hopper's blocks run in
// no order, so the Pallas kernel's sequential SMEM carry of the previous
// element is replaced by a direct load of keys[i-1]. The three sums are a
// warp/block reduction followed by one integer atomicAdd per block:
// integer addition is associative, so the result is bit-exact whatever
// order the blocks finish in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;  // grid-stride beyond this

__global__ void run_marks_kernel(const int64_t* __restrict__ keys,
                                 uint8_t* __restrict__ head,
                                 uint8_t* __restrict__ tail,
                                 unsigned int* __restrict__ stats,
                                 long long n, long long n_valid) {
  unsigned int n_unique = 0, total = 0, checksum = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    bool h = false, t = false;
    if (i < n_valid) {
      const int64_t key = keys[i];
      h = i == 0 || keys[i - 1] != key;
      t = i == n_valid - 1 || keys[i + 1] != key;
      const uint64_t word = static_cast<uint64_t>(key) ^ (1ull << 63);
      const unsigned int x = static_cast<unsigned int>(word >> 32) ^
                             static_cast<unsigned int>(word);
      const unsigned int pos = static_cast<unsigned int>(i);
      total += 1;
      n_unique += h;
      if (t) checksum += x * (pos + 1u);
      if (h) checksum -= x * pos;
    }
    head[i] = h;
    tail[i] = t;
  }

  __shared__ unsigned int partial[3][kThreads / 32];
  n_unique = __reduce_add_sync(0xffffffffu, n_unique);
  total = __reduce_add_sync(0xffffffffu, total);
  checksum = __reduce_add_sync(0xffffffffu, checksum);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    partial[0][warp] = n_unique;
    partial[1][warp] = total;
    partial[2][warp] = checksum;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += partial[threadIdx.x][w];
    atomicAdd(&stats[threadIdx.x], s);
  }
}

}  // namespace

// Launches on `stream`; allocates nothing. `stats` must hold three
// zeroed 32-bit words. Returns cudaGetLastError().
extern "C" int gt4_run_marks(const void* keys, void* head, void* tail,
                             void* stats, long long n, long long n_valid,
                             void* stream) {
  if (n <= 0) return 0;
  if (n_valid < 0 || n_valid > n)
    return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  run_marks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(keys), static_cast<uint8_t*>(head),
      static_cast<uint8_t*>(tail), static_cast<unsigned int*>(stats), n,
      n_valid);
  return static_cast<int>(cudaGetLastError());
}
