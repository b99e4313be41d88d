// Kernel E: merge every pair of aligned sorted runs with the GPU merge path.
//
// Replaces the Pallas TPU kernel make_block_merge
// (genometester4_tpu/ops/bitonic_merge_pallas.py:47, kernel body :75) with
// the contract of its callers merge_sorted_runs and merge_round (:154,
// :200). Plain PyTorch version with the same contract:
// genometester4_tpu_torch/ops/merge_runs.py:merge_runs. Wrapper:
// ops/merge_runs_cuda.py.
//
// Contract: keys[0:n] are int64 keys (bit 63 flipped words) in which every
// aligned run of L is sorted, and n is a multiple of 2L. For every span
// [s*2L, (s+1)*2L), run A = its first L keys and run B = its last L, the
// kernel writes the span's keys sorted into out[] and, for every output
// slot, the input position of its key into pos[] (int32, n < 2^31).
// Equal keys keep their order and A's come before B's: the result is the
// one of a stable sort, bit for bit. The wrapper gathers any payloads with
// pos[], so payloads need no code here.
//
// Design (Green, McColl & Bader, "GPU merge path", 2012). The TPU kernel
// runs a bitonic network over a whole span in VMEM (log2(2L) passes of
// compare-exchange) and needs XLA passes for the distances beyond one
// VMEM block; a merge path reads and writes every key once at any L:
//   1. merge_partition_kernel: one thread per output tile of kTile slots
//      binary-searches the tile's start diagonal over A and B (ties to A)
//      and stores how many of A's keys come before it.
//   2. merge_tile_kernel: one block per tile. If the tile lies in one
//      span, the block loads A[a0:a1) and B[b0:b1) into shared memory,
//      each thread searches its own diagonal of kItems slots there and
//      merges them sequentially into shared memory, and the block writes
//      keys and positions out coalesced. A tile that crosses spans (2L
//      smaller than a tile, or L not a power of two) is merged per thread
//      from global memory, each thread searching within its own span.
// Bound: device memory bandwidth, 8 B read and 8 + 4 B written per key,
// plus the wrapper's payload gathers; the searches cost log2(L) loads per
// tile and per thread, from shared memory or L2. Every index stays inside
// its span whatever the keys hold, so unsorted input gives a wrong order,
// never an out-of-range access. Left for later: TMA loads and one pass for
// several merge rounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

// Number of A's keys among the first d outputs of merge(A, B), ties to A.
__device__ __forceinline__ long long merge_path(const int64_t* a,
                                                long long na,
                                                const int64_t* b,
                                                long long nb, long long d) {
  long long lo = d > nb ? d - nb : 0;
  long long hi = d < na ? d : na;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void merge_partition_kernel(const int64_t* __restrict__ keys,
                                       long long* __restrict__ splits,
                                       long long n, long long run,
                                       long long n_tiles) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_tiles) return;
  const long long o = t * kTile;
  const long long base = o / (2 * run) * (2 * run);
  const int64_t* a = keys + base;
  splits[t] = merge_path(a, run, a + run, run, o - base);
}

__global__ void __launch_bounds__(kThreads)
    merge_tile_kernel(const int64_t* __restrict__ keys,
                      const long long* __restrict__ splits,
                      int64_t* __restrict__ out, int* __restrict__ pos,
                      long long n, long long run) {
  __shared__ int64_t s_in[kTile];
  __shared__ int64_t s_out[kTile];
  __shared__ int s_pos[kTile];

  const long long span = 2 * run;
  const long long tile_start = static_cast<long long>(blockIdx.x) * kTile;
  const long long tile_end =
      tile_start + kTile < n ? tile_start + kTile : n;
  const long long base = tile_start / span * span;
  const int tid = threadIdx.x;

  if (tile_end - 1 >= base + span) {
    // the tile crosses spans: each thread merges its slots from global
    // memory, searching again whenever it enters a span
    long long o = tile_start + static_cast<long long>(tid) * kItems;
    const long long o_end = o + kItems < tile_end ? o + kItems : tile_end;
    while (o < o_end) {
      const long long sb = o / span * span;
      const int64_t* a = keys + sb;
      const int64_t* b = a + run;
      long long ia = merge_path(a, run, b, run, o - sb);
      long long ib = o - sb - ia;
      const long long stop = sb + span < o_end ? sb + span : o_end;
      for (; o < stop; ++o) {
        const bool take_a = ib >= run || (ia < run && a[ia] <= b[ib]);
        if (take_a) {
          out[o] = a[ia];
          pos[o] = static_cast<int>(sb + ia);
          ++ia;
        } else {
          out[o] = b[ib];
          pos[o] = static_cast<int>(sb + run + ib);
          ++ib;
        }
      }
    }
    return;
  }

  // the tile lies in one span: diagonals d0, d1 of the span's merge path
  const long long d0 = tile_start - base, d1 = tile_end - base;
  const long long cnt = d1 - d0;
  const long long a0 = splits[blockIdx.x];
  long long a1 = d1 == span ? run : splits[blockIdx.x + 1];
  // keep A's and B's slices inside [0, cnt] even if the runs are unsorted
  if (a1 < a0) a1 = a0;
  if (a1 > a0 + cnt) a1 = a0 + cnt;
  if (a1 > run) a1 = run;
  const long long b0 = d0 - a0;
  const int na = static_cast<int>(a1 - a0);
  const int nb = static_cast<int>(cnt) - na;
  const int64_t* a = keys + base + a0;
  const int64_t* b = keys + base + run + b0;
  for (int i = tid; i < cnt; i += kThreads)
    s_in[i] = i < na ? a[i] : b[i - na];
  __syncthreads();

  int d = tid * kItems;
  if (d > cnt) d = static_cast<int>(cnt);
  int ia = static_cast<int>(merge_path(s_in, na, s_in + na, nb, d));
  int ib = d - ia;
  const int pos_a = static_cast<int>(base + a0);
  const int pos_b = static_cast<int>(base + run + b0);
  for (int j = 0; j < kItems && d + j < cnt; ++j) {
    const bool take_a = ib >= nb || (ia < na && s_in[ia] <= s_in[na + ib]);
    if (take_a) {
      s_out[d + j] = s_in[ia];
      s_pos[d + j] = pos_a + ia;
      ++ia;
    } else {
      s_out[d + j] = s_in[na + ib];
      s_pos[d + j] = pos_b + ib;
      ++ib;
    }
  }
  __syncthreads();
  for (int i = tid; i < cnt; i += kThreads) {
    out[tile_start + i] = s_out[i];
    pos[tile_start + i] = s_pos[i];
  }
}

}  // namespace

// Launches both kernels on `stream`; allocates nothing. `splits` is scratch
// of ceil(n / 2048) int64 words. Returns cudaGetLastError().
extern "C" int gt4_merge_runs(const void* keys, void* out, void* pos,
                              void* splits, long long n, long long run,
                              void* stream) {
  if (n <= 0) return 0;
  if (run < 1 || n % (2 * run) != 0 || n >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_tiles = (n + kTile - 1) / kTile;
  const int64_t* k = static_cast<const int64_t*>(keys);
  long long* sp = static_cast<long long*>(splits);
  merge_partition_kernel<<<static_cast<unsigned>((n_tiles + kThreads - 1) /
                                                 kThreads),
                           kThreads, 0, s>>>(k, sp, n, run, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_tile_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, s>>>(
      k, sp, static_cast<int64_t*>(out), static_cast<int*>(pos), n, run);
  return static_cast<int>(cudaGetLastError());
}
