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
// Why a merge path (Green, McColl & Bader, "GPU merge path", 2012): the
// TPU kernel runs a bitonic network over a whole span in VMEM (log2(2L)
// passes of compare-exchange) and needs XLA passes for the distances
// beyond one VMEM block; a merge path reads and writes every key once at
// any L, so it is bound by device memory: 8 B read and 8 + 4 B written per
// key, 0.40 ms at n = 2^26 and 3.35 TB/s.
//
// What held the first form back (0.909 ms at n = 2^26, L = 2^23, 44% of
// that bound, on an H100 80GB HBM3, 700 W): each block went through load,
// search, merge and store with barriers between them and at most 5 blocks
// per SM, so a block's loads (8 B scalar loads, a select per key) never
// overlapped its own merge and stores; the merge wrote to shared memory at
// a 64 B and 32 B stride between threads (bank conflicts) and the stores
// were 8 B and 4 B wide.
//
// Design:
//   1. merge_partition_kernel: one thread per output tile of kTile slots
//      binary-searches the tile's start diagonal over A and B (ties to A)
//      and stores how many of A's keys come before it. It stays a separate
//      pass: its log2(L) dependent loads run in parallel over all tiles,
//      where a persistent block would wait on them tile after tile.
//   2. merge_tile_kernel: a persistent grid (two 256-thread blocks per SM,
//      75 KB of dynamic shared memory each) walks the tiles in a fixed
//      stride. A tile's A[a0:a1) and B[b0:b1) slices go into one slot of
//      a two-slot shared-memory ring by cp.async 16-byte copies, started one
//      tile ahead, so the next tile's loads are in flight while this one
//      merges. A slice start that is not 16-byte aligned copies from the
//      aligned key before it and is read one key in; a copy that would
//      reach outside [0, n) goes 8 bytes at a time.
//      Each thread searches its diagonal of kItems (odd: 15) slots once,
//      merges them into registers, and writes keys and positions to shared
//      memory at a stride of kItems (odd, so free of bank conflicts); the
//      block then writes them out as 16-byte stores (two keys, four
//      positions), neighbouring lanes on neighbouring addresses.
//      A tile that crosses spans (2L smaller than a tile, or L not a
//      multiple of it) is merged per thread from global memory, each thread
//      searching within its own span.
// Measured on an H100 80GB HBM3 (700 W) at n = 2^26, L = 2^23: ~0.54 ms
// per call queued back to back, 74% of the bytes bound (partition pass
// ~0.035 ms, tile pass ~0.50 ms, i.e. 2.7 TB/s for its 20 B per key); a
// 32-probe warp search in the partition pass measured 3x slower than the
// binary search, its probes each a sector of their own
// (tools/time_kernels.py, chip_smoke.py).
// Every index stays inside its span whatever the keys hold, so unsorted
// input gives a wrong order, never an out-of-range access. Tiles write
// disjoint outputs, so the result does not depend on the order in which
// blocks take them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 15;                   // odd: conflict-free strides
constexpr int kTile = kThreads * kItems;     // 3840 output slots
constexpr int kSlot = kTile + 4;             // keys per ring slot (+ pads)
constexpr int kStages = 2;                   // ring slots: 1 tile ahead
constexpr int kSmem = kStages * kSlot * 8 + kTile * 4;   // ring + positions

// Number of A's keys among the first d outputs of merge(A, B), ties to A.
template <typename I>
__device__ __forceinline__ I merge_path(const int64_t* a, I na,
                                        const int64_t* b, I nb, I d) {
  I lo = d > nb ? d - nb : 0;
  I hi = d < na ? d : na;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most kStages - 1 of this thread's newest copy groups are
// pending: the oldest, the current tile's, has landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// One tile's work, the same in every thread of the block.
struct Tile {
  long long start;   // first output slot
  int cnt;           // output slots
  bool cross;        // crosses spans: merged per thread from global memory
  int na, nb;        // A's and B's keys in the tile
  long long ga, gb;  // index of A's and B's first key in keys[]
  int sa, sb;        // index of A's and B's first key in the ring slot
  int rb;            // B's copy starts rb keys before B (A's: sa before)
};

__device__ __forceinline__ Tile describe(const long long* __restrict__ splits,
                                         long long tile, long long n,
                                         long long run, uintptr_t keys) {
  Tile t;
  const long long span = 2 * run;
  t.start = tile * kTile;
  const long long end = t.start + kTile < n ? t.start + kTile : n;
  t.cnt = static_cast<int>(end - t.start);
  const long long base = t.start / span * span;
  t.cross = end - 1 >= base + span;
  t.na = t.nb = t.sa = t.sb = t.rb = 0;
  t.ga = t.gb = 0;
  if (t.cross) return t;
  // diagonals d0, d1 of the span's merge path; keep A's and B's slices
  // inside their runs even if the runs are unsorted
  const long long d0 = t.start - base, d1 = end - base;
  const long long a0 = splits[tile];
  long long a1 = d1 == span ? run : splits[tile + 1];
  if (a1 < a0) a1 = a0;
  if (a1 < d1 - run) a1 = d1 - run;
  if (a1 > a0 + t.cnt) a1 = a0 + t.cnt;
  if (a1 > run) a1 = run;
  t.na = static_cast<int>(a1 - a0);
  t.nb = t.cnt - t.na;
  t.ga = base + a0;
  t.gb = base + run + d0 - a0;
  // parity of a key's 8-byte word address: odd starts copy from one before
  const int odd = static_cast<int>((keys >> 3) & 1);
  t.sa = static_cast<int>((t.ga + odd) & 1);
  t.rb = static_cast<int>((t.gb + odd) & 1);
  t.sb = ((t.sa + t.na + 1) & ~1) + t.rb;
  return t;
}

// Start the cp.async copies of one slice: keys [g - s, g + cnt) into
// slot[0 : s + cnt), 16 bytes where both keys lie in [0, n), else 8.
__device__ __forceinline__ void copy_slice(int64_t* slot,
                                           const int64_t* __restrict__ keys,
                                           long long n, long long g, int s,
                                           int cnt, int first, int step) {
  const long long g0 = g - s;
  for (int i = first; 2 * i < s + cnt; i += step) {
    const long long j = g0 + 2ll * i;
    if (j >= 0 && j + 2 <= n) {
      cp_async16(slot + 2 * i, keys + j);
    } else {
      if (j >= 0 && j < n) cp_async8(slot + 2 * i, keys + j);
      if (j + 1 >= 0 && j + 1 < n) cp_async8(slot + 2 * i + 1, keys + j + 1);
    }
  }
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

// A tile that crosses spans: each thread merges its slots from global
// memory, searching again whenever it enters a span.
__device__ void merge_crossing(const int64_t* __restrict__ keys,
                               int64_t* __restrict__ out,
                               int* __restrict__ pos, long long run,
                               const Tile& t) {
  const long long span = 2 * run;
  long long o = t.start + static_cast<long long>(threadIdx.x) * kItems;
  const long long tile_end = t.start + t.cnt;
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
}

// A tile inside one span whose slices are in `slot`: merge, then write
// keys and positions out through shared memory.
__device__ void merge_staged(int64_t* slot, int* s_pos,
                             int64_t* __restrict__ out,
                             int* __restrict__ pos, const Tile& t) {
  const int tid = threadIdx.x;
  const int64_t* sa = slot + t.sa;
  const int64_t* sb = slot + t.sb;
  const int d = tid * kItems < t.cnt ? tid * kItems : t.cnt;
  int ia = merge_path(sa, t.na, sb, t.nb, d);
  int ib = d - ia;
  // the keys one past a slice are padding: read, never taken
  int64_t ka = sa[ia], kb = sb[ib];
  const int pa = static_cast<int>(t.ga), pb = static_cast<int>(t.gb);
  int64_t rk[kItems];
  int rp[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (d + j < t.cnt) {
      const bool take_a = ib >= t.nb || (ia < t.na && ka <= kb);
      rk[j] = take_a ? ka : kb;
      rp[j] = take_a ? pa + ia : pb + ib;
      if (take_a)
        ka = sa[++ia];
      else
        kb = sb[++ib];
    }
  }
  __syncthreads();   // every thread is done reading the slot
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if (d + j < t.cnt) {
      slot[d + j] = rk[j];
      s_pos[d + j] = rp[j];
    }
  }
  __syncthreads();
  const int pairs = t.cnt >> 1, quads = t.cnt >> 2;
  longlong2* out2 = reinterpret_cast<longlong2*>(out + t.start);
  const longlong2* s2 = reinterpret_cast<const longlong2*>(slot);
  for (int u = tid; u < pairs; u += kThreads) out2[u] = s2[u];
  int4* pos4 = reinterpret_cast<int4*>(pos + t.start);
  const int4* p4 = reinterpret_cast<const int4*>(s_pos);
  for (int u = tid; u < quads; u += kThreads) pos4[u] = p4[u];
  for (int i = 2 * pairs + tid; i < t.cnt; i += kThreads)
    out[t.start + i] = slot[i];
  for (int i = 4 * quads + tid; i < t.cnt; i += kThreads)
    pos[t.start + i] = s_pos[i];
}

__global__ void __launch_bounds__(kThreads, 2)
    merge_tile_kernel(const int64_t* __restrict__ keys,
                      const long long* __restrict__ splits,
                      int64_t* __restrict__ out, int* __restrict__ pos,
                      long long n, long long run, long long n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* ring = reinterpret_cast<int64_t*>(smem);
  int* s_pos = reinterpret_cast<int*>(smem + kStages * kSlot * 8);
  const uintptr_t kaddr = reinterpret_cast<uintptr_t>(keys);
  const int tid = threadIdx.x;

  auto prefetch = [&](const Tile& t, int64_t* slot) {
    if (t.cross) return;
    copy_slice(slot, keys, n, t.ga, t.sa, t.na, tid, kThreads);
    copy_slice(slot + t.sb - t.rb, keys, n, t.gb, t.rb, t.nb, tid, kThreads);
  };

  // prologue: the block's first kStages - 1 tiles in flight
  for (int i = 0; i < kStages - 1; ++i) {
    const long long tile = blockIdx.x + static_cast<long long>(i) * gridDim.x;
    if (tile < n_tiles)
      prefetch(describe(splits, tile, n, run, kaddr), ring + i * kSlot);
    cp_async_commit();
  }
  int it = 0;
  for (long long tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, ++it) {
    const long long ahead = tile + (kStages - 1) * static_cast<long long>(
                                                       gridDim.x);
    if (ahead < n_tiles)
      prefetch(describe(splits, ahead, n, run, kaddr),
               ring + (it + kStages - 1) % kStages * kSlot);
    cp_async_commit();
    cp_async_wait_ring();  // this thread's copies of `tile` have landed
    __syncthreads();       // and every other thread's
    const Tile cur = describe(splits, tile, n, run, kaddr);
    if (cur.cross)
      merge_crossing(keys, out, pos, run, cur);
    else
      merge_staged(ring + it % kStages * kSlot, s_pos, out, pos, cur);
    __syncthreads();       // the slot is free for the tile kStages ahead
  }
}

}  // namespace

// Tile size in output slots; the wrapper's `splits` scratch holds one int64
// word per tile.
extern "C" int gt4_merge_runs_tile() { return kTile; }

// Launches both kernels on `stream`; allocates nothing. `splits` is scratch
// of ceil(n / gt4_merge_runs_tile()) int64 words. `out` and `pos` must be
// 16-byte aligned (the wrapper allocates them); `keys` may start at any
// 8-byte boundary. Returns cudaGetLastError() or the error of the
// occupancy query.
extern "C" int gt4_merge_runs(const void* keys, void* out, void* pos,
                              void* splits, long long n, long long run,
                              void* stream) {
  if (n <= 0) return 0;
  if (run < 1 || n % (2 * run) != 0 || n >= (1ll << 31) ||
      (reinterpret_cast<uintptr_t>(keys) & 7) ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(pos) & 15))
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

  // resident blocks on the whole card, found once per device
  static int resident[64];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(merge_tile_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, merge_tile_kernel, kThreads, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  const long long grid = resident[dev] < n_tiles ? resident[dev] : n_tiles;
  merge_tile_kernel<<<static_cast<unsigned>(grid), kThreads, kSmem, s>>>(
      k, sp, static_cast<int64_t*>(out), static_cast<int*>(pos), n, run,
      n_tiles);
  return static_cast<int>(cudaGetLastError());
}
