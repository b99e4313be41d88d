// Kernel B: one-pass run encoding of a sorted key stream (unique keys and
// their counts, reduce-by-key with decoupled look-back).
//
// Replaces the Pallas TPU kernel make_run_marks
// (genometester4_tpu/ops/runmarks_pallas.py:32, kernel body :56). The TPU
// kernel writes head/tail masks that XLA then compacts; here the kernel
// writes what every caller wants, the contract of
// genometester4_tpu/ops/sortcount.py:count_unique(compact=True) computed
// from an already sorted stream. Plain PyTorch version with the same
// contract: genometester4_tpu_torch/ops/sortcount.py:run_encode (run_marks,
// then a nonzero of the tails and a difference). Wrapper:
// ops/runmarks_cuda.py.
//
// Contract. Inputs: keys[0:n] sorted int64 keys (bit 63 flipped words),
// n < 2^31; weights[0:n] int64 or null (null: every valid entry weighs 1);
// a limit key (has_limit) at or above which a key is invalid, so that the
// invalid keys are a suffix of the stream (none for 64-bit words). With
//   head[i] = i valid and (i == 0 or keys[i-1] != keys[i])
//   tail[i] = i valid and (i == n-1 or keys[i+1] != keys[i])
// the runs tile the valid prefix, and the kernel writes, for the r-th run
// (r = 0 .. n_unique-1, in key order), out_keys[r] = its key and
// out_counts[r] = its summed weight mod 2^32 (its length with null
// weights). stats (uint32) gets, summed with wrap-around:
//   stats[0] = sum(head)  (n_unique)    stats[1] = valid entries (total)
//   stats[2] = sum(tail * x * (i+1)) - sum(head * x * i)   (checksum)
// with x = hi32(word) ^ lo32(word): the bench checksum of the TPU kernel.
// stats[3] is the tile counter. The launcher zeroes stats and the status
// words (cudaMemsetAsync) before the kernel; the wrapper reads stats back
// once, its only host sync, and slices the outputs to n_unique.
//
// Bound: device memory. The stream is read once (8 B a valid key, 16 B
// with weights) and every run written once (16 B): at 2^25 keys, 30.2 M
// valid and 23.9 M runs, 0.62 GB, 0.186 ms at 3.35 TB/s. The mask kernel
// this replaces wrote 2 B a key that two nonzero compactions (each a host
// sync) and a diff then read again.
//
// Design (Merrill and Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", NVIDIA 2016, for reduce-by-key):
//   * A block takes tiles of kTile = 256 x 16 keys in launch order from an
//     atomic counter, so every tile it waits on belongs to a running block.
//     A tile whose first key is invalid lies past the valid prefix: it
//     publishes an empty aggregate and stops after that one key.
//   * Keys come into shared memory by cp.async (weights by coalesced
//     loads), with the key before the tile and the key after it; one pad
//     word per 16 keys lets each thread read its 16 consecutive keys free
//     of bank conflicts. Heads and tails are neighbour compares there.
//   * The carried state of a stretch of keys is (r = heads in it, c = the
//     weight since its last head, or its whole weight with no head), with
//       (r_a, c_a) + (r_b, c_b) = (r_a + r_b, r_b ? c_b : c_a + c_b mod 2^32)
//     and "has a head" is r > 0. Unit weights are weights of 1 through the
//     same code. A run that crosses tiles, or spans thousands of them (one
//     repeated word), gets its count from the carry, not from a search.
//   * Each thread folds its 16 keys; a warp scan and one pass over the 8
//     warp totals give every thread its exclusive state in the tile and
//     the tile's aggregate. Warp 0 publishes the aggregate, looks back
//     over windows of 32 predecessors (the latest one with an inclusive
//     prefix ends the walk; the aggregates after it fold in order, and only
//     those are waited for), then publishes the inclusive prefix; the
//     other warps stage their runs meanwhile. A status word holds state
//     and flag in 64 bits, so one relaxed load reads them consistently:
//     bit 63 inclusive prefix (r in bits 62..32, r < 2^31), bit 62
//     aggregate (r <= kTile), bits 31..0 c; zero = not yet published.
//   * A tail's run index is the heads up to it, less one; within the tile
//     the runs whose tail falls in it take consecutive indices from
//     (heads before the tile) - (1 if the tile starts inside a run). Each
//     thread stages its tails' positions (2 B; with weights also their
//     counts, 4 B) in shared memory at their local index, and the block
//     writes the tile's runs as one contiguous, coalesced range, the keys
//     gathered from the staged tile. With unit weights a count is the
//     distance between staged tails, the first run's plus its carry.
//   * Occupancy: the loads need no registers and unit weights stage no
//     counts, so a block takes 43 KB of shared memory and 5 fit an SM.
//   * The three stats are a warp/block reduction plus one integer atomicAdd
//     a block: exact in any order.
// Measured on an H100 80GB HBM3 (700 W) at the shape above: 0.275 ms a
// call, the memset included (68% of the bound), against 0.288-0.290 ms for
// CUB's reduce-by-key kernel inside torch.unique_consecutive on the same
// keys (chip_smoke.py; torch.profiler). The first form (59 KB and 61
// registers a block, 3 an SM) took 0.30 ms. What holds it back is latency:
// clock64 probes put ~40% of a block's time in the look-back, spinning on
// predecessors whose aggregates are not yet out (2.8 windows and ~13
// status reads a tile); look-back windows of 64-256 tiles (several words a
// lane) and 2-4 blocks an SM measured slower.
// Unsorted keys give wrong runs, never an out-of-range access or a hang:
// every tile publishes, and every index stays inside its tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // 4096 keys
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;                 // look-back window
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 1ull << 63;

// Shared-memory word of buffer slot q: one pad word after every 16 slots.
__host__ __device__ constexpr int pad(int q) { return q + q / 16; }

// keys: slot 0 the key before the tile, slots 1..kTile the tile, then the
// key after it; weights (mod 2^32): slot p the tile's key p, a region that
// then holds the staged counts
constexpr int kKeyWords = pad(kTile + 1) + 1;
constexpr int kWeightWords = pad(kTile - 1) + 1;
constexpr int kPosOffset = kKeyWords * 8;
constexpr int kWeightOffset = kPosOffset + kTile * 2;
static_assert(kWeightWords >= kTile, "staged counts overlay the weights");
constexpr int smem_bytes(bool weighted) {
  return kWeightOffset + (weighted ? kWeightWords * 4 : 0);
}
// 43 KB a block (unit weights) and at most 51 registers a thread keep 5
// blocks on an SM; 60 KB with weights, 3
__host__ __device__ constexpr int min_blocks(bool weighted) {
  return weighted ? 3 : 5;
}

struct Run {
  unsigned r;   // heads in the stretch
  unsigned c;   // weight since its last head (all of it without one)
};

__device__ __forceinline__ Run combine(Run a, Run b) {   // a, then b
  return {a.r + b.r, b.r ? b.c : a.c + b.c};
}

__device__ __forceinline__ Run shfl_up(Run v, int off) {
  return {__shfl_up_sync(kFull, v.r, off), __shfl_up_sync(kFull, v.c, off)};
}

__device__ __forceinline__ Run shfl_down(Run v, int off) {
  return {__shfl_down_sync(kFull, v.r, off),
          __shfl_down_sync(kFull, v.c, off)};
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long encode(Run s,
                                                     unsigned long long flag) {
  return flag | (static_cast<unsigned long long>(s.r) << 32) | s.c;
}

__device__ __forceinline__ Run decode(unsigned long long w) {
  const unsigned hi = static_cast<unsigned>(w >> 32);
  return {hi & ((w & kPrefix) ? 0x7fffffffu : 0x3fffffffu),
          static_cast<unsigned>(w)};
}

// The state of every tile before `tile`, in all lanes of the calling warp.
// A window counts from its latest inclusive prefix on (all of it without
// one), and only those status words are waited for.
__device__ Run look_back(const unsigned long long* status, long long tile,
                         int lane) {
  Run acc = {0u, 0u};
  for (long long end = tile;; end -= kLanes) {
    const long long j = end - kLanes + lane;   // lane 31: the latest tile
    unsigned long long w;
    unsigned prefixed;
    int latest;
    do {
      w = j >= 0 ? ld_relaxed(status + j) : kPrefix;   // before tile 0: {0,0}
      prefixed = __ballot_sync(kFull, (w & kPrefix) != 0);
      latest = prefixed ? 31 - __clz(prefixed) : 0;
    } while (__any_sync(kFull, lane >= latest && w == 0));
    Run v = lane >= latest ? decode(w) : Run{0u, 0u};
    // ordered fold, lane 0 first: lane l holds lanes l .. l + 2 off - 1
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const Run o = shfl_down(v, off);
      if (lane + off < kLanes) v = combine(v, o);
    }
    v = {__shfl_sync(kFull, v.r, 0), __shfl_sync(kFull, v.c, 0)};
    acc = combine(v, acc);
    if (prefixed) return acc;
  }
}

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads, min_blocks(kWeighted))
    run_encode_kernel(const int64_t* __restrict__ keys,
                      const int64_t* __restrict__ weights,
                      int64_t* __restrict__ out_keys,
                      int64_t* __restrict__ out_counts,
                      unsigned* __restrict__ stats,
                      unsigned long long* __restrict__ status, long long n,
                      int64_t limit, int has_limit) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* const buf = reinterpret_cast<int64_t*>(smem);
  uint16_t* const stage_pos = reinterpret_cast<uint16_t*>(smem + kPosOffset);
  unsigned* const wbuf = reinterpret_cast<unsigned*>(smem + kWeightOffset);
  unsigned* const stage_count = wbuf;   // weighted: after the fold
  __shared__ long long s_tile;
  __shared__ int s_skip, s_nout;
  __shared__ Run s_warp[kWarps];
  __shared__ unsigned s_stats[3][kWarps];
  __shared__ Run s_before;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  if (t == 0) {
    const long long tile = atomicAdd(&stats[3], 1u);
    s_tile = tile;
    s_skip = has_limit && keys[tile * kTile] >= limit;
    s_nout = 0;
  }
  __syncthreads();
  const long long tile = s_tile;
  if (s_skip) {   // past the valid prefix: nothing to count or wait for
    if (t == 0) st_relaxed(status + tile, kAggregate);
    return;
  }
  const long long start = tile * kTile;

  // the tile and its neighbours into shared memory by cp.async, with no
  // register staging; slots past n stay unset and are never used
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int p = it * kThreads + t;
    if (start + p < n) cp_async8(buf + pad(p + 1), keys + start + p);
  }
  if (t == 0 && start > 0) cp_async8(buf + pad(0), keys + start - 1);
  if (t == kThreads - 1 && start + kTile < n)
    cp_async8(buf + pad(kTile + 1), keys + start + kTile);
  if (kWeighted) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const long long i = start + it * kThreads + t;
      wbuf[pad(it * kThreads + t)] =
          i < n ? static_cast<unsigned>(weights[i]) : 0u;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // fold this thread's 16 consecutive keys
  const int p0 = t * kItems;
  const long long i0 = start + p0;
  unsigned valids = 0, heads = 0, tails = 0;   // bit j: key p0 + j
  unsigned wts[kItems];   // weighted: the weights of the valid keys
  unsigned n_head = 0, n_valid = 0, checksum = 0;
  Run mine = {0u, 0u};
  int64_t prev = buf[pad(p0)], cur = buf[pad(p0 + 1)];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int64_t next = buf[pad(p0 + j + 2)];
    const long long i = i0 + j;
    const bool valid = i < n && !(has_limit && cur >= limit);
    const bool h = valid && (i == 0 || prev != cur);
    // an invalid next key is >= limit > cur, so it differs
    const bool tl = valid && (i == n - 1 || next != cur);
    if (kWeighted) wts[j] = valid ? wbuf[pad(p0 + j)] : 0u;
    mine = combine(mine, Run{h, kWeighted ? wts[j] : valid});
    valids |= static_cast<unsigned>(valid) << j;
    heads |= static_cast<unsigned>(h) << j;
    tails |= static_cast<unsigned>(tl) << j;
    const uint64_t word = static_cast<uint64_t>(cur) ^ (1ull << 63);
    const unsigned x = static_cast<unsigned>(word >> 32) ^
                       static_cast<unsigned>(word);
    const unsigned pos = static_cast<unsigned>(i);
    n_valid += valid;
    n_head += h;
    if (tl) checksum += x * (pos + 1u);
    if (h) checksum -= x * pos;
    prev = cur;
    cur = next;
  }

  // block scan of the threads' states; block sums of the stats
  Run incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Run up = shfl_up(incl, off);
    if (lane >= off) incl = combine(up, incl);
  }
  n_head = __reduce_add_sync(kFull, n_head);
  n_valid = __reduce_add_sync(kFull, n_valid);
  checksum = __reduce_add_sync(kFull, checksum);
  if (lane == 31) s_warp[warp] = incl;
  if (lane == 0) {
    s_stats[0][warp] = n_head;
    s_stats[1][warp] = n_valid;
    s_stats[2][warp] = checksum;
  }
  __syncthreads();
  Run excl = shfl_up(incl, 1);
  if (lane == 0) excl = {0u, 0u};
  Run agg = {0u, 0u};
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) excl = combine(agg, excl);
    agg = combine(agg, s_warp[w]);
  }

  // stage this thread's runs at their index within the tile, with their
  // counts within the tile (with weights; over the weights, all read by
  // now): warp 0 after its look-back, the others meanwhile. The tile starts
  // inside a run when its first key equals the key before it; that run's
  // count also takes the carry, at the write.
  const int mid = start > 0 && buf[pad(0)] == buf[pad(1)];
  auto stage = [&] {
    Run run = excl;
    int last = -1;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      run = combine(run, Run{heads >> j & 1u,
                             kWeighted ? wts[j] : valids >> j & 1u});
      if (tails >> j & 1u) {
        last = static_cast<int>(run.r) - 1 + mid;   // <= p0 + j
        stage_pos[last] = static_cast<uint16_t>(p0 + j);
        if (kWeighted) stage_count[last] = run.c;
      }
    }
    if (last >= 0) atomicMax(&s_nout, last + 1);
  };
  if (warp == 0) {
    Run before = {0u, 0u};
    if (tile == 0) {
      if (lane == 0) st_relaxed(status, encode(agg, kPrefix));
    } else {
      if (lane == 0) st_relaxed(status + tile, encode(agg, kAggregate));
      before = look_back(status, tile, lane);
      if (lane == 0)
        st_relaxed(status + tile, encode(combine(before, agg), kPrefix));
    }
    if (lane == 0) s_before = before;
  } else if (warp == 1 && lane < 3) {
    unsigned s = 0;
    for (int w = 0; w < kWarps; ++w) s += s_stats[lane][w];
    atomicAdd(&stats[lane], s);
  }
  stage();
  __syncthreads();
  const Run before = s_before;

  // the tile's runs as one contiguous range; with unit weights the runs
  // tile the stream, so a count is the distance from the previous tail
  // (the first run's also the carried length when it started before)
  const long long base = static_cast<long long>(before.r) - mid;
  const int n_out = s_nout;
  const unsigned carry = mid ? before.c : 0u;
  for (int q = t; q < n_out; q += kThreads) {
    const unsigned pos = stage_pos[q];
    const unsigned count =
        kWeighted ? stage_count[q] + (q ? 0u : carry)
        : q ? pos - stage_pos[q - 1] : pos + 1u + carry;
    out_keys[base + q] = buf[pad(pos + 1)];
    out_counts[base + q] = static_cast<int64_t>(count);
  }
}

template <bool kWeighted>
cudaError_t launch(const void* keys, const void* weights, int64_t* out,
                   long long n, long long limit, int has_limit,
                   cudaStream_t stream) {
  // the dynamic shared memory is allowed once per device
  static bool allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(run_encode_kernel<kWeighted>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes(kWeighted));
    if (err != cudaSuccess) return err;
    allowed[dev] = true;
  }
  const long long tiles = (n + kTile - 1) / kTile;
  int64_t* const scratch = out + 2 * n;
  err = cudaMemsetAsync(scratch, 0, 16 + 8 * tiles, stream);
  if (err != cudaSuccess) return err;
  run_encode_kernel<kWeighted>
      <<<static_cast<unsigned>(tiles), kThreads, smem_bytes(kWeighted),
         stream>>>(static_cast<const int64_t*>(keys),
                   static_cast<const int64_t*>(weights), out, out + n,
                   reinterpret_cast<unsigned*>(scratch),
                   reinterpret_cast<unsigned long long*>(scratch + 2), n,
                   static_cast<int64_t>(limit), has_limit);
  return cudaGetLastError();
}

}  // namespace

// Keys per tile: the wrapper's buffer ends in 16 bytes (stats[0..3]) and
// one 8-byte status word per tile.
extern "C" int gt4_run_encode_tile() { return kTile; }

// Launches on `stream` of `device`; allocates nothing. `weights` may be
// null. `out` holds 2n + 2 + ceil(n / kTile) int64: the run keys, their
// counts, then the stats and status words, which this zeroes first.
// Returns the first CUDA error, or cudaErrorInvalidValue for n >= 2^31.
extern "C" int gt4_run_encode(const void* keys, const void* weights,
                              void* out, long long n, long long limit,
                              int has_limit, int device, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  int old = 0;
  cudaError_t err = cudaGetDevice(&old);
  if (err == cudaSuccess && old != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* const o = static_cast<int64_t*>(out);
  err = weights ? launch<true>(keys, weights, o, n, limit, has_limit, s)
                : launch<false>(keys, weights, o, n, limit, has_limit, s);
  if (old != device) {
    const cudaError_t back = cudaSetDevice(old);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}
