// Kernels C and D: affine-gap Smith-Waterman fill, score/sx/sy matrices.
//
// Kernel C (sw_lanes_kernel) replaces the Pallas TPU kernel
// make_sw_pallas_lanes (genometester4_tpu/ops/swalign_pallas.py:182, body
// :211): every read carries its own reference and reference length, so many
// gassembler regions share one launch. Kernel D (sw_shared_kernel) replaces
// make_sw_pallas (swalign_pallas.py:46, body :58): one reference for all
// reads. Plain PyTorch version of both:
// genometester4_tpu_torch/ops/swalign.py:sw_fill. Wrappers:
// ops/swalign_cuda.py.
//
// Contract (both): score int16, sx int8, sy int8, each [B, n+1, m+1]
// row-major, for any n >= 0 and m >= 0. Row 0, column 0 and the rows past a
// read's reference length are 0. Cell (i, j) follows the C reference's
// recurrence (src/gassembler.c:2185-2321, the JAX package's ops/swalign.py):
// match +2, mismatch -3, a code >= N (4) on either side 0, gap open -4,
// extend -2; the left gap is taken if >= the cell, then the top gap if >=
// the updated cell; gap lengths wrap as int8. Padded read columns (code 6)
// are computed like any other column.
//
// Schedule (sw_warp, both kernels): one warp per read. Lane L owns a strip
// of S columns (S a template parameter, so the strip's state lives in
// registers) and computes row i = t - L + 1 at step t: a skewed wavefront.
// Within a strip the cells go left to right; the left neighbour's state
// (its gap state in row i and its score in row i-1) comes from lane L-1's
// previous step through __shfl_up_sync. Lane 31 finishes a row one step
// after lane 30, so at every step exactly one row completes. Cells go to a
// ring of 32 rows in shared memory as one word each (score, sx, sy), and
// the warp copies each finished row out with neighbouring lanes on
// neighbouring addresses. A substitution score is one byte permute of a
// per-column table by the row's reference code.
//
// Any width: S = ceil(m / 32) up to 8. A wider read is swept in slabs of
// 256 columns, left to right. Lane 31 leaves, for every row of a slab, the
// state of the slab's last column (H(i, c), the left-gap score and the
// left-gap length; int32, 16 bytes a row) and lane 0 of the next slab reads
// it in place of column 0: its gap state at row i, and H at row i-1 as its
// diagonal. The top-gap state is per column and stays in registers. The
// boundary lives in shared memory up to 512 rows, past that in a scratch
// tensor the wrapper allocates (gt4_sw_scratch). The ring is sized by the
// slab, at most 32 x 265 x 4 = 33.9 KB a warp, so a wide read keeps
// several warps on an SM.
//
// Kernel C: one warp (one read) per block, so a window of reads spreads
// over every SM. Kernel D: blocks of four warps, four reads of the one
// reference, which each block stages once in shared memory (up
// to 16 KB; a longer reference is read from device memory). No block
// barrier runs inside the sweep. The earlier D, one block per read with a
// thread per column, paid a __syncthreads per anti-diagonal and wrote every
// cell on its own: neighbouring threads stored m + 1 bytes apart.
//
// Bound. A cell costs ~30 integer operations and writes 4 bytes (int16
// score, two int8 directions): at the card's int32 rate (16.7 T op/s) a
// gassembler window of 512 reads x 200 x 152 cells needs ~0.03 ms, its 63
// MB of output ~0.02 ms at 3.35 TB/s. What holds both kernels above that is
// one warp's chain of steps: ceil(m / 256) slabs of lim + 31 steps, each
// ~40 instructions a cell (S of them) plus ~120 for the shuffles, the row
// copy and the loop, issued by one warp with little to overlap. A window of
// 512 reads, or kernel D's 128, puts about one warp on each of the card's
// 528 schedulers, so the time is that chain, not the operations bound.
// Splitting a read over two or four warps (strips of 3 or 2 columns) is
// not built: the measured cost of a step falls little with S (PERF.md),
// and every extra warp adds 32 steps to the chain.
//
// The TPU kernels' diagonal-stacked int32 output (and the host
// diag_to_matrix it needed), their 128-lane / 8-sublane padding, the
// precomputed diagonal gather of reference bases, the rolling reference row
// in scratch and the (..., 1, 128) unit dimensions exist only for Mosaic and
// are not ported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMatch = 2;
constexpr int kMismatch = -3;
constexpr int kNScore = 0;
constexpr int kGapOpen = -4;
constexpr int kGapExt = -2;
constexpr int kNeg = -1000;
constexpr int kNuclN = 4;
constexpr int kNone = 6;             // padding code of reads
constexpr int kWarp = 32;
constexpr int kRingRows = 32;        // rows staged per read
constexpr int kMaxStrip = 8;         // columns per lane; a slab is 32 x 8
constexpr int kSharedWarps = 4;      // kernel D: reads per block
constexpr int kMaxBndRows = 512;     // slab boundary rows in shared memory
constexpr int kMaxRefShared = 16384; // kernel D: reference bytes staged
constexpr int kMaxSharedBytes = 232448;

// Substitution scores of one read code b against every reference code a,
// as signed bytes 0..3 of a word (a >= 4 selects the zero word beside it):
// +2 for a == b, -3 otherwise, 0 when either is >= N.
__device__ __forceinline__ uint32_t sub_table(int b) {
  if (b >= kNuclN) return 0;
  const uint32_t mism = 0xFDFDFDFDu;   // -3 in every byte
  return (mism & ~(0xFFu << (8 * b))) | (static_cast<uint32_t>(kMatch)
                                         << (8 * b));
}

// The prmt selector that picks byte a of (table, 0) sign-extended to 32
// bits: nibble 0 = a, nibbles 1..3 = a with the sign-replicate bit.
__device__ __forceinline__ uint32_t sub_selector(int a) {
  return static_cast<uint32_t>(a) * 0x1111u | 0x8880u;
}

__device__ __forceinline__ int sub_score(uint32_t table, uint32_t sel) {
  int r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(table), "r"(0u), "r"(sel));
  return r;
}

// The value an int8 store keeps (two's complement wrap).
__device__ __forceinline__ int wrap8(int x) {
  return static_cast<int>(static_cast<int8_t>(x));
}

// One cell. In: sub = the substitution score, diag = H(i-1, j-1), (ls, ll)
// the left gap state of (i, j-1), (ts, tl) the top gap state of (i-1, j).
// Out: the cell's score and directions; (ls, ll) and (ts, tl) become the
// gap states of (i, j). Written as maxima so that the score's dependent
// chain is add, max, add, max, max, add, max; the directions hang off it.
__device__ __forceinline__ void sw_cell(int sub, int diag, int& ls, int& ll,
                                        int& ts, int& tl, int& cell,
                                        int& csx, int& csy) {
  const int dsc = diag + sub;
  const int d = dsc > 0 ? -1 : 0;
  cell = max(dsc, 0);
  const int lo = cell + kGapOpen, le = ls + kGapExt;
  ll = le > lo ? wrap8(ll + 1) : 0;   // the left gap: taken if >= cell
  ls = max(lo, le);
  const bool left = ls >= cell;
  cell = max(cell, ls);
  const int to = cell + kGapOpen, te = ts + kGapExt;
  tl = te > to ? wrap8(tl + 1) : 0;   // the top gap: taken if >= the new cell
  ts = max(to, te);
  const bool top = ts >= cell;
  cell = max(cell, ts);
  csx = top ? 0 : (left ? wrap8(-ll) : d);
  csy = top ? wrap8(-tl) : (left ? 0 : d);
}

// A ring row holds the slab's columns 0..32*S packed as words (score in
// the low half, sx and sy in the high bytes). Its stride, 33 * S + 1
// words, is S + 1 modulo 32 banks: at one step lane L stores to row
// t - L at column L * S + s, and those 32 words fall in 32 banks.
__host__ __device__ constexpr int ring_stride(int S) { return 33 * S + 1; }

// Shared memory of one block: per warp a boundary of n+1 int4 rows (when it
// is kept there) and a ring of [kRingRows][ring_stride(S)] words; then
// kernel D's staged reference.
struct Plan {
  int S;                 // columns per lane
  bool slabs;            // m > 32 * S: boundary carried between slabs
  bool bnd_shared;       // the boundary in shared memory, else in scratch
  bool ref_shared;       // kernel D: the reference staged in shared memory
  long long bnd_bytes;   // per warp
  long long ring_bytes;  // per warp
  long long bytes;       // per block
};

Plan make_plan(int n, int m, int warps, bool one_ref) {
  Plan p{};
  const int strip = (m + kWarp - 1) / kWarp;
  p.S = strip < 1 ? 1 : (strip > kMaxStrip ? kMaxStrip : strip);
  p.slabs = m > kWarp * p.S;
  p.bnd_shared = p.slabs && n + 1 <= kMaxBndRows;
  p.ref_shared = one_ref && n <= kMaxRefShared;
  p.bnd_bytes = p.bnd_shared ? 16LL * (n + 1) : 0;
  p.ring_bytes = 4LL * kRingRows * ring_stride(p.S);   // a multiple of 16
  // at most 4 x (33,920 + 8,192) + 16,384 = 184,832 bytes
  p.bytes = warps * (p.bnd_bytes + p.ring_bytes) + (p.ref_shared ? n : 0);
  return p;
}

// One warp fills one read: read[0:m] against ref[0:lim] into this read's
// [n+1][m+1] outputs. Lane L owns the columns base + L*S + 1 .. + S of the
// slab at `base`; ring entry k of a row is column base + k. `bnd` (n+1
// rows of {H, left-gap score, left-gap length, -}) carries the last column
// of one slab to the next.
template <int S>
__device__ __forceinline__ void sw_warp(const int8_t* ref, int lim,
                                        const int8_t* __restrict__ read,
                                        int n, int m, int16_t* sc, int8_t* x,
                                        int8_t* y, uint32_t* ring, int4* bnd,
                                        int lane) {
  static_assert(kRingRows == kWarp, "one ring row per lane at set-up");
  constexpr int kWidth = kWarp * S;
  constexpr int kStride = ring_stride(S);
  const int cols = m + 1;
  if (m == 0) lim = 0;

  // row 0 and the rows past lim are zero, and so is column 0 of the ring
  for (int k = lane; k < cols; k += kWarp) {
    sc[k] = 0;
    x[k] = 0;
    y[k] = 0;
  }
  const long long z1 = static_cast<long long>(n + 1) * cols;
  for (long long k = static_cast<long long>(lim + 1) * cols + lane; k < z1;
       k += kWarp) {
    sc[k] = 0;
    x[k] = 0;
    y[k] = 0;
  }
  if (lim == 0) return;
  ring[lane * kStride] = 0;

  for (int base = 0; base < m; base += kWidth) {
    const bool first = base == 0, last = base + kWidth >= m;
    const int k0 = first ? 0 : 1;            // ring entries copied out:
    const int k1 = last ? m - base : kWidth; // k0 .. k1
    uint32_t tab[S];   // per column: substitution scores by reference code
    int up[S], ts[S], tl[S];   // H(i-1, j), top gap state
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = base + lane * S + s + 1;
      tab[s] = sub_table(j <= m ? read[j - 1] : kNone);
      up[s] = 0;
      ts[s] = kNeg;
      tl[s] = 0;
    }
    // from lane L-1's previous step: H(i-1, c0-1) and the left gap state
    // of (i, c0-1). Lane 0 borders column 0 (first slab) or the previous
    // slab's boundary: bnd[i] for the gap state, bnd[i-1].x for H. The
    // boundary and the reference base of the next row load one step ahead.
    int diag_in = 0, ls_in = kNeg, ll_in = 0;
    int4 next = make_int4(0, kNeg, 0, 0);
    if (!first && lane == 0) next = bnd[1];
    int prev_h = 0;
    int a_next = lane == 0 ? ref[0] : 0;
    __syncwarp();

    for (int t = 0; t < lim + kWarp - 1; ++t) {
      const int i = t - lane + 1;
      const int a = a_next;
      if (i >= 0 && i < lim) a_next = ref[i];
      int diag = diag_in, ls = ls_in, ll = ll_in;
      auto from_boundary = [&] {
        diag = prev_h;
        ls = next.y;
        ll = next.z;
        prev_h = next.x;
        if (i < lim) next = bnd[i + 1];
      };
      // lane 0's column-0 border: by selects for short strips, by a branch
      // from S = 6 on (each measured the faster there)
      if (S <= 5) {
        diag = lane ? diag : 0;
        ls = lane ? ls : kNeg;
        ll = lane ? ll : 0;
        if (!first && lane == 0) from_boundary();
      } else if (lane == 0) {
        if (first) {
          diag = 0;
          ls = kNeg;
          ll = 0;
        } else {
          from_boundary();
        }
      }
      if (i >= 1 && i <= lim) {
        // entries past k1 take columns past m: never copied out
        uint32_t* row = ring + ((i - 1) & (kRingRows - 1)) * kStride +
                        lane * S + 1;
        const uint32_t sel = sub_selector(a);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          int cell, csx, csy;
          sw_cell(sub_score(tab[s], sel), diag, ls, ll, ts[s], tl[s], cell,
                  csx, csy);
          diag = up[s];
          up[s] = cell;
          row[s] = __byte_perm(cell, __byte_perm(csx, csy, 0x0040), 0x5410);
        }
        if (!last && lane == kWarp - 1) bnd[i] = make_int4(up[S - 1], ls, ll, 0);
      }
      diag_in = __shfl_up_sync(0xffffffffu, diag, 1);
      ls_in = __shfl_up_sync(0xffffffffu, ls, 1);
      ll_in = __shfl_up_sync(0xffffffffu, ll, 1);
      __syncwarp();
      // lane 31 has just finished row r: copy it out, lane k on column k
      const int r = t - (kWarp - 2);
      if (r >= 1) {
        const uint32_t* row = ring + ((r - 1) & (kRingRows - 1)) * kStride;
        const long long g = static_cast<long long>(r) * cols + base;
        uint32_t v[S + 1];
#pragma unroll
        for (int c = 0; c <= S; ++c) {
          const int k = c * kWarp + lane;
          v[c] = k >= k0 && k <= k1 ? row[k] : 0;
        }
#pragma unroll
        for (int c = 0; c <= S; ++c) {
          const int k = c * kWarp + lane;
          if (k >= k0 && k <= k1) {
            sc[g + k] = static_cast<int16_t>(v[c]);
            x[g + k] = static_cast<int8_t>(v[c] >> 16);
            y[g + k] = static_cast<int8_t>(v[c] >> 24);
          }
        }
      }
      __syncwarp();
    }
  }
}

// Kernel C: block b, one warp, aligns reads[b] to refs[b, :min(nvec[b], n)].
template <int S>
__global__ void __launch_bounds__(kWarp)
    sw_lanes_kernel(const int8_t* __restrict__ refs,
                    const int8_t* __restrict__ reads,
                    const int* __restrict__ nvec, int16_t* __restrict__ score,
                    int8_t* __restrict__ sx, int8_t* __restrict__ sy,
                    int4* scratch, int n, int m, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const long long at = static_cast<long long>(b) * (n + 1) * (m + 1);
  int4* bnd = p.bnd_shared ? reinterpret_cast<int4*>(smem)
              : scratch ? scratch + static_cast<long long>(b) * (n + 1)
                        : nullptr;
  sw_warp<S>(refs + static_cast<long long>(b) * n, min(max(nvec[b], 0), n),
             reads + static_cast<long long>(b) * m, n, m, score + at, sx + at,
             sy + at, reinterpret_cast<uint32_t*>(smem + p.bnd_bytes), bnd,
             threadIdx.x);
}

// Kernel D: block g, kSharedWarps warps, aligns reads[4g + w] to ref[0:n].
template <int S>
__global__ void __launch_bounds__(kWarp * kSharedWarps)
    sw_shared_kernel(const int8_t* __restrict__ ref,
                     const int8_t* __restrict__ reads,
                     int16_t* __restrict__ score, int8_t* __restrict__ sx,
                     int8_t* __restrict__ sy, int4* scratch, int B, int n,
                     int m, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kSharedWarps + w;
  const int8_t* r = ref;
  if (p.ref_shared) {
    int8_t* staged = reinterpret_cast<int8_t*>(
        smem + kSharedWarps * (p.bnd_bytes + p.ring_bytes));
    for (int k = threadIdx.x; k < n; k += blockDim.x) staged[k] = ref[k];
    __syncthreads();
    r = staged;
  }
  if (b >= B) return;
  const long long at = static_cast<long long>(b) * (n + 1) * (m + 1);
  int4* bnd = p.bnd_shared ? reinterpret_cast<int4*>(smem + w * p.bnd_bytes)
              : scratch ? scratch + static_cast<long long>(b) * (n + 1)
                        : nullptr;
  sw_warp<S>(r, n, reads + static_cast<long long>(b) * m, n, m, score + at,
             sx + at, sy + at,
             reinterpret_cast<uint32_t*>(smem + kSharedWarps * p.bnd_bytes +
                                         w * p.ring_bytes),
             bnd, lane);
}

template <typename Kernel>
int prepare_shared(Kernel kernel, long long bytes) {
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
  }
  return 0;
}

template <int S>
int launch(const int8_t* refs, const int8_t* reads, const int* nvec,
           int16_t* score, int8_t* sx, int8_t* sy, int4* scratch, int B,
           int n, int m, const Plan& p, cudaStream_t stream) {
  if (nvec) {   // kernel C
    const int err = prepare_shared(sw_lanes_kernel<S>, p.bytes);
    if (err) return err;
    sw_lanes_kernel<S><<<static_cast<unsigned>(B), kWarp, p.bytes, stream>>>(
        refs, reads, nvec, score, sx, sy, scratch, n, m, p);
  } else {      // kernel D
    const int err = prepare_shared(sw_shared_kernel<S>, p.bytes);
    if (err) return err;
    const unsigned blocks = (B + kSharedWarps - 1) / kSharedWarps;
    sw_shared_kernel<S><<<blocks, kWarp * kSharedWarps, p.bytes, stream>>>(
        refs, reads, score, sx, sy, scratch, B, n, m, p);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* refs, const void* reads, const void* nvec,
             void* score, void* sx, void* sy, void* scratch, int B, int n,
             int m, void* stream) {
  if (B <= 0) return 0;
  if (n < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(n, m, nvec ? 1 : kSharedWarps, nvec == nullptr);
  if (p.slabs && !p.bnd_shared && !scratch)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rf = static_cast<const int8_t*>(refs);
  const auto* rd = static_cast<const int8_t*>(reads);
  const auto* nv = static_cast<const int*>(nvec);
  auto* sc = static_cast<int16_t*>(score);
  auto* x = static_cast<int8_t*>(sx);
  auto* y = static_cast<int8_t*>(sy);
  auto* scr = static_cast<int4*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  switch (p.S) {
#define GT4_SW(S)                                                          \
  case S:                                                                  \
    return launch<S>(rf, rd, nv, sc, x, y, scr, B, n, m, p, st);
    GT4_SW(1) GT4_SW(2) GT4_SW(3) GT4_SW(4)
    GT4_SW(5) GT4_SW(6) GT4_SW(7) GT4_SW(8)
#undef GT4_SW
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Bytes of device scratch per read that gt4_sw_lanes and gt4_sw_shared need
// for a reference of n and reads of m (the slab boundary past 512 rows; 0
// when it stays in shared memory or the read takes one slab).
extern "C" int gt4_sw_scratch(int n, int m) {
  if (n < 0 || m < 0) return 0;
  const Plan p = make_plan(n, m, 1, false);
  return p.slabs && !p.bnd_shared ? 16 * (n + 1) : 0;
}

// Kernel C. refs int8[B, n], reads int8[B, m], nvec int32[B], scratch 16-byte
// aligned, B * gt4_sw_scratch(n, m) bytes (may be null when that is 0);
// outputs [B, n+1, m+1]. Launches on `stream`; allocates nothing. Returns
// cudaGetLastError() (or the error of a refused configuration).
extern "C" int gt4_sw_lanes(const void* refs, const void* reads,
                            const void* nvec, void* score, void* sx, void* sy,
                            void* scratch, int B, int n, int m,
                            void* stream) {
  if (!nvec) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(refs, reads, nvec, score, sx, sy, scratch, B, n, m, stream);
}

// Kernel D. ref int8[n], reads int8[B, m], scratch as for gt4_sw_lanes;
// outputs [B, n+1, m+1]. Launches on `stream`; allocates nothing. Returns
// cudaGetLastError() (or the error of a refused configuration).
extern "C" int gt4_sw_shared(const void* ref, const void* reads, void* score,
                             void* sx, void* sy, void* scratch, int B, int n,
                             int m, void* stream) {
  return dispatch(ref, reads, nullptr, score, sx, sy, scratch, B, n, m,
                  stream);
}
