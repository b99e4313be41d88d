// Kernels C and D: affine-gap Smith-Waterman fill, score/sx/sy matrices.
//
// Kernel C (sw_lanes_kernel) replaces the Pallas TPU kernel
// make_sw_pallas_lanes (genometester4_tpu/ops/swalign_pallas.py:182, body
// :211): every read carries its own reference and reference length, so many
// gassembler regions share one launch. Kernel D (sw_shared_kernel) replaces
// make_sw_pallas (swalign_pallas.py:46, body :58): one reference for all
// reads, one read per block. Plain PyTorch version of both:
// genometester4_tpu_torch/ops/swalign.py:sw_fill. Wrappers:
// ops/swalign_cuda.py.
//
// Contract (both): score int16, sx int8, sy int8, each [B, n+1, m+1]
// row-major. Row 0, column 0 and the rows past a read's reference length
// are 0. Cell (i, j) follows the C reference's recurrence
// (src/gassembler.c:2185-2321, the JAX package's ops/swalign.py): match +2,
// mismatch -3, a code >= N (4) on either side 0, gap open -4, extend -2;
// the left gap is taken if >= the cell, then the top gap if >= the updated
// cell; gap lengths wrap as int8. Padded read columns (code 6) are computed
// like any other column.
//
// Bound: operations. A cell costs ~30 integer operations and writes 4 bytes
// (int16 score, two int8 directions): at the card's int32 rate
// (16.7 T op/s) a gassembler window of 512 reads x 200 x 152 cells needs
// ~0.03 ms, its 63 MB of output ~0.02 ms at 3.35 TB/s. What stands between
// a kernel and that bound is the dependent chain of cells, and how the
// output reaches device memory.
//
// Kernel C: one warp per read, so a window of reads spreads over every SM
// (the earlier form, one thread per read, filled 16 of 132 SMs with 512
// reads and wrote each cell as a transaction of its own). Lane L owns a
// strip of S = ceil(m/32) columns (S is a template parameter, so the
// strip's state lives in registers) and computes row i = t - L + 1 at step
// t: a skewed wavefront. Within a strip the cells go left to right; the
// left neighbour's state (its gap state in row i and its score in row i-1)
// comes from lane L-1's previous step through __shfl_up_sync, so the warp
// needs no barrier. Lane 31 finishes a row one step after lane 30, so at
// every step exactly one row completes. Rows are staged in a ring of 32
// rows in shared memory (4 bytes per cell: 19.6 KB at m = 152, 11 warps
// per SM), and the warp copies each finished row out with neighbouring
// lanes on neighbouring addresses. One warp per read, rather than kernel
// D's block per read, because a block that sweeps anti-diagonals finishes
// row i only at diagonal i + m: staging its output takes the whole matrix
// (123 KB at 200 x 152, one block per SM), and every diagonal costs a
// block barrier. Limit: m <= 1472 (32 strips of at most 46 columns).
//
// Kernel D: one thread per column sweeps the anti-diagonals (cells of one
// diagonal are independent), with the neighbour column's state of the
// previous diagonal in double-buffered shared memory and one __syncthreads
// per diagonal; the reference sits in shared memory. It writes row-major
// matrices straight from the recurrence.
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
constexpr int kNone = 6;           // padding code of reads
constexpr int kWarp = 32;
constexpr int kRingRows = 32;      // kernel C: rows staged per read
constexpr int kMaxLaneCols = 1472; // kernel C: widest read (m), 32 x 46
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ int wrap8(int x) { return ((x + 128) & 255) - 128; }

// One cell. In: the reference and read codes, diag = H(i-1, j-1), (ls, ll)
// the left gap state of (i, j-1), (ts, tl) the top gap state of (i-1, j).
// Out: the cell's score and directions; (ls, ll) and (ts, tl) become the
// gap states of (i, j).
__device__ __forceinline__ void sw_cell(int a, int b, int diag, int& ls,
                                        int& ll, int& ts, int& tl, int& cell,
                                        int& csx, int& csy) {
  const int sub = (a >= kNuclN || b >= kNuclN) ? kNScore
                  : (a == b ? kMatch : kMismatch);
  const int dsc = diag + sub;
  cell = dsc > 0 ? dsc : 0;
  csx = csy = dsc > 0 ? -1 : 0;
  int s = cell + kGapOpen, l = 0;
  if (ls + kGapExt > s) {
    s = ls + kGapExt;
    l = wrap8(ll + 1);
  }
  ls = s;
  ll = l;
  if (s >= cell) {
    cell = s;
    csx = wrap8(-l);
    csy = 0;
  }
  s = cell + kGapOpen;
  l = 0;
  if (ts + kGapExt > s) {
    s = ts + kGapExt;
    l = wrap8(tl + 1);
  }
  ts = s;
  tl = l;
  if (s >= cell) {
    cell = s;
    csx = 0;
    csy = wrap8(-l);
  }
}

// Kernel C: block b, one warp, aligns reads[b] to refs[b, :min(nvec[b], n)].
// Lane L owns columns L*S+1 .. L*S+S and computes row i = t - L + 1 at step
// t; rows go through a ring of kRingRows rows in shared memory, three
// planes (score, sx, sy) of [kRingRows][m+1].
template <int S>
__global__ void __launch_bounds__(kWarp)
    sw_lanes_kernel(const int8_t* __restrict__ refs,
                    const int8_t* __restrict__ reads,
                    const int* __restrict__ nvec, int16_t* __restrict__ score,
                    int8_t* __restrict__ sx, int8_t* __restrict__ sy, int n,
                    int m) {
  static_assert(kRingRows == kWarp, "one ring row per lane at set-up");
  extern __shared__ unsigned char smem[];
  const int cols = m + 1;
  int16_t* ring_sc = reinterpret_cast<int16_t*>(smem);
  int8_t* ring_x = reinterpret_cast<int8_t*>(ring_sc + kRingRows * cols);
  int8_t* ring_y = ring_x + kRingRows * cols;
  const int b = blockIdx.x, lane = threadIdx.x;
  const long long at = static_cast<long long>(b) * (n + 1) * cols;
  int16_t* sc = score + at;
  int8_t* x = sx + at;
  int8_t* y = sy + at;
  const int8_t* ref = refs + static_cast<long long>(b) * n;
  const int lim = min(max(nvec[b], 0), n);

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
  ring_sc[lane * cols] = 0;
  ring_x[lane * cols] = 0;
  ring_y[lane * cols] = 0;

  const int c0 = lane * S + 1;   // this lane's first column
  int code[S], up[S], ts[S], tl[S];   // read code, H(i-1, j), top gap
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int j = c0 + s;
    code[s] = j <= m ? reads[static_cast<long long>(b) * m + j - 1] : kNone;
    up[s] = 0;
    ts[s] = kNeg;
    tl[s] = 0;
  }
  // from lane L-1's previous step: H(i-1, c0-1) and the left gap state of
  // (i, c0-1); lane 0 borders column 0 instead
  int diag_in = 0, ls_in = kNeg, ll_in = 0;
  __syncwarp();

  for (int t = 0; t < lim + kWarp - 1; ++t) {
    const int i = t - lane + 1;
    int diag = lane ? diag_in : 0;
    int ls = lane ? ls_in : kNeg, ll = lane ? ll_in : 0;
    if (i >= 1 && i <= lim) {
      const int a = ref[i - 1];
      const int row = ((i - 1) & (kRingRows - 1)) * cols;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        int cell, csx, csy;
        sw_cell(a, code[s], diag, ls, ll, ts[s], tl[s], cell, csx, csy);
        diag = up[s];
        up[s] = cell;
        const int j = c0 + s;
        if (j <= m) {
          ring_sc[row + j] = static_cast<int16_t>(cell);
          ring_x[row + j] = static_cast<int8_t>(csx);
          ring_y[row + j] = static_cast<int8_t>(csy);
        }
      }
    }
    diag_in = __shfl_up_sync(0xffffffffu, diag, 1);
    ls_in = __shfl_up_sync(0xffffffffu, ls, 1);
    ll_in = __shfl_up_sync(0xffffffffu, ll, 1);
    __syncwarp();
    // lane 31 has just finished row r: copy it out, lane k on column k
    const int r = t - (kWarp - 2);
    if (r >= 1) {
      const int row = ((r - 1) & (kRingRows - 1)) * cols;
      const long long g = static_cast<long long>(r) * cols;
      for (int k = lane; k < cols; k += kWarp) {
        sc[g + k] = ring_sc[row + k];
        x[g + k] = ring_x[row + k];
        y[g + k] = ring_y[row + k];
      }
    }
    __syncwarp();
  }
}

// Kernel D: block b aligns reads[b] to ref[0:n]; thread j owns column j.
__global__ void sw_shared_kernel(const int8_t* __restrict__ ref,
                                 const int8_t* __restrict__ reads,
                                 int16_t* __restrict__ score,
                                 int8_t* __restrict__ sx,
                                 int8_t* __restrict__ sy, int n, int m) {
  extern __shared__ unsigned char smem[];
  // two buffers (by diagonal parity) of per-column score, left-gap score
  // and left-gap length, then the reference codes
  int* h_buf = reinterpret_cast<int*>(smem);   // [2][m+1]
  int* ls_buf = h_buf + 2 * (m + 1);
  int* ll_buf = ls_buf + 2 * (m + 1);
  int8_t* ref_s = reinterpret_cast<int8_t*>(ll_buf + 2 * (m + 1));
  const int b = blockIdx.x, j = threadIdx.x;
  const long long cols = m + 1;
  const long long at = static_cast<long long>(b) * (n + 1) * cols;
  int16_t* sc = score + at;
  int8_t* x = sx + at;
  int8_t* y = sy + at;

  for (int k = j; k < n; k += blockDim.x) ref_s[k] = ref[k];
  for (int i = j; i <= n; i += blockDim.x) {   // column 0
    sc[i * cols] = 0;
    x[i * cols] = 0;
    y[i * cols] = 0;
  }
  const bool col = j >= 1 && j <= m;
  if (j <= m) {
    sc[j] = 0;   // row 0
    x[j] = 0;
    y[j] = 0;
    h_buf[(m + 1) + j] = 0;   // diagonal 1 (parity 1): no valid cell
    ls_buf[(m + 1) + j] = kNeg;
    ll_buf[(m + 1) + j] = 0;
  }
  const int bcode = col ? reads[static_cast<long long>(b) * m + j - 1] : 0;
  int diag = 0;            // H(i-1, j-1), read one diagonal earlier
  int ts = kNeg, tl = 0;   // this column's gap state on the last diagonal
  __syncthreads();

  for (int d = 2; d <= n + m; ++d) {
    const int rd = ((d - 1) & 1) * (m + 1), wr = (d & 1) * (m + 1);
    int left_h = 0, ls = kNeg, ll = 0;   // (i, j-1) on diagonal d-1
    if (col) {
      left_h = h_buf[rd + j - 1];
      ls = ls_buf[rd + j - 1];
      ll = ll_buf[rd + j - 1];
    }
    const int i = d - j;
    int cell = 0;
    if (col && i >= 1 && i <= n) {
      int csx, csy;
      sw_cell(ref_s[i - 1], bcode, diag, ls, ll, ts, tl, cell, csx, csy);
      sc[i * cols + j] = static_cast<int16_t>(cell);
      x[i * cols + j] = static_cast<int8_t>(csx);
      y[i * cols + j] = static_cast<int8_t>(csy);
    } else {
      ls = ts = kNeg;
      ll = tl = 0;
    }
    if (j <= m) {
      h_buf[wr + j] = cell;
      ls_buf[wr + j] = ls;
      ll_buf[wr + j] = ll;
    }
    diag = left_h;   // H(i, j-1) is the diagonal neighbour of (i+1, j)
    __syncthreads();
  }
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
int launch_lanes(const void* refs, const void* reads, const void* nvec,
                 void* score, void* sx, void* sy, int B, int n, int m,
                 void* stream) {
  const long long bytes = 4LL * kRingRows * (m + 1);
  const int err = prepare_shared(sw_lanes_kernel<S>, bytes);
  if (err) return err;
  sw_lanes_kernel<S><<<static_cast<unsigned>(B), kWarp, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(refs), static_cast<const int8_t*>(reads),
      static_cast<const int*>(nvec), static_cast<int16_t*>(score),
      static_cast<int8_t*>(sx), static_cast<int8_t*>(sy), n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Kernel C. refs int8[B, n], reads int8[B, m] with m <= 1472, nvec
// int32[B]; outputs [B, n+1, m+1]. Launches on `stream`; allocates nothing.
// Returns cudaGetLastError() (or the error of a refused configuration).
extern "C" int gt4_sw_lanes(const void* refs, const void* reads,
                            const void* nvec, void* score, void* sx, void* sy,
                            int B, int n, int m, void* stream) {
  if (B <= 0) return 0;
  if (n < 0 || m < 0 || m > kMaxLaneCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const int strip = (m + kWarp - 1) / kWarp;   // columns per lane
#define GT4_LANES(S)                                                        \
  if (strip <= S)                                                           \
    return launch_lanes<S>(refs, reads, nvec, score, sx, sy, B, n, m, stream);
  GT4_LANES(1) GT4_LANES(2) GT4_LANES(3) GT4_LANES(4) GT4_LANES(5)
  GT4_LANES(6) GT4_LANES(7) GT4_LANES(8) GT4_LANES(10) GT4_LANES(12)
  GT4_LANES(16) GT4_LANES(24) GT4_LANES(32) GT4_LANES(46)
#undef GT4_LANES
  return static_cast<int>(cudaErrorInvalidValue);
}

// Kernel D. ref int8[n], reads int8[B, m] with m + 1 <= 1024; outputs
// [B, n+1, m+1]. Launches on `stream`; allocates nothing. Returns
// cudaGetLastError() (or the error of a refused configuration).
extern "C" int gt4_sw_shared(const void* ref, const void* reads, void* score,
                             void* sx, void* sy, int B, int n, int m,
                             void* stream) {
  if (B <= 0) return 0;
  if (n < 0 || m < 0 || m + 1 > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = 6LL * 4 * (m + 1) + n;
  const int err = prepare_shared(sw_shared_kernel, bytes);
  if (err) return err;
  const int threads = (m + 1 + 31) / 32 * 32;
  sw_shared_kernel<<<static_cast<unsigned>(B), threads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ref), static_cast<const int8_t*>(reads),
      static_cast<int16_t*>(score), static_cast<int8_t*>(sx),
      static_cast<int8_t*>(sy), n, m);
  return static_cast<int>(cudaGetLastError());
}
