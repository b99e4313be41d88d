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
// Bound: the output. A cell costs ~30 integer operations and writes 4 bytes
// (int16 score, two int8 directions), which this card can stream far
// faster than one thread per read can produce them, so in practice both
// kernels are bound by the latency of their dependent cell chain, not by
// device memory. What the designs do about it:
//   C: one thread per read sweeps rows i, then columns j: the C reference's
//      own order. Its rolling row state (score, top-gap score and length
//      of row i-1) lives in shared memory, column-interleaved across the
//      block's threads so a warp's 32 accesses to one column are free of
//      bank conflicts. It needs no barrier, and blocks of one warp spread
//      a window of ~512 reads over as many SMs as there are warps. That
//      is 16 of 132 SMs for 512 reads: the chain of one thread per read,
//      not the card, bounds it.
//   D: one thread per column sweeps the anti-diagonals (cells of one
//      diagonal are independent), with the neighbour column's state of the
//      previous diagonal in double-buffered shared memory and one
//      __syncthreads per diagonal; the reference sits in shared memory.
// Both write row-major matrices straight from the recurrence. The TPU
// kernels' diagonal-stacked int32 output (and the host diag_to_matrix it
// needed), their 128-lane / 8-sublane padding, the precomputed diagonal
// gather of reference bases, the rolling reference row in scratch and the
// (..., 1, 128) unit dimensions exist only for Mosaic and are not ported.

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
constexpr int kLaneThreads = 32;   // kernel C: reads per block
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

// Kernel C: thread b aligns reads[b] to refs[b, :min(nvec[b], n)].
__global__ void sw_lanes_kernel(const int8_t* __restrict__ refs,
                                const int8_t* __restrict__ reads,
                                const int* __restrict__ nvec,
                                int16_t* __restrict__ score,
                                int8_t* __restrict__ sx,
                                int8_t* __restrict__ sy, int B, int n, int m) {
  extern __shared__ unsigned char smem[];
  const int T = blockDim.x, t = threadIdx.x;
  // row state of row i-1 for column j at [j * T + t]
  int16_t* h_row = reinterpret_cast<int16_t*>(smem);
  int16_t* tg_s = h_row + (m + 1) * T;
  int8_t* tg_l = reinterpret_cast<int8_t*>(tg_s + (m + 1) * T);
  const int b = blockIdx.x * T + t;
  if (b >= B) return;   // no barrier below, so idle threads may leave

  const long long cols = m + 1;
  const long long at = static_cast<long long>(b) * (n + 1) * cols;
  int16_t* sc = score + at;
  int8_t* x = sx + at;
  int8_t* y = sy + at;
  const int8_t* ref = refs + static_cast<long long>(b) * n;
  const int8_t* read = reads + static_cast<long long>(b) * m;
  const int lim = min(max(nvec[b], 0), n);

  for (int j = 0; j <= m; ++j) {
    h_row[j * T + t] = 0;
    tg_s[j * T + t] = kNeg;
    tg_l[j * T + t] = 0;
    sc[j] = 0;
    x[j] = 0;
    y[j] = 0;
  }
  for (int i = 1; i <= n; ++i) {
    int16_t* sc_r = sc + i * cols;
    int8_t* x_r = x + i * cols;
    int8_t* y_r = y + i * cols;
    sc_r[0] = 0;
    x_r[0] = 0;
    y_r[0] = 0;
    if (i > lim) {
      for (int j = 1; j <= m; ++j) {
        sc_r[j] = 0;
        x_r[j] = 0;
        y_r[j] = 0;
      }
      continue;
    }
    const int a = ref[i - 1];
    int diag = 0;            // H(i-1, 0)
    int ls = kNeg, ll = 0;   // left gap state of (i, 0)
    for (int j = 1; j <= m; ++j) {
      const int k = j * T + t;
      const int up = h_row[k];
      int ts = tg_s[k], tl = tg_l[k];
      int cell, csx, csy;
      sw_cell(a, read[j - 1], diag, ls, ll, ts, tl, cell, csx, csy);
      diag = up;
      h_row[k] = static_cast<int16_t>(cell);
      tg_s[k] = static_cast<int16_t>(ts);
      tg_l[k] = static_cast<int8_t>(tl);
      sc_r[j] = static_cast<int16_t>(cell);
      x_r[j] = static_cast<int8_t>(csx);
      y_r[j] = static_cast<int8_t>(csy);
    }
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

}  // namespace

// Kernel C. refs int8[B, n], reads int8[B, m], nvec int32[B]; outputs
// [B, n+1, m+1]. Launches on `stream`; allocates nothing. Returns
// cudaGetLastError() (or the error of a refused configuration).
extern "C" int gt4_sw_lanes(const void* refs, const void* reads,
                            const void* nvec, void* score, void* sx, void* sy,
                            int B, int n, int m, void* stream) {
  if (B <= 0) return 0;
  if (n < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = 5LL * (m + 1) * kLaneThreads;
  const int err = prepare_shared(sw_lanes_kernel, bytes);
  if (err) return err;
  const unsigned blocks = (B + kLaneThreads - 1) / kLaneThreads;
  sw_lanes_kernel<<<blocks, kLaneThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(refs), static_cast<const int8_t*>(reads),
      static_cast<const int*>(nvec), static_cast<int16_t*>(score),
      static_cast<int8_t*>(sx), static_cast<int8_t*>(sy), B, n, m);
  return static_cast<int>(cudaGetLastError());
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
