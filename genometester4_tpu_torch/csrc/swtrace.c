/* gassembler's alignment of one region's reads from filled SW matrices,
 * in one call.
 *
 * gt4_sw_align_mats takes the matrices of a fill that has already run
 * (kernel C's launch copied back, or the plain fill on the CPU) and does
 * for every read, in read order, what align_reads' per-read loop did in
 * Python (pipelines/gassemble.py): the traceback of src/gassembler.c:
 * 2298-2320, the divergence count of :1162-1196, the four filters and the
 * per-reference-position read-position row of :1925-2006, and the stop
 * after max_aligned kept reads.  Its outputs are those of the host route's
 * fgx_sw_align_region8 (native/listkernel.c), which fuses its own fill in
 * front of the same steps; the tests hold the two and the per-read loop to
 * the same rows, reads and statistics.
 *
 * The matrices are read in place through their strides, so a region's
 * views into one padded launch need no copy: lane b's cell (i, j) is
 * score[b * lane + i * row + j] (sx and sy alike, counted in elements).
 * Rows 0..n and columns 0..read_len of each lane are read.
 *
 * The traceback starts at the first maximum in row-major order, taken as
 * fgx_sw_traceback takes it: strictly greater, starting from cell (0, 0).
 * Two passes find the same cell with no branch per cell: one takes every
 * row's maximum (a reduction the compiler vectorises), the other looks for
 * the overall maximum in the first row that holds it.
 *
 * The matrices of a launch come back from the card into memory no cache
 * holds, and the walk's steps depend on each other, so both passes fetch
 * ahead: the scan ROWS_AHEAD rows, the walk STEPS_AHEAD cells up its
 * diagonal (most steps are diagonal).
 */

#include <stdlib.h>

#define BEFORE (-1)
#define AFTER (-2)
#define UNKNOWN (-3)

#define ROWS_AHEAD 6
#define STEPS_AHEAD 16

/* The first maximum of lane sc over rows 0..n and columns 0..rl in
 * row-major order; 0 and (0, 0) when no cell beats cell (0, 0). */
static void first_max (const short *sc, long row, int n, int rl,
                       short *row_max, int *mi, int *mj)
{
  int i, j;
  short best = sc[0];
  for (i = 0; i <= n; i++) {
    const short *r = sc + i * row;
    short v = r[0];
    if (i + ROWS_AHEAD <= n)
      for (j = 0; j <= rl; j += 32)
        __builtin_prefetch (r + ROWS_AHEAD * row + j);
    for (j = 1; j <= rl; j++)
      v = r[j] > v ? r[j] : v;
    row_max[i] = v;
  }
  *mi = *mj = 0;
  for (i = 0; i <= n; i++)
    best = row_max[i] > best ? row_max[i] : best;
  if (best <= sc[0])
    return;
  for (i = 0; row_max[i] != best; i++)
    ;
  for (j = 0; sc[i * row + j] != best; j++)
    ;
  *mi = i;
  *mj = j;
}

/* The walk back from (mi, mj) along sx/sy; the aligned pairs in ascending
 * order.  Every step of a sound fill lowers mi + mj, so the walk takes at
 * most n + m steps and stays inside the matrix: the bounds only keep a
 * malformed fill from reading or writing past its arrays. */
static int walk_back (const short *sc, const signed char *sx,
                      const signed char *sy, long row, int n, int m,
                      int mi, int mj, int *a_pos, int *b_pos)
{
  int cnt = 0, steps = 0, t, half;
  for (t = 1; t < STEPS_AHEAD && t <= mi && t <= mj; t++) {
    __builtin_prefetch (sx + (mi - t) * row + mj - t);
    __builtin_prefetch (sy + (mi - t) * row + mj - t);
  }
  while (mi > 0 && mj > 0 && mi <= n && mj <= m && steps++ <= n + m) {
    long at = mi * row + mj;
    signed char cx = sx[at], cy = sy[at];
    if (mi > STEPS_AHEAD && mj > STEPS_AHEAD) {
      __builtin_prefetch (sx + at - STEPS_AHEAD * (row + 1));
      __builtin_prefetch (sy + at - STEPS_AHEAD * (row + 1));
    }
    if (cx == 0 && cy == 0) break;
    if (sc[at] < 1) break;
    if (cx && cy) { a_pos[cnt] = mi - 1; b_pos[cnt] = mj - 1; cnt++; }
    mi += cy;
    mj += cx;
  }
  half = cnt / 2;
  for (t = 0; t < half; t++) {
    int x = a_pos[t]; a_pos[t] = a_pos[cnt - 1 - t]; a_pos[cnt - 1 - t] = x;
    x = b_pos[t]; b_pos[t] = b_pos[cnt - 1 - t]; b_pos[cnt - 1 - t] = x;
  }
  return cnt;
}

/* The read's row: BEFORE where it would start before position 0, UNKNOWN
 * up to its first anchor, at each anchor the read position of the first
 * pair there, between anchors the previous anchor's, then UNKNOWN and
 * AFTER where the read has run out. */
static void build_row (int *row, int n, int rl, const int *a_pos,
                       const int *b_pos, int cnt)
{
  int a0 = a_pos[0], a_last = a_pos[cnt - 1];
  int before_end = a0 - b_pos[0];
  int cut = a_last + rl - b_pos[cnt - 1];
  int unk_end = cut > a_last + 1 ? cut : a_last + 1;
  int p = 0, t, cur = 0;
  if (before_end > a0) before_end = a0;
  if (before_end < 0) before_end = 0;
  if (unk_end > n) unk_end = n;
  for (; p < before_end; p++) row[p] = BEFORE;
  for (; p < a0; p++) row[p] = UNKNOWN;
  for (t = 0; t < cnt; t++) {
    if (a_pos[t] < p) continue;             /* the first anchor wins */
    for (; p < a_pos[t]; p++) row[p] = cur;
    cur = b_pos[t];
    row[p++] = cur;
  }
  for (p = a_last + 1; p < unk_end; p++) row[p] = UNKNOWN;
  for (; p < n; p++) row[p] = AFTER;
}

/* ref int8[n]; reads int8[B, m] padded; read_lens int[B]; score int16,
 * sx and sy int8 with element strides lane and row (columns dense).
 * rows int[min(B, max_aligned), n] and keep_idx take the kept reads;
 * *hit_cap is set when max_aligned stopped the scan; stats int[B * 6]
 * take {align_len, n_divergent, n_gaps, gaps_total, s_gap, e_gap} of
 * every processed read, align_len 0 and the rest -1 for an empty
 * traceback, and are left as they were for reads never reached.
 * Returns the kept count, or -1 when its scratch cannot be allocated. */
long gt4_sw_align_mats (const signed char *ref, int n,
                        const signed char *reads, long B, int m,
                        const int *read_lens,
                        const short *score, const signed char *sx,
                        const signed char *sy, long lane, long row,
                        int max_divergent, int min_align_len,
                        int max_endgap, int max_gaps, long max_aligned,
                        int *rows, int *keep_idx, int *hit_cap, int *stats)
{
  short *row_max = (short *) malloc ((size_t) (n + 1) * sizeof (short));
  int *a_pos = (int *) malloc ((size_t) (n + m + 2) * sizeof (int));
  int *b_pos = (int *) malloc ((size_t) (n + m + 2) * sizeof (int));
  long b, kept = 0;
  *hit_cap = 0;
  if (!row_max || !a_pos || !b_pos) {
    free (row_max); free (a_pos); free (b_pos);
    return -1;
  }
  for (b = 0; b < B; b++) {
    const short *sc = score + b * lane;
    const signed char *rd = reads + b * m;
    int rl = read_lens[b];
    int mi, mj, cnt, t;
    int n_gaps = 0, gaps_total = 0, s_gap = 0, e_gap = 0, n_div;
    first_max (sc, row, n, rl, row_max, &mi, &mj);
    cnt = walk_back (sc, sx + b * lane, sy + b * lane, row, n, m, mi, mj,
                     a_pos, b_pos);
    if (cnt == 0) {
      stats[b * 6] = 0;
      for (t = 1; t < 6; t++) stats[b * 6 + t] = -1;
      continue;
    }
    if (a_pos[0] > 0 && b_pos[0] > 0) {
      int mn = a_pos[0] < b_pos[0] ? a_pos[0] : b_pos[0];
      n_gaps++; s_gap = mn; gaps_total += mn;
    }
    if (a_pos[cnt - 1] < n - 1 && b_pos[cnt - 1] < rl - 1) {
      int ga = n - 1 - a_pos[cnt - 1];
      int gb = rl - 1 - b_pos[cnt - 1];
      int mn = ga < gb ? ga : gb;
      n_gaps++; e_gap = mn; gaps_total += mn;
    }
    n_div = n_gaps;
    for (t = 0; t < cnt; t++)
      n_div += ref[a_pos[t]] != rd[b_pos[t]];
    stats[b * 6 + 0] = cnt; stats[b * 6 + 1] = n_div;
    stats[b * 6 + 2] = n_gaps; stats[b * 6 + 3] = gaps_total;
    stats[b * 6 + 4] = s_gap; stats[b * 6 + 5] = e_gap;
    if (n_div > max_divergent) continue;
    if (cnt < min_align_len) continue;
    if (s_gap > max_endgap || e_gap > max_endgap) continue;
    if (gaps_total > max_gaps) continue;
    build_row (rows + kept * n, n, rl, a_pos, b_pos, cnt);
    keep_idx[kept++] = (int) b;
    if (kept >= max_aligned) { *hit_cap = 1; break; }
  }
  free (row_max); free (a_pos); free (b_pos);
  return kept;
}
