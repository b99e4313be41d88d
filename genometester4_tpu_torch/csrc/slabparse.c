/* Host FASTQ slab parse in one call: frame and decode together.
 *
 * gt4_fastq_frame_decode takes the bytes of a slab (the previous slab's
 * carry followed by the new read) and writes the 2-bit codes of every
 * whole 4-line group in it, with one 255 sentinel after each record, and
 * per record the code offset of its first base, the byte offsets of its
 * name and of its header line's end (a '\r' before the '\n' kept, as the
 * name's bytes keep it) and its sequence line's raw length ('\r'
 * included).  It returns the bytes it consumed: the end of the last
 * whole group, so the caller keeps the rest as its carry and never looks
 * for a newline itself.
 *
 * Semantics are those of parse_fastq (io/fasta.py) and of
 * fgx_parse_fastq_slab (native/listkernel.c), which the tests hold it to:
 * every '\n'-delimited segment is a line, empty ones included; one
 * trailing '\r' is stripped from each line; a record is a group of four
 * lines (name, sequence, '+', quality) and the groups follow each other
 * with no resync.  A segment with no '\n' after it is a line only at the
 * end of the input (at_eof) and only when it is not empty.
 *
 * The slab is cut into pieces that start at line starts.  A first pass
 * counts each piece's lines and the stripped lengths of its lines by
 * their index mod 4; prefix sums over the pieces then give each piece its
 * first line's global index (its phase in the 4-line group) and its first
 * code's offset, and a second pass decodes the pieces independently.
 * Line ends are found with memchr.  A large slab's pieces run on one
 * thread per CPU this process may use, started for the call and joined
 * before it returns, so no thread pool outlives it (a forked child finds
 * none); a small slab runs the same pieces on the calling thread.
 */

#define _GNU_SOURCE
#include <pthread.h>
#include <sched.h>
#include <stdlib.h>
#include <string.h>

/* the smallest slab split across threads, and the smallest piece */
#define PAR_MIN_BYTES (1L << 23)
#define PIECE_MIN_BYTES (1L << 21)
#define MAX_THREADS 64

static unsigned char code_of[256];

static void code_init (void)
{
  static int done = 0;
  if (done) return;
  memset (code_of, 255, 256);
  code_of['A'] = code_of['a'] = 0;
  code_of['C'] = code_of['c'] = 1;
  code_of['G'] = code_of['g'] = 2;
  code_of['T'] = code_of['t'] = 3;
  code_of['U'] = code_of['u'] = 3;
  done = 1;
}

typedef struct {
  long start, end;      /* [start, end): whole lines, and the tail if last */
  long lines;           /* lines in the piece (pass 1) */
  long len[4];          /* stripped lengths by local line index mod 4 */
  long line0, code0;    /* global index of the first line, first code */
  long codes, bases, ncnt, consumed;   /* pass 2 */
} piece_t;

/* The end of the line starting at i within [i, end), and whether it is a
 * line at all: a segment without '\n' counts only at EOF when not empty. */
static long line_end (const unsigned char *data, long i, long end,
                      long n, int at_eof, int *is_line)
{
  const unsigned char *p = memchr (data + i, '\n', (size_t) (end - i));
  if (p) {
    *is_line = 1;
    return p - data;
  }
  *is_line = at_eof && end == n && end > i;
  return end;
}

static long stripped (const unsigned char *data, long i, long e)
{
  return (e > i && data[e - 1] == '\r') ? e - 1 : e;
}

static void count_piece (const unsigned char *data, long n, int at_eof,
                         piece_t *pc)
{
  long i = pc->start, lines = 0;
  memset (pc->len, 0, sizeof pc->len);
  while (i < pc->end) {
    int is_line;
    long e = line_end (data, i, pc->end, n, at_eof, &is_line);
    if (!is_line) break;
    pc->len[lines & 3] += stripped (data, i, e) - i;
    lines++;
    i = e + 1;
  }
  pc->lines = lines;
}

static void decode_piece (const unsigned char *data, long n, int at_eof,
                          long last_line, piece_t *pc, unsigned char *codes,
                          long *rec_starts, long *name_pos, long *name_end,
                          long *seq_len)
{
  long i = pc->start, g = pc->line0, c = pc->code0;
  long bases = 0, ncnt = 0;
  pc->consumed = -1;
  while (i < pc->end && g <= last_line) {
    int is_line;
    long e = line_end (data, i, pc->end, n, at_eof, &is_line);
    if (!is_line) break;
    if ((g & 3) == 0) {
      name_pos[g >> 2] = i + 1;               /* past '@' */
      name_end[g >> 2] = e;
    } else if ((g & 3) == 1) {
      long j, le = stripped (data, i, e);
      rec_starts[g >> 2] = c;
      seq_len[g >> 2] = e - i;
      for (j = i; j < le; j++) {
        unsigned char b = data[j];
        codes[c++] = code_of[b];
        ncnt += (b | 0x20) == 'n';
      }
      codes[c++] = 255;                       /* sentinel */
      bases += le - i;
    }
    if (g == last_line) pc->consumed = e < n ? e + 1 : n;
    g++;
    i = e + 1;
  }
  pc->codes = c - pc->code0;
  pc->bases = bases;
  pc->ncnt = ncnt;
}

typedef struct {
  const unsigned char *data;
  long n, last_line;
  int at_eof, pass;
  piece_t *pcs;
  long np, first, stride;
  unsigned char *codes;
  long *rec_starts, *name_pos, *name_end, *seq_len;
} share_t;

static void *run_share (void *arg)
{
  const share_t *sh = arg;
  long j;
  for (j = sh->first; j < sh->np; j += sh->stride) {
    if (sh->pass == 1)
      count_piece (sh->data, sh->n, sh->at_eof, &sh->pcs[j]);
    else
      decode_piece (sh->data, sh->n, sh->at_eof, sh->last_line, &sh->pcs[j],
                    sh->codes, sh->rec_starts, sh->name_pos, sh->name_end,
                    sh->seq_len);
  }
  return NULL;
}

/* Run one pass over every piece: piece j on share j mod threads, share 0
 * on the calling thread, and a share whose thread fails to start after
 * it. */
static void run_pass (const share_t *job, int threads)
{
  pthread_t tid[MAX_THREADS];
  share_t sh[MAX_THREADS];
  int started[MAX_THREADS];
  int t;
  for (t = 0; t < threads; t++) {
    sh[t] = *job;
    sh[t].first = t;
    sh[t].stride = threads;
    started[t] = t > 0 && pthread_create (&tid[t], NULL, run_share,
                                          &sh[t]) == 0;
  }
  run_share (&sh[0]);
  for (t = 1; t < threads; t++) {
    if (started[t])
      pthread_join (tid[t], NULL);
    else
      run_share (&sh[t]);
  }
}

static int cpu_threads (void)
{
  cpu_set_t set;
  int n = 1;
  if (sched_getaffinity (0, sizeof set, &set) == 0) n = CPU_COUNT (&set);
  if (n < 1) n = 1;
  return n > MAX_THREADS ? MAX_THREADS : n;
}

/* data[0..n): the slab; at_eof: no byte follows it; piece: bytes per
 * piece (0 picks by size and thread count; a positive value is for the
 * tests, which set every seam).  codes has room for n + 1 bytes;
 * rec_starts, name_pos, name_end and seq_len for rec_cap records.  out: [0] codes written,
 * [1] records, [2] total bases, [3] N/n bytes among them.  Returns the
 * bytes consumed, -1 when the records exceed rec_cap (out[1] then holds
 * how many there are and nothing is written) or -2 when memory for the
 * pieces is short. */
long gt4_fastq_frame_decode (const unsigned char *data, long n, int at_eof,
                             long piece, unsigned char *codes,
                             long *rec_starts, long *name_pos,
                             long *name_end, long *seq_len, long rec_cap,
                             long *out)
{
  long np, j, lines = 0, code = 0, nrec, consumed = 0;
  int threads = 1;
  piece_t *pcs;
  share_t job;

  code_init ();
  out[0] = out[1] = out[2] = out[3] = 0;
  if (n <= 0) return 0;
  if (n >= PAR_MIN_BYTES) threads = cpu_threads ();
  if (piece <= 0) {
    piece = (n + threads - 1) / threads;
    if (threads > 1 && piece < PIECE_MIN_BYTES) piece = PIECE_MIN_BYTES;
  }
  np = (n + piece - 1) / piece;
  pcs = malloc ((size_t) np * sizeof *pcs);
  if (!pcs) return -2;

  /* each piece starts at the first line start at or after its seam */
  pcs[0].start = 0;
  for (j = 1; j < np; j++) {
    long s = j * piece;
    if (s < pcs[j - 1].start) s = pcs[j - 1].start;
    if (s >= n) {
      pcs[j].start = n;
    } else if (data[s - 1] == '\n') {
      pcs[j].start = s;
    } else {
      const unsigned char *p = memchr (data + s, '\n', (size_t) (n - s));
      pcs[j].start = p ? p - data + 1 : n;
    }
  }
  for (j = 0; j < np; j++)
    pcs[j].end = j + 1 < np ? pcs[j + 1].start : n;

  if (threads > np) threads = (int) np;
  job.data = data;
  job.n = n;
  job.at_eof = at_eof;
  job.pcs = pcs;
  job.np = np;
  job.codes = codes;
  job.rec_starts = rec_starts;
  job.name_pos = name_pos;
  job.name_end = name_end;
  job.seq_len = seq_len;
  job.pass = 1;
  run_pass (&job, threads);

  for (j = 0; j < np; j++) {
    /* the piece's sequence lines: local index r, r + 4, ... */
    long r = (1 - lines) & 3;
    pcs[j].line0 = lines;
    pcs[j].code0 = code;
    code += pcs[j].len[r] + (pcs[j].lines + 3 - r) / 4;
    lines += pcs[j].lines;
  }
  nrec = lines / 4;
  out[1] = nrec;
  if (nrec > rec_cap) {
    free (pcs);
    return -1;
  }
  job.last_line = 4 * nrec - 1;
  job.pass = 2;
  run_pass (&job, threads);

  for (j = 0; j < np; j++) {
    out[0] += pcs[j].codes;
    out[2] += pcs[j].bases;
    out[3] += pcs[j].ncnt;
    if (pcs[j].consumed >= 0) consumed = pcs[j].consumed;
  }
  free (pcs);
  return consumed;
}
