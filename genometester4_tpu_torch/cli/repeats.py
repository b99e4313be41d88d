"""Over-represented-repeat region tooling
(reference: scripts/repeats/*.pl).
The port's copy of ``genometester4_tpu/cli/repeats.py``.

Five stages, mirroring the Perl pipeline that post-processes glistquery
output:

  find_regions      over-representation moving-average region finder
  collate_repeats   group (semi)identical regions via a BLAST table
  filter_collated   keep groups with a minimum member count
  unique            drop regions BLAST-identical to an earlier one
  filter_final      keep regions matching only the target chromosome

Each is exposed as ``python -m genometester4_tpu_torch.cli.repeats <stage>
ARGS...`` with the Perl scripts' positional arguments and byte-identical
output (including find_regions' stderr progress lines).
"""

from __future__ import annotations

import sys


def find_regions(argv) -> int:
    """scripts/repeats/find_regions.pl OVERREP FASTA MINLEN MINMOVAVG
    [MAXLEN]."""
    overrep_file, fasta_file = argv[0], argv[1]
    min_len = int(argv[2])
    min_movavg = float(argv[3])
    max_len = int(argv[4]) if len(argv) > 4 and argv[4] else 10000
    wordlen = 16

    sys.stderr.write("Loading oligo file (%s)\n" % overrep_file)
    overrep = {}
    with open(overrep_file) as f:
        for line in f:
            t = line.rstrip("\n").replace("\r", "").split("\t")
            if len(t) >= 2:
                overrep[t[0]] = float(t[1])
    sys.stderr.write("Done\n")

    sys.stderr.write("Loading FastA file (%s)\n" % fasta_file)
    with open(fasta_file) as f:
        f.readline()  # the Perl script skips only the FIRST line
        seq = "".join(ln.rstrip("\n") for ln in f)
    sys.stderr.write("Done\n")

    idx = 1
    nwords = len(seq) - wordlen
    sys.stderr.write("Sequence contains %d words\n" % nwords)
    start = -1
    end = -1
    ssum = 0.0
    for i in range(nwords):
        word = seq[i:i + wordlen]
        count = overrep.get(word, 0.0)
        if count >= min_movavg:
            ssum += count
            if start < 0:
                start = i
                end = i + 32
                sys.stderr.write("Starting region at %d" % i)
            else:
                end = i + 32
        else:
            if start >= 0:
                length = i + 1 - start
                movavg = ssum / length
                if movavg < min_movavg:
                    length = end - start
                    sys.stderr.write(" ending at %d length %d\n"
                                     % (i, length))
                    movavg = ssum / (length - 31)
                    if min_len <= length <= max_len:
                        reg = seq[start:start + length]
                        sys.stdout.write(
                            ">Repeat_%d %d-%d length %d avg %.2f\n%s\n"
                            % (idx, i, i + length, length, movavg, reg))
                        idx += 1
                    ssum = 0.0
                    start = -1
            else:
                ssum = 0.0
    return 0


def _read_two_line_fasta(path, max_seq_len=None):
    ids, seqs, names = [], [], {}
    with open(path) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                break
            hdr = hdr.rstrip("\n").replace("\r", "")
            seq = f.readline().rstrip("\n").replace("\r", "")
            name = hdr[1:]
            rid = name.split()[0] if name.split() else ""
            if max_seq_len is not None and len(seq) > max_seq_len:
                continue
            ids.append(rid)
            seqs.append(seq)
            names[rid] = name
    return ids, seqs, names


def collate_repeats(argv) -> int:
    """scripts/repeats/collate_repeats.pl BLASTFILE FASTAFILE."""
    blast_file, fasta_file = argv[0], argv[1]
    sys.stderr.write("Loading BLAST file (%s)\n" % blast_file)
    with open(blast_file) as f:
        lines = [ln.rstrip("\n").replace("\r", "") for ln in f]
    sys.stderr.write("Done\n")

    ids = []
    names = {}
    seqs = {}
    sys.stderr.write("Loading FastA file (%s)\n" % fasta_file)
    with open(fasta_file) as f:
        while True:
            hdr = f.readline()
            if not hdr:
                break
            name = hdr.rstrip("\n").replace("\r", "")[1:]
            seq = f.readline().rstrip("\n").replace("\r", "")
            rid = name.split()[0] if name.split() else ""
            sys.stderr.write("Adding %s\n" % rid)
            ids.append(rid)
            names[rid] = name
            seqs[rid] = seq
    sys.stderr.write("Done\n")
    ids.sort()

    group_of = {}
    rows = [ln.split("\t") for ln in lines]
    for dbid in ids:
        for t in rows:
            if t[0] != dbid or len(t) < 6:
                continue
            dblen, qid, qlen = float(t[1]), t[2], float(t[3])
            ident, alen = float(t[4]), float(t[5])
            if qid not in names:
                continue
            if (ident > 90 and abs(dblen / qlen - 1) < 0.05
                    and abs(dblen / alen - 1) < 0.05):
                if group_of.get(qid, "") == "":
                    if group_of.get(dbid, "") == "":
                        group_of[dbid] = dbid
                    if qid != dbid:
                        group_of[qid] = dbid
    for dbid in ids:
        if group_of.get(dbid, "") == dbid:
            sys.stdout.write("\nGroup %s\n\n" % dbid)
            sys.stdout.write(">%s\n%s\n\n" % (names[dbid], seqs[dbid]))
            for t in rows:
                if t[0] != dbid or len(t) < 6:
                    continue
                qid = t[2]
                if qid not in names:
                    continue
                if group_of.get(qid, "") != dbid:
                    sys.stdout.write(">%s\n%s\n" % (names[qid], seqs[qid]))
    return 0


def filter_collated(argv) -> int:
    """scripts/repeats/_filter_collated.pl GROUP_FILE MIN_NUM_MATCHES."""
    group_file, min_num = argv[0], int(argv[1])
    gidx = 0
    block = []
    num_members = 0
    with open(group_file) as f:
        for line in f:
            if line[:5] == "Group":
                if gidx > 0 and num_members > min_num:
                    sys.stdout.write("".join(block))
                num_members = 0
                block = []
                gidx += 1
            elif line[:1] == ">":
                num_members += 1
            block.append(line)
    if gidx > 0 and num_members > min_num:
        sys.stdout.write("".join(block))
    return 0


def unique(argv) -> int:
    """scripts/repeats/_unique.pl FASTAFILE BLASTFILE."""
    fasta_file, blast_file = argv[0], argv[1]
    ids, seqs, _ = _read_two_line_fasta(fasta_file, max_seq_len=2000)
    incl = {i: 1 for i in ids}
    with open(blast_file) as f:
        for line in f:
            t = line.rstrip("\n").replace("\r", "").split("\t")
            if len(t) < 6:
                continue
            id0, len0, id1, len1 = t[0], float(t[1]), t[2], float(t[3])
            ident, alen = float(t[4]), float(t[5])
            if id0 == id1 or id0 > id1:
                continue
            if not incl.get(id0, 0) or not incl.get(id1, 0):
                continue
            if ident < 90:
                continue
            if abs((alen - len0) / alen) > 0.1:
                continue
            if abs((alen - len1) / alen) > 0.1:
                continue
            incl[id1] = 0
    for rid, seq in zip(ids, seqs):
        if incl.get(rid, 0):
            sys.stdout.write(">%s\n%s\n" % (rid, seq))
    return 0


def filter_final(argv) -> int:
    """scripts/repeats/_filter_final.pl FASTAFILE BLASTFILE TARGET."""
    fasta_file, blast_file, tgt = argv[0], argv[1], argv[2]
    ids, seqs, _ = _read_two_line_fasta(fasta_file)
    tcount = {}
    ocount = {}
    with open(blast_file) as f:
        for line in f:
            t = line.rstrip("\n").replace("\r", "").split("\t")
            # perl counts EVERY line: a missing second column numifies
            # to "" ne TARGET and lands in ocount (under the undef/""
            # key for empty lines) — _filter_final.pl:42-47
            qid = t[0] if t else ""
            dbid = t[1] if len(t) > 1 else ""
            if dbid == tgt:
                tcount[qid] = tcount.get(qid, 0) + 1
            else:
                ocount[qid] = ocount.get(qid, 0) + 1
    for rid, seq in zip(ids, seqs):
        if tcount.get(rid, 0) > 0 and ocount.get(rid, 0) == 0:
            sys.stdout.write(">%s %s:%s\n%s\n"
                             % (rid, tgt, tcount[rid], seq))
    return 0


STAGES = {
    "find_regions": find_regions,
    "collate_repeats": collate_repeats,
    "filter_collated": filter_collated,
    "unique": unique,
    "filter_final": filter_final,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in STAGES:
        sys.stderr.write("Usage: repeats {%s} ARGS...\n"
                         % "|".join(STAGES))
        return 1
    return STAGES[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
