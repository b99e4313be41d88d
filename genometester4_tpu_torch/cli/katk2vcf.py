"""katk2vcf — KATK gassembler calls to VCF
(reference: scripts/katk2vcf.pl).
The port's copy of ``genometester4_tpu/cli/katk2vcf.py``.

Behavior-compatible translation: indel runs are merged into single VCF
records, insertions/deletions are left-shifted against the reference by
the script's 50 bp window scan, NC positions are tracked. The chromosome
FASTA directory (hard-coded in the Perl script) is the --chr_dir
argument here; chromosome files are ``<chr>.fa``.

Usage: katk2vcf --chr_dir DIR CALLS_FILE
"""

from __future__ import annotations

import os
import sys

CHRS = ["MT", "X", "Y"] + [str(i) for i in range(1, 23)]


def perl_num(s):
    """Perl scalar numification of a position token: the leading
    decimal-integer prefix, else 0 (header "POS", comments, and
    short lines all numify to 0 — scripts/katk2vcf.pl:39 records
    $posit for EVERY line, so such lines participate in the
    pending-indel flush distance check). Also applied wherever the
    Perl script does arithmetic on a position string ($lahti[1]-1 at
    pl:47, $asukoht[1]-1 at pl:196, $tmp0[1]-1 at pl:107/138):
    degenerate tokens like "12x" numify to 12 instead of crashing."""
    i = 0
    if s[:1] in "+-":
        i = 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    return int(s[:j]) if j > i else 0


def _substr(s: str, off: int, ln: int | None = None) -> str:
    """Perl ``substr`` in rvalue string context: negative offset counts
    from the end; offset beyond either end yields "" (Perl returns
    undef with a warning, which concatenates as the empty string)."""
    n = len(s)
    if off < 0:
        off = n + off
        if off < 0:
            return ""
    if off > n:
        return ""
    if ln is None:
        return s[off:]
    if ln < 0:
        return s[off:n + ln]
    return s[off:off + ln]


def load_chr_seqs(chr_dir: str) -> dict:
    seqs = {}
    for c in CHRS:
        path = os.path.join(chr_dir, f"{c}.fa")
        if not os.path.exists(path):
            continue
        parts = []
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln or ln.startswith(">"):
                    continue
                parts.append(ln)
        seqs[c] = "".join(parts)
    return seqs


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    chr_dir = None
    calls_fn = None
    i = 0
    while i < len(argv):
        if argv[i] == "--chr_dir":
            i += 1
            chr_dir = argv[i]
        else:
            calls_fn = argv[i]
        i += 1
    if not chr_dir or not calls_fn:
        sys.stderr.write("Usage: katk2vcf --chr_dir DIR CALLS_FILE\n")
        return 1
    hg = load_chr_seqs(chr_dir)
    out = sys.stdout

    REF_COL, CALL_COL, TYPE_COL = 3, 5, 6
    callid = []
    call = {}
    tyyp = {}
    nc = {}
    pikk = 0
    het = 0
    taht = ""
    voti = ""
    mutat_1 = mutat_2 = ""
    prev_pos = None

    def flush_indel(cur_tokens):
        """End-of-run indel normalization (50 bp left-shift scan).

        Perl quirk reproduced deliberately (scripts/katk2vcf.pl:63-65,
        82-84): the rebuilt key takes its CHROMOSOME from the
        flush-triggering line's first column (``$voti = $tmp0[0]``)
        while the shift scan indexes the PENDING line's chromosome
        sequence — so a pending indel flushed at a chromosome switch
        is re-attributed to the new line's chromosome (and, for
        deletions, the r=0 identity match fires unconditionally, so
        the reattribution happens even with no shift). Found by
        fuzz_scripts.py; KATK call tables genuinely span chromosomes.
        """
        nonlocal voti, mutat_1, mutat_2, pikk, taht, het
        lahti = voti.split(":")
        p0 = perl_num(lahti[1]) - 1
        seq = hg.get(lahti[0], "")
        cur_chr = cur_tokens[0] if cur_tokens else ""
        if taht == "I":
            mut_pikk_2 = len(mutat_2)
            ref_i2 = true_i2 = ""
            if len(mutat_2) > 1:
                ref_i2 = _substr(seq, p0 - 50, 100)
                true_i2 = (_substr(seq, p0 - 50, 51) + mutat_2[1:]
                           + _substr(seq, p0 + 1, 49))
            for r in range(50):
                ajut = _substr(true_i2, 0, 50 - r) \
                    + _substr(true_i2, -50 - r)
                # the inner condition RE-CHECKS the length (pl:58), so
                # a clobbered single-char pending I never slides
                if ajut == ref_i2 and len(mutat_2) > 1:
                    ajut_pos = p0 - r
                    if het == 1:
                        mutat_1 = _substr(true_i2, 49 - r, 1)
                    mutat_2 = _substr(true_i2, 49 - r, mut_pikk_2)
                    if het == 0:
                        mutat_1 = mutat_2
                    voti = f"{cur_chr}:{ajut_pos}"
        if taht == "D":
            # per-assignment guards only (pl:71-76): with a pending
            # run whose mutat_1 was clobbered to one char by an
            # adjacent S line (no gap -> no flush -> the S branch
            # overwrites the shared $mutat_* state), both strings stay
            # "" and the match fires at EVERY r — the final r=49
            # rewrites the variant to (flush-line chrom, pos-50) with
            # bases read 50 left of the pending site. Deterministic;
            # byte-parity requires it (fuzz_scripts finding #2).
            ml = len(mutat_1)
            ref_d1 = ""
            if ml > 1:
                ref_d1 = _substr(seq, p0 - 50, 50) \
                    + _substr(seq, p0 + ml - 1, 50)
            # $ajut_1 is initialized ONCE before the loop (pl:71) and
            # each per-iteration assignment is guarded (pl:75-76): when
            # a match truncates mutat_1 to <=1 chars (substr clamped
            # near a chromosome end), Perl retains the previous
            # MATCHING $ajut_1 and re-fires the match at every later r
            ajut = ""
            for r in range(50):
                if len(mutat_1) > 1:
                    ajut = _substr(seq, p0 - 50, 50 - r) \
                        + _substr(seq, p0 + len(mutat_1) - 1 - r, 50 + r)
                if ajut == ref_d1:
                    ajut_pos = p0 - r
                    if het == 1:
                        mutat_2 = _substr(seq, p0 - r - 1, 1).lower()
                    mutat_1 = _substr(seq, p0 - r - 1,
                                      len(mutat_1)).lower()
                    if het == 0:
                        mutat_2 = mutat_1
                    voti = f"{cur_chr}:{ajut_pos}"
            mutat_1 = mutat_1[:1].upper() + mutat_1[1:]
            mutat_2 = mutat_2[:1].upper() + mutat_2[1:]
        callid.append(voti)
        call[voti] = f"{mutat_1}/{mutat_2}"
        tyyp[voti] = taht
        pikk = 0
        taht = ""
        het = 0

    with open(calls_fn) as f:
        for line in f:
            line = line.rstrip("\n")
            t = line.split("\t")
            pos = perl_num(t[1]) if len(t) > 1 else 0
            key0 = f"{t[0]}:{t[1] if len(t) > 1 else ''}"
            if len(t) > 5 and t[5] == "NC":
                nc[key0] = "NC"
                prev_pos = pos
                continue
            if pikk == 1 and prev_pos is not None and pos - prev_pos > 1:
                flush_indel(t)
            prev_pos = pos
            if len(t) <= TYPE_COL:
                continue
            c0, c1 = t[CALL_COL][:1], t[CALL_COL][1:2]
            if t[TYPE_COL] == "I":
                if pikk == 0:
                    voti = key0
                    # substr($hg38{...}, $tmp0[1]-1, 1) with numified
                    # pos (pl:107): pos 0 wraps to the LAST chromosome
                    # base via Perl's negative offset
                    base = _substr(hg.get(t[0], ""), pos - 1, 1)
                    mutat_1 = mutat_2 = base
                    if c0 != c1:
                        if c0 == "-":
                            mutat_2 += c1
                        if c1 == "-":
                            mutat_2 += c0
                        het = 1
                    else:
                        mutat_1 += c0
                        mutat_2 += c1
                    pikk = 1
                    taht = "I"
                else:
                    if c0 != c1:
                        if c0 == "-":
                            mutat_2 += c1
                        if c1 == "-":
                            mutat_2 += c0
                    else:
                        mutat_1 += c0
                        mutat_2 += c0
                continue
            if t[TYPE_COL] == "D":
                if pikk == 0:
                    voti = key0
                    base = _substr(hg.get(t[0], ""), pos - 1, 1)  # pl:138
                    mutat_1 = mutat_2 = base
                    if c0 != c1:
                        if c0 == "-":
                            mutat_2 += c1.lower()
                        if c1 == "-":
                            mutat_1 += c0.lower()
                        het = 1
                    else:
                        mutat_1 += c0.lower()
                        mutat_2 += c0.lower()
                    pikk = 1
                    taht = "D"
                else:
                    if c0 != c1:
                        if c0 == "-":
                            mutat_2 += c1.lower()
                        if c1 == "-":
                            mutat_1 += c0.lower()
                    else:
                        mutat_1 += c0.lower()
                        mutat_2 += c0.lower()
                continue
            if t[TYPE_COL] == "S":
                if c0 != c1:
                    mutat_1 = t[REF_COL]
                    if c1 == t[REF_COL]:
                        mutat_2 = c0
                    if c0 == t[REF_COL]:
                        mutat_2 = c1
                else:
                    mutat_1, mutat_2 = c0, c1
                callid.append(key0)
                call[key0] = f"{mutat_1}/{mutat_2}"
                tyyp[key0] = "S"
                continue

    out.write("##fileformat=VCFv4.0\n")
    out.write("##fileDate=\n")
    out.write("##source=KATKtools\n")
    out.write("##reference=GRCh38\n")
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\n")
    # the Perl loop stops BEFORE the last accumulated call (l < jrk where
    # jrk is the last index) — reproduced
    for li in range(max(0, len(callid) - 1)):
        muutus = callid[li]
        asukoht = muutus.split(":")
        call[muutus] = call[muutus].upper()
        genot = call[muutus].split("/")
        seq = hg.get(asukoht[0], "")
        # $nuc = substr(..., $asukoht[1]-1, 1) (pl:196): numified
        # position, and position 0 wraps to the last chromosome base
        p = perl_num(asukoht[1])
        nuc = _substr(seq, p - 1, 1)
        if muutus in nc:
            call[muutus] = nc[muutus]
        if tyyp[muutus] in ("I", "S"):
            out.write("%s\t%s\t.\t%s\t%s\t.\tPASS\t%s\tGT\t"
                      % (asukoht[0], asukoht[1], nuc, genot[1],
                         tyyp[muutus]))
            if genot[0] == nuc:
                out.write("0")
            if genot[0] == genot[1]:
                out.write("1")
            out.write("/")
            out.write("1\n")
        elif tyyp[muutus] == "D":
            out.write("%s\t%s\t.\t%s\t%s\t.\tPASS\tD\tGT\t"
                      % (asukoht[0], asukoht[1], genot[0], nuc))
            out.write("0/")
            if genot[0] == genot[1]:
                out.write("0\n")
            else:
                out.write("1\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
