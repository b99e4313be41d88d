"""generate_vcf — FastGT genotype calls to VCF
(reference: scripts/generate_vcf.pl).
The port's copy of ``genometester4_tpu/cli/generate_vcf.py``.

Input: gmer_caller output whose marker IDs look like
``CHR:POS:ID:REF/ALT``. Output columns mirror the Perl script, including
its ``*`` placeholders and trailing raw-genotype column.
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        sys.stderr.write("Usage: generate_vcf CALLS_FILE\n")
        return 1
    calls = argv[0]
    out = sys.stdout
    sex = 0

    t = time.localtime()
    out.write("##fileformat=VCFv4.1\n")
    out.write("##fileDate=%4d%02d%02d\n" % (t.tm_year, t.tm_mon, t.tm_mday))
    out.write("##source=%s\n" % calls)
    out.write("##reference=HumanNCBI37_UCSC\n")
    out.write("##phasing=none\n")
    out.write('##FILTER=<ID=q20,Description="Quality below 20">\n')
    out.write('##FORMAT=<ID=GT,Number=1,Type=String,'
              'Description="Genotype">\n')
    out.write('##FORMAT=<ID=GQ,Number=1,Type=Integer,'
              'Description="Genotype Quality">\n')
    out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
              "\t****\n")

    with open(calls) as f:
        for line in f:
            line = line.rstrip("\n")
            if line[:4] == "#Sex":
                if line[5:6] == "M":
                    sex = 1
            if line[:1] == "#":
                continue
            t_ = line.split("\t")
            gt = t_[1]
            tt = t_[0].split(":")
            chrom, pos, id_ = tt[0], tt[1], tt[2]
            ra = tt[3].split("/")
            ref, alt = ra[0], ra[1]
            rc, ac = t_[3], t_[4]
            a0 = a1 = 0
            if sex == 0 or (chrom != "Y" and chrom != "X"):
                if gt == "AB":
                    a1 = 1
                elif gt == "BB":
                    a0 = a1 = 1
            else:
                if gt == "B":
                    a0 = a1 = 1
            out.write("%s\t%s\t%s\t%s\t%s" % (chrom, pos, id_, ref, alt))
            out.write("\t*\t*\t*\tGT:GQ")
            out.write("\t%s/%s:%s" % (a0, a1, int(rc) + int(ac)))
            out.write("\t%s\n" % gt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
