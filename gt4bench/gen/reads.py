"""Short reads from a source genome, and their FASTQ lane.

A vectorised copy of ``chip_smoke.write_gmer_reads``: fixed-length reads
at uniform positions, a share of their bases substituted, a share of them
reverse-complemented. The lane is sized by bytes, so every seed gives the
same number of reads.
"""

from __future__ import annotations

import numpy as np

from gt4bench.gen.genome import _COMP, ALPHABET


def record_bytes(n_reads: int, read_len: int) -> int:
    """Bytes of one FASTQ record: ``@r<digits>``, the bases, ``+``, the
    qualities."""
    return 2 + len(str(max(n_reads - 1, 0))) + 1 + read_len + 3 + read_len + 1


def reads_for_lane(lane_bytes: int, read_len: int) -> int:
    """The most reads whose FASTQ fits in ``lane_bytes``."""
    n = lane_bytes // record_bytes(1, read_len)
    while n and n * record_bytes(n, read_len) > lane_bytes:
        n -= 1
    return n


def draw_reads(rng: np.random.Generator, bases: np.ndarray, n: int,
               p: dict) -> np.ndarray:
    """ASCII reads uint8[n, read_len]: ``p``'s ``read_len``,
    ``substitution`` (share of bases changed to another base) and
    ``rc_share`` (share reverse-complemented)."""
    L = int(p["read_len"])
    lut = np.zeros(256, np.uint8)
    lut[ALPHABET] = np.arange(4, dtype=np.uint8)
    seq = bases[rng.integers(0, len(bases) - L + 1, n)[:, None]
                + np.arange(L)]
    flat = seq.reshape(-1)
    at = rng.integers(0, flat.size, rng.binomial(flat.size,
                                                 float(p["substitution"])))
    flat[at] = ALPHABET[(lut[flat[at]] + rng.integers(1, 4, len(at))) % 4]
    flip = rng.random(n) < float(p["rc_share"])
    seq[flip] = _COMP[seq[flip]][:, ::-1]
    return seq


def fastq_bytes(seq: np.ndarray) -> np.ndarray:
    """The FASTQ lane of reads ``seq`` (uint8[n, L]) as one uint8 array;
    names ``r0``.. zero-padded to one width, qualities ``I``."""
    n, L = seq.shape
    width = len(str(max(n - 1, 0)))
    i = np.arange(n)
    digits = np.stack([48 + (i // 10 ** (width - 1 - j)) % 10
                       for j in range(width)], axis=1).astype(np.uint8)

    def col(text: bytes):
        return np.broadcast_to(np.frombuffer(text, np.uint8), (n, len(text)))

    return np.concatenate([col(b"@r"), digits, col(b"\n"), seq,
                           col(b"\n+\n"), col(b"I" * L), col(b"\n")],
                          axis=1).reshape(-1)
