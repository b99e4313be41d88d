"""FastGT SNV k-mer database (GmerDB): the in-memory tables (the port's copy
of the ``GmerDB`` class of ``genometester4_tpu/formats/gmerdb.py``).

The reference maps canonical k-mer -> 32-bit code with a pointer trie
(src/database.c:94-260, src/database.h:13-46); the code packs
``dir | (node+1) << kmer_bits | kmer`` (src/database.c:217-218). The port
keeps a binary database's serialized trie as it is in the file and walks
it per query, like the reference's mmap'd trie
(``formats.gmerdb_binary.trie_lookup_one``). Adding the same canonical
k-mer twice SUMS the stored codes (u32 wrap), because the reference trie
treats the code as a count (src/trie.c:266-282). The text parser and the
JAX package's sorted-array lookup table are not ported: the port's
gassembler reads binary databases lazily.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GmerDB:
    """A FastGT database: per-node names and k-mer slots, the serialized
    trie (canonical k-mer -> code) and the KATK read index."""

    wordsize: int
    node_bits: int
    kmer_bits: int
    count_bits: int
    names: list  # list[bytes]
    node_kmers_start: np.ndarray  # u64[n_nodes] offset into flat kmer table
    node_nkmers: np.ndarray  # u32[n_nodes]
    trie_blob: np.ndarray    # the serialized trie (src/trie.c:177-203)
    # read index (KATK), populated by gmer_counter --compile_index
    index: "object | None" = None

    @property
    def n_nodes(self) -> int:
        return len(self.names)

    def lookup_code(self, word: int) -> int:
        """Point lookup of one canonical word -> stored code (0 if
        absent), walking the serialized trie like the reference's
        trie_lookup: only the path's pages are touched."""
        from genometester4_tpu_torch.formats.gmerdb_binary import \
            trie_lookup_one
        return trie_lookup_one(self.trie_blob, word)
