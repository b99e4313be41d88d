"""genometester4_tpu_torch — the PyTorch/CUDA port of genometester4_tpu.

The JAX package ``genometester4_tpu`` is the reference; this package
reimplements its device layer for one NVIDIA Hopper GPU (sm_90a) and is
held to the JAX package bit for bit by the differential tests in
``tests/test_torch_*.py``. It imports ``torch`` and never ``jax``.

The port imports nothing of the JAX package either. The host layers it
runs (FASTA slab parsing, the file formats, gassembler's pipeline and CLI,
the host C library's loader) are its own copies, in the JAX package's
layout, so a reader finds each counterpart by name; the CPU tests hold the
copies to the JAX package's output bytes.

Device representation: a k-mer is one int64 *key*, the 2k-bit word with
bit 63 flipped, so signed int64 order is unsigned word order. For k <= 31
an invalid window additionally carries a flag at bit 2k and sorts after
every valid key (``ops.encode``).

Sub-packages
------------
utils      device resolution, the host C library (``native``), mmap
           failure chrome, numpy allocation setting
ops        encode helpers, k-mer extraction, sort + run counting, SW fills
           and the merge of sorted runs, each hand-written CUDA kernel
           beside its plain PyTorch version
csrc       the CUDA C++ kernel sources, built with nvcc at first use
formats    .list reader/writer; GMDB, read index readers
io         the FASTA/FASTQ slab parser
parallel   glistmaker's mesh counting route (``sharding``)
pipelines  glistmaker's device counting route (``make_list``) and
           gassembler (``gassemble``), its SW fills on the device
cli        gassembler's command line
tools      a seeded KATK gassembler workload
"""

__version__ = "0.1.0"
