"""genometester4_tpu_torch — the PyTorch/CUDA port of genometester4_tpu.

The JAX package ``genometester4_tpu`` is the reference; this package
reimplements its device layer for one NVIDIA Hopper GPU (sm_90a) and is
held to the JAX package bit for bit by the differential tests in
``tests/test_torch_*.py``. It imports ``torch`` and never ``jax``.

Host layers that never touched JAX are reused from the JAX package, not
copied, so the byte-parity quirks they encode stay in one place:
``io.fasta`` (slab parsing), ``formats.list_format`` (.list I/O) and the
numpy helpers of ``ops.encode``.

Device representation: a k-mer is one int64 *key*, the 2k-bit word with
bit 63 flipped, so signed int64 order is unsigned word order. For k <= 31
an invalid window additionally carries a flag at bit 2k and sorts after
every valid key (``ops.encode``).

Sub-packages
------------
utils      device resolution
ops        encode helpers, k-mer extraction and sort + run counting, each
           hand-written CUDA kernel beside its plain PyTorch version
csrc       the CUDA C++ kernel sources, built with nvcc at first use
pipelines  glistmaker's device counting route (``make_list``)
"""

__version__ = "0.1.0"
