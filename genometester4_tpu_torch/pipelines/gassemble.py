"""gassembler's region alignment on the port's SW fill (port of the device
branches of ``genometester4_tpu/pipelines/gassemble.py``).

Only the SW fill runs on the device. Reading the index, gathering reads
(and the glibc ``rand()`` subsampling), traceback, filters, the gapped
multi-alignment, grouping and calling stay the JAX package's host code,
which this module reuses and does not copy:

* ``align_reads`` fills the matrices with kernel C (``ops.swalign_cuda``)
  and hands them to the JAX ``align_reads(..., sw_mats=...)``, the JAX
  device route's own split (``gassemble.py:679-688``);
* ``Assembler`` batches the SW fills of a window of upcoming regions into
  one kernel C launch, as the JAX ``Assembler.prefetch_device_sw`` does,
  and sends every region it did not batch through this module's
  ``align_reads``.
"""

from __future__ import annotations

import os

import numpy as np

from genometester4_tpu.pipelines import gassemble as _gas
from genometester4_tpu.pipelines.gassemble import (CHR_MT,
                                                   MAX_READS_PER_KMER,
                                                   MIN_READS, NONE)
from genometester4_tpu_torch.ops.swalign_cuda import (
    sw_matrices_batch_device, sw_matrices_batch_device_multi)
from genometester4_tpu_torch.utils.device import resolve_device

_jax_align_reads = _gas.align_reads


def device_sw_enabled() -> bool:
    """``GT4_TPU_DEVICE_SW`` decides when set (``"1"`` on, anything else
    off), as in the JAX package; the JAX CLI's forked workers set it to 0,
    and CUDA cannot run in a forked child. Otherwise on: the port has no
    slow accelerator link to route around."""
    v = os.environ.get("GT4_TPU_DEVICE_SW")
    return v is None or v == "1"


def pad_reads(reads: list) -> np.ndarray:
    """Read codes int8[B, longest read], padded with NONE."""
    m_cap = max(len(r.nucl) for r in reads)
    batch = np.full((len(reads), m_cap), NONE, np.int8)
    for i, r in enumerate(reads):
        batch[i, :len(r.nucl)] = r.nucl
    return batch


def align_reads(ref_codes: np.ndarray, reads: list, params: _gas.Params,
                sw_mats=None, device=None):
    """The JAX ``align_reads`` with the fill on ``device``.

    Without precomputed ``sw_mats``, the matrices come from kernel C (from
    ``sw_fill`` for ``device="cpu"``) unless the device route is off or
    ``-DDD`` asks for the JAX host fill (``params.debug > 2``).
    """
    if (sw_mats is None and reads and params.debug <= 2
            and device_sw_enabled()):
        sw_mats = sw_matrices_batch_device(ref_codes.astype(np.int8),
                                           pad_reads(reads), device=device)
    return _jax_align_reads(ref_codes, reads, params, sw_mats=sw_mats)


class Assembler(_gas.Assembler):
    """The JAX ``Assembler`` with its SW fills on ``device``."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)

    def prefetch_device_sw(self, regions, idx):
        """Gather the reads of a window of regions from ``idx`` on and fill
        all their SW matrices in one kernel C launch, as
        ``gassemble.py:928-995`` does: regions in order (so glibc ``rand()``
        is drawn as in the sequential run), oversized regions skipped, off
        under ``-D`` and ``--print_reads``, window bounded by
        ``GT4_TPU_SW_BATCH_LANES`` reads and ``GT4_TPU_SW_BATCH_REGIONS``
        regions.

        Unlike the JAX loop, regions already in ``_sw_cache`` are skipped.
        Called for an oversized region inside an earlier window, the JAX
        loop gathers the cached regions after it again: a second ``rand()``
        draw for any region of more than 200 reads, and a different
        subsample from then on.
        """
        p = self.p
        if p.debug > 0 or p.print_reads or not device_sw_enabled():
            return
        if id(regions[idx]) in self._sw_cache:
            return
        target = int(os.environ.get("GT4_TPU_SW_BATCH_LANES", "512"))
        max_regions = int(os.environ.get("GT4_TPU_SW_BATCH_REGIONS", "16"))
        window = []
        total = 0
        for j in range(idx, len(regions)):
            if len(window) >= max_regions:
                break
            region = regions[j]
            rlen = region.end - region.start
            if (rlen > p.max_reference_length
                    or id(region) in self._sw_cache):
                continue
            ref_codes = _gas._C2N[np.frombuffer(
                region.ref[:rlen].encode("latin1"),
                np.uint8)].astype(np.int8)
            max_rpk = 2000 if region.chr == CHR_MT else MAX_READS_PER_KMER
            infos = _gas.get_unique_reads(self.db, self.files, region.kmers,
                                          p, max_rpk)
            reads = _gas.get_read_sequences(infos, self.files, p)
            self._sw_cache[id(region)] = [reads, None]
            if len(reads) >= MIN_READS:
                window.append((id(region), ref_codes, reads))
                total += len(reads)
            if total >= target:
                break
        if not window:
            return
        mats = sw_matrices_batch_device_multi(
            [(ref_codes, pad_reads(reads)) for _, ref_codes, reads in window],
            device=self.device)
        for (rid, _, _), m in zip(window, mats):
            self._sw_cache[rid][1] = m

    def _align_phase(self, region):
        """The JAX align phase, with this module's ``align_reads`` bound to
        the JAX module's name for the call.

        ``_align_phase`` looks ``align_reads`` up in its module, so the swap
        reaches every region the prefetch did not fill (``-D``, the region
        after an oversized one, forked workers) without copying the phase's
        host logic. gassembler assembles regions on one thread (its workers
        are processes), and the name is restored when the call ends.
        """
        def bound(ref_codes, reads, params, sw_mats=None):
            return align_reads(ref_codes, reads, params, sw_mats=sw_mats,
                               device=self.device)

        saved = _gas.align_reads
        _gas.align_reads = bound
        try:
            return super()._align_phase(region)
        finally:
            _gas.align_reads = saved
