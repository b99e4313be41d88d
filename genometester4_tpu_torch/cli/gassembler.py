"""gassembler on the port: the JAX package's CLI with the port's Assembler.

    python -m genometester4_tpu_torch.cli.gassembler --dbi db.idx \
        --region_file regions.txt --num_threads 1 [flags]

Argv, stdout and stderr are those of ``genometester4_tpu.cli.gassembler``
(its ``main`` runs unchanged); only the ``Assembler`` it builds is the
port's, so the regions' SW fills run on the device (CUDA by default; no
CUDA raises when the first Assembler is built). As in the JAX package,
the device route runs under ``--num_threads 1``: more threads fork
workers, which align on the host.

Importing this module, and runs that never build an ``Assembler`` (``-h``,
bad flags), import no torch: the port's ``Assembler`` is imported when the
first one is built.
"""

from __future__ import annotations

import functools
import sys

from genometester4_tpu.cli import gassembler as _cli


def _port_assembler(*args, device=None, **kwargs):
    from genometester4_tpu_torch.pipelines.gassemble import Assembler
    return Assembler(*args, device=device, **kwargs)


def main(argv=None, device=None) -> int:
    """Run the JAX CLI's ``main(argv)`` with the port's ``Assembler`` on
    ``device`` bound to the CLI module's name for the call."""
    saved = _cli.Assembler
    _cli.Assembler = functools.partial(_port_assembler, device=device)
    try:
        return _cli.main(argv)
    finally:
        _cli.Assembler = saved


if __name__ == "__main__":
    sys.exit(main())
