"""setup_s: process start to the window's start (imports, CUDA set-up,
kernel load or build, inputs, the program's state, the warm-up job)."""


def read(run):
    return run.setup_s
