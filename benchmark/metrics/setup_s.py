"""Seconds from the process's start to the first timed solve: imports, the
CUDA context, the kernel loaded (or built), the inputs made, the warm-up."""


def read(run):
    return run.setup_s
