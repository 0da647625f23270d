"""Set-up: from the harness's first line (the interpreter's start,
before torch is imported) to the window's first timed operation. It
holds the imports, the CUDA context, the kernels' build on a
checkout's first run, the fleet's state, and the warm-up."""


def read(run):
    return run.setup_s
