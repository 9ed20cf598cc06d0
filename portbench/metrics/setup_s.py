"""Process start to the first timed block: imports, CUDA start, the kernels'
build when none is cached, the seeded inputs, the pipe and its warm-up."""


def read(run):
    return run.setup_s
