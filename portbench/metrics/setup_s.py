"""setup_s: host seconds from the start of the run to the start of the
window: imports, CUDA, the kernels' build where it is not cached, the
sequences, the index, the variant, the table, the pool and the warm-up."""


def read(run):
    return run["setup_s"]
