"""setup_s: seconds from the process's start to the first timed frame or
step (loading, making the inputs, building the program's tables, the
kernels' first build or load, warm-up)."""


def read(r):
    return r["setup_s"]
