"""setup_s: process start to the first timed request: data generation,
upload, and one warm run of each of the cell's texts (plan cache filled,
kernels built and loaded, graphs captured where execution is compiled)."""


def read(run):
    return run.setup["setup_s"]
