"""The window's peak device memory above what was allocated when it opened
(weights, gradients, Adam's state): activations, workspaces and prefetched
batches."""


def read(run):
    if not run.peak_mem_bytes:
        return None
    return (run.peak_mem_bytes - run.resident_bytes) / 2**30
