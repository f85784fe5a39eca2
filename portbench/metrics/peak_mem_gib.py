"""`torch.cuda.max_memory_allocated()` over the window, reset when it
opens: weights, optimizer state and prefetched batches included."""


def read(run):
    return run.peak_mem_bytes / 2**30 if run.peak_mem_bytes else None
