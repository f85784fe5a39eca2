"""The caching allocator's calls to cudaMalloc and cudaFree over the
recorded window (`num_device_alloc` + `num_device_free`, read when the
recording opens and closes), a step."""

from ._spans import summary


def read(run):
    s = summary(run)
    if s is None or "num_device_alloc" not in s["allocator"]:
        return None
    a = s["allocator"]
    return (a["num_device_alloc"] + a["num_device_free"]) / s["steps"]
