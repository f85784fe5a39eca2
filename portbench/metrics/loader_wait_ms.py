"""The trainer's wait for its next batch (`train.next_batch`: each
`next()` on `device_prefetch`, the batch's copy queued), host ms a step."""

from ._spans import host_ms


def read(run):
    return host_ms(run, "train.next_batch")
