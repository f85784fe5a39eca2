"""The port's own spans and counters over the traced window
(`utils/profiling.py`): the trainer records each epoch that runs under a
caller's profiler, so the harness's traced window is recorded, and the
program keeps it as `profiling.last_recording()`.  `summary` returns its
means a step (`Recording.summary()`), or None in an untraced run, from a
program without the recorder, and where the last recording is not this
window's: another count of steps, or opened after the first traced kernel
or closed before it."""


def summary(run):
    if not run.kernels or not run.steps:
        return None
    try:
        from multimodalaggressionrecognition_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_recording", None)
    rec = last() if last is not None else None
    if rec is None or rec.steps != run.steps:
        return None
    if not rec.opened_ns <= run.kernels[0][1] <= rec.closed_ns:
        return None
    return rec.summary()


def host_ms(run, name):
    """Span `name`'s host ms a step (None where it never opened)."""
    s = summary(run)
    return None if s is None else s["host_ms"].get(name)


def device_ms(run, *names):
    """The device phases' (and backward segments') card ms a step, summed;
    None where the first never ran."""
    s = summary(run)
    if s is None or names[0] not in s["device_ms"]:
        return None
    return sum(s["device_ms"].get(n, 0.0) for n in names)
