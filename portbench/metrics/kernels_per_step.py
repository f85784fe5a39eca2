"""All kernels the traced window ran (copies and fills left out) over
its steps."""


def read(run):
    if run.kernels is None or not run.steps:
        return None
    return len(run.kernels) / run.steps
