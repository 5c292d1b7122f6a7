"""Host syncs per engine call in CUDA sync debug mode, the readback of the
numbers the user reads included."""


def read(run):
    return run.syncs_per_call
