"""setup_s: process start until the measured window opens."""


def read(run, spec):
    return run.setup_s
