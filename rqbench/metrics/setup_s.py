"""setup_s: process start until the window opens."""


def read(run):
    return run.setup_s
