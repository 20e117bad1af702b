"""Process start to the first timed request, s."""


def read(run):
    return run.setup_s
