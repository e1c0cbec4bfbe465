"""Seconds of the port's compile of the configuration's network, every
tenant (the classifier's training included), run fresh: the traced run
never reads the compile cache."""


def read(run):
    return run.compile_s
