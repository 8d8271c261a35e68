"""Host microseconds an ops call waits in its ``.cpu()`` for the device's
result (the program's span ``ops.wait`` over its ``ops.call`` spans), in
the half without the profiler."""
from perfbench import program

SPANS = program.SPANS
program.arm()


def read(run):
    program.report(run)
    return program.per(run, ("ops.wait",), "ops.call", 1e6)
