"""Host microseconds an ops call spends taking its host buffer and filling
it with the call's planes (the program's spans ``ops.alloc`` + ``ops.fill``
over its ``ops.call`` spans), in the half without the profiler."""
from perfbench import program

SPANS = program.SPANS
program.arm()


def read(run):
    program.report(run)
    return program.per(run, ("ops.alloc", "ops.fill"), "ops.call", 1e6)
