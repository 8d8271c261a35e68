"""Share of the device's idle time in the traced window that no program
span below an entry call names: each idle interval split by overlap among
the innermost program spans open on the host's thread, and the part under
``api.pack`` / ``dse.sweep`` themselves or under none taken over the whole.
The whole split and the clock check are printed (``[program]`` lines)."""
from perfbench import program

program.arm()


def read(run):
    program.report(run)
    return program.unnamed_share(program.idle_split(run))
