"""Points a call makes the host wait on the card: the port's ``host_syncs``
counter, its delta per call of the traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.counter("host_syncs"))
