"""Host milliseconds a call waits on the card: the port's ``te.sync`` spans
(blocking copies of host data onto the card, reads back), per call of the
traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.span_ms({"te.sync"}))
