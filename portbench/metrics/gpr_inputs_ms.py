"""Host milliseconds a call spends staging the GP's inputs: the port's
``te.gpr.inputs`` span (every state's derivatives, its index-table
bootstrap and covariance, and the block-diagonal noise; it reads each
state's derivatives back, so it spans their device time too), per call of
the traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.span_ms({"te.gpr.inputs"}))
