"""Host milliseconds a call spends pooling moment states: the port's
``te.merge`` spans (``DataCentralMoments.merge``, the mean and the
replicate states of a stream), per call of the traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.span_ms({"te.merge"}))
