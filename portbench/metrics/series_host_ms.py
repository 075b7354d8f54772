"""Host milliseconds a call spends in the float64 series engine: the port's
``te.coefs`` (float64 casts, coefficient recursions) and ``te.taylor``
(Taylor evaluation, the replicates' deviation) spans, per call of the
traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.span_ms({"te.coefs", "te.taylor"}))
