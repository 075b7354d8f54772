"""Host milliseconds a call spends fitting the GP: the port's ``te.gpr.fit``
span (``train_GPR``: scipy's L-BFGS-B on the host, each evaluation of the
objective and its gradient read back from the card), per call of the
traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.span_ms({"te.gpr.fit"}))
