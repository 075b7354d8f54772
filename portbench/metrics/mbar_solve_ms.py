"""Host milliseconds a call spends in the MBAR solve: the port's
``te.mbar.solve`` span (``u_kn`` and ``models.mbar.mbar_solve``, whose loop
waits on the card every iteration, so the span covers the solve's device
time too), per call of the traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.span_ms({"te.mbar.solve"}))
