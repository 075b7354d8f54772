"""Evaluations of the GP's objective and gradient a call: the port's
``gpr_lml_evals`` counter, its delta per call of the traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.counter("gpr_lml_evals"))
