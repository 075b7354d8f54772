"""Iterations of the MBAR solver a call: the port's ``mbar_iters`` counter,
its delta per call of the traced slice."""

from portbench import program_log


def read(ctx):
    return program_log.per_call(ctx, program_log.counter("mbar_iters"))
