"""Host ms per prefill request in the program's ``prefill`` span: taking
the prompt to returning the next token's tensor and the cache, on the
host's clock (the benchmark's read of the token is outside)."""

from cardbench import program_spans


def read(r):
    return program_spans.ms_per_unit(r, "prefill", ("prefill",), clock="host_s")
