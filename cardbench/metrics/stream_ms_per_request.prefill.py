"""Stream ms per prefill request in the program's ``prefill`` span: from
the stream reaching the span's opening event to its closing one, idle
stretches of the stream included."""

from cardbench import program_spans


def read(r):
    return program_spans.ms_per_unit(r, "prefill", ("prefill",))
