"""Stream ms per training step in the MoE layers' own backward (the
program's ``moe.backward`` spans, from the gradient reaching a layer's
output to its leaving the layer's input; the recompute runs before)."""

from cardbench import program_spans


def read(r):
    return program_spans.ms_per_unit(r, "train.step", ("moe.backward",))
