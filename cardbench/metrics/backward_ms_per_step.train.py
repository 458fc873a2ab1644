"""Stream ms per training step in the program's ``train.backward`` span:
``torch.autograd.grad``, remat's recompute of every layer included."""

from cardbench import program_spans


def read(r):
    return program_spans.ms_per_unit(r, "train.step", ("train.backward",))
