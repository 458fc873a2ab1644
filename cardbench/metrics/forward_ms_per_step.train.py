"""Stream ms per training step in the program's ``train.forward`` span:
the loss's forward, every layer and the head (stream time between the
span's CUDA events, over the traced window's steps)."""

from cardbench import program_spans


def read(r):
    return program_spans.ms_per_unit(r, "train.step", ("train.forward",))
