"""Stream ms per training step in the program's ``train.optimizer`` span:
AdamW's update in place (``training/optim.py::update``), the clipping norm
and the per-leaf passes."""

from cardbench import program_spans


def read(r):
    return program_spans.ms_per_unit(r, "train.step", ("train.optimizer",))
