"""Stream ms per training step in the MoE layers' routing, dispatch and
combine (the program's ``moe.route``, ``moe.dispatch`` and
``moe.combine`` spans, in the forward and in remat's recompute): the MoE
layer's work other than the experts' products and its backward."""

from cardbench import program_spans


def read(r):
    return program_spans.ms_per_unit(r, "train.step",
                                     ("moe.route", "moe.dispatch", "moe.combine"))
