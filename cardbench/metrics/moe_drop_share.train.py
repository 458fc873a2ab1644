"""The share of the MoE layers' token-to-expert assignments that the
capacity drops, over the traced window's steps: 100 x (1 - kept /
assigned), from the program's counters ``moe.kept`` and ``moe.assigned``
(the forward's and remat's recompute's alike)."""

from cardbench import program_spans


def read(r):
    sums = program_spans.counter_sums(r, "train.step", ("moe.kept", "moe.assigned"))
    if sums is None or not sums[1]:
        return None
    return 100.0 * (1.0 - sums[0] / sums[1])
