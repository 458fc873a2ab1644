"""The prefills' model operations (2 per parameter a token passes through,
the head at the last position, attention's pairs) over the traced window's
time, as a share of the card's bf16 peak."""

from cardbench import roofline


def read(r):
    if r.runner != "prefill" or not r.window.lengths:
        return None
    ops = sum(roofline.prefill_flops(r.config, n) for n in r.window.lengths)
    peak = roofline.PEAK_FLOP_PER_S[r.config["port"]["param_dtype"]]
    return 100.0 * ops / r.window.seconds / peak
