"""The training step's model operations (6 per parameter a token passes
through, attention's pairs; no recompute) over the traced window's time,
as a share of the card's bf16 peak."""

from cardbench import roofline


def read(r):
    if r.runner != "train" or not r.window.units:
        return None
    t = r.traffic
    ops = roofline.train_step_flops(r.config, t["batch"], t["seq"]) * r.window.units
    peak = roofline.PEAK_FLOP_PER_S[r.config["port"]["param_dtype"]]
    return 100.0 * ops / r.window.seconds / peak
