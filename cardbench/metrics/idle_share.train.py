"""The share of the traced window in which no device work ran (training)."""


def read(r):
    if r.runner != "train":
        return None
    lo, hi = r.profile.window
    if hi <= lo or not r.profile.kernels:
        return None
    return 100.0 * (1.0 - r.profile.busy_s() / (hi - lo))
