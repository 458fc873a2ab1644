"""Flash attention's forward in training (the entry that also writes the
log-sum-exp; remat's recompute included) as a share of its roofline: the
bound of each launch at the step's shape over the kernels' device time."""

from cardbench import kernels, roofline


def read(r):
    if r.runner != "train":
        return None
    calls, secs = kernels.calls_and_seconds(r.profile.kernels, kernels.FLASH_FWD,
                                            kernels.FLASH_FWD_AUX)
    if not calls or not secs:
        return None
    c, t = r.config, r.traffic
    dt = c["port"]["param_dtype"]
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    ops, byt = roofline.flash_fwd(t["batch"], t["seq"], t["seq"], h, hk, d, d, dt, lse=True)
    return 100.0 * calls * roofline.bound_s(ops, byt, dt) / secs
