"""Flash attention's backward as a share of its roofline: the bound of
each call at the step's shape over the device time of its kernels (delta,
dK and dV, dQ, and the f32 route's preparations)."""

from cardbench import kernels, roofline


def read(r):
    if r.runner != "train":
        return None
    calls, secs = kernels.calls_and_seconds(r.profile.kernels, kernels.FLASH_BWD,
                                            kernels.FLASH_BWD_AUX)
    if not calls or not secs:
        return None
    c, t = r.config, r.traffic
    dt = c["port"]["param_dtype"]
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    ops, byt = roofline.flash_bwd(t["batch"], t["seq"], t["seq"], h, hk, d, d, dt)
    return 100.0 * calls * roofline.bound_s(ops, byt, dt) / secs
