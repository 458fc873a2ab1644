"""Flash attention's forward in prefill as a share of its roofline: the
bounds of every launch of the traced window (one a layer a request, at the
request's prompt length) over the kernels' device time. Nothing is read
where the launches do not come one a layer a request."""

from cardbench import kernels, roofline


def read(r):
    if r.runner != "prefill":
        return None
    calls, secs = kernels.calls_and_seconds(r.profile.kernels, kernels.FLASH_FWD,
                                            kernels.FLASH_FWD_AUX)
    c = r.config
    layers = c["num_hidden_layers"]
    if not calls or not secs or calls != layers * len(r.window.lengths):
        return None
    dt = c["port"]["param_dtype"]
    h, hk = c["num_attention_heads"], c["num_key_value_heads"]
    d = c["hidden_size"] // h
    bound = sum(roofline.bound_s(*roofline.flash_fwd(1, n, n, h, hk, d, d, dt), dt)
                for n in r.window.lengths)
    return 100.0 * layers * bound / secs
