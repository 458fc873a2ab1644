"""The benchmark's cells cut to sizes that run on the CPU in seconds, for
the tests: two layers of narrow width, the program in float32."""

from __future__ import annotations

import copy

from cardbench import harness

SMALL_CONFIG = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
                "num_key_value_heads": 2, "intermediate_size": 48, "vocab_size": 500}
SMALL_MOE = {"num_local_experts": 8, "num_experts_per_tok": 2, "intermediate_size": 32}
SMALL_TRAFFIC = {
    "train": {"batch": 2, "seq": 32, "steps": 8, "documents": {"median": 8, "sigma": 1.0,
                                                               "min": 2, "max": 64},
              "trace": {"steps": 2}},
    "prefill": {"prompt": {"median": 24, "sigma": 0.5, "min": 8, "max": 64, "strata": 4},
                "check": {"requests": 2, "positions": 4}, "trace": {"cycles": 1}},
}


def small(name: str, dtype: str = "float32") -> harness.Cell:
    cell = harness.cell(name)
    c = copy.deepcopy(cell.config)
    c.update(SMALL_CONFIG)
    if c.get("num_local_experts"):
        c.update(SMALL_MOE)
    if "attention_multiplier" in c:
        c["attention_multiplier"] = (c["hidden_size"] // c["num_attention_heads"]) ** -0.5
    c["port"] = dict(c["port"], param_dtype=dtype, router_dtype="float32")
    t = copy.deepcopy(cell.traffic)
    t.update(copy.deepcopy(SMALL_TRAFFIC[t["runner"]]))
    cell.config, cell.traffic = c, t
    return cell
