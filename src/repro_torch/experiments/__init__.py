# Experiments subsystem (DESIGN.md §7): scenario library + block-trace
# replay + sweep orchestration + tail-latency reporting, between the
# simulator core (repro_torch.ssdsim) and whatever drives a grid. Importing
# the package registers the scenarios and the MSR replay by name.
from repro_torch.experiments import registry, scenarios, sweep, traces  # noqa: F401
