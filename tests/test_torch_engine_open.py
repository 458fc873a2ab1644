"""The port's engine (repro_torch.ssdsim.engine) against the JAX package's
on the CPU, end to end (``engine.run`` + ``summarize`` on ``tiny_config``),
for open-loop arrivals under the legacy and lattice timing models (the
lattice run at ``obs_level="full"``), a faults-armed run (program, erase
and read faults, a retry budget, parity rebuild, a bounded spare pool,
the lifespan GC objective) and non-default ``RunKnobs`` (r1, an R2
override, initial P/E, an arrival scale, the GC objective code). The
closed-loop cases are in ``test_torch_engine.py``; each JAX run is shared
by the tests of its case (``torch_ssd_parity.run_engine_case``).

Tolerance (the comparison rule): integer ``SSDState`` leaves, integer
``ChunkMetrics`` fields and count-valued summary entries exact; float
leaves and summary values rtol 1e-5; latency histograms equal totals with
no count moved by more than one bin. One named exception: under
``chan_model="lattice"`` open loop, the per-(mode, bin) component sums
``obs_lat_comp`` (and the summary's ``lat_attrib_us`` built from them) are
held to rtol 1e-3 with an absolute slack of 0.1 µs per read in the cell:
each read's channel-wait component is the difference of two departure
clocks, which the two frameworks' prefix sums (the Lindley ``cumsum``)
round differently, so each lane may differ by about one float32 ulp of a
clock of hundreds of milliseconds (ROADMAP queue 3).
"""

import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch  # noqa: F401
import torch_ssd_parity as parity

CASES = ["open_legacy", "open_lattice", "faults", "knobs"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return parity.run_engine_case(request.param)


def test_state_matches_reference(case):
    parity.check_engine_state(case)


def test_summary_matches_reference(case):
    parity.check_engine_summary(case)


def test_chunk_metrics_match_reference(case):
    parity.check_engine_metrics(case)


def test_case_exercises_its_path(case):
    parity.check_engine_reaches(case)
