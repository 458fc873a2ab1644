"""Twin of tests/test_metrics_schema.py: the port's metrics-schema registry
(``repro_torch.ssdsim.metrics_schema``), held by the reference's
assertions on the CPU; the grep-style sweep walks ``src/repro_torch/``.
The full-instrument summary is held against the JAX package's.

``ssdsim.metrics_schema`` is the single source of truth for metric names,
units and descriptions: ``engine.summarize`` may only emit keys registered
there, and the sweep CSV unit map is the registry's scalar subset rather
than a hand-maintained copy. Also pins the geometry alias deprecations
(``lun_of_block`` / ``channel_of_lun``): warn once, delegate exactly, and no
production module may still call them.
"""

import dataclasses
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_twins import check_against_reference, run

from repro_torch.experiments import registry, sweep
from repro_torch.ssdsim import engine, geometry, metrics_schema, obs

SRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def _trace(cfg):
    return registry.build("mixed", cfg, 8 * cfg.chunk, seed=0, read_frac=0.5)


def _summary(cfg):
    s, _ = run(cfg, _trace(cfg))
    return engine.summarize(s, cfg)


class TestSchemaCoversSummarize:
    @pytest.mark.parametrize("level", obs.LEVELS)
    def test_summarize_keys_subset_of_schema(self, level):
        cfg = geometry.tiny_config(obs_level=level)
        if level == "full":
            cfg = dataclasses.replace(cfg, obs_event_capacity=256)
        m = _summary(cfg)
        unknown = set(m) - set(metrics_schema.SCHEMA)
        assert not unknown, f"summarize emits unregistered metrics: {unknown}"

    def test_faults_armed_keys_subset_of_schema(self):
        cfg = geometry.tiny_config(prog_fail_rate=0.02, erase_fail_rate=0.05,
                                   max_read_retries=4, fault_seed=1)
        m = _summary(cfg)
        assert set(m) <= set(metrics_schema.SCHEMA)

    def test_scalar_flags_match_reality(self):
        cfg = geometry.tiny_config(obs_level="full", obs_event_capacity=256)
        m = _summary(cfg)
        for k, v in m.items():
            if metrics_schema.SCHEMA[k].scalar:
                assert np.isscalar(v) or isinstance(v, (int, float)), (
                    f"{k} registered scalar but summarize emitted {type(v)}")
            else:
                assert not isinstance(v, (int, float)), (
                    f"{k} registered non-scalar but summarize emitted {type(v)}")

    def test_endurance_metrics_registered_with_units(self):
        u = metrics_schema.units()
        assert u["waf"] == "ratio"
        assert u["lifetime_years"] == "years"
        for k in ("user_pages", "reloc_pages", "waf", "pe_mean",
                  "pe_variance", "pe_max", "tbw_gib", "dwpd",
                  "lifetime_years"):
            assert k in u
            assert metrics_schema.describe(k).description

    def test_full_summary_equals_reference(self):
        cfg = geometry.tiny_config(obs_level="full", obs_event_capacity=256)
        tr = _trace(cfg)
        s, _ = run(cfg, tr)
        check_against_reference(cfg, tr, s)

    def test_every_metric_documented(self):
        for k, m in metrics_schema.SCHEMA.items():
            assert m.unit, f"{k} has no unit"
            assert m.description, f"{k} has no description"


class TestSweepUsesRegistry:
    def test_row_units_is_the_scalar_subset(self):
        ru = metrics_schema.row_units()
        assert ru == {k: m.unit for k, m in metrics_schema.SCHEMA.items()
                      if m.scalar}

    def test_sweep_row_units_come_from_registry(self):
        assert sweep._ROW_UNITS == metrics_schema.row_units()


class TestGeometryAliasDeprecation:
    def _reset(self):
        geometry._ALIAS_WARNED.clear()

    def test_lun_of_block_warns_once_and_delegates(self):
        cfg = geometry.tiny_config()
        self._reset()
        blocks = np.arange(8)
        with pytest.warns(DeprecationWarning, match="lun_of_block"):
            got = cfg.lun_of_block(blocks)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(cfg.die_of_block(blocks)))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            cfg.lun_of_block(blocks)
        assert not [r for r in rec if issubclass(r.category, DeprecationWarning)]

    def test_channel_of_lun_warns_once_and_delegates(self):
        cfg = geometry.tiny_config()
        self._reset()
        dies = np.arange(cfg.n_dies)
        with pytest.warns(DeprecationWarning, match="channel_of_lun"):
            got = cfg.channel_of_lun(dies)
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(cfg.channel_of_die(dies)))

    def test_no_production_callers_of_deprecated_aliases(self):
        # grep-style sweep over src/: only geometry.py (the definitions) may
        # mention the deprecated names
        pat = re.compile(r"\b(lun_of_block|channel_of_lun)\b")
        offenders = []
        for p in sorted(SRC.rglob("*.py")):
            if p.name == "geometry.py":
                continue
            for i, line in enumerate(p.read_text().splitlines(), 1):
                if pat.search(line):
                    offenders.append(f"{p.relative_to(SRC)}:{i}: {line.strip()}")
        assert not offenders, "\n".join(offenders)
