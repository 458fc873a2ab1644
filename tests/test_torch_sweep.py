"""The port's sweep runner (``repro_torch.experiments.sweep.run_sweep``) on
one device: the single-device half of ``tests/test_sharded_sweep.py``,
``tests/test_faults.py``'s ``TestSweepResume`` and device clamp, and
``tests/test_obs.py``'s ``TestSweepIntegration``, run on the CPU
(``device="cpu"``). Where the reference holds its sharded executor to its
vmapped one, these hold ``devices=1`` and a clamped count to
``devices=None``: same runs, same order, every result exactly equal
(``assert_results_identical``). A count that resolves above one device
raises ``NotImplementedError``, and a sweep without ``device=`` needs CUDA.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import modes
from repro_torch.experiments import sweep
from repro_torch.ssdsim import geometry

TINY = geometry.tiny_config()
CPU = "cpu"
N_DEV = len(sweep.visible_devices(CPU))

_assert_identical = sweep.assert_results_identical


def _spec(**kw):
    d = dict(
        scenario="read_disturb_hammer",
        n_requests=2_048,
        policies=(geometry.BASELINE, geometry.RARO),
        initial_pe=(166, 833),
        seeds=(0,),
        base=TINY,
    )
    d.update(kw)
    return sweep.SweepSpec(**d)


@pytest.fixture(scope="module")
def plain():
    return sweep.run_sweep(_spec(), device=CPU)


class TestOneDevice:
    def test_one_device_matches_default(self, plain):
        _assert_identical(plain, sweep.run_sweep(_spec(), devices=1, device=CPU))

    def test_too_many_devices_clamps_with_warning(self, plain):
        # over-asking devices clamps to the visible count (with a warning)
        # instead of aborting the sweep — results are unchanged
        with pytest.warns(UserWarning, match="clamping"):
            res = sweep.run_sweep(_spec(), devices=N_DEV + 1, device=CPU)
        _assert_identical(res, plain)
        _assert_identical(res, sweep.run_sweep(_spec(), devices="all", device=CPU))

    def test_zero_devices_raises(self):
        with pytest.raises(ValueError, match="devices"):
            sweep.run_sweep(_spec(), devices=0, device=CPU)

    def test_more_than_one_device_is_refused(self):
        """Two devices resolved: the sweep refuses rather than running on
        fewer devices than it resolved, and names where a multi-card sweep
        waits."""
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sweep.run_sweep(_spec(), devices=("cpu", "cpu"), device=CPU)

    def test_resolve_devices_clamps_and_warns(self):
        with pytest.warns(UserWarning, match="clamping"):
            devs = sweep.resolve_devices(N_DEV + 99, device=CPU)
        assert len(devs) == N_DEV == 1

    def test_no_device_means_cuda(self):
        """Without ``device=`` the sweep runs on CUDA, and without a card it
        raises before building a trace instead of running on the CPU."""
        if torch.cuda.is_available():
            assert sweep.resolve_devices(None)[0].type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                sweep.run_sweep(_spec())


# ------------------------ checkpointed sweep resume ------------------------


def _fault_spec(**kw):
    d = dict(
        scenario="fault_storm", n_requests=2_048,
        policies=(geometry.BASELINE, geometry.RARO),
        initial_pe=(900,), seeds=(0,),
        prog_fail_rate=(0.0, 0.02), erase_fail_rate=(0.05,),
        max_read_retries=(6,), base=TINY,
    )
    d.update(kw)
    return sweep.SweepSpec(**d)


class TestSweepResume:
    @pytest.fixture(scope="class")
    def baseline(self):
        return sweep.run_sweep(_fault_spec(), device=CPU)

    def test_checkpointing_changes_nothing(self, baseline, tmp_path):
        res = sweep.run_sweep(_fault_spec(), resume_dir=tmp_path, device=CPU)
        sweep.assert_results_identical(baseline, res)
        assert sorted(p.name for p in tmp_path.glob("ckpt_*.json")) == [
            "ckpt_fault_storm_baseline.json", "ckpt_fault_storm_raro.json"]

    def test_full_resume_is_identical(self, baseline, tmp_path, monkeypatch):
        spec = _fault_spec()
        sweep.run_sweep(spec, resume_dir=tmp_path, device=CPU)

        # every group cached: the rerun must not recompute anything and the
        # merged results must match the uninterrupted run bit for bit
        def no_run(*a, **k):
            raise AssertionError("a cached group was recomputed")

        monkeypatch.setattr(sweep, "run_one", no_run)
        res = sweep.run_sweep(spec, resume_dir=tmp_path, device=CPU)
        sweep.assert_results_identical(baseline, res)

    def test_partial_resume_is_identical(self, baseline, tmp_path):
        """A sweep killed after one policy group completed: only the missing
        group reruns and the merged results are unchanged."""
        spec = _fault_spec()
        sweep.run_sweep(spec, resume_dir=tmp_path, device=CPU)
        (tmp_path / "ckpt_fault_storm_raro.json").unlink()
        res = sweep.run_sweep(spec, resume_dir=tmp_path, device=CPU)
        sweep.assert_results_identical(baseline, res)

    def test_stale_checkpoint_is_ignored(self, baseline, tmp_path):
        spec = _fault_spec()
        sweep.run_sweep(spec, resume_dir=tmp_path, device=CPU)
        p = tmp_path / "ckpt_fault_storm_baseline.json"
        doc = json.loads(p.read_text())
        doc["n_requests"] = 999  # pretend it came from a different sweep
        p.write_text(json.dumps(doc))
        res = sweep.run_sweep(spec, resume_dir=tmp_path, device=CPU)
        sweep.assert_results_identical(baseline, res)

    def test_failing_group_is_retried_then_named(self, tmp_path, monkeypatch):
        """A group that keeps failing is retried with backoff, the other
        group still completes and checkpoints, then a RuntimeError names the
        failed group."""
        real = sweep.run_one

        def flaky(cfg, *a, **k):
            if cfg.policy == geometry.RARO:
                raise OSError("device lost")
            return real(cfg, *a, **k)

        monkeypatch.setattr(sweep, "run_one", flaky)
        with pytest.warns(UserWarning, match="retry"):
            with pytest.raises(RuntimeError, match="raro"):
                sweep.run_sweep(_fault_spec(), resume_dir=tmp_path, device=CPU,
                                retry_backoff_s=0.0)
        assert [p.name for p in tmp_path.glob("ckpt_*.json")] == [
            "ckpt_fault_storm_baseline.json"]


# ------------------------- observability integration -----------------------


def _full_cfg(**kw):
    base = dict(policy=geometry.RARO, initial_pe=500, obs_level="full",
                obs_event_capacity=4096, obs_windows=32, obs_window_ms=5.0)
    base.update(kw)
    return geometry.tiny_config(**base)


class TestSweepIntegration:
    def test_sweep_ships_attribution(self):
        """Every sweep result carries its own per-run attribution, and the
        per-run JSON artifact serializes the nested-list metrics."""
        spec = sweep.SweepSpec(
            scenario="mixed", n_requests=4 * 128,
            policies=(geometry.RARO,), initial_pe=(166, 833), seeds=(0,),
            base=_full_cfg(),
        )
        results = sweep.run_sweep(spec, device=CPU)
        assert len(results) == 2
        for r in results:
            counts = np.asarray(r["lat_mode_counts"])
            assert counts.shape == (modes.N_MODES, 64)
            assert counts.sum() == r["reads"]
            assert np.asarray(r["conversion_events"]).shape == (3, 3)
            json.loads(json.dumps({k: v for k, v in r.items()}))

    def test_write_artifacts_json_safe(self, tmp_path):
        spec = sweep.SweepSpec(
            scenario="mixed", n_requests=2 * 128,
            policies=(geometry.RARO,), initial_pe=(166,), seeds=(0,),
            base=_full_cfg(),
        )
        results = sweep.run_sweep(spec, device=CPU)
        paths = sweep.write_artifacts(results, tmp_path)
        doc = json.loads(paths[0].read_text())
        assert doc["metrics"]["conversion_events"] == results[0]["conversion_events"]
        names = [r[0] for r in doc["rows"]]
        assert any(n.endswith("tail_retry_share_qlc") for n in names)
        assert any(n.endswith("obs_events_total") for n in names)
