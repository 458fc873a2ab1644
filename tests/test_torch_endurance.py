"""Twin of tests/test_endurance.py: the port's endurance, WAF and unified
victim-scorer code (``repro_torch.core.reclaim``, ``core.modes``' endurance
helpers, the engine's WAF counters, ``experiments.sweep``'s
``gc_objective`` axis), held by the reference's assertions on the CPU with
the same geometry, seeds and sizes. The historical top-k the reference
computes with ``jax.lax.top_k`` is computed here with a stable descending
sort (ties to the lowest index, as ``lax.top_k``). The closed-loop WAF run
is held against the JAX package's engine.

Pinned here:

  1. The WAF accounting identity — ``waf == (user + reloc) / user`` holds
     exactly across closed-loop, open-loop (legacy and lattice) and
     faults-armed runs, and the relocation counter matches both
     ``n_migrated_pages`` (fault-free) and the page count decoded from the
     event ring when nothing is dropped.
  2. Default-scorer bit-identity — ``reclaim.score_victims`` with the
     ``min_valid`` objective (static or knob code 0) selects exactly the
     blocks the historical inline top-k picked, on real engine states
     against a numpy greedy reference.
  3. The lifespan scorer formula, its wear sensitivity, and the
     ``gc_objective`` sweep axis (the min-valid point of a mixed-objective
     grid equals the knob-free run bit for bit).
  4. The deprecated wrappers (``select_demotions`` /
     ``select_demotion_victims`` / ``topk_victims``) — equivalent to the
     unified entry point, and they warn exactly once.
  5. DWPD / TBW / lifetime-years conversion-helper arithmetic.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch_twins import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_twins import CPU, check_against_reference, f32, i32
from torch_twins import run as _engine_run

from repro_torch.core import modes, reclaim
from repro_torch.experiments import registry, sweep
from repro_torch.ssdsim import engine, geometry, obs, policies, workload
from repro_torch.ssdsim import state as st

# small high-occupancy geometry: GC fires within a few chunks, so the WAF
# numerator is nonzero on a 24-chunk trace
CFG = geometry.tiny_config(gc_free_threshold=6, n_logical=2_944,
                           initial_pe=500)
N_REQ = 24 * CFG.chunk


def _trace(cfg, seed=0, read_frac=0.3):
    return registry.build("mixed", cfg, N_REQ, seed=seed,
                          read_frac=read_frac)


def _run(cfg, trace):
    s, _ = _engine_run(cfg, trace)
    return s


def _top_k(x, k):
    """``jax.lax.top_k``: the k largest, ties to the lowest index."""
    v, i = torch.sort(x, descending=True, stable=True)
    return v[:k], i[:k]


def _waf_checks(m, *, expect_reloc_eq_migrated=True):
    assert m["user_pages"] > 0
    assert m["reloc_pages"] > 0, "trace must actually trigger relocation"
    assert m["waf"] == (m["user_pages"] + m["reloc_pages"]) / m["user_pages"]
    assert m["user_pages"] == m["writes"]
    if expect_reloc_eq_migrated:
        # fault-free: every relocation booked by relocate_group/migrate_pages
        # lands in _place_pages, so the two counters agree exactly
        assert m["reloc_pages"] == m["migrated_pages"]


class TestWafIdentity:
    def test_closed_loop(self):
        m = engine.summarize(_run(CFG, _trace(CFG)), CFG)
        _waf_checks(m)

    def test_closed_loop_equals_reference(self):
        tr = _trace(CFG)
        check_against_reference(CFG, tr, _run(CFG, tr))

    def test_open_loop_legacy(self):
        tr = workload.attach_arrivals(CFG, _trace(CFG), 30_000.0, seed=7)
        m = engine.summarize(_run(CFG, tr), CFG)
        _waf_checks(m)

    def test_open_loop_lattice(self):
        cfg = dataclasses.replace(CFG, chan_model="lattice")
        tr = workload.attach_arrivals(cfg, _trace(cfg), 30_000.0, seed=7)
        m = engine.summarize(_run(cfg, tr), cfg)
        _waf_checks(m)

    def test_faults_armed(self):
        # erase failures + a finite retry budget armed, prog_fail_rate = 0 so
        # no re-placements perturb the reloc == migrated equality
        cfg = dataclasses.replace(CFG, erase_fail_rate=0.05,
                                  max_read_retries=4, fault_seed=3)
        m = engine.summarize(_run(cfg, _trace(cfg)), cfg)
        _waf_checks(m)

    def test_prog_fail_replacement_counts_as_amplification(self):
        cfg = dataclasses.replace(CFG, prog_fail_rate=0.05, fault_seed=3)
        m = engine.summarize(_run(cfg, _trace(cfg)), cfg)
        _waf_checks(m, expect_reloc_eq_migrated=False)
        assert m["prog_fails"] > 0
        # re-placed pages are write amplification but not "migrations"
        assert m["reloc_pages"] > m["migrated_pages"]

    def test_matches_event_ring(self):
        # full instruments, capacity large enough that nothing is dropped:
        # the decoded per-event page counts must reproduce the counter
        cfg = dataclasses.replace(CFG, obs_level="full",
                                  obs_event_capacity=4_096)
        s = _run(cfg, _trace(cfg))
        m = engine.summarize(s, cfg)
        records, total, dropped = obs.decode_events(s, cfg)
        assert dropped == 0
        reloc_reasons = {obs.REASON_CONV_PAGE, obs.REASON_GC,
                         obs.REASON_RECLAIM, obs.REASON_CONV_BLOCK}
        ring_pages = sum(r["pages"] for r in records
                         if r["reason"] in reloc_reasons)
        assert ring_pages == m["reloc_pages"]
        _waf_checks(m)

    def test_read_only_waf_is_one(self):
        cfg = geometry.tiny_config()
        tr = registry.build("zipf", cfg, 8 * cfg.chunk, seed=0)
        m = engine.summarize(_run(cfg, tr), cfg)
        assert m["user_pages"] == 0.0
        assert m["waf"] == 1.0
        assert m["lifetime_years"] == 0.0 and m["dwpd"] == 0.0


# ------------------- default-scorer bit-identity (tentpole) ----------------


def _legacy_min_valid(s, cfg, k):
    """The historical inline GC selection, reproduced op for op."""
    ppb = geometry.pages_per_block(cfg, CPU)
    reclaimable = (s.block_state == st.FULL) & (s.block_valid < ppb[s.block_mode.long()])
    masked = torch.where(reclaimable, -s.block_valid.float(), -torch.inf)
    vals, victims = _top_k(masked, k)
    return victims.to(torch.int32), vals > -torch.inf


class TestDefaultScorerBitIdentity:
    @pytest.fixture(scope="class")
    def real_states(self):
        """Real engine states at several wear points / seeds."""
        out = []
        for seed, pe in ((0, 500), (1, 900)):
            cfg = dataclasses.replace(CFG, initial_pe=pe)
            out.append((_run(cfg, _trace(cfg, seed=seed)), cfg))
        return out

    def test_property_matches_legacy_ops(self, real_states):
        for s, cfg in real_states:
            for k in (1, 2, 4):
                v_ref, ok_ref = _legacy_min_valid(s, cfg, k)
                v, ok, tgt = reclaim.score_victims(s, cfg, "min_valid", k=k)
                np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))
                np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_ref))
                # GC relocates at the victim's own density
                np.testing.assert_array_equal(
                    np.asarray(tgt), np.asarray(s.block_mode)[np.asarray(v).astype(np.int64)])

    def test_property_matches_numpy_greedy(self, real_states):
        for s, cfg in real_states:
            ppb = np.asarray(geometry.pages_per_block_host(cfg))
            valid = np.asarray(s.block_valid)
            mode = np.asarray(s.block_mode)
            reclaimable = ((np.asarray(s.block_state) == st.FULL)
                           & (valid < ppb[mode]))
            cand = np.flatnonzero(reclaimable)
            greedy = cand[np.lexsort((cand, valid[cand]))]
            k = 4
            v, ok, _ = reclaim.score_victims(s, cfg, "min_valid", k=k)
            n = min(k, len(greedy))
            np.testing.assert_array_equal(np.asarray(v)[:n], greedy[:n])
            np.testing.assert_array_equal(
                np.asarray(ok), np.arange(k) < len(greedy))

    def test_knob_code_zero_is_bit_identical(self, real_states):
        for s, cfg in real_states:
            v_ref, ok_ref = _legacy_min_valid(s, cfg, 4)
            v, ok, _ = reclaim.score_victims(
                s, cfg, "min_valid", k=4, objective_code=i32(0))
            np.testing.assert_array_equal(np.asarray(v), np.asarray(v_ref))
            np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_ref))

    def test_full_run_unchanged_by_scorer_refactor(self):
        # the engine's own GC path (routed through score_victims) must keep
        # producing the historical states: pin a couple of headline counters
        # against the reference scalar GC in a k=1 config where the two are
        # guaranteed identical (covered in depth by test_relocation.py)
        cfg = dataclasses.replace(CFG, gc_victims_per_pass=1)
        tr = _trace(cfg)
        s = _run(cfg, tr)
        assert float(s.n_reloc_pages) == float(s.n_migrated_pages)


# ----------------------------- lifespan scorer -----------------------------


class TestLifespanScorer:
    def _toy_state(self):
        # four FULL QLC blocks: equal-valid pairs with different wear
        return SimpleNamespace(
            block_valid=i32([10, 10, 50, 50]),
            block_mode=torch.full((4,), modes.QLC, dtype=torch.int32),
            block_state=torch.full((4,), st.FULL, dtype=torch.int32),
            block_pe=i32([900, 100, 100, 900]),
        )

    def test_formula(self):
        cfg = geometry.tiny_config(gc_objective="lifespan", gc_alpha=1.0,
                                   gc_beta=0.5, gc_gamma=0.3)
        s = self._toy_state()
        ppb = geometry.pages_per_block(cfg, CPU)
        mig = np.asarray(s.block_valid, np.float32) / np.asarray(
            ppb, np.float32)[np.asarray(s.block_mode)]
        pe_norm = np.asarray(s.block_pe, np.float32) / np.asarray(
            modes.PE_LIMIT, np.float32)[np.asarray(s.block_mode)]
        expect = (cfg.gc_alpha * (1.0 - mig) - cfg.gc_beta * mig
                  - cfg.gc_gamma * pe_norm)
        got = np.asarray(reclaim.gc_scores(s, cfg, "lifespan"))
        np.testing.assert_allclose(got, expect, rtol=1e-6)

    def test_prefers_less_worn_block_on_valid_ties(self):
        cfg = geometry.tiny_config(gc_objective="lifespan")
        v, ok, _ = reclaim.score_victims(self._toy_state(), cfg, "lifespan", k=2)
        # blocks 0/1 tie on invalid ratio; γ > 0 breaks the tie toward the
        # younger block 1 (min_valid would pick block 0 by index order)
        assert int(v[0]) == 1 and int(v[1]) == 0

    def test_invalid_ratio_dominates(self):
        cfg = geometry.tiny_config(gc_objective="lifespan")
        v, _, _ = reclaim.score_victims(self._toy_state(), cfg, "lifespan", k=4)
        # the 10-valid pair beats the 50-valid pair regardless of wear
        assert set(np.asarray(v)[:2].tolist()) == {0, 1}

    def test_knob_code_selects_lifespan(self):
        cfg = geometry.tiny_config()  # static default: min_valid
        s = self._toy_state()
        v_life, _, _ = reclaim.score_victims(
            s, cfg, "min_valid", k=1, objective_code=i32(1))
        v_static, _, _ = reclaim.score_victims(s, cfg, "lifespan", k=1)
        assert int(v_life[0]) == int(v_static[0]) == 1

    def test_engine_gc_path_honours_objective(self):
        # the engine's GC entry point (ftl.select_gc_victims) must route
        # cfg.gc_objective / knobs.gc_objective into the scorer: on a real
        # engine state with striped wear, a heavy γ flips the victim choice
        from repro_torch.ssdsim import ftl

        cfg = dataclasses.replace(CFG, gc_free_threshold=50)
        s = _run(cfg, _trace(cfg))
        # stripe the wear so equal-valid candidates differ in P/E
        pe = 100 + 800 * (np.arange(s.block_pe.shape[0]) % 2)
        s = s._replace(block_pe=i32(pe))
        v_mv, ok_mv = ftl.select_gc_victims(s, cfg, 4)
        cfg_l = dataclasses.replace(cfg, gc_objective="lifespan",
                                    gc_gamma=1e4)
        v_ls, ok_ls = ftl.select_gc_victims(s, cfg_l, 4)
        assert bool(ok_mv.all()) and bool(ok_ls.all())
        assert not np.array_equal(np.asarray(v_mv), np.asarray(v_ls))
        # γ=1e4 dominates: every lifespan victim comes from the young stripe
        assert (np.asarray(s.block_pe)[np.asarray(v_ls).astype(np.int64)] == 100).all()
        # a knob code overrides the static objective identically
        knobs = policies.RunKnobs(
            r1=i32(1), r2_override=i32(-1),
            initial_pe=i32(500), gc_objective=i32(1))
        v_knob, _ = ftl.select_gc_victims(s, cfg_l, 4, knobs)
        np.testing.assert_array_equal(np.asarray(v_knob), np.asarray(v_ls))

    def test_unknown_objective_rejected(self):
        with pytest.raises(ValueError):
            reclaim.score_victims(self._toy_state(), CFG, "nope", k=1)
        with pytest.raises(ValueError):
            geometry.tiny_config(gc_objective="nope")

    def test_objective_tables_consistent(self):
        assert geometry.GC_OBJECTIVES == reclaim.GC_OBJECTIVES
        assert (set(reclaim.GC_OBJECTIVE_CODES)
                == set(reclaim.GC_OBJECTIVES))


# --------------------------- gc_objective sweep axis -----------------------


class TestSweepAxis:
    def _spec(self, **kw):
        return sweep.SweepSpec(
            scenario="mixed", n_requests=8 * CFG.chunk,
            policies=(geometry.BASELINE,), initial_pe=(500,), seeds=(0,),
            scenario_kw=(("read_frac", 0.3),), base=CFG, **kw,
        )

    def test_expand_tag_and_n_runs(self):
        spec = self._spec(gc_objective=("min_valid", "lifespan"))
        runs = sweep.expand(spec)
        assert len(runs) == spec.n_runs() == 2
        tags = [r.tag() for r in runs]
        assert any(t.endswith("gc_lifespan") for t in tags)
        # the default objective never pollutes existing tags (checkpoint and
        # artifact names from older sweeps stay valid)
        assert all("gc_min_valid" not in t for t in tags)

    def test_min_valid_point_bit_identical_to_knob_free_run(self):
        res0 = sweep.run_sweep(self._spec(), device=CPU)
        res1 = sweep.run_sweep(
            self._spec(gc_objective=("min_valid", "lifespan")), device=CPU)
        assert len(res0) == 1 and len(res1) == 2
        mv = next(r for r in res1 if r["run"]["gc_objective"] == "min_valid")
        for k, v in res0[0].items():
            if k == "run":
                continue
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(mv[k]), err_msg=k)
        # both objectives actually produced endurance rows
        for r in res1:
            assert r["waf"] >= 1.0 and r["lifetime_years"] >= 0.0
            assert r["pe_variance"] >= 0.0


# --------------------------- deprecated wrappers ---------------------------


class TestDeprecatedWrappers:
    def _args(self, seed=0):
        rng = np.random.default_rng(seed)
        B = 16
        block_mode = i32(rng.integers(0, 3, B))
        block_heat = f32(rng.random(B))
        cold_age = i32(rng.integers(0, 10, B))
        return block_mode, block_heat, cold_age

    def test_select_demotion_victims_equivalent(self):
        cfg = reclaim.ReclaimConfig()
        for seed in range(4):
            mode, heat, age = self._args(seed)
            with pytest.warns(DeprecationWarning) if seed == 0 else _nullctx():
                reclaim._DEPRECATED_WARNED.discard("select_demotion_victims")
                v_old, ok_old, t_old = reclaim.select_demotion_victims(
                    mode, heat, age, 0.05, cfg)
            # the historical implementation, op for op
            scores = reclaim.demotion_scores(mode, heat, age)
            eligible = (scores > -torch.inf) & (age >= cfg.cold_epochs)
            v_ref, ok_ref = reclaim._topk(scores, eligible & torch.tensor(True),
                                          min(cfg.max_per_pass, 16))
            t_ref = torch.clamp(mode[v_ref.long()] + 1, max=modes.QLC)
            np.testing.assert_array_equal(np.asarray(v_old), np.asarray(v_ref))
            np.testing.assert_array_equal(np.asarray(ok_old), np.asarray(ok_ref))
            np.testing.assert_array_equal(np.asarray(t_old), np.asarray(t_ref))

    def test_select_demotions_equivalent_to_dense_reference(self):
        cfg = reclaim.ReclaimConfig()
        for seed in range(4):
            for free_frac in (0.05, 0.9):
                mode, heat, age = self._args(seed)
                reclaim._DEPRECATED_WARNED.discard("select_demotions")
                mask, target = reclaim.select_demotions(
                    mode, heat, age, free_frac, cfg)
                # historical dense-mask implementation
                scores = reclaim.demotion_scores(mode, heat, age)
                eligible = (scores > -torch.inf) & (age >= cfg.cold_epochs)
                under = free_frac < cfg.low_watermark
                k = min(cfg.max_per_pass, 16)
                masked = torch.where(eligible, scores, -torch.inf)
                _, top = _top_k(masked, k)
                m_ref = torch.zeros(16, dtype=torch.bool)
                m_ref[top] = True
                m_ref = m_ref & eligible & under
                t_ref = torch.where(m_ref, torch.clamp(mode + 1, max=modes.QLC), mode)
                np.testing.assert_array_equal(np.asarray(mask), np.asarray(m_ref))
                np.testing.assert_array_equal(np.asarray(target), np.asarray(t_ref))

    def test_wrappers_warn_once(self):
        mode, heat, age = self._args()
        for name, call in (
            ("topk_victims",
             lambda: reclaim.topk_victims(heat, mode >= 0, 2)),
            ("select_demotions",
             lambda: reclaim.select_demotions(mode, heat, age, 0.05,
                                              reclaim.ReclaimConfig())),
            ("select_demotion_victims",
             lambda: reclaim.select_demotion_victims(
                 mode, heat, age, 0.05, reclaim.ReclaimConfig())),
        ):
            reclaim._DEPRECATED_WARNED.discard(name)
            with pytest.warns(DeprecationWarning, match=name):
                call()
            with no_warns(DeprecationWarning):
                call()

    def test_engine_hot_path_never_warns(self):
        # the production demotion/GC paths use score_victims directly
        with no_warns(DeprecationWarning):
            _run(CFG, _trace(CFG))


# ------------------------- conversion helpers (modes) ----------------------


class TestEnduranceHelpers:
    def test_rated_pe_host_table_matches_device_table(self):
        np.testing.assert_array_equal(np.asarray(modes.PE_LIMIT),
                                      np.asarray(modes.RATED_PE))

    def test_tbw(self):
        cap = 16 * 2**30
        assert modes.tbw_bytes(cap, 1_000, waf=1.0) == cap * 1_000
        assert modes.tbw_bytes(cap, 1_000, waf=2.0) == cap * 500

    def test_lifetime_roundtrip(self):
        cap = 16 * 2**30
        tbw = modes.tbw_bytes(cap, 1_000, waf=1.25)
        rate = 3 * cap  # 3 drive writes per day
        assert modes.dwpd(rate, cap) == 3.0
        yrs = modes.lifetime_years(tbw, rate)
        assert yrs == pytest.approx(tbw / (rate * 365.25))
        # dwpd_for_lifetime inverts lifetime_years at the same TBW
        assert modes.dwpd_for_lifetime(tbw, cap, yrs) == pytest.approx(3.0)

    def test_no_writes_sentinel(self):
        assert modes.lifetime_years(1e15, 0.0) == 0.0


# ----------------------------- warning helpers -----------------------------


import contextlib  # noqa: E402


@contextlib.contextmanager
def _nullctx():
    yield


@contextlib.contextmanager
def no_warns(category):
    import warnings as _w
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        yield
    hits = [r for r in rec if issubclass(r.category, category)]
    assert not hits, f"unexpected {category.__name__}: {hits[0].message}"
