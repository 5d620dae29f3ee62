"""The port's ray_tpu_torch.tune (copies of the JAX package's tune/ under
the rename rule) on the CPU.

Mirrors of tests/test_tune.py (6), tests/test_tune_round3.py (6) and
tests/test_tune_search_alg.py (5) on ray_tpu_torch, each with its
reference test's assertions; the PPO sweep's learners on
device="cpu". Held against the JAX package, both in this process (the
schedulers and searchers are pure Python): one seeded sequence of trial
results fed to the reference's and the port's ASHAScheduler,
MedianStoppingRule and PopulationBasedTraining(seed=0) gives equal
decisions, equal exploit targets and equal mutated configs;
BasicVariantGenerator and TPESearcher(seed) suggest equal configs. One
cluster for the module (ray_tpu_torch.init(num_cpus=4)).
"""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu_torch import tune
from ray_tpu_torch.tune import (MedianStoppingRule, PopulationBasedTraining,
                                Trainable, TuneConfig, Tuner, TuneRunConfig)
from ray_tpu_torch.tune.schedulers import CONTINUE, STOP
from ray_tpu_torch.tune.search import (BasicVariantGenerator, TPESearcher,
                                       loguniform, uniform)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# ---- held against the JAX package ------------------------------------

def _schedulers(pkg):
    """name -> a fresh scheduler of package `pkg` (its tune module)."""
    return {
        "asha": lambda: pkg.ASHAScheduler(
            metric="acc", mode="max", max_t=9, grace_period=1,
            reduction_factor=3),
        "median": lambda: pkg.MedianStoppingRule(
            metric="acc", mode="max", grace_period=2,
            min_samples_required=2),
        "pbt": lambda: pkg.PopulationBasedTraining(
            metric="acc", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": [1e-4, 3e-4, 1e-3, 3e-3],
                                  "momentum": [0.8, 0.9, 0.99]},
            quantile_fraction=0.34, resample_probability=0.3, seed=0)}


def _drive(scheduler, seed, n_trials=6, max_t=9):
    """Feeds `scheduler` one seeded sequence of trial results (trials
    report in a seeded order, each its own noisy curve; a stopped trial
    reports no more, an exploited one takes the decision's config) and
    returns every decision."""
    rng = np.random.default_rng(seed)
    configs = {f"t{i}": {"lr": [1e-4, 3e-4, 1e-3, 3e-3][i % 4],
                         "momentum": 0.9} for i in range(n_trials)}
    for tid, cfg in configs.items():
        if hasattr(scheduler, "on_trial_add"):
            scheduler.on_trial_add(tid, cfg)
    skill = {tid: rng.uniform(0.5, 2.0) for tid in configs}
    it = dict.fromkeys(configs, 0)
    live = list(configs)
    out = []
    while live:
        tid = live[int(rng.integers(len(live)))]
        it[tid] += 1
        acc = skill[tid] * it[tid] + rng.normal(0, 0.5)
        d = scheduler.on_result(tid, {"acc": acc,
                                      "training_iteration": it[tid]})
        out.append((tid, it[tid], d))
        if isinstance(d, dict):
            configs[tid] = d["config"]
            skill[tid] = skill[d["source"]]
            scheduler.confirm_exploit(tid, d["config"])
        if d == STOP or it[tid] >= max_t:
            live.remove(tid)
            if hasattr(scheduler, "on_trial_remove"):
                scheduler.on_trial_remove(tid)
    return out


@pytest.mark.parametrize("name", ["asha", "median", "pbt"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scheduler_decisions_equal_the_jax_package(name, seed):
    got = _drive(_schedulers(tune)[name](), seed)
    want = _drive(_schedulers(jtune)[name](), seed)
    assert got == want
    kinds = {("exploit" if isinstance(d, dict) else d) for _, _, d in got}
    # each sequence exercises the scheduler's decisions, not CONTINUE only
    assert kinds - {CONTINUE}, kinds


def _space(pkg):
    return {"lr": pkg.loguniform(1e-5, 1e-1), "x": pkg.uniform(-2.0, 3.0),
            "kind": pkg.choice(["a", "b", "c"]), "fixed": 7}


def _tpe_run(pkg, seed):
    s = pkg.TPESearcher(_space(pkg), metric="loss", mode="min", seed=seed,
                        n_initial=5)
    out = []
    for i in range(25):
        cfg = s.suggest(f"t{i}")
        out.append(cfg)
        s.on_trial_complete(f"t{i}", {"loss": abs(np.log10(cfg["lr"]) + 3)
                                      + (cfg["x"] - 1.0) ** 2
                                      + (cfg["kind"] != "b")})
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_searchers_suggest_what_the_jax_package_suggests(seed):
    space = dict(_space(tune), grid=tune.grid_search([1, 2]))
    jspace = dict(_space(jtune), grid=jtune.grid_search([1, 2]))
    got = list(BasicVariantGenerator(space, num_samples=3,
                                     seed=seed).variants())
    want = list(jtune.search.BasicVariantGenerator(
        jspace, num_samples=3, seed=seed).variants())
    assert len(got) == 6 and got == want
    assert _tpe_run(tune, seed) == _tpe_run(jtune, seed)


# ---- mirrors of tests/test_tune.py -----------------------------------

def test_variant_generator_grid_and_random():
    space = {"lr": tune.grid_search([0.1, 0.01]),
             "h": tune.choice([32, 64]),
             "fixed": "abc"}
    variants = list(BasicVariantGenerator(space, num_samples=3,
                                          seed=0).variants())
    assert len(variants) == 6  # 3 samples x 2 grid values
    assert all(v["fixed"] == "abc" for v in variants)
    assert sorted({v["lr"] for v in variants}) == [0.01, 0.1]
    assert {v["h"] for v in variants} <= {32, 64}


def test_function_trainable_grid_sweep(cluster, tmp_path):
    def objective(config):
        for i in range(5):
            tune.report(score=config["x"] * (i + 1))

    tuner = tune.Tuner(
        objective,
        param_space={"x": tune.grid_search([1, 2, 3, 4])},
        tune_config=tune.TuneConfig(metric="score", mode="max",
                                    max_concurrent_trials=2),
        run_config=tune.TuneRunConfig(
            storage_path=str(tmp_path),
            stop={"training_iteration": 3},
            resources_per_trial={"CPU": 0.5}))
    grid = tuner.fit()
    assert len(grid) == 4 and not grid.errors
    best = grid.get_best_result()
    assert best.config["x"] == 4
    assert best.metrics["score"] == 12  # 4 * 3rd iteration
    assert all(r.state == "TERMINATED" for r in grid)


def test_asha_rung_decisions_unit():
    """Deterministic ASHA semantics: once rf peers sit at a rung, a
    below-cutoff newcomer stops; an above-cutoff one continues."""
    s = tune.ASHAScheduler(metric="acc", mode="max", max_t=8,
                           grace_period=2, reduction_factor=2)
    # best trial reaches the t=2 rung first (promoted optimistically)
    assert s.on_result("a", {"acc": 8.0, "training_iteration": 2}) \
        == "CONTINUE"
    # worse latecomers at the same rung are cut (keep top 1/2)
    assert s.on_result("b", {"acc": 2.0, "training_iteration": 2}) == "STOP"
    assert s.on_result("c", {"acc": 9.0, "training_iteration": 2}) \
        == "CONTINUE"  # new best continues
    assert s.on_result("d", {"acc": 3.0, "training_iteration": 2}) == "STOP"
    # non-milestone iterations never stop
    assert s.on_result("a", {"acc": 8.0, "training_iteration": 3}) \
        == "CONTINUE"
    # reaching max_t stops unconditionally
    assert s.on_result("a", {"acc": 99.0, "training_iteration": 8}) == "STOP"


def test_asha_integration_completes_with_best(cluster, tmp_path):
    def objective(config):
        for i in range(8):
            tune.report(acc=config["q"] * (i + 1))

    sched = tune.ASHAScheduler(metric="acc", mode="max", max_t=8,
                               grace_period=2, reduction_factor=2)
    tuner = tune.Tuner(
        objective,
        param_space={"q": tune.grid_search([1.0, 2.0, 3.0, 4.0])},
        tune_config=tune.TuneConfig(metric="acc", mode="max",
                                    scheduler=sched,
                                    max_concurrent_trials=4),
        run_config=tune.TuneRunConfig(storage_path=str(tmp_path),
                                      stop={"training_iteration": 8},
                                      resources_per_trial={"CPU": 0.5}))
    grid = tuner.fit()
    assert not grid.errors
    assert all(r.state == "TERMINATED" for r in grid)
    # async arrival order decides who gets cut, but the best q must
    # survive to a competitive score and win selection
    assert grid.get_best_result().config["q"] == 4.0


def test_trainable_failure_restores_from_checkpoint(cluster, tmp_path):
    marker = str(tmp_path / "crashed_once")

    class Flaky(tune.Trainable):
        def setup(self, config):
            self.n = 0
            self.marker = config["marker"]

        def step(self):
            self.n += 1
            if self.n == 4 and not os.path.exists(self.marker):
                with open(self.marker, "w") as f:
                    f.write("x")
                os._exit(1)  # hard-kill the trial actor mid-training
            return {"n": self.n}

        def save_checkpoint(self, d):
            with open(os.path.join(d, "state"), "w") as f:
                f.write(str(self.n))

        def load_checkpoint(self, d):
            with open(os.path.join(d, "state")) as f:
                self.n = int(f.read())

    tuner = tune.Tuner(
        Flaky,
        param_space={"marker": marker},
        tune_config=tune.TuneConfig(metric="n", mode="max"),
        run_config=tune.TuneRunConfig(
            storage_path=str(tmp_path),
            stop={"training_iteration": 6},
            checkpoint_frequency=2,
            max_failures_per_trial=2,
            resources_per_trial={"CPU": 0.5}))
    grid = tuner.fit()
    r = grid[0]
    assert r.error is None and r.state == "TERMINATED"
    assert r.num_restores == 1, "trial should have restored exactly once"
    # restored from n=3's checkpoint (freq=2 -> checkpoint at n=2), so the
    # counter continues rather than restarting from zero
    assert r.metrics["n"] == 6


def test_ppo_lr_sweep_with_best_trial(cluster, tmp_path):
    """A 4-trial PPO LR sweep completes with best-trial selection
    (param_space merges into AlgorithmConfig.training), the learners on
    the CPU."""
    from ray_tpu_torch.rllib import PPOConfig

    base = (PPOConfig()
            .environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                         rollout_fragment_length=64)
            .training(train_batch_size=256, minibatch_size=64, num_epochs=2)
            .debugging(seed=3)
            .learners(device="cpu"))
    tuner = tune.Tuner(
        base,
        param_space={"lr": tune.grid_search([3e-2, 1e-3, 3e-4, 1e-4])},
        tune_config=tune.TuneConfig(metric="episode_reward_mean",
                                    mode="max", max_concurrent_trials=2),
        run_config=tune.TuneRunConfig(storage_path=str(tmp_path),
                                      stop={"training_iteration": 2},
                                      resources_per_trial={"CPU": 0.5}))
    grid = tuner.fit()
    assert len(grid) == 4 and not grid.errors
    best = grid.get_best_result()
    assert best.config["lr"] in (3e-2, 1e-3, 3e-4, 1e-4)
    assert "episode_reward_mean" in best.metrics
    assert all(r.checkpoint_dir for r in grid
               if r.state == "TERMINATED"), "final checkpoints missing"


# ---- mirrors of tests/test_tune_round3.py ----------------------------

class TestMedianStoppingRule:
    def test_below_median_stops(self):
        rule = MedianStoppingRule(metric="score", mode="max",
                                  grace_period=1,
                                  min_samples_required=3)
        for i, tid in enumerate(["a", "b", "c"]):
            assert rule.on_result(
                tid, {"score": 10.0 + i,
                      "training_iteration": 2}) == CONTINUE
        # 'd' reports well below the median of a/b/c running means
        assert rule.on_result(
            "d", {"score": 0.1, "training_iteration": 2}) == STOP
        # a strong trial continues
        assert rule.on_result(
            "e", {"score": 50.0, "training_iteration": 2}) == CONTINUE


class TestPBTScheduler:
    def test_bottom_trial_exploits_top(self):
        pbt = PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": [1e-4, 1e-3, 1e-2]}, seed=0)
        for tid, lr in [("t0", 1e-4), ("t1", 1e-3), ("t2", 1e-2),
                        ("t3", 1e-3)]:
            pbt.on_trial_add(tid, {"lr": lr})
        # iteration 2: scores spread; t3 is worst
        for tid, score in [("t0", 100.0), ("t1", 50.0), ("t2", 40.0)]:
            assert pbt.on_result(
                tid, {"score": score, "training_iteration": 2}) \
                == CONTINUE
        decision = pbt.on_result(
            "t3", {"score": 1.0, "training_iteration": 2})
        assert isinstance(decision, dict)
        assert decision["action"] == "exploit"
        assert decision["source"] == "t0"  # the only top-quantile trial
        assert "lr" in decision["config"]
        # proposal counts only once the controller confirms the clone
        assert pbt.num_perturbations == 0
        pbt.confirm_exploit("t3", decision["config"])
        assert pbt.num_perturbations == 1
        assert pbt._configs["t3"] == decision["config"]

    def test_dead_trial_does_not_freeze_population_gate(self):
        pbt = PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": [1e-4, 1e-3]}, seed=0)
        for tid in ["a", "b", "c"]:
            pbt.on_trial_add(tid, {"lr": 1e-3})
        # 'c' dies before ever reporting
        pbt.on_trial_remove("c")
        for tid, score in [("a", 100.0), ("b", 50.0)]:
            pbt.on_result(tid, {"score": score,
                                "training_iteration": 1})
        decision = pbt.on_result(
            "b", {"score": 50.0, "training_iteration": 2})
        assert isinstance(decision, dict) and \
            decision["action"] == "exploit"

    def test_explore_perturbs_numeric(self):
        pbt = PopulationBasedTraining(
            metric="score", perturbation_interval=1,
            hyperparam_mutations={"lr": [1e-4, 1e-3, 1e-2]},
            resample_probability=0.0, seed=0)
        cfg = pbt._explore({"lr": 1e-3})
        assert cfg["lr"] in (1e-4, 1e-2)  # neighbor hop
        pbt2 = PopulationBasedTraining(
            metric="score", perturbation_interval=1,
            hyperparam_mutations={"lr": [7.0]},
            resample_probability=1.0, seed=0)
        assert pbt2._explore({"lr": 3.0})["lr"] == 7.0  # resample


def _make_quadratic():
    """score converges toward 100 at a rate set by lr; state is the
    current score so PBT exploit visibly transfers progress. Defined
    inside a function so cloudpickle ships it by value to workers."""

    class _Quadratic(Trainable):
        def setup(self, config):
            self.lr = config["lr"]
            self.score = 0.0
            # optional population rendezvous: trials announce
            # themselves and step() holds until the whole population
            # is up (PBT needs a population)
            self._rdv = None
            self._pop = int(config.get("population", 0))
            if self._pop:
                import os
                d = config["rendezvous_dir"]
                os.makedirs(d, exist_ok=True)
                open(os.path.join(d, f"up-{os.getpid()}"), "w").close()
                self._rdv = d

        def step(self):
            import time
            if self._rdv is not None:
                import glob
                deadline = time.time() + 60
                while len(glob.glob(os.path.join(
                        self._rdv, "up-*"))) < self._pop:
                    if time.time() > deadline:
                        raise RuntimeError("population never assembled")
                    time.sleep(0.1)
                self._rdv = None
            time.sleep(float(self.config.get("step_sleep", 0.15)))
            self.score += self.lr * (100.0 - self.score)
            return {"score": self.score}

        def save_checkpoint(self, checkpoint_dir):
            with open(os.path.join(checkpoint_dir, "s.txt"), "w") as f:
                f.write(str(self.score))

        def load_checkpoint(self, checkpoint_dir):
            with open(os.path.join(checkpoint_dir, "s.txt")) as f:
                self.score = float(f.read())

    return _Quadratic


class TestPBTEndToEnd:
    def test_pbt_transfers_checkpoint_and_config(self, cluster, tmp_path):
        from ray_tpu_torch.tune import grid_search

        # warm the worker pool so both trial actors start together
        @ray_tpu_torch.remote
        def _noop():
            return 0
        ray_tpu_torch.get([_noop.options(num_cpus=0.5).remote()
                           for _ in range(2)], timeout=120)
        pbt = PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=2,
            hyperparam_mutations={"lr": [0.01, 0.2, 0.5]},
            resample_probability=0.0, seed=0)
        tuner = Tuner(
            _make_quadratic(),
            param_space={"lr": grid_search([0.01, 0.5]),
                         "population": 2,
                         "rendezvous_dir": str(tmp_path / "rdv")},
            tune_config=TuneConfig(metric="score", mode="max",
                                   scheduler=pbt,
                                   max_concurrent_trials=2),
            run_config=TuneRunConfig(
                storage_path=str(tmp_path), name="pbt",
                resources_per_trial={"CPU": 0.5},
                stop={"training_iteration": 16}))
        grid = tuner.fit()
        assert not grid.errors
        assert pbt.num_perturbations >= 1
        # the weak lr=0.01 trial must have been lifted by exploiting
        # the strong one
        weak = [r for r in grid
                if r.metrics_history[0]["score"] < 10.0][0]
        assert weak.metrics["score"] > 30.0

    def test_tuner_restore_resumes_unfinished(self, cluster, tmp_path,
                                              monkeypatch):
        from ray_tpu_torch.tune import grid_search
        from ray_tpu_torch.tune.tune_controller import TuneController

        # phase 1: run with a tiny time budget so trials get cut off
        tuner = Tuner(
            _make_quadratic(),
            # 6 x 0.5s = 3s per trial: the 2.0s phase-1 budget below
            # cannot finish both sequential trials
            param_space={"lr": grid_search([0.3, 0.4]),
                         "step_sleep": 0.5},
            tune_config=TuneConfig(metric="score", mode="max",
                                   max_concurrent_trials=1),
            run_config=TuneRunConfig(
                storage_path=str(tmp_path), name="resume",
                checkpoint_frequency=1,
                resources_per_trial={"CPU": 0.5},
                stop={"training_iteration": 6}))
        run_dir = str(tmp_path / "resume")
        # simulate interruption: run the controller with ~no budget
        orig_run = TuneController.run
        monkeypatch.setattr(TuneController, "run",
                            lambda self, timeout_s=3600:
                            orig_run(self, timeout_s=2.0))
        grid1 = tuner.fit()
        monkeypatch.setattr(TuneController, "run", orig_run)
        assert os.path.exists(
            os.path.join(run_dir, "experiment_state.pkl"))
        done1 = [r for r in grid1 if r.state == "TERMINATED"]
        # phase 2: restore and finish everything
        tuner2 = Tuner.restore(run_dir, _make_quadratic())
        grid2 = tuner2.fit()
        assert not grid2.errors
        assert all(r.state == "TERMINATED" for r in grid2)
        assert len(grid2) == 2
        for r in grid2:
            assert r.metrics["training_iteration"] >= 6
        # finished trials from phase 1 keep their recorded results
        for r1 in done1:
            r2 = next(r for r in grid2 if r.trial_id == r1.trial_id)
            assert r2.metrics["score"] >= r1.metrics["score"] - 1e-9


# ---- mirrors of tests/test_tune_search_alg.py ------------------------

def test_tpe_beats_random_on_quadratic():
    """Sequential TPE on f(x) = -(x-3)^2: after a budget of 40
    suggestions, the best TPE sample lands far closer to the optimum
    than random search's expectation."""
    space = {"x": uniform(-10.0, 10.0)}
    s = TPESearcher(space, metric="score", mode="max", seed=0,
                    n_initial=8)
    best = -np.inf
    for i in range(40):
        tid = f"t{i}"
        cfg = s.suggest(tid)
        score = -(cfg["x"] - 3.0) ** 2
        s.on_trial_complete(tid, {"score": score})
        best = max(best, score)
    assert best > -0.5, f"TPE best {best}"
    # late suggestions concentrate near x=3
    tail = [s.suggest(f"late{i}")["x"] for i in range(10)]
    assert np.mean(np.abs(np.asarray(tail) - 3.0)) < 3.0


def test_tpe_categorical_and_log():
    space = {"kind": tune.choice(["a", "b"]),
             "lr": loguniform(1e-5, 1e-1)}
    s = TPESearcher(space, metric="loss", mode="min", seed=1,
                    n_initial=6)
    for i in range(30):
        tid = f"t{i}"
        cfg = s.suggest(tid)
        loss = (0.0 if cfg["kind"] == "b" else 1.0) + \
            abs(np.log10(cfg["lr"]) + 3.0)  # optimum lr=1e-3, kind=b
        s.on_trial_complete(tid, {"loss": loss})
    picks = [s.suggest(f"p{i}") for i in range(20)]
    assert sum(1 for p in picks if p["kind"] == "b") >= 12
    lrs = np.asarray([p["lr"] for p in picks])
    assert 1e-5 < np.median(lrs) < 1e-1


def test_tpe_rejects_grid():
    with pytest.raises(ValueError, match="grid_search"):
        TPESearcher({"x": tune.grid_search([1, 2])}, metric="m")


def test_optuna_adapter_importerror_without_optuna():
    try:
        import optuna  # noqa: F401
        pytest.skip("optuna installed; adapter usable")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="TPESearcher"):
        tune.OptunaSearcher({"x": uniform(0, 1)}, metric="m")


def test_tuner_with_search_alg_end_to_end(cluster, tmp_path):
    """Tuner drives the searcher sequentially: trials get suggested
    configs and results flow back (observations accumulate)."""

    def trainable(config):
        x = config["x"]
        return {"score": -(x - 2.0) ** 2, "done": True}

    space = {"x": uniform(-5.0, 5.0)}
    searcher = TPESearcher(space, metric="score", mode="max", seed=2,
                           n_initial=3)
    tuner = tune.Tuner(
        trainable,
        param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=8,
            max_concurrent_trials=2, search_alg=searcher),
        run_config=tune.TuneRunConfig(storage_path=str(tmp_path),
                                      stop={"training_iteration": 1}))
    grid = tuner.fit()
    assert len(grid) == 8
    assert len(searcher._obs) == 8  # every completed trial reported
    best = grid.get_best_result()
    assert best.metrics["score"] > -25.0
