"""Tune sweep with population-based training."""

import os
import time

import ray_tpu_torch
from ray_tpu_torch.tune import (PopulationBasedTraining, Trainable, TuneConfig,
                          Tuner, TuneRunConfig, grid_search)


class Quadratic(Trainable):
    """Converges toward 100 at a speed set by lr."""

    def setup(self, config):
        self.lr = config["lr"]
        self.score = 0.0

    def step(self):
        time.sleep(0.1)
        self.score += self.lr * (100.0 - self.score)
        return {"score": self.score}

    def save_checkpoint(self, d):
        with open(os.path.join(d, "s.txt"), "w") as f:
            f.write(str(self.score))

    def load_checkpoint(self, d):
        with open(os.path.join(d, "s.txt")) as f:
            self.score = float(f.read())


def main():
    ray_tpu_torch.init(num_cpus=2)
    pbt = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=3,
        hyperparam_mutations={"lr": [0.01, 0.1, 0.3, 0.5]}, seed=0)
    tuner = Tuner(
        Quadratic,
        param_space={"lr": grid_search([0.01, 0.3])},
        tune_config=TuneConfig(metric="score", mode="max",
                               scheduler=pbt,
                               max_concurrent_trials=2),
        run_config=TuneRunConfig(stop={"training_iteration": 15},
                                 resources_per_trial={"CPU": 0.5}))
    grid = tuner.fit()
    best = grid.get_best_result()
    print("best:", best.config, round(best.metrics["score"], 2))
    print("perturbations:", pbt.num_perturbations)
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
