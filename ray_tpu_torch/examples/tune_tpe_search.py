"""Hyperparameter search with the in-tree TPE (Bayesian) searcher.

Run: python -m ray_tpu_torch.examples.tune_tpe_search

The Searcher interface is the reference's search_alg adapter surface
(tune/search/searcher.py); TPESearcher is a dependency-free
tree-structured Parzen estimator, and OptunaSearcher plugs optuna in
unchanged where it is installed.
"""

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.tune.search import TPESearcher, loguniform, uniform


def trainable(config):
    # toy objective: best at lr=1e-3, momentum=0.9
    import math
    lr_err = abs(math.log10(config["lr"]) + 3.0)
    mom_err = (config["momentum"] - 0.9) ** 2
    return {"score": -(lr_err + 10 * mom_err), "done": True}


def main(num_samples=20) -> None:
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    space = {"lr": loguniform(1e-5, 1e-1),
             "momentum": uniform(0.0, 0.99)}
    searcher = TPESearcher(space, metric="score", mode="max", seed=0)
    tuner = tune.Tuner(
        trainable,
        param_space=space,
        tune_config=tune.TuneConfig(
            metric="score", mode="max", num_samples=num_samples,
            max_concurrent_trials=2, search_alg=searcher),
        run_config=tune.TuneRunConfig(stop={"training_iteration": 1}))
    best = tuner.fit().get_best_result()
    print("best config:", best.config, "score:", best.metrics["score"])
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
