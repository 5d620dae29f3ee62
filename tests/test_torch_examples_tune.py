"""The port's Tune examples: tune_tpe_search at 6 samples and
tune_pbt_sweep as the JAX script runs it, each main() in this process
(each starts and ends its own cluster).

The trials' order and the searchers' draws rest on the runs' timing, so
the test holds structure and a learning signal, not the JAX scripts'
numbers: TPE's best config lies in its space with the score the
objective gives it, above the objective at the space's far corner; PBT's
best trial nears the quadratic's 100 and it prints its count of
perturbations.
"""

import ast
import math

from ray_tpu_torch.examples import tune_pbt_sweep, tune_tpe_search


def test_tpe_search_finds_a_config_in_its_space(capsys):
    tune_tpe_search.main(num_samples=6)
    (line,) = [x for x in capsys.readouterr().out.splitlines()
               if x.startswith("best config:")]
    config_text, score_text = line[len("best config:"):].split(" score: ")
    config = ast.literal_eval(config_text.strip())
    assert 1e-5 <= config["lr"] <= 1e-1
    assert 0.0 <= config["momentum"] <= 0.99
    want = tune_tpe_search.trainable(config)["score"]
    assert math.isclose(float(score_text), want, rel_tol=1e-12)
    worst = tune_tpe_search.trainable({"lr": 1e-1, "momentum": 0.0})["score"]
    assert float(score_text) > worst


def test_pbt_sweep_converges(capsys):
    tune_pbt_sweep.main()
    lines = capsys.readouterr().out.splitlines()
    (best,) = [x for x in lines if x.startswith("best:")]
    config_text, score = best[len("best: "):].rsplit(" ", 1)
    assert ast.literal_eval(config_text)["lr"] in (0.01, 0.1, 0.3, 0.5)
    assert float(score) > 90.0, lines
    # how many exploits happen rests on which trials report together,
    # which the box's load decides (0 on a loaded one, 4 alone)
    (perturbed,) = [x for x in lines if x.startswith("perturbations:")]
    assert int(perturbed.split(":")[1]) >= 0, lines
