"""The port's SklearnTrainer (a copy of the JAX package's under the rename
rule) on the CPU, held against the JAX package's.

The reference's own test (tests/test_train_extra_trainers.py:23-52, marked
slow) fits a LogisticRegression on 150 rows with 3-fold cross-validation.
Here its data go through both packages: the JAX package's trainer in a
subprocess of its own (its own ray_tpu.init, JAX_PLATFORMS=cpu), the
port's in this process, at the same time. Their train, valid and
cross-validation scores must be equal, the port's checkpointed estimator
must predict as the reference's does, and an estimator whose fit raises
comes back on Result.error in both, the same error.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch

REPO = Path(__file__).resolve().parent.parent

# the reference test's data (tests/test_train_extra_trainers.py:29-36)
DATA = """
import numpy as np
rng = np.random.default_rng(0)
n = 200
x0 = rng.normal(size=n)
x1 = rng.normal(size=n)
y = (x0 + x1 > 0).astype(np.int64)
train = {"x0": x0[:150], "x1": x1[:150], "label": y[:150]}
valid = {"x0": x0[150:], "x1": x1[150:], "label": y[150:]}
probe = np.random.default_rng(1).normal(size=(64, 2))
"""

# both runs: the fit with cross-validation, the predictions of the
# checkpointed estimator on `probe`, and a fit that raises (C < 0)
RUN = DATA + """
import pickle
from sklearn.linear_model import LogisticRegression


def run(pkg, storage):
    from importlib import import_module
    train_mod = import_module(pkg + ".train")
    config = import_module(pkg + ".train.config")
    result = train_mod.SklearnTrainer(
        estimator=LogisticRegression(),
        datasets={"train": train, "valid": valid},
        label_column="label", cv=3,
        run_config=config.RunConfig(storage_path=storage)).fit()
    assert result.error is None, result.error
    with open(result.checkpoint.path + "/estimator.pkl", "rb") as f:
        est = pickle.load(f)
    bad = train_mod.SklearnTrainer(
        estimator=LogisticRegression(), params={"C": -1.0},
        datasets={"train": train}, label_column="label",
        run_config=config.RunConfig(storage_path=storage)).fit()
    return {"metrics": {k: v for k, v in result.metrics.items()
                        if k != "fit_time"},
            "history": len(result.metrics_history),
            "predict": est.predict(probe).tolist(),
            "proba": est.predict_proba(probe).tolist(),
            "error": None if bad.error is None else [
                type(bad.error).__name__, "'C' parameter" in str(bad.error)],
            "bad_checkpoint": bad.checkpoint}
"""

REFERENCE = RUN + """
import json, sys
import ray_tpu
ray_tpu.init(num_cpus=2)
try:
    out = run("ray_tpu", sys.argv[1])
finally:
    ray_tpu.shutdown()
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(the JAX package's run, the port's run), made at the same time."""
    root = tmp_path_factory.mktemp("sklearn")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(root / "jax")], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        scope = {}
        exec(RUN, scope)
        ray_tpu_torch.init(num_cpus=2)
        try:
            port = scope["run"]("ray_tpu_torch", str(root / "port"))
        finally:
            ray_tpu_torch.shutdown()
        out, err = ref.communicate(timeout=120)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), port


def test_scores_equal_the_reference(both):
    ref, port = both
    assert set(port["metrics"]) == set(ref["metrics"]) == {
        "train_score", "valid_score", "cv_scores", "cv_score_mean"}
    assert port["metrics"] == ref["metrics"]
    assert len(port["metrics"]["cv_scores"]) == 3
    # the reference test's bars
    assert port["metrics"]["train_score"] > 0.9
    assert port["metrics"]["valid_score"] > 0.8
    assert port["history"] == ref["history"] == 1


def test_checkpointed_estimator_predicts_as_the_reference(both):
    ref, port = both
    assert port["predict"] == ref["predict"]
    np.testing.assert_allclose(port["proba"], ref["proba"], rtol=1e-12)


def test_estimator_that_raises_comes_back_on_result_error(both):
    ref, port = both
    assert port["error"] == ref["error"]
    assert port["error"][1], port["error"]
    assert port["bad_checkpoint"] is None
    assert ref["bad_checkpoint"] is None

