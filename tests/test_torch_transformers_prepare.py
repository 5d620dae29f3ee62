"""The port's prepare_trainer (transformers_trainer.py, a copy of the JAX
package's under the rename rule) on one HF Trainer, held against the JAX
package's, in this process.

Each package's prepare_trainer, called twice on a Trainer of the
reference test's tiny BERT (a BertConfig, no download:
tests/test_train_extra_trainers.py:62-90), attaches its report callback
once, and both leave the same callbacks. The callback is found by its
class name, which the two packages share, so one package's call after
the other's attaches nothing more. The callback turns HF's numeric logs
into one report each (with the step) in both packages.
"""

import os

import pytest

from ray_tpu.train import transformers_trainer as jax_transformers
from ray_tpu_torch.train import transformers_trainer as transformers_port

CALLBACK = "_RayTpuReportCallback"


@pytest.fixture(scope="module")
def make_trainer(tmp_path_factory):
    # transformers finds TensorFlow and Flax at import unless told not to
    # look (TensorFlow's import takes tens of seconds here)
    saved = {k: os.environ.get(k) for k in ("USE_TF", "USE_FLAX",
                                            "USE_TORCH")}
    os.environ.update(USE_TF="0", USE_FLAX="0", USE_TORCH="1")
    try:
        import torch
        from transformers import (BertConfig, BertForSequenceClassification,
                                  Trainer, TrainingArguments)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = tmp_path_factory.mktemp("hf")

    def make():
        torch.manual_seed(0)
        model = BertForSequenceClassification(BertConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_labels=2))
        args = TrainingArguments(
            output_dir=str(out), max_steps=3, per_device_train_batch_size=8,
            report_to=[], use_cpu=True, logging_steps=1, disable_tqdm=True,
            save_strategy="no")
        return Trainer(model=model, args=args)
    return make


def _callbacks(trainer):
    return [type(cb).__name__ for cb in trainer.callback_handler.callbacks]


def test_prepare_twice_attaches_one_callback_as_the_reference(make_trainer):
    lists = []
    for module in (jax_transformers, transformers_port):
        trainer = make_trainer()
        before = _callbacks(trainer)
        assert module.prepare_trainer(trainer) is trainer
        assert module.prepare_trainer(trainer) is trainer
        after = _callbacks(trainer)
        assert after.count(CALLBACK) == 1, after
        assert after == before + [CALLBACK]
        lists.append(after)
    assert lists[0] == lists[1]


def test_one_package_after_the_other_attaches_nothing_more(make_trainer):
    trainer = make_trainer()
    jax_transformers.prepare_trainer(trainer)
    transformers_port.prepare_trainer(trainer)
    assert _callbacks(trainer).count(CALLBACK) == 1


def test_callback_reports_numeric_logs_with_the_step(make_trainer,
                                                     monkeypatch):
    import ray_tpu.train as jax_train
    import ray_tpu_torch.train as port_train
    reports = {}
    for name, module, train_mod in (("jax", jax_transformers, jax_train),
                                    ("port", transformers_port, port_train)):
        got = reports.setdefault(name, [])
        monkeypatch.setattr(train_mod, "report",
                            lambda m, checkpoint=None, got=got: got.append(m))
        trainer = module.prepare_trainer(make_trainer())
        callback = next(cb for cb in trainer.callback_handler.callbacks
                        if type(cb).__name__ == CALLBACK)
        trainer.state.global_step = 7
        callback.on_log(trainer.args, trainer.state, trainer.control,
                        logs={"loss": 0.5, "learning_rate": 1e-3,
                              "note": "text"})
        callback.on_log(trainer.args, trainer.state, trainer.control,
                        logs={})
    assert reports["port"] == reports["jax"] == [
        {"loss": 0.5, "learning_rate": 1e-3, "step": 7}]
