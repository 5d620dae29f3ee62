"""The port's TransformersTrainer (a copy of the JAX package's under the
rename rule) fine-tunes the reference test's tiny BERT on the CPU.

The reference's test (tests/test_train_extra_trainers.py:55-90, slow)
builds the model from a BertConfig (no download) in each worker's
trainer_init_per_worker and takes 3 steps through the gang and the
report callback; here the port's trainer does the same in one CPU
worker, and its metrics_history holds HF's loss logs, one a step, with
the steps in order. The worker's transformers import is told not to
look for TensorFlow and Flax (their imports take tens of seconds here).
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.train import (RunConfig, ScalingConfig,
                                 TransformersTrainer)

QUIET = {"USE_TF": "0", "USE_FLAX": "0", "USE_TORCH": "1"}


@pytest.fixture()
def cluster():
    """A cluster whose workers inherit QUIET."""
    saved = {k: os.environ.get(k) for k in QUIET}
    os.environ.update(QUIET)
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_tiny_bert_fit_reports_hf_loss_logs(cluster, tmp_path):
    # defined here, so that the worker gets it by value
    def trainer_init(config):
        import torch
        from transformers import (BertConfig, BertForSequenceClassification,
                                  Trainer, TrainingArguments)

        torch.set_num_threads(1)
        model = BertForSequenceClassification(BertConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32, num_labels=2))

        class DS(torch.utils.data.Dataset):
            def __len__(self):
                return 64

            def __getitem__(self, i):
                g = torch.Generator().manual_seed(i)
                ids = torch.randint(0, 64, (16,), generator=g)
                return {"input_ids": ids,
                        "attention_mask": torch.ones(16, dtype=torch.long),
                        "labels": torch.tensor(i % 2)}

        args = TrainingArguments(
            output_dir=config["out"], max_steps=3,
            per_device_train_batch_size=8, report_to=[],
            use_cpu=True, logging_steps=1,
            disable_tqdm=True, save_strategy="no")
        return Trainer(model=model, args=args, train_dataset=DS())

    result = TransformersTrainer(
        trainer_init,
        trainer_init_config={"out": str(tmp_path / "hf")},
        scaling_config=ScalingConfig(num_workers=1,
                                     resources_per_worker={"CPU": 1}),
        run_config=RunConfig(storage_path=str(tmp_path / "runs")),
    ).fit()
    assert result.error is None, result.error
    history = result.metrics_history
    losses = [m for m in history if "loss" in m]
    assert [m["step"] for m in losses] == [1, 2, 3], history
    for m in losses:
        assert isinstance(m["loss"], float) and m["loss"] > 0
    # the last log is HF's summary of the run (train_loss, runtime)
    assert any("train_loss" in m for m in history), history
