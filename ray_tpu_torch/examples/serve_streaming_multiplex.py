"""Serve round-4 features: streaming responses + model multiplexing.

Run: python -m ray_tpu_torch.examples.serve_streaming_multiplex

Demonstrates (reference: serve streaming responses proxy.py:556 and
serve.multiplexed / get_multiplexed_model_id):
- a generator deployment streamed chunk by chunk while it produces,
- a multi-model deployment with a per-replica LRU of loaded models and
  router affinity for replicas that already hold the requested model.
"""

import ray_tpu_torch
from ray_tpu_torch import serve


@serve.deployment
class TokenStreamer:
    """Stands in for an LLM decode loop: yields tokens as produced."""

    def __call__(self, prompt: str):
        for word in prompt.upper().split():
            yield word + " "


@serve.deployment(num_replicas=2)
class MultiModel:
    """One deployment serving many fine-tunes: models load on demand
    and stay cached per replica (LRU, 2 models per replica here)."""

    @serve.multiplexed(max_num_models_per_replica=2)
    def get_model(self, model_id: str):
        # stand-in for loading an orbax checkpoint onto the chip
        return {"id": model_id, "scale": len(model_id)}

    def __call__(self, x: float) -> float:
        model = self.get_model(serve.get_multiplexed_model_id())
        return x * model["scale"]


def main() -> None:
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)

    streamer = serve.run(TokenStreamer)
    print("streaming:", end=" ")
    for chunk in streamer.options(stream=True).remote(
            "hello tpu serving world"):
        print(chunk, end="", flush=True)
    print()

    models = serve.run(MultiModel)
    for model_id in ("adapter-a", "adapter-bb", "adapter-a"):
        out = ray_tpu_torch.get(models.options(
            multiplexed_model_id=model_id).remote(10.0), timeout=120)
        print(f"model {model_id}: f(10) = {out}")

    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
