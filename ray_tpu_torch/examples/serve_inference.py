"""Serve deployment with request batching (MXU-friendly inference)."""

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import serve


def main():
    ray_tpu_torch.init(num_cpus=2)

    @serve.deployment(num_replicas=1, max_concurrent_queries=16)
    class Model:
        def __init__(self):
            rng = np.random.default_rng(0)
            self.w = rng.standard_normal((4, 2)).astype(np.float32)

        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        def predict(self, xs):
            batch = np.stack(xs)          # one fused forward pass
            return list(batch @ self.w)

        def __call__(self, x):
            return self.predict(np.asarray(x, np.float32))

    handle = serve.run(Model.bind())
    refs = [handle.remote([1.0, 2.0, 3.0, 4.0]) for _ in range(8)]
    outs = ray_tpu_torch.get(refs, timeout=60)
    print("predictions:", np.stack(outs).shape)

    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
