"""Core API tour: tasks, actors, objects, placement groups."""

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.util import placement_group, remove_placement_group


def main():
    ray_tpu_torch.init(num_cpus=4)

    # --- tasks -------------------------------------------------------
    @ray_tpu_torch.remote
    def square(x):
        return x * x

    print("squares:", ray_tpu_torch.get([square.remote(i) for i in range(8)]))

    # --- objects -----------------------------------------------------
    big = ray_tpu_torch.put(np.arange(1_000_000))

    @ray_tpu_torch.remote
    def total(arr):
        return int(arr.sum())

    print("sum:", ray_tpu_torch.get(total.remote(big)))

    # --- actors (with a named concurrency group) ---------------------
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self, k=1):
            self.n += k
            return self.n

        @ray_tpu_torch.method(concurrency_group="io")
        def ping(self):
            return "pong"

    c = Counter.options(concurrency_groups={"io": 2}).remote()
    print("count:", ray_tpu_torch.get([c.incr.remote() for _ in range(5)]))
    print("ping:", ray_tpu_torch.get(c.ping.remote()))

    # --- placement group (gang reservation) --------------------------
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ray_tpu_torch.get(pg.ready())
    print("placement group ready:", pg.bundle_specs)
    remove_placement_group(pg)

    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
