"""IMPALA on MiniPong: the Atari-class pixel pipeline end to end.

Run: python -m ray_tpu_torch.examples.rllib_impala_minipong

North-star configs #2/#3 shape (BASELINE.md): CPU EnvRunner actors
step a pixel environment through the DeepMind preprocessing stack
(MaxAndSkip -> WarpFrame 84x84 grayscale -> FrameStack 4 -> uint8
[84,84,4] observations), trajectories ship through the object store,
and the IMPALA learner (async V-trace, Nature-CNN RLModule, jitted
update) trains on the accelerator. MiniPong is the procedurally
generated Pong-class stand-in (ALE isn't installable here); with the
ALE present, `gymnasium.make("ALE/Pong-v5")` plugs into the same
wrappers through the gymnasium adapter.
"""

import time

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithms.impala import ImpalaConfig


def main(seconds=900, device=None) -> None:
    ray_tpu_torch.init(num_cpus=4, ignore_reinit_error=True)
    config = (ImpalaConfig()
              .environment("MiniPong-v0",
                           env_config={"paddle_w": 5, "max_returns": 3,
                                       "speeds": (-0.5, 0.5)})
              .env_runners(num_env_runners=2,
                           num_envs_per_env_runner=4,
                           rollout_fragment_length=32)
              .training(train_batch_size=256, lr=6e-4,
                        entropy_coeff=0.02, vf_loss_coeff=0.5)
              .debugging(seed=0)
              .learners(device=device))
    algo = config.build()
    t0 = time.time()
    try:
        while time.time() - t0 < seconds:
            result = algo.train()
            rew = result.get("episode_reward_mean")
            if rew is not None:
                print(f"t={time.time() - t0:5.0f}s "
                      f"reward_mean={rew:+.2f}", flush=True)
            if rew is not None and rew >= 1.0:
                print("solved: averaging a net positive score")
                break
    finally:
        algo.stop()
        ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
