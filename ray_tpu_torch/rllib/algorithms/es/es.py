"""ES: OpenAI-style evolution strategies (derivative-free).

The port's counterpart of ray_tpu/rllib/algorithms/es/es.py (reference
parity: rllib/algorithms/es/es.py (ES Algorithm: the algorithm holds flat
params; Worker actors evaluate mirrored gaussian perturbations and return
episode rewards; the update is the rank-weighted sum of noise, es.py
_train + optimizers.py Adam; utils.py compute_centered_ranks)).
Perturbation noise regenerates from integer seeds on both sides (only
seeds + returns cross the object store; reference SharedNoiseTable
serves the same purpose), and episode policy forwards run on the
evaluation workers' CPU. The flat parameter vector theta is the JAX
package's ravel_pytree order and layout (catalog.flat_order), so one
seed perturbs the same weights in both packages; theta's Adam step runs
on the host as optax.adam's does, and the learner's weights on its
device are set from theta after every step.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.core.catalog import flat_order
from ray_tpu_torch.rllib.core.learner import Learner


class ESConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class=algo_class or ES)
        self.lr = 0.02
        self.sigma = 0.05               # perturbation stddev
        self.num_perturbations = 32     # mirrored pairs per iteration
        self.num_workers = 0            # 0 -> evaluate in-process
        self.episode_horizon = 1000
        self.l2_coeff = 0.005
        self.report_length = 10


def compute_centered_ranks(x: np.ndarray) -> np.ndarray:
    """reference es/utils.py: ranks scaled to [-0.5, 0.5]."""
    ranks = np.empty(x.size, dtype=np.float64)
    ranks[x.ravel().argsort()] = np.arange(x.size)
    ranks = ranks.reshape(x.shape) / (x.size - 1) - 0.5
    return ranks


def adam_init(theta: np.ndarray) -> Dict[str, Any]:
    return {"mu": np.zeros_like(theta), "nu": np.zeros_like(theta),
            "count": 0}


def adam_update(step: np.ndarray, state: Dict[str, Any], lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
                ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """optax.adam(lr)'s update on an f32 vector, in numpy: f32 moments,
    bias correction by 1 - b^t, eps outside the square root, the update
    scaled by -lr. Returns (updates, new state)."""
    f32 = np.float32
    mu = f32(1 - b1) * step + f32(b1) * state["mu"]
    nu = f32(1 - b2) * (step * step) + f32(b2) * state["nu"]
    count = state["count"] + 1
    mu_hat = mu / (f32(1) - f32(b1) ** f32(count))
    nu_hat = nu / (f32(1) - f32(b2) ** f32(count))
    updates = mu_hat / (np.sqrt(nu_hat) + f32(eps)) * f32(-lr)
    return updates.astype(np.float32), {"mu": mu, "nu": nu,
                                        "count": count}


class _ESLearner(Learner):
    """Parameter container only — ES has no gradient loss; the algorithm
    sets the learner's weights from theta after each step."""

    def compute_loss(self, batch, extra):  # pragma: no cover
        raise NotImplementedError("ES does not use gradient updates")


class ESEvalWorker:
    """Evaluates mirrored perturbations on the CPU: noise regenerates
    from seeds."""

    def __init__(self, env_name: str, env_config: Optional[dict],
                 module: Any, sigma: float, horizon: int):
        from ray_tpu_torch._private import worker as worker_mod
        w = worker_mod.global_worker_or_none()
        if w is not None and w.mode == "worker":
            # an actor's process: the evaluation workers of one node
            # share its cores
            torch.set_num_threads(1)
        import copy

        from ray_tpu_torch.rllib.env.base import make_env
        self.env = make_env(env_name, env_config)
        # the worker's own CPU copy, loaded from each perturbed theta
        self.module = copy.deepcopy(module).to("cpu").eval()
        self.sigma = sigma
        self.horizon = horizon
        self._order = flat_order(self.module)
        self.dim = self._order.dim

    @torch.inference_mode()
    def _episode_return(self, flat_params: np.ndarray,
                        ep_seed: int) -> Tuple[float, int]:
        self.module.load_state_dict(
            {k: torch.from_numpy(v)
             for k, v in self._order.unflatten(flat_params).items()})
        obs, _ = self.env.reset(ep_seed)
        total, steps = 0.0, 0
        for _ in range(self.horizon):
            action = self.module.forward_inference(
                {"obs": torch.from_numpy(np.asarray(obs)[None])}
            )["actions"][0].numpy()
            obs, r, term, trunc, _ = self.env.step(action)
            total += float(r)
            steps += 1
            if term or trunc:
                break
        return total, steps

    def evaluate(self, flat_params: np.ndarray, noise_seeds: List[int],
                 ep_seed: int) -> List[Dict[str, Any]]:
        out = []
        for seed in noise_seeds:
            noise = np.random.default_rng(seed).standard_normal(
                self.dim).astype(np.float32)
            r_pos, s1 = self._episode_return(
                flat_params + self.sigma * noise, ep_seed)
            r_neg, s2 = self._episode_return(
                flat_params - self.sigma * noise, ep_seed)
            out.append({"seed": seed, "r_pos": r_pos, "r_neg": r_neg,
                        "steps": s1 + s2})
        return out


class ES(Algorithm):
    learner_cls = _ESLearner
    needs_env_runners = False  # ES evaluates perturbations itself

    def __init__(self, config: "ESConfig"):
        super().__init__(config)
        self._order = flat_order(self.module)
        # theta lives on the host (numpy optimizer loop), f32 as the
        # JAX package keeps it
        self._theta = self._order.flatten(self.learner_group.get_weights())
        self.dim = self._theta.shape[0]
        self._opt_state = adam_init(self._theta)
        self._rng = np.random.default_rng(config.seed)
        self._eval_workers: List[Any] = []
        if config.num_workers > 0:
            import ray_tpu_torch
            cls = ray_tpu_torch.remote(ESEvalWorker)
            self._eval_workers = [
                cls.options(num_cpus=1).remote(
                    config.env, config.env_config, self.module,
                    config.sigma, config.episode_horizon)
                for _ in range(config.num_workers)]
        else:
            self._local_eval = ESEvalWorker(
                config.env, config.env_config, self.module,
                config.sigma, config.episode_horizon)

    def _evaluate_all(self, seeds: List[int], ep_seed: int
                      ) -> List[Dict[str, Any]]:
        flat32 = self._theta.astype(np.float32)
        if not self._eval_workers:
            return self._local_eval.evaluate(flat32, seeds, ep_seed)
        import ray_tpu_torch
        n = len(self._eval_workers)
        chunks = [(i, seeds[i::n]) for i in range(n) if seeds[i::n]]
        refs = [self._eval_workers[i].evaluate.remote(flat32, chunk, ep_seed)
                for i, chunk in chunks]
        # back in the seeds' order, as the local evaluation returns them:
        # the centered ranks break ties by position, so another order
        # gives another update
        out: List[Dict[str, Any]] = [{} for _ in seeds]
        for (i, _), part in zip(chunks, ray_tpu_torch.get(refs,
                                                          timeout=600)):
            out[i::n] = part
        return out

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        seeds = [int(s) for s in
                 self._rng.integers(0, 2 ** 31 - 1,
                                    cfg.num_perturbations)]
        ep_seed = int(self._rng.integers(0, 2 ** 31 - 1))
        results = self._evaluate_all(seeds, ep_seed)

        returns = np.array([[r["r_pos"], r["r_neg"]] for r in results])
        ranks = compute_centered_ranks(returns)
        # rank-weighted noise combination (reference es.py _train):
        # g = 1/(n*sigma) * sum_i (rank+_i - rank-_i) * eps_i, in f64
        grad = np.zeros(self.dim)
        for r, (w_pos, w_neg) in zip(results, ranks):
            noise = np.random.default_rng(r["seed"]).standard_normal(
                self.dim)
            grad += (w_pos - w_neg) * noise
        grad /= len(results) * cfg.sigma
        # ascent on reward, with L2 pull toward 0 (reference l2_coeff)
        step = (-(grad - cfg.l2_coeff * self._theta)).astype(np.float32)
        updates, self._opt_state = adam_update(step, self._opt_state,
                                               cfg.lr)
        self._theta = np.asarray(self._theta + updates, np.float32)

        self.learner_group.set_weights(self._order.unflatten(self._theta))
        self._timesteps_total += int(sum(r["steps"] for r in results))
        for r in results:
            for ret in (r["r_pos"], r["r_neg"]):
                self._episode_returns.append(ret)
                self._episode_lens.append(r["steps"] // 2)
        mean_ret = float(returns.mean())
        return {"learner": {"mean_perturbation_return": mean_ret,
                            "theta_norm": float(
                                np.linalg.norm(self._theta))},
                "num_env_steps_sampled":
                    int(sum(r["steps"] for r in results))}

    def _extra_state(self) -> Dict[str, Any]:
        return {"theta": self._theta.copy(),
                "opt_state": {k: (v.copy() if isinstance(v, np.ndarray)
                                  else v)
                              for k, v in self._opt_state.items()}}

    def _restore_extra_state(self, extra: Dict[str, Any]) -> None:
        if "theta" in extra:
            self._theta = extra["theta"]
            self._opt_state = extra["opt_state"]

    def stop(self) -> None:
        import ray_tpu_torch
        for w in self._eval_workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001 - worker already dead
                pass
        local = getattr(self, "_local_eval", None)
        if local is not None:
            local.env.close()
        super().stop()
