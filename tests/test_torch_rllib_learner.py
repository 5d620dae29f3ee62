"""The port's RLlib modules and PPO learner against the JAX package's, on
the CPU.

The JAX package's params (init_params from a PRNG key) go through
params_from_jax into the port's modules, and the same inputs (numpy, from
np.random.default_rng) through both; f32 throughout, device="cpu".
Tolerances: Categorical logp, entropy, kl at rtol 1e-6 (one log-softmax,
the same sums), mode exactly; module forwards at atol 1e-5; the PPO loss
at rtol 1e-5 and each grad at rtol 1e-5 with an atol of 1e-5 times the
largest grad element of the model (a grad that is a sum cancelling far
below its terms, as the value head's bias here, carries their rounding); params after a 4-minibatch Learner.update sweep whose grad
clip fires, rtol 1e-4 with an atol of 1e-4 times the learning rate (four
Adam steps: f32 sums in another order, and the clip's divide; a bias the
steps carry back to near 0 is held to the steps' scale); the sweep's
mean stats at rtol 1e-4. Actions are
fixed, never sampled: the two RNGs differ. An EnvRunner fragment is held
to the JAX runner's in keys, shapes and dtypes only, and its logp to the
module's logp of the actions it took.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ray_tpu.rllib.algorithms.ppo.ppo import PPOConfig as JPPOConfig
from ray_tpu.rllib.algorithms.ppo.ppo import PPOLearner as JPPOLearner
from ray_tpu.rllib.core.catalog import DiscreteConvModule as JConv
from ray_tpu.rllib.core.catalog import DiscreteMLPModule as JMLP
from ray_tpu.rllib.core.rl_module import Categorical as JCategorical
from ray_tpu.rllib.env.env_runner import \
    SingleAgentEnvRunner as JEnvRunner
from ray_tpu_torch.rllib import (DiscreteConvModule, DiscreteMLPModule,
                                 params_from_jax)
from ray_tpu_torch.rllib.algorithms.ppo.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.core.rl_module import Categorical
from ray_tpu_torch.rllib.env.env_runner import SingleAgentEnvRunner

OBS = (84, 84, 4)


def _modules(kind):
    """(JAX module, its params as numpy, the port's module loaded from
    them)."""
    if kind == "mlp":
        jmod, mod = JMLP(4, 2, (32, 32)), DiscreteMLPModule(4, 2, (32, 32))
    else:
        jmod, mod = JConv(OBS, 3, dense=64), DiscreteConvModule(OBS, 3,
                                                                dense=64)
    params = jax.device_get(jax.jit(jmod.init_params)(jax.random.PRNGKey(3)))
    mod.load_state_dict(params_from_jax(mod, params))
    return jmod, params, mod


def _obs(kind, rng, n):
    if kind == "mlp":
        return rng.standard_normal((n, 4)).astype(np.float32)
    return rng.integers(0, 256, (n, *OBS)).astype(np.uint8)


def _batch(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": _obs(kind, rng, n),
        "actions": rng.integers(0, 2 if kind == "mlp" else 3,
                                n).astype(np.int32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": rng.standard_normal(n).astype(np.float32),
        "action_logp": (-0.7 + 0.2 * rng.standard_normal(n)).astype(
            np.float32),
        "vf_preds": rng.standard_normal(n).astype(np.float32),
    }


def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    a = (3 * rng.standard_normal((64, 5))).astype(np.float32)
    b = (3 * rng.standard_normal((64, 5))).astype(np.float32)
    actions = rng.integers(0, 5, 64).astype(np.int32)
    jd, jo = JCategorical(jnp.asarray(a)), JCategorical(jnp.asarray(b))
    td, to = Categorical(torch.from_numpy(a)), Categorical(torch.from_numpy(b))
    for got, want in [
            (td.logp(torch.from_numpy(actions)), jd.logp(jnp.asarray(actions))),
            (td.entropy(), jd.entropy()),
            (td.kl(to), jd.kl(jo))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(td.mode().numpy(), np.asarray(jd.mode()))


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_forward_train_matches_jax(kind):
    """The CNN at 84x84x4 holds the dense layer's rows to the JAX
    module's H, W, C flatten order."""
    jmod, params, mod = _modules(kind)
    obs = _obs(kind, np.random.default_rng(1), 4)
    want = jax.jit(jmod.forward_train)(params, {"obs": jnp.asarray(obs)})
    with torch.no_grad():
        got = mod.forward_train({"obs": torch.from_numpy(obs)})
    for k in ("action_dist_inputs", "vf_preds"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)


def _learners(kind, **training):
    jmod, params, mod = _modules(kind)
    jl = JPPOLearner(jmod, JPPOConfig().training(**training))
    jl.build(seed=3)  # the same params as _modules' PRNGKey(3)
    tl = PPOLearner(mod, PPOConfig().training(**training).learners(
        device="cpu"))
    tl.build(seed=0)
    tl.module.load_state_dict(params_from_jax(tl.module, params))
    return jl, tl


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_ppo_loss_and_grads_match_jax(kind):
    jl, tl = _learners(kind, entropy_coeff=0.01, clip_param=0.2,
                       vf_clip_param=1.0)
    batch = _batch(kind, 32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jl.compute_loss(p, jb, jl.extra_inputs()),
        has_aux=True))(jl._params)
    loss, stats = tl.compute_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        tl.extra_inputs())
    grads = torch.autograd.grad(loss, list(tl.module.parameters()))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for k, v in jstats.items():
        np.testing.assert_allclose(stats[k].item(), float(v), rtol=1e-5,
                                   atol=1e-7)
    want = params_from_jax(tl.module, jax.device_get(jgrads))
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for (name, _), g in zip(tl.module.named_parameters(), grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_clipped_update_sweep_matches_jax():
    """One Learner.update: 2 epochs x 2 minibatches of 32 from 64 rows,
    with a grad clip well under the grad norm, so optax's
    clip_by_global_norm fires on every step."""
    jl, tl = _learners("mlp", lr=1e-2, grad_clip=0.5, entropy_coeff=0.01)
    batch = _batch("mlp", 64, seed=2)
    want = jl.update(batch, minibatch_size=32, num_iters=2, seed=4)
    got = tl.update(batch, minibatch_size=32, num_iters=2, seed=4)
    assert want["grad_norm"] > 4 * 0.5  # the clip fired
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    params = params_from_jax(tl.module, jl.get_weights())
    for name, p in tl.module.state_dict().items():
        np.testing.assert_allclose(p.numpy(), params[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * 1e-2,
                                   err_msg=name)
    weights = tl.get_weights()  # CPU numpy, detached from the params
    assert all(isinstance(v, np.ndarray) for v in weights.values())


def test_adaptive_kl_coeff_matches_jax():
    jl, tl = _learners("mlp", kl_coeff=0.2, kl_target=0.01)
    for mean_kl in (0.05, 0.03, 0.01, 0.001, 0.02, 0.0049):
        assert tl.additional_update(mean_kl=mean_kl) == \
            jl.additional_update(mean_kl=mean_kl)
    assert tl.extra_inputs() == jl.extra_inputs()


def test_env_runner_fragment_matches_jax_runner():
    jmod, params, mod = _modules("mlp")
    jr = JEnvRunner("CartPole-v1", jmod, num_envs=3, seed=5)
    jr.set_weights(params)
    tr = SingleAgentEnvRunner("CartPole-v1", mod, num_envs=3, seed=5)
    tr.set_weights({k: v.numpy() for k, v in mod.state_dict().items()})
    # long enough that episodes end (CartPole's random policy: ~20 steps)
    want, got = jr.sample(120), tr.sample(120)
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("final_obs_idx", "final_obs_vals"):  # one row a done step
            assert (got[k].shape[1:], got[k].dtype) == \
                (v.shape[1:], v.dtype), k
        elif isinstance(v, np.ndarray):
            assert (got[k].shape, got[k].dtype) == (v.shape, v.dtype), k
        else:
            assert type(got[k]) is type(v), k
    assert got["episode_metrics"] and \
        set(got["episode_metrics"][0]) == set(want["episode_metrics"][0])
    with torch.no_grad():
        out = mod.forward_train(
            {"obs": torch.from_numpy(got["obs"].reshape(-1, 4))})
        logp = mod.action_dist(out["action_dist_inputs"]).logp(
            torch.from_numpy(got["actions"].reshape(-1)))
    np.testing.assert_allclose(got["action_logp"].reshape(-1), logp.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(got["vf_preds"].reshape(-1),
                               out["vf_preds"].numpy(), rtol=1e-6)
    assert tr.torch_state()["cuda_initialized"] is False
