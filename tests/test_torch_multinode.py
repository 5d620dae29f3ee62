"""The port across node managers, on the CPU: one Cluster whose head
holds no GPU (and no CPU), and two added nodes started under
CUDA_VISIBLE_DEVICES "0,1" and "2,3" with one CPU each, which is what two
hosts of two cards look like to the runtime. Each node's CPU takes one
learner rank or one ES actor, so those spread one a node; a train worker
asks half a CPU and one GPU, so the four take two a node.

- One TorchTrainer.fit() of four gloo workers (use_gpu=True, the loop
  touching no CUDA): the workers of one node see "0" and "1", those of
  the other "2" and "3"; make_multislice_mesh(2 x (fsdp=2)) from the
  runtime's own node ids puts each node's ranks in one dcn row; three
  AdamW steps of TINY (f32) from the JAX package's Transformer.init
  params (params_from_jax), the batch over ("dcn", "data", "fsdp"),
  against the JAX make_train_step on the same mesh over four of the
  virtual devices: loss and grad norm each step to rtol 1e-4, the final
  params to the bars of tests/test_torch_mesh_steps.py.
- A two-policy PPO gang, one gloo rank a node, each rank pulling its
  batch from the head's object store: three full-batch steps equal one
  local learner's at the bars of tests/test_torch_multi_agent.py's gang
  test, and the two ranks' weights equal to the bit.
- ES with two evaluation actors, one on each node: two iterations give
  the theta of the local evaluation (num_workers=0).
"""

import numpy as np
import pytest

import jax
import optax

import ray_tpu_torch
from ray_tpu.models import TINY as JTINY
from ray_tpu.models import Transformer as JTransformer
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import MultiSliceConfig as JMultiSliceConfig
from ray_tpu.parallel import ShardingRules as JShardingRules
from ray_tpu.parallel import make_multislice_mesh as jax_multislice_mesh
from ray_tpu.parallel.train_step import make_train_step as jax_make_train_step
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.rllib import (DiscreteMLPModule, ESConfig, LearnerGroup,
                                 MultiAgentRLModule, PPOConfig)
from ray_tpu_torch.rllib.algorithms.ppo.ppo import MultiAgentPPOLearner
from ray_tpu_torch.util import state as state_api

NODE_CARDS = ("0,1", "2,3")
STEPS = 3
LR = 1e-3
JCFG = JTINY.replace(dtype="float32")
MIDS = ("pol_a", "pol_b")


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(head_node_args={"num_cpus": 0, "resources": {"GPU": 0}})
    try:
        nodes = [c.add_node(num_cpus=1, env={"CUDA_VISIBLE_DEVICES": cards})
                 for cards in NODE_CARDS]
        c.connect()
        yield c, [n.node_id_hex for n in nodes]
    finally:
        c.shutdown()


def _flat(tree):
    out = {}
    for k, v in tree.items():
        if k == "layers":
            out.update({f"layers.{n}": np.asarray(a) for n, a in v.items()})
        else:
            out[k] = np.asarray(v)
    return out


def _jax_run(params, batch):
    mesh = jax_multislice_mesh(JMultiSliceConfig(
        num_slices=2, per_slice=JMeshConfig(fsdp=2)),
        devices=jax.devices()[:4])
    rules = JShardingRules().replace(batch=("dcn", "data", "fsdp"))
    init, step = jax_make_train_step(
        lambda p, b: JTransformer.loss(p, b, JCFG, mesh=mesh, rules=rules),
        JTransformer.param_specs(JCFG), mesh, rules=rules,
        optimizer=optax.adamw(LR, weight_decay=0.01))
    state = init(jax.tree.map(jax.numpy.asarray, params))
    losses, gnorms = [], []
    for _ in range(STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return losses, gnorms, _flat(jax.device_get(state["params"]))


@pytest.fixture(scope="module")
def trained(cluster, tmp_path_factory):
    from ray_tpu_torch.train import (RunConfig, ScalingConfig, TorchConfig,
                                     TorchTrainer)

    # defined here: a worker cannot import a test module, and a nested
    # function rides by value
    def loop(config):
        """Each worker: its node and cards, then the sharded TINY step on
        2 x (fsdp=2) with the node ids the runtime gives; rank 0 reports."""
        import os

        import torch
        import torch.distributed as dist

        from ray_tpu_torch import get_runtime_context, train
        from ray_tpu_torch.models import TINY, Transformer
        from ray_tpu_torch.models.convert import params_from_jax
        from ray_tpu_torch.parallel import (MeshConfig, MultiSliceConfig,
                                            ShardingRules,
                                            make_multislice_mesh)
        from ray_tpu_torch.parallel.train_step import adamw, make_train_step

        torch.set_num_threads(1)
        me = {"rank": dist.get_rank(),
              "node": get_runtime_context().get_node_id(),
              "cards": os.environ.get("CUDA_VISIBLE_DEVICES"),
              "cuda_initialized": torch.cuda.is_initialized()}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, me)
        cfg = TINY.replace(dtype="float32")
        mesh = make_multislice_mesh(MultiSliceConfig(
            num_slices=2, per_slice=MeshConfig(fsdp=2)), device="cpu")
        rules = ShardingRules().replace(batch=("dcn", "data", "fsdp"))
        model = Transformer(cfg, device="meta")
        model.load_state_dict(params_from_jax(
            config["params"], cfg, "cpu", mesh=mesh, rules=rules),
            assign=True)
        init, step = make_train_step(
            lambda p, b: model.loss(b, mesh=mesh, rules=rules),
            Transformer.param_specs(cfg), mesh,
            optimizer=adamw(config["lr"], weight_decay=0.01), rules=rules,
            device="cpu")
        state = init(model)
        losses, gnorms = [], []
        for _ in range(config["steps"]):
            state, m = step(state, config["batch"])
            losses.append(m["loss"].item())
            gnorms.append(m["grad_norm"].item())
        params = {n: p.full_tensor().detach().numpy()
                  for n, p in state["params"].items()}
        train.report({"ranks": ranks, "mesh_names": mesh.mesh_dim_names,
                      "dcn_rows": mesh.mesh.reshape(2, -1).tolist(),
                      "loss": losses, "grad_norm": gnorms, "params": params})

    params = jax.tree.map(np.asarray,
                          JTransformer.init(jax.random.PRNGKey(0), JCFG))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, JCFG.vocab_size, (8, 33)
                                    ).astype(np.int32)}
    result = TorchTrainer(
        loop,
        train_loop_config={"params": params, "batch": batch, "lr": LR,
                           "steps": STEPS},
        scaling_config=ScalingConfig(
            num_workers=4, resources_per_worker={"CPU": 0.5, "GPU": 1}),
        torch_config=TorchConfig(backend="gloo"),
        run_config=RunConfig(storage_path=str(
            tmp_path_factory.mktemp("multinode")))).fit()
    assert result.error is None, result.error
    return result.metrics, _jax_run(params, batch)


def test_each_node_advertises_two_gpus_and_the_head_none(cluster):
    c, nodes = cluster
    by_id = {n["node_id"]: n for n in state_api.list_nodes()}
    assert by_id[c.head_node.node_id_hex]["resources_total"].get(
        "GPU", 0.0) == 0.0
    for node in nodes:
        assert by_id[node]["resources_total"]["GPU"] == 2.0


def test_workers_see_their_own_nodes_cards(cluster, trained):
    _, nodes = cluster
    ranks = trained[0]["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    cards = {}
    for r in ranks:
        cards.setdefault(r["node"], []).append(r["cards"])
        assert not r["cuda_initialized"]
    assert set(cards) == set(nodes)
    assert sorted(sorted(v) for v in cards.values()) == [["0", "1"],
                                                         ["2", "3"]]
    # the node started under "2,3" hands out its own cards
    assert sorted(cards[nodes[1]]) == ["2", "3"]


def test_dcn_rows_are_the_nodes_ranks(trained):
    m = trained[0]
    assert m["mesh_names"] == ("dcn", "data", "fsdp", "tensor")
    node_of = {r["rank"]: r["node"] for r in m["ranks"]}
    rows = m["dcn_rows"]
    assert sorted(r for row in rows for r in row) == [0, 1, 2, 3]
    row_nodes = [{node_of[r] for r in row} for row in rows]
    assert all(len(s) == 1 for s in row_nodes)
    assert row_nodes[0] != row_nodes[1]


def test_loss_and_grad_norm_match_jax(trained):
    got, (losses, gnorms, _) = trained
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], gnorms, rtol=1e-4)
    assert got["loss"][-1] < got["loss"][0]


def test_final_params_match_jax(trained):
    got, (_, _, want_params) = trained
    assert set(got["params"]) == set(want_params)
    outside, total = 0, 0
    for name, want in want_params.items():
        a = got["params"][name]
        off = np.abs(a - want) > 1e-5 + 1e-4 * np.abs(want)
        outside, total = outside + int(off.sum()), total + a.size
        assert np.abs(a - want).max() <= 2 * LR * STEPS, name
    assert outside <= 1e-4 * total, outside


def _ppo_batch(sizes, seed):
    rng = np.random.default_rng(seed)
    return {mid: {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": rng.standard_normal(n).astype(np.float32),
        "action_logp": (-0.7 + 0.1 * rng.standard_normal(n)).astype(
            np.float32),
        "vf_preds": rng.standard_normal(n).astype(np.float32)}
        for mid, n in sizes.items()}


def test_two_policy_ppo_gang_one_rank_a_node_equals_one_learner(cluster):
    _, nodes = cluster
    cfg = PPOConfig().training(lr=1e-2).learners(device="cpu")
    module = MultiAgentRLModule({m: DiscreteMLPModule(4, 2, (16, 16))
                                 for m in MIDS})

    def factory():
        return MultiAgentPPOLearner(module, cfg)

    batch = _ppo_batch({"pol_a": 64, "pol_b": 32}, seed=0)
    local = LearnerGroup(factory, num_learners=0, seed=5)
    s_local = local.update(batch, minibatch_size=None, num_iters=3, seed=0)
    w_local = local.get_weights()
    gang = LearnerGroup(factory, num_learners=2, seed=5)
    try:
        where = ray_tpu_torch.get([a.node_id.remote() for a in gang._actors],
                                  timeout=60)
        s_gang = gang.update(batch, minibatch_size=None, num_iters=3,
                             seed=0)
        ranks = ray_tpu_torch.get([a.get_weights.remote()
                                   for a in gang._actors], timeout=60)
    finally:
        gang.shutdown()
    assert sorted(where) == sorted(nodes)
    for k in ("total_loss", "grad_norm", "pol_a/policy_loss"):
        np.testing.assert_allclose(s_gang[k], s_local[k], rtol=1e-5,
                                   err_msg=k)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    diff = max(float(np.abs(w_local[k] - ranks[0][k]).max())
               for k in w_local)
    assert diff < 1e-6, diff


def test_es_evaluation_actors_on_both_nodes_give_the_local_theta(cluster):
    _, nodes = cluster

    def config(workers):
        return (ESConfig().environment("CartPole-v1")
                .training(lr=0.03, sigma=0.1, num_perturbations=4,
                          episode_horizon=50, num_workers=workers)
                .rl_module(model_hiddens=(32, 32)).debugging(seed=0)
                .learners(device="cpu"))

    local, remote = config(0).build(), config(2).build()
    try:
        for _ in range(2):
            local.train()
            remote.train()
        actors = [a["node_id"] for a in state_api.list_actors(
            {"class_name": "ESEvalWorker", "state": "ALIVE"})]
        np.testing.assert_array_equal(remote._theta, local._theta)
    finally:
        remote.stop()
        local.stop()
    assert sorted(actors) == sorted(nodes)
    assert sorted(remote._episode_returns) == sorted(local._episode_returns)
