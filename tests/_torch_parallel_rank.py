"""One rank of the data-parallel tests (``tests/test_torch_parallel.py``),
run as its own process on the CPU with one torch thread.

    python tests/_torch_parallel_rank.py train <torch_multihost_train args>
    python tests/_torch_parallel_rank.py update IN OUT INIT_METHOD WORLD RANK

``train`` runs ``scripts/torch_multihost_train.py``'s ``main`` with the
plain twins' calls counted as the kernels' launches (on the CPU the
wrappers run the twins, which count nothing).  ``update`` runs the port's
PPO ``update`` on one rank of a gloo group, for each case in ``IN`` (a
``torch.save`` of the slab, the parameters and the injected shuffles),
and saves the parameters and loss parts of each to ``OUT``, with what
``local_batch_slice`` gave on that rank.
"""
import importlib.util
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def count_twins():
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import step as k1
    step_plain, lidar_plain = k1.step_plain, k2.lidar_plain

    def counted_step(*args, **kw):
        k1.step_fused.launches += 1
        return step_plain(*args, **kw)

    def counted_lidar(*args, **kw):
        k2.lidar.launches += 1
        return lidar_plain(*args, **kw)

    k1.step_plain, k2.lidar_plain = counted_step, counted_lidar


def train(argv):
    count_twins()
    spec = importlib.util.spec_from_file_location(
        "torch_multihost_train",
        os.path.join(ROOT, "scripts", "torch_multihost_train.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    script.main(argv)


def update(path_in, path_out, init_method, world, rank):
    import torch.distributed as dist

    from mujoco_playground_tpu_torch.parallel import (initialize_distributed,
                                                      local_batch_slice,
                                                      make_mesh)
    from mujoco_playground_tpu_torch.rl import networks, ppo
    from mujoco_playground_tpu_torch.rl.config import RLConfig

    initialize_distributed(init_method, world, rank, device="cpu")
    out = {"slice": local_batch_slice(8)}
    try:
        local_batch_slice(7)
    except ValueError:
        out["uneven_raises"] = True
    cases = torch.load(path_in, weights_only=False)
    for name, case in cases.items():
        config = RLConfig(**case["config"])
        shard = make_mesh(config.num_envs)
        net = networks.ActorCritic(case["obs_size"], 2)
        net.load_state_dict(case["params"])
        ts = ppo.TrainState(
            network=net, optimizer=ppo.make_optimizer(config,
                                                      net.parameters()),
            env_states=None, generator=torch.Generator(), global_step=0)
        step = ppo.make_train_step(None, config, shard)
        ts, metrics = step.update(
            ts, (case["batch"], case["adv"], case["ret"]), case["shuffles"])
        out[name] = {"params": net.state_dict(), "metrics": metrics,
                     "global_step": ts.global_step,
                     "count": ts.optimizer.count}
    dist.destroy_process_group()
    torch.save(out, path_out)


if __name__ == "__main__":
    torch.set_num_threads(1)
    if sys.argv[1] == "train":
        train(sys.argv[2:])
    else:
        update(*sys.argv[2:5], int(sys.argv[5]), int(sys.argv[6]))
