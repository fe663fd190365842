"""Data parallelism over the env batch (``mujoco_playground_tpu_torch/
parallel/``) on the CPU: ranks of a gloo group on ``tcp://127.0.0.1``,
each a process of its own with one torch thread, against one process.

The runs (``scripts/torch_multihost_train.py`` through
``tests/_torch_parallel_rank.py``): PPO (2 iterations, with the running
normalization), SAC and TD3 (one warm-up iteration of uniform actions and
2 iterations) at B=8 global envs, T=4, 2 minibatches, solver 2/2, the
umaze env: once without a process group (the one-process run), once as a
gloo group of world size 1 and once as 2 ranks.  Held:

* (1) each rank's ``reset_core`` rows, joined, are bitwise one process's
  batch, and the generator moves as one process's does;
  ``local_batch_slice`` gives each rank its rows and refuses a batch that
  does not split;
* (2) world size 1 is bitwise the run without a process group (the
  trainers' default shard of the whole batch): parameters, env states,
  norm statistics, replay buffers, launch counts;
* (3) 2 ranks: the parameters bitwise equal on both ranks; within
  ``PARAM_TOL`` of one process, the env states within ``ENV_TOL``; the
  replay buffer after the warm-up bitwise one process's (uniform actions,
  no network in the loop); each rank's launches of the K1 and K2 twins
  those of one process;
* (4) the port's 2-rank PPO ``update``, with JAX's shuffles injected:
  bitwise one process's update on the same slab (every rank runs it on
  the whole slab), and against JAX's ``update`` jitted on a 2-device CPU
  mesh with the slab sharded and the parameters replicated
  (``parallel/mesh.py`` of the JAX package), at ``test_torch_ppo.py``'s
  1e-5 of the parameters' largest magnitude.

The update is bitwise one process's, so a 2-rank run parts from one
process only where a rank runs the policy on its own rows: the rollout's
and the collect's forward passes at B/2 rows may round differently from
the forward at B rows, and the actions, the slab and so the update
follow.  ``PARAM_TOL``: 1e-5 of the largest |parameter|, the bound
``test_torch_ppo.py`` holds a whole update to against JAX, whose
reduction order also differs (Adam divides each entry's step by its own
gradient scale, so the rounding of a tiny gradient entry moves that
entry's step).  ``ENV_TOL``: 1e-5 of (1 + the leaf's largest |value|) for
the float leaves of the env states, whose second rollout runs on
parameters that moved by that much; integer and bool leaves equal.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_playground_tpu.parallel import mesh as jax_mesh
from mujoco_playground_tpu.rl import networks as jax_networks
from mujoco_playground_tpu.rl import ppo as jax_ppo
from mujoco_playground_tpu.rl.config import RLConfig as JaxRLConfig
from _torch_parity import one_torch_thread  # noqa: F401
from mujoco_playground_tpu_torch import interop
from mujoco_playground_tpu_torch.envs import make_ackermann_env
from mujoco_playground_tpu_torch.parallel import (EnvShard, dryrun,
                                                  local_batch_slice,
                                                  make_mesh,
                                                  shard_train_state)
from mujoco_playground_tpu_torch.rl import networks, ppo
from mujoco_playground_tpu_torch.rl.config import RLConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK = os.path.join(ROOT, "tests", "_torch_parallel_rank.py")
ALGOS = ("ppo", "sac", "td3")
B, T = 8, 4
TRAIN = ["--device", "cpu", "--algo", *ALGOS, "--num-envs", str(B),
         "--unroll", str(T), "--minibatches", "2", "--steps", "2",
         "--solver-iterations", "2", "--ls-iterations", "2", "--normalize",
         "--seed", "0"]
PARAM_TOL = 1e-5
ENV_TOL = 1e-5
OBS = 79
UPDATE_BLOCKS = (1, 8)     # test_torch_ppo.py's update cases
TIMEOUT = 300


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return env


def _spawn(args, log):
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, RANK] + args, cwd=ROOT,
                                env=_env(), stdout=f,
                                stderr=subprocess.STDOUT)


def _wait(procs, logs):
    for p, log in zip(procs, logs):
        try:
            p.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        with open(log) as f:
            assert p.returncode == 0, f"{log}:\n{f.read()[-3000:]}"


# ------------------------------------------------------ the JAX anchor
def _jax_shuffle_draws(key, n, mb, blk):
    """(perm, shift) as JAX's make_epoch_shuffle draws them from ``key``
    (test_torch_ppo.py's helper)."""
    if blk > 1 and n % blk == 0 and (n // mb) % blk == 0:
        k_perm, k_roll = jax.random.split(key)
        return (np.asarray(jax.random.permutation(k_perm, n // blk)),
                np.asarray(jax.random.randint(k_roll, (), 0, n)))
    return np.asarray(jax.random.permutation(key, n)), None


def _slab(rng, n, params, jnet):
    obs = rng.standard_normal((n, OBS)).astype(np.float32)
    mean, log_std, _ = jnet.apply(params, jnp.asarray(obs))
    action = np.asarray(mean + jnp.exp(log_std) * rng.standard_normal(
        (n, 2)).astype(np.float32))
    logp = (np.asarray(jax_networks.gaussian_logp(mean, log_std, action))
            + rng.normal(0, 0.3, n)).astype(np.float32)
    adv = (rng.standard_normal(n) * 2 + 0.5).astype(np.float32)
    ret = (rng.standard_normal(n) * 3).astype(np.float32)
    return dict(obs=obs, action=action, logp=logp), adv, ret


def _jax_sharded_updates():
    """JAX's update on a 2-device mesh for each UPDATE_BLOCKS case, and the
    port's inputs for the same case."""
    devices = jax.devices("cpu")[:2]
    assert len(devices) == 2, "needs the virtual CPU devices of conftest.py"
    jmesh = jax_mesh.make_mesh(devices)
    batch_sh = jax_mesh.batch_sharding(jmesh)
    repl = jax_mesh.replicated_sharding(jmesh)
    want, cases = {}, {}
    for blk in UPDATE_BLOCKS:
        kw = dict(num_envs=B, unroll_length=T, ppo_epochs=2,
                  num_minibatches=2, shuffle_block_size=blk,
                  total_timesteps=64, anneal_lr=True)
        jconfig = JaxRLConfig(**kw)
        jnet = jax_networks.ActorCritic(action_size=2, hidden=(64, 64))
        params = jax.tree.map(np.asarray, jnet.init(
            jax.random.PRNGKey(9), jnp.zeros((OBS,), jnp.float32)))
        batch, adv, ret = _slab(np.random.default_rng(9), T * B, params,
                                jnet)
        jparams = jax.tree.map(jnp.asarray, params)
        jts = jax_ppo.TrainState(
            params=jax.device_put(jparams, repl),
            opt_state=jax.device_put(
                jax_ppo.make_optimizer(jconfig).init(jparams), repl),
            env_states=None, rng=jax.random.PRNGKey(0),
            global_step=jnp.zeros((), jnp.int32))
        z = jnp.zeros((T * B,), jnp.float32)
        trans = jax_ppo.Transition(
            obs=jnp.asarray(batch["obs"]), action=jnp.asarray(batch["action"]),
            logp=jnp.asarray(batch["logp"]), value=z, reward=z,
            terminated=z, done=z, final_obs=z)
        k_update = jax.random.PRNGKey(10)
        data = (jax.device_put(trans, batch_sh),
                jax.device_put(jnp.asarray(adv), batch_sh),
                jax.device_put(jnp.asarray(ret), batch_sh), k_update)
        jts2, jmetrics = jax.jit(
            jax_ppo.make_train_step(None, jnet, jconfig).update)(jts, data)
        assert len(data[0].obs.sharding.device_set) == 2
        want[blk] = ({k: v.numpy() for k, v in interop.actor_critic_from_flax(
            jax.tree.map(np.asarray, jts2.params)).items()},
            {k: float(v) for k, v in jmetrics.items()})
        shuffles = [tuple(None if a is None else torch.tensor(np.asarray(a))
                          for a in _jax_shuffle_draws(k, T * B, 2, blk))
                    for k in jax.random.split(k_update, jconfig.ppo_epochs)]
        cases[f"blk{blk}"] = dict(
            config=kw, obs_size=OBS, shuffles=shuffles,
            params=interop.actor_critic_from_flax(params),
            batch={k: torch.tensor(v) for k, v in batch.items()},
            adv=torch.tensor(adv), ret=torch.tensor(ret))
    return want, cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts every process at once: the three train runs (2 ranks, world
    size 1, one process) and the 2-rank anchor update once JAX's side is
    computed; loads what they wrote."""
    tmp = tmp_path_factory.mktemp("parallel")
    procs, logs = [], []

    def spawn(args, name):
        logs.append(str(tmp / f"{name}.log"))
        procs.append(_spawn(args, logs[-1]))

    two = f"tcp://127.0.0.1:{dryrun.free_port()}"
    for r in range(2):
        spawn(["train"] + TRAIN + ["--init-method", two, "--world-size", "2",
                                   "--rank", str(r), "--dump",
                                   str(tmp / "two")], f"two{r}")
    spawn(["train"] + TRAIN + ["--init-method",
                               f"tcp://127.0.0.1:{dryrun.free_port()}",
                               "--world-size", "1", "--rank", "0", "--dump",
                               str(tmp / "one_rank")], "one_rank")
    spawn(["train"] + TRAIN + ["--dump", str(tmp / "single")], "single")
    logs.append(str(tmp / "dryrun.log"))
    with open(logs[-1], "w") as f:
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "from mujoco_playground_tpu_torch."
             "parallel.dryrun import dryrun_multigpu; "
             "dryrun_multigpu(2, 'cpu')"], cwd=ROOT, env=_env(), stdout=f,
            stderr=subprocess.STDOUT))
    try:
        want, cases = _jax_sharded_updates()
        torch.save(cases, tmp / "update_in.pt")
        upd = f"tcp://127.0.0.1:{dryrun.free_port()}"
        for r in range(2):
            spawn(["update", str(tmp / "update_in.pt"),
                   str(tmp / f"update{r}.pt"), upd, "2", str(r)],
                  f"update{r}")
    finally:
        _wait(procs, logs)

    def load(run, algo, rank=0):
        return torch.load(tmp / run / f"{algo}_rank{rank}.pt",
                          weights_only=False)

    with open(tmp / "dryrun.log") as f:
        dryrun_log = f.read()
    return dict(
        dryrun=dryrun_log,
        single={a: load("single", a) for a in ALGOS},
        one_rank={a: load("one_rank", a) for a in ALGOS},
        two={a: [load("two", a, r) for r in range(2)] for a in ALGOS},
        jax=want, update_cases=cases,
        update=[torch.load(tmp / f"update{r}.pt", weights_only=False)
                for r in range(2)])


def _equal(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), f"{what}: {k}"
        else:
            assert a[k] == b[k], f"{what}: {k}"


# ------------------------------------------------------------------ (1)
@pytest.mark.parametrize("arena", ["umaze", "umaze_heading", "open"])
def test_reset_core_rows_are_one_process_rows(arena):
    kw = dict(spawn_heading_noise=3.0) if arena == "umaze_heading" else {}
    env = (make_ackermann_env("simple", device="cpu", solver_iterations=2,
                              ls_iterations=2) if arena == "open" else
           make_ackermann_env("maze", "umaze", device="cpu",
                              solver_iterations=2, ls_iterations=2, **kw))
    g = torch.Generator().manual_seed(3)
    want = env.reset_core(B, g)
    after = torch.rand(4, generator=g)
    parts = []
    for r in range(2):
        g = torch.Generator().manual_seed(3)
        shard = EnvShard(B, rank=r, world_size=2)
        parts.append(env.reset_core(B, g, rows=shard.rows))
        assert torch.equal(torch.rand(4, generator=g), after)
    got = [_leaves(p) for p in parts]
    for name, w in _leaves(want).items():
        assert torch.equal(torch.cat([got[0][name], got[1][name]]), w), name


def test_shard_train_state_keeps_the_rank_rows():
    """A PPO train state built for the whole batch and cut to rank 1 of 2
    (``shard_train_state``) holds the env states that rank builds itself
    (``init_train_state(..., shard=)``): the same draws, the rank's
    rows."""
    config = RLConfig(num_envs=B, unroll_length=T, num_minibatches=2)
    shard = EnvShard(B, rank=1, world_size=2)
    got = []
    for s in (None, shard):
        env = make_ackermann_env("maze", "umaze", device="cpu",
                                 solver_iterations=2, ls_iterations=2)
        ts = ppo.init_train_state(env, networks.ActorCritic(OBS, 2), config,
                                  torch.Generator().manual_seed(1), shard=s)
        got.append(ts if s is not None else shard_train_state(ts, shard))
    a, b = (_leaves(ts.env_states) for ts in got)
    for name in b:
        assert a[name].shape[0] == B // 2 and torch.equal(a[name], b[name]), \
            name


def _leaves(states, prefix=""):
    """The tensors of a batched EnvState by dotted name."""
    if isinstance(states, torch.Tensor):
        return {prefix: states}
    out = {}
    for f in dataclasses.fields(states):
        out.update(_leaves(getattr(states, f.name), f"{prefix}.{f.name}"))
    return out


def test_local_batch_slice_and_uneven_batches(runs):
    assert local_batch_slice(B) == slice(0, B)        # no process group
    shard = make_mesh(B)
    assert (shard.world_size, shard.rows, shard.group) == (1, slice(0, B),
                                                          None)
    for r, out in enumerate(runs["update"]):
        assert out["slice"] == slice(4 * r, 4 * (r + 1))
        assert out["uneven_raises"]
    with pytest.raises(ValueError):
        EnvShard(7, 0, 2)


# ------------------------------------------------------------------ (2)
@pytest.mark.parametrize("algo", ALGOS)
def test_world_size_one_is_bitwise_the_unsharded_run(runs, algo):
    got, want = runs["one_rank"][algo], runs["single"][algo]
    assert got["result"]["distributed"] and got["result"]["world_size"] == 1
    assert not want["result"]["distributed"]
    for part in ("params", "env_states", "norm", "warm_buffer", "buffer"):
        if part in want:
            _equal(got[part], want[part], f"{algo} {part}")
    for key in ("param_sha256", "mean_reward", "global_step", "launches"):
        assert got["result"][key] == want["result"][key], key


# ------------------------------------------------------------------ (3)
@pytest.mark.parametrize("algo", ALGOS)
def test_two_ranks_hold_equal_parameters(runs, algo):
    r0, r1 = runs["two"][algo]
    assert [r["result"]["rank"] for r in (r0, r1)] == [0, 1]
    assert r0["result"]["local_envs"] == r1["result"]["local_envs"] == B // 2
    assert r0["result"]["param_sha256"] == r1["result"]["param_sha256"]
    _equal(r0["params"], r1["params"], algo)
    assert r0["result"]["mean_reward"] == r1["result"]["mean_reward"]
    if "buffer" in r0:
        _equal(r0["buffer"], r1["buffer"], f"{algo} buffer")


@pytest.mark.parametrize("algo", ALGOS)
def test_two_ranks_within_tolerance_of_one_process(runs, algo):
    r0, r1 = runs["two"][algo]
    want = runs["single"][algo]
    scale = max(float(v.abs().max()) for v in want["params"].values())
    for name, w in want["params"].items():
        err = float((r0["params"][name] - w).abs().max())
        assert err <= PARAM_TOL * scale, f"{algo} {name}: {err:.3e}"
    for name, w in want["env_states"].items():
        joined = torch.cat([r0["env_states"][name], r1["env_states"][name]])
        if w.dtype.is_floating_point:
            err = float((joined - w).abs().max())
            bound = ENV_TOL * (1.0 + float(w.abs().max()))
            assert err <= bound, f"{algo} {name}: {err:.3e} > {bound:.3e}"
        else:
            assert torch.equal(joined, w), f"{algo} {name}"
    assert r0["result"]["global_step"] == want["result"]["global_step"]
    if "norm" in want:    # statistics of the gathered slab
        _equal(r0["norm"], want["norm"], "norm")


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_two_ranks_warm_buffer_is_one_process_buffer(runs, algo):
    for r in runs["two"][algo]:
        _equal(r["warm_buffer"], runs["single"][algo]["warm_buffer"],
               f"{algo} rank {r['result']['rank']}")


@pytest.mark.parametrize("algo", ALGOS)
def test_two_ranks_launch_counts_are_one_process_counts(runs, algo):
    want = runs["single"][algo]["result"]["launches"]
    iters = 2 if algo == "ppo" else 1 + 2
    per_iter = T if algo == "ppo" else 4
    # the env's 3 settle steps, one K1 a rollout or collect step, one K2 at
    # the first reset
    assert want == {"K1": 3 + iters * per_iter, "K2": 1}
    for r in runs["two"][algo]:
        assert r["result"]["launches"] == want


# ------------------------------------------------------------------ (4)
@pytest.mark.parametrize("blk", UPDATE_BLOCKS)
def test_two_rank_update_matches_jax_sharded_update(runs, blk):
    want, jmetrics = runs["jax"][blk]
    scale = max(float(np.abs(w).max()) for w in want.values())
    r0, r1 = (u[f"blk{blk}"] for u in runs["update"])
    _equal(r0["params"], r1["params"], "ranks")
    assert r0["global_step"] == T * B and r0["count"] == 4
    for name, w in want.items():
        err = float(np.abs(r0["params"][name].numpy() - w).max())
        assert err <= 1e-5 * scale, f"{name}: {err:.3e}"
    for k in ppo.AUX_KEYS:
        got = float(r0["metrics"][k])
        assert abs(got - jmetrics[k]) <= 1e-5 * max(abs(jmetrics[k]),
                                                     1e-30), k


@pytest.mark.parametrize("blk", UPDATE_BLOCKS)
def test_two_rank_update_is_one_process_update(runs, blk):
    """Every rank runs one process's update on the whole slab: the 2-rank
    update is bitwise that process's, loss parts included."""
    case = runs["update_cases"][f"blk{blk}"]
    config = RLConfig(**case["config"])
    net = networks.ActorCritic(case["obs_size"], 2)
    net.load_state_dict(case["params"])
    ts = ppo.TrainState(
        network=net, optimizer=ppo.make_optimizer(config, net.parameters()),
        env_states=None, generator=torch.Generator(), global_step=0)
    ts, metrics = ppo.make_train_step(None, config).update(
        ts, (case["batch"], case["adv"], case["ret"]), case["shuffles"])
    for r in runs["update"]:
        got = r[f"blk{blk}"]
        _equal(got["params"], net.state_dict(), "params")
        _equal(got["metrics"], metrics, "loss parts")


def test_dryrun_multigpu(runs):
    """``dryrun_multigpu(2)`` on the CPU: one PPO, SAC and TD3 step each
    with 4 envs on each rank and equal parameters on both ranks."""
    for algo in ALGOS:
        assert (f"dryrun_multigpu ok [{algo}]: 2 ranks x 4 envs on cpu"
                in runs["dryrun"]), runs["dryrun"][-2000:]
