"""Per-episode returns of the committed SAC and TD3 policies on
rl_logs/offpolicy/EVAL.json's episodes, as drawn and with every spawn
moved by one float32 ulp.

    python3 scripts/torch_offpolicy_eval.py                 # the port, card
    JAX_PLATFORMS=cpu python scripts/torch_offpolicy_eval.py --jax

Plays EVAL.json's protocol (256 episodes, a deterministic policy, at most
1000 steps, ``--maze umaze --progress-reward 3`` at the CLI's defaults) on
its own episodes (``rl_logs/offpolicy/eval_seed0.npz``): with the port's
policies (``rl_logs/offpolicy/*_torch/*.pt``) on the card, once as drawn
and ``--nudges`` times with each spawn coordinate moved one ulp up or down
(a direction drawn from the nudge's seed, as ``chip_smoke.py`` does); with
``--jax``, once as drawn with the JAX package's policies
(``params_final``) on the CPU, the reference's arithmetic off the TPU.
Prints, for each run, the mean return, its std and the success rate
beside EVAL.json's, and the episodes whose returns move most, with their
collision steps; writes every return to ``build/``.  The port's
mode needs one CUDA card (or ``--device cpu`` with tiny ``--steps``).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

RUN = os.path.join(ROOT, "rl_logs", "offpolicy")
ALGOS = ("sac", "td3")
# the CLI's env defaults with --maze umaze --progress-reward 3
ENV = dict(progress_reward_scale=3.0, solver_iterations=4, ls_iterations=3,
           max_linear_velocity=1.0, max_angular_velocity=1.0,
           goal_distance_threshold=0.5, max_episode_steps=1000)


def port_runs(algo, nudges, steps, device):
    """(returns, collision steps, successes) of each run, (runs, 256)."""
    import torch

    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
    from mujoco_playground_tpu_torch.rl import sac, td3
    from mujoco_playground_tpu_torch.rl.config import RLConfig
    from mujoco_playground_tpu_torch.rl.train import ckpt_subdir
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    env = make_ackermann_env("maze", "umaze", device=dev, **ENV)
    with np.load(os.path.join(RUN, "eval_seed0.npz")) as d:
        draws = {k: torch.from_numpy(d[k]).to(dev) for k in d.files}
    mod = sac if algo == "sac" else td3
    make = sac.make_sac if algo == "sac" else td3.make_td3
    init, _ = make(env, RLConfig(num_envs=256, sac_buffer_size=1))
    src = os.path.join(RUN, ckpt_subdir(algo))
    state = ckpt_lib.restore_policy(
        os.path.join(src, sorted(os.listdir(src))[-1]), init())
    policy = mod.deterministic_policy(state)
    out = []
    for k in range(1 + nudges):
        xy = draws["start_xy"]
        if k:
            g = torch.Generator(device=dev).manual_seed(k)
            up = torch.randint(0, 2, xy.shape, generator=g, device=dev).bool()
            xy = torch.nextafter(xy, torch.where(up, np.inf, -np.inf))
        states = env.reset(core=env.maze_core(xy, draws["goal_xy"],
                                              draws["goal_cell"]))
        ret = torch.zeros(256, device=dev)
        col = torch.zeros(256, dtype=torch.int32, device=dev)
        fin = torch.zeros(256, dtype=torch.bool, device=dev)
        succ = fin.clone()
        with torch.no_grad():
            for _ in range(steps):
                states = env.step_batch(states, policy(states.obs))
                live = ~fin
                ret += states.reward * live
                col += (states.collision & live).int()
                succ |= states.terminated & live
                fin |= states.done
        out.append([x.cpu().numpy() for x in (ret, col, succ)])
    return [np.stack(x) for x in zip(*out)]


def jax_runs(algo, steps):
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from mujoco_playground_tpu.envs import make_ackermann_env
    from mujoco_playground_tpu.rl import sac, td3
    env = make_ackermann_env("maze", "umaze", **ENV)
    state = ocp.StandardCheckpointer().restore(
        os.path.join(RUN, algo, "params_final"))

    class Policy:
        actor_params = state["actor_params"]

    policy = (sac if algo == "sac" else td3).deterministic_policy(
        env, Policy)
    with np.load(os.path.join(RUN, "eval_seed0.npz")) as d:
        n = d["start_xy"].shape[0]
    states = jax.vmap(env.reset)(jax.random.split(jax.random.PRNGKey(0), n))

    def body(carry, _):
        states, ret, col, fin, succ = carry
        nxt = env.step_batch(states, policy(states.obs))
        live = ~fin
        return (nxt, ret + nxt.reward * live,
                col + (nxt.collision & live).astype(jnp.int32),
                fin | nxt.done, succ | (nxt.terminated & live)), ()

    init = (states, jnp.zeros(n), jnp.zeros(n, jnp.int32),
            jnp.zeros(n, bool), jnp.zeros(n, bool))
    _, ret, col, _, succ = jax.jit(lambda c: jax.lax.scan(
        body, c, None, length=steps)[0])(init)
    return [np.asarray(x)[None] for x in (ret, col, succ)]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--jax", action="store_true",
                   help="the JAX package's policies on the CPU")
    p.add_argument("--nudges", type=int, default=16)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if args.jax:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_enable_x64", False)
        where = "the JAX package on the CPU"
    else:
        import subprocess
        where = "the port on " + (subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() if args.device == "cuda"
            else args.device)
    with open(os.path.join(RUN, "EVAL.json")) as f:
        ref = json.load(f)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for algo in ALGOS:
        ret, col, succ = (jax_runs(algo, args.steps) if args.jax else
                          port_runs(algo, args.nudges, args.steps,
                                    args.device))
        r = ref[algo]
        for k in range(ret.shape[0]):
            worst = [(int(i), round(float(ret[k][i]), 1), int(col[k][i]))
                     for i in np.argsort(ret[k])[:3]]
            print(f"{algo} {'as drawn' if not k else f'nudge {k}'}: mean "
                  f"return {ret[k].mean():.2f} (EVAL.json "
                  f"{r['mean_return']}), std {ret[k].std():.1f} "
                  f"({r['std_return']}), success {succ[k].mean():.4f} "
                  f"({r['success_rate']}); worst episodes (id, return, "
                  f"collision steps) {worst}")
        if ret.shape[0] > 1:
            span = ret.max(0) - ret.min(0)
            moved = np.argsort(span)[::-1][:5]
            print(f"{algo}: the median mean return over the "
                  f"{ret.shape[0]} runs {np.median(ret.mean(1)):.2f}; the "
                  f"episodes whose return moves most under the nudges "
                  f"(id, span): "
                  f"{[(int(i), round(float(span[i]), 1)) for i in moved]}")
        tag = "jax_cpu" if args.jax else "port"
        np.savez(os.path.join(ROOT, "build",
                              f"offpolicy_eval_{tag}_{algo}.npz"),
                 ret=ret, col=col, succ=succ)
    print(f"({where})")


if __name__ == "__main__":
    main()
