"""The JAX package's committed learning curves, trained again by the port.

    python3 scripts/torch_learning_record.py --out chiprun_out/learning
    python3 scripts/torch_learning_record.py --device cpu --tiny --out DIR

Trains, through ``python -m mujoco_playground_tpu_torch.rl.train`` (one
process per run, all started together; each run's curve is the one it
would draw alone, only its ``steps_per_second`` shares the card):

* PPO with the solved recipe (README: 4096 umaze envs, 256x256 towers,
  the geodesic shaping and the goal compass, gamma 0.995) for 20,054,016
  env steps at ``--shuffle-block 128``, seeds 0, 1 and 2, the arm
  ``blk128`` of ``rl_logs/shuffle_ab/`` (22 logs, one per 917,504 steps).
  Those curves were drawn at a constant learning rate (their
  ``approx_kl`` grows to ~0.0067 by the last log; an annealed run's falls
  to ~0 there), so the runs leave README's ``--anneal-lr`` out;
  ``--ppo-anneal`` keeps it and writes ``blk128_anneal_s<seed>``;
* SAC (seed 0) and TD3 (seed 1) at ``rl_logs/offpolicy/``'s configuration
  (``--maze umaze --num-envs 256 --progress-reward 3``, 20,000,000 env
  steps); when TD3's seed 1 collapses (the mean of its last 20 logged
  ``mean_reward``s at most ``COLLAPSED``, as the JAX package's seed 0 did),
  seeds 0 and 2 as well.

Each run's ``metrics.jsonl`` lands in ``<out>/shuffle_ab_torch/blk128_s<seed>
/ppo/`` or ``<out>/offpolicy_torch/<algo>[_s<seed>]/``, each line with the
card's name and power limit beside its ``steps_per_second``; the checkpoints
stay under ``--work`` (a TD3 or SAC checkpoint holds its 100,000-row
buffer).  Each off-policy run's final policy is then scored with
``rl_logs/offpolicy/EVAL.json``'s protocol (256 episodes, a deterministic
policy, at most 1000 steps) on that file's own episodes
(``rl_logs/offpolicy/eval_seed0.npz``), into ``<out>/offpolicy_torch/
EVAL.json`` with the card's name and power limit.  Needs one CUDA card,
or ``--device cpu --tiny`` (a few steps of each, to rehearse it).
"""
import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

PPO_FLAGS = ["--algo", "ppo", "--maze", "umaze", "--num-envs", "4096",
             "--hidden", "256", "256", "--sane-collision",
             "--collision-penalty", "-1", "--geodesic-reward", "10",
             "--goal-compass", "--normalize",
             "--max-velocity", "1.5", "--max-angular", "3.0",
             "--max-episode-steps", "6000", "--gamma", "0.995",
             "--shuffle-block", "128", "--timesteps", "20054016",
             # no evaluation inside the loop, as the JAX A/B's curves
             "--eval-freq", str(10 ** 12), "--save-freq", "5000000"]
OFF_FLAGS = ["--maze", "umaze", "--num-envs", "256", "--progress-reward",
             "3", "--timesteps", "20000000", "--save-freq", "5000000"]
TINY = dict(ppo=["--num-envs", "8", "--unroll", "4", "--minibatches", "2",
                 "--timesteps", "64", "--max-episode-steps", "20",
                 "--eval-episodes", "2"],
            off=["--num-envs", "2", "--timesteps", "1040",
                 "--max-episode-steps", "4", "--eval-episodes", "2",
                 "--hidden", "32", "32"])
PPO_SEEDS, SAC_SEEDS, TD3_SEEDS, TD3_MORE = (0, 1, 2), (0,), (1,), (0, 2)
COLLAPSED = -20.0           # last-20 mean reward per step of a collapse
EVAL_EPISODES, EVAL_STEPS = 256, 1000
OFFPOLICY_RUN = os.path.join(ROOT, "rl_logs", "offpolicy")


def card(device):
    if device == "cpu":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def curve(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def last_mean(path, n=20):
    rewards = [r["mean_reward"] for r in curve(path) if "mean_reward" in r]
    return float(np.mean(rewards[-n:])), float(np.mean(rewards[:n]))


class Run:
    """One training process: its flags, its log dir under ``work`` and the
    place its curve is copied to under ``out``."""

    def __init__(self, name, algo, seed, flags, work, dest):
        self.name, self.algo, self.seed = name, algo, seed
        self.log_dir = os.path.join(work, name)
        self.dest = dest
        self.argv = flags + ["--seed", str(seed), "--log-dir", self.log_dir]
        self.proc = None

    def start(self, device):
        shutil.rmtree(self.log_dir, ignore_errors=True)
        os.makedirs(self.log_dir)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.log = open(self.log_dir + ".log", "w")
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "mujoco_playground_tpu_torch.rl.train"]
            + self.argv + (["--device", device] if device else []),
            cwd=ROOT, env=env, stdout=self.log, stderr=subprocess.STDOUT)
        print(f"started {self.name}: {' '.join(self.argv)}", flush=True)

    def metrics(self):
        return os.path.join(self.log_dir, f"{self.algo}_torch",
                            "metrics.jsonl")

    def finish(self, where):
        self.log.close()
        secs = time.time() - self.t0
        if self.proc.returncode:
            with open(self.log_dir + ".log") as f:
                tail = f.read()[-4000:]
            raise SystemExit(f"{self.name} exited {self.proc.returncode} "
                             f"after {secs:.0f} s:\n{tail}")
        os.makedirs(os.path.dirname(self.dest), exist_ok=True)
        with open(self.dest, "w") as f:
            for rec in curve(self.metrics()):
                f.write(json.dumps(dict(rec, card=where)) + "\n")
        print(f"{self.name}: done in {secs:.0f} s, {len(curve(self.dest))} "
              f"logs -> {self.dest}", flush=True)


def run_all(runs, device, td3_more, where):
    """Runs every process at once; starts ``td3_more`` when TD3's first
    seed has collapsed.  Each curve's lines carry the card ``where``."""
    pending = list(runs)
    for r in pending:
        r.start(device)
    try:
        while pending:
            time.sleep(2)
            for r in list(pending):
                if r.proc.poll() is None:
                    continue
                pending.remove(r)
                r.finish(where)
                if r.algo == "td3" and td3_more:
                    last, _ = last_mean(r.dest)
                    if last <= COLLAPSED:
                        print(f"{r.name} collapsed (last-20 mean "
                              f"{last:.3f}); training seeds "
                              f"{[m.seed for m in td3_more]}", flush=True)
                        for m in td3_more:
                            m.start(device)
                        pending += td3_more
                        runs += td3_more
                    td3_more = []
    finally:
        for r in pending:      # a failed run stops the others
            r.proc.kill()
    return runs


def score_offpolicy(run, device, tiny):
    """EVAL.json's protocol on its own episodes for the run's final
    policy."""
    import torch

    from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
    from mujoco_playground_tpu_torch.rl import sac, td3
    from mujoco_playground_tpu_torch.rl import train as train_lib
    from mujoco_playground_tpu_torch.rl.evaluate import evaluate_agent
    args = train_lib.make_parser().parse_args(run.argv)
    episodes = 2 if tiny else EVAL_EPISODES
    config = dataclasses.replace(train_lib.config_from_args(args),
                                 num_envs=episodes, sac_buffer_size=1)
    env = train_lib.build_env(config, device)
    mod = sac if run.algo == "sac" else td3
    init, _ = (sac.make_sac(env, config) if run.algo == "sac"
               else td3.make_td3(env, config))
    latest = ckpt_lib.latest_checkpoint(
        os.path.join(run.log_dir, f"{run.algo}_torch"))
    state = ckpt_lib.restore_policy(latest, init())
    with np.load(os.path.join(OFFPOLICY_RUN, "eval_seed0.npz")) as d:
        d = {k: torch.from_numpy(d[k][:episodes]).to(env.device)
             for k in d.files}
    t0 = time.time()
    stats = evaluate_agent(
        env, mod.deterministic_policy(state), num_episodes=episodes,
        max_steps=4 if tiny else EVAL_STEPS,
        core=env.maze_core(d["start_xy"], d["goal_xy"], d["goal_cell"]))
    secs = time.time() - t0
    last, first = last_mean(run.dest)
    rates = [r["steps_per_second"] for r in curve(run.dest)]
    return dict(timesteps=int(ckpt_lib.checkpoint_step(latest)),
                seed=run.seed, **stats,
                train_reward_per_step={"first_20_logs": first,
                                       "last_20_logs": last},
                median_steps_per_second_while_sharing_the_card=float(
                    np.median(rates)),
                eval_seconds=secs)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(ROOT, "rl_logs"))
    p.add_argument("--work", default=os.path.join(ROOT, "build",
                                                  "learning"))
    p.add_argument("--algos", nargs="+", default=["ppo", "sac", "td3"])
    p.add_argument("--ppo-anneal", action="store_true",
                   help="PPO with README's --anneal-lr (to zero at the "
                        "run's end), into blk128_anneal_s<seed>")
    p.add_argument("--device", default=None)
    p.add_argument("--tiny", action="store_true",
                   help="a few steps of each run (a rehearsal)")
    args = p.parse_args()
    device = args.device
    if device != "cpu":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device (pass --device cpu --tiny)")
    out = os.path.abspath(args.out)

    def ppo(seed):
        arm = "blk128_anneal" if args.ppo_anneal else "blk128"
        return Run(f"ppo_{arm}_s{seed}", "ppo", seed,
                   PPO_FLAGS + (["--anneal-lr"] if args.ppo_anneal else [])
                   + (TINY["ppo"] if args.tiny else []), args.work,
                   os.path.join(out, "shuffle_ab_torch", f"{arm}_s{seed}",
                                "ppo", "metrics.jsonl"))

    def off(algo, seed, suffix=""):
        return Run(f"{algo}{suffix}", algo, seed,
                   ["--algo", algo] + OFF_FLAGS
                   + (TINY["off"] if args.tiny else []), args.work,
                   os.path.join(out, "offpolicy_torch", f"{algo}{suffix}",
                                "metrics.jsonl"))

    runs, more = [], []
    if "ppo" in args.algos:
        runs += [ppo(s) for s in PPO_SEEDS]
    if "sac" in args.algos:
        runs += [off("sac", s) for s in SAC_SEEDS]
    if "td3" in args.algos:
        runs += [off("td3", s) for s in TD3_SEEDS]
        more = [off("td3", s, f"_s{s}") for s in TD3_MORE]
    where = card(device)
    t0 = time.time()
    runs = run_all(runs, device, more, where)
    print(f"all runs: {time.time() - t0:.0f} s ({where})", flush=True)
    offs = [r for r in runs if r.algo != "ppo"]
    if not offs:
        return
    path = os.path.join(out, "offpolicy_torch", "EVAL.json")
    report = {}
    if os.path.exists(path):
        with open(path) as f:
            report = json.load(f)
    report.update({
        "env": "AckermannEnv maze umaze, progress_reward_scale=3.0, "
               "solver 4/3 (--maze umaze --num-envs 256 --progress-reward 3)",
        "protocol": f"rl.evaluate.evaluate_agent, {EVAL_EPISODES} parallel "
                    f"episodes, deterministic policy, max {EVAL_STEPS} "
                    "steps, on rl_logs/offpolicy/EVAL.json's own episodes "
                    "(rl_logs/offpolicy/eval_seed0.npz)",
        "card": where,
        "trained_by": "scripts/torch_learning_record.py: python -m "
                      "mujoco_playground_tpu_torch.rl.train, every run of "
                      "the call sharing the card"})
    for r in offs:
        stats = score_offpolicy(r, device, args.tiny)
        report[os.path.basename(os.path.dirname(r.dest))] = stats
        print(f"{r.name} final policy on EVAL.json's episodes: success "
              f"{stats['success_rate']:.4f}, mean return "
              f"{stats['mean_return']:.1f}; train reward per step, last 20 "
              f"logs {stats['train_reward_per_step']['last_20_logs']:.4f} "
              f"({where})", flush=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
