"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of ``mujoco_playground_tpu_torch/csrc`` with nvcc
(one nvcc per source, all at once), holds each kernel against its plain
PyTorch twin on the card, then drives the port's three paths over 16384
lockstep envs of ``make_ackermann_env("maze", "umaze", solver_iterations=4,
ls_iterations=3)`` with uniform random actions:

* the main path: a batched reset and 200 steps of ``step_autoreset_batch``
  (kernel K1, K2 at reset);
* path A: ``DomainRandomizedEnv`` for 200 steps (kernel K1e);
* path B: the same env with the compat manifolds
  (``reference_flat_manifold``, ``reference_wheel_patch``): the staged step
  through kernel K3, the observation through K2; K3 is held against its
  twin on the Newton system of path B's states every ``K3_PATH_EVERY``
  steps from step ``K3_PATH_FROM`` on (15 checks in 200 steps, outside the
  launch counts and the timing), and before the paths on the path-B envs
  where it once missed its twins (``K3_MISSES``, at their own batch: a
  partial block);
* the reference-compat knobs, the staged DR fallback and DR with heading
  noise (``compat_paths``), each with its exact launch counts: path R
  (``reference_delayed_obs`` and ``reference_lidar_aliasing``, 200 steps:
  K1 ``<0,0,0>`` once and K2 twice a step, obs columns 0-9 equal to 71);
  path R under the default randomization (200 steps: K1e ``<0,0,0,dr>``,
  K2 with each env's floor on the pre-step physics, K2 on the fresh
  batch); path S (two physics substeps, 50 steps: K1 ``<0,0,0>`` and the
  fused K1 once each a step); path C, the default randomization over the
  compat manifolds (60 steps: K3 once and K2 with each env's floor twice
  a step; identical starts and actions spread qvel), and at 1024 envs on
  the default manifolds with per-env joint ranges (20 steps, K3 every
  step); path A with ``spawn_heading_noise`` (50 steps: K1e
  ``<1,0,0,dr>`` and K2 with each env's floor once a step);
* the imported robot (``import_phase``): ``ackermann_robot_v2`` exported
  with ``spec.mjcf.to_mjcf``, imported back with
  ``spec.mjcf_import.from_mjcf`` and compiled with the umaze scene at
  solver 4/3 beside the hand spec's model: the leaves that differ (only
  the chassis hulls may, which the export writes as their boxes; every
  other float32 leaf within one ulp), then 50 steps of the main path's
  16384 reset states through ``engine.step_batch`` with each model and the
  same ctrl (K1 ``<0,0,0>`` exactly 100 times), the imported model's
  states held against the hand spec's with K1's tolerances, and each
  model's ms per step;
* the batch-last assembly (``constraint_bl_phase``): path B's last states
  stepped 20 times through the staged step with the rows assembled in K3's
  own layout (``constraint_bl.make_efc_bl``, K3 with ``pre_transposed``;
  its launches counted apart, exactly 20); on the same states K3 in the
  kernel layout held bitwise against K3 row-major on the same arrays
  moved to row-major, against its twin (``check_k3``, ``set_aside``), and
  against K3 on the staged step's own assembly (the two assemblies' arrays
  within ``BL_ROWS_TOL``, qacc with ``check_k3``'s rules); a second launch
  repeats the bits; each assembly with K3 timed by events and by the
  profiler's device time, K3 alone in each layout by events and a CUDA
  graph (A B B A), with both instantiations' ptxas lines and occupancy;
* the trainer: ``rl.train.main`` with the README's PPO recipe at 4096
  umaze envs (``--algo ppo --maze umaze --num-envs 4096 --normalize
  --anneal-lr``) for 1 iteration, K1 on every rollout and evaluation step
  and K2 at every batched reset; then a resume for one more iteration, a
  resumed run held against a straight one, one minibatch update on the
  card held against the same update on the CPU (and, as a control that
  the check sees TF32, the same with TF32 matmuls on, which must miss),
  and the iteration's times;
* the reference-compat trainer (``compat_trainer_phase``):
  ``rl.train.main`` with ``--reference-compat`` at 4096 envs on the open
  floor for 1 iteration and a resume of one, K1 ``<0,0,0>`` exactly once
  per rollout and evaluation step and K2 twice per rollout step, the
  rollouts' mean reward per step in [-52, -49] (every step pays the -50
  collision penalty there), and training env-steps/s;
* the solved recipe (README.md: 256x256 towers, the geodesic shaping and
  the goal compass, obs 81, gamma 0.995, 6000-step episodes) through
  ``rl.train.main`` at 4096 envs, as written and with
  ``--spawn-heading-noise 3.14159265`` (K1 with no fused spawn scan and K2
  on every rollout step): its launch counts, every obs and final_obs
  finite and 81 wide, 3 timed iterations after a warm-up, and the geodesic
  lookups' share of a rollout step; then the committed solved policies
  (``rl_logs/solved*/ppo_torch/*.pt``, carried across from the Orbax
  checkpoints by ``scripts/torch_convert_solved.py``) and a random policy
  scored with EVAL.json's protocol (512 episodes, deterministic, at most
  6000 steps) on EVAL.json's own episodes (the JAX package's spawn, goal
  and yaw draws for eval seed 0, and its random baseline's actions,
  ``eval_seed0.npz``) through ``--eval-only``: each success rate must lie
  within 3 binomial standard deviations of EVAL.json's;
* off-policy (``offpolicy_phase``): SAC and TD3 through ``rl.train.main``
  at the committed runs' configuration (``--maze umaze --num-envs 256
  --progress-reward 3``: a 100,000-row replay buffer, batch 256, 256x256
  towers, 4 collect and 4 gradient steps an iteration) for one warm-up
  iteration and two chunks of 97 iterations (199,680 env steps): K1
  exactly 4 times an iteration and K2 once per batched reset; the buffer
  and every parameter finite, one ``metrics.jsonl`` line per chunk; the
  second chunk's env-steps/s by CUDA events and by the loop's own
  ``steps_per_second``; one profiled iteration (collect against the
  gradient steps: launches, device busy, idle share) and its host syncs,
  which must be none; a split run (the warm-up and the first chunk, then
  a resume for the second) held bitwise against the main run; one SAC
  gradient step on the card against the same step
  on the CPU (TF32 off, with the TF32-on control that must miss); then
  the committed SAC and TD3 policies (``rl_logs/offpolicy/*_torch/*.pt``,
  carried across by ``scripts/torch_convert_offpolicy.py``) scored
  through ``--eval-only`` with ``rl_logs/offpolicy/EVAL.json``'s protocol
  (256 episodes, at most 1000 steps) on its own episodes
  (``eval_seed0.npz``): each success rate within 3 binomial standard
  deviations of EVAL.json's, and the median mean return over those
  episodes and 16 copies with every spawn moved by one float32 ulp within
  3 standard errors of EVAL.json's (``NUDGES``);
* the per-env step (``per_env_phase``): 8 umaze envs stepped one at a time
  through ``AckermannEnv.step`` (plain PyTorch on the card) for 5 steps,
  each step held against ``engine.staged_step`` (K3) on the same envs as a
  batch, and the same envs' per-env step on the CPU held against the
  card's;
* the interop and tooling layer (``tooling_phase``): which of gymnasium,
  gymnasium_robotics, mujoco, matplotlib, pygame and glfw the machine
  has, and the Gym wrappers' base classes; ``GymVectorAckermannEnv`` over
  the main path's env at 16384 envs for 200 steps of seeded numpy
  actions (K1 200 and K2 1 exactly; env-steps/s by host clock beside the
  main path's, and the share of a step its device-to-host copies take),
  then the same steps in lockstep with ``step_autoreset_batch`` on the
  same env and seed (numpy outputs of the contract's shapes, final_obs
  and its masks exactly where an env ends, bitwise equal; one more step
  with the even envs truncating); ``GymAckermannEnv`` for 20 steps (a
  second ``reset(seed=3)`` repeats the obs bitwise); synthetic SB3 PPO
  (64x64), SAC (256x256, ``log_ent_coef``) and TD3 (400x300) zips
  loaded on the card and on the CPU, each module's outputs against an
  SB3-layout forward and the CPU's, and the PPO policy evaluated at 4096
  envs for 200 steps (K1 200, K2 1); both spawners over the four
  PointMazes, maze_flat and the open floor, 4 per-env steps each,
  finite; ``main_sim.main(["--headless", "--steps", "50"])`` on the card
  against the CPU, its odometry printout finite, its steps/s against
  the 500 Hz pace;
* data parallelism over the env batch (``parallel_phase``): K1 and K2
  against their twins at the ranks' local batches (2048 and 128 envs);
  the README PPO recipe at 4096 envs and SAC/TD3 at the committed runs'
  256 envs for one iteration through ``parallel.dryrun.train_run``,
  without a process group and as an NCCL group of world size 1, in the
  order A B B A (all four bitwise the same: parameters, env states, norm
  statistics, replay buffers; the same K1 and K2 counts), with the slab
  gather's ms; two gloo ranks of ``scripts/torch_multihost_train.py``
  sharing the card (2048 / 128 envs each: equal hashes, the parameters
  within ``PAR_PARAM_TOL`` of the one-process run, K1 once a step on each
  rank); ``scripts/torch_scale_bench.py`` at N=1 and 16384 envs beside the
  main path's rate, both 180 steps after 20 (N>=2 is not measured on a
  one-card machine);
* the JAX package's learning record (``capability_phase``): K1 ``<0,0,0>``
  and K2 against their twins at 1 and 3 envs (the 1-env recipe's partial
  blocks) on the open floor and the medium maze, K1 with the evaluation's
  flag set ``<1,0,0>`` and K2 on PointMaze_Medium-v3 states at 512 envs
  (14 wall boxes; a second launch repeats the bits), and those shapes
  timed; the converted medium policy (``rl_logs/solved_medium/ppo_torch``)
  through ``--eval-only`` on its EVAL.json's own 512 episodes of at most
  12000 steps (success within 3 binomial SDs, K1 once a step); the
  scripted expert (``scripts/torch_scripted_ceiling.py``) on umaze with
  PARITY.md's protocol, 512 x 6000 on the JAX script's own episodes
  (within 3 binomial SDs of 44.3%); one iteration (2048 steps) of the
  1-env reference-compat recipe (``scripts/torch_reference_compat_run.py``)
  on the open floor: K1 ``<0,0,0>`` once and K2 twice a step, its two
  finished episodes each in [-52,000, -49,000].

Each path runs with the launch counts set to 0 just before it and read just
after; it checks that the path went through its kernels and that its
outputs are finite, and times it with CUDA events.  Then each kernel is
held against its twin at the paths' shapes, launched a second time on the
same inputs (the bits must repeat) and timed beside its bound twice: by
CUDA events around each wrapper call (``ms``, the host's launch path
included, as the plain twins are timed) and by one replay of a CUDA graph
of the calls (``device_ms``, the kernel alone).  K3 is also held against its twin with every
contact row in contact, which overflows its block's pool of rows.  The
plain physics step (K1 ``<0,0,0>``, K1e ``<0,0,0,dr>``) is held on
wall-contact states at 1024 envs and on path R's and path R under DR's
states at 16384; K1 and K1e are held strictly (an env shown
ill-conditioned by the one-ulp rule fails them, and each check prints how
many envs each verdict took and how many envs' physics outputs differ
from the twin's in any bit), also on the envs where K1 once missed its
twins (``K1_MISSES``: K1 with each env's flag set, K1e on the same inputs);
K2 with a per-env floor on path C's frames and the default
randomization's floors; K2's launches with a per-env floor
are counted apart (``K2f``), and K1's and K1e's by flag set.  It
prints the kernels' ptxas lines and occupancy, one JSON line of kernel
numbers and, last, the device line.  Exits non-zero on any failure, and
when no CUDA device exists.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

B_MAIN = 16384        # envs of the main path (the umaze bench's width)
STEPS = 200           # main-path env steps
WARMUP = 20           # of those, untimed
PROFILE_STEPS = 10    # further steps under torch.profiler
B_CHECK = 1024        # envs of the kernel-vs-twin checks
CHECK_STEPS = 3
SEED = 0
DR_STEPS = 200        # path A env steps (WARMUP of them untimed)
SAME_STEPS = 10       # of those, from one shared start with shared actions
STAGED_STEPS = 200    # path B env steps (spawned robots land by ~100)
STAGED_WARMUP = 20
STAGED_PROFILE = 5
# K3 against its twin on path B's states after every K3_PATH_EVERY-th step
# from K3_PATH_FROM on (scripts/torch_k3_probe.py's checks), and on the
# path-B envs that the probe captured where K3 once missed its twins
K3_PATH_FROM = 60
K3_PATH_EVERY = 10
K3_MISSES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "data", "k3_path_b_misses.npz")
# the envs on which K1 once missed its twins by a different decision
# (scripts/torch_k1_probe.py --save): held strictly, K1 with each env's
# flag set and K1e with the same inputs (its parameters, or the model's own)
K1_MISSES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "data", "k1_wall_misses.npz")
# newton_solve's positional arguments, as engine.newton_inputs returns them
K3_ARG_NAMES = ("Mt", "a_s", "G", "j_aref", "j_R", "j_floss", "j_active",
                "j_kind", "Jn", "Jt1", "Jt2", "c_aref", "c_R", "c_mu",
                "c_active", "iterations", "ls_iterations")
# the reference-compat knobs, the staged DR fallback and DR with heading
# noise (compat_paths): path R and path R under DR run STEPS steps (the
# plain steps' kernel checks take their last states: envs in contact as on
# the main path's), path S SUBSTEP_STEPS, path C STAGED_DR_STEPS (path B's
# step takes ~0.15 s), path C at B_CHECK with per-env joint ranges
# JNT_RANGE_STEPS, path A with heading noise HEADING_STEPS
SUBSTEP_STEPS = 50
STAGED_DR_STEPS = 60
JNT_RANGE_STEPS = 20
HEADING_STEPS = 50
# the trainer phase: the README's PPO recipe (64x64 tanh ActorCritic, T=32,
# 10 epochs x 32 minibatches, blocks of 128 rows, 4 Newton and 3 line-search
# iterations) at 4096 umaze envs
TRAIN_FLAGS = ["--algo", "ppo", "--maze", "umaze", "--num-envs", "4096",
               "--normalize", "--seed", str(SEED)]
TRAIN_ITERS = 1       # iterations of the main run; the resume adds one
TIMED_ITERS = 2       # iterations timed by CUDA events after one warm-up
# the reference-compat trainer (compat_trainer_phase): --reference-compat
# at 4096 envs on the CLI's default arena, the open floor; there every
# no-hit beam counts as a collision, so the reward per step is the -50
# penalty, -0.01 and -0.1 x the goal distance: the bounds
# tests/test_env_parity.py holds the JAX env to
COMPAT_TRAIN = ["--algo", "ppo", "--reference-compat", "--num-envs", "4096",
                "--seed", str(SEED)]
REWARD_BOUNDS = (-52.0, -49.0)
# the per-env step (per_env_phase): PER_ENV_B envs one at a time for
# PER_ENV_STEPS steps.  Against the staged step on the same inputs: qpos
# 1e-6; qvel 1e-4 of 1 + the env's largest |qvel| (the two solve the same
# system in float32, summing in other orders; ~1e-6 on the CPU against
# JAX's per-env step, tests/test_torch_per_env_step.py).  The CPU's per-env
# step against the card's, each step from the card's states: 1e-4 (the
# same program, other libraries' rounding).
PER_ENV_B = 8
PER_ENV_STEPS = 5
PER_ENV_TOL = dict(qpos=1e-6, qvel=1e-4, cpu=1e-4)
# the tooling phase: the Gym vector env over the main path's env and width
# (K1 once a step, K2 at reset; the trajectory bitwise equal to
# step_autoreset_batch's on the same env, seed and actions), the single
# Gym env, the SB3 loaders with a 200-step PPO evaluation at 4096 envs, the
# spawners and main_sim --headless.  SB3_TOL: the loaded modules against an
# SB3-layout forward of the same weights on the card (the same Linear
# products: last-ulp at most), and the card's outputs against the CPU's
# (other BLAS summation orders over up to 400 inputs; the outputs reach
# ~10).  SIM_TOL: main_sim's final state on the card against the CPU's
# after SIM_STEPS steps, PER_ENV_TOL's card-against-CPU bound (the same
# per-env program, other libraries' rounding: per_env_phase reads 2.4e-6
# in qvel over 20 steps, |qvel| reaching ~13 on the wheels).
GYM_B = B_MAIN
GYM_STEPS = STEPS
GYM_SINGLE_STEPS = 20
# the import phase: ackermann_robot_v2 through to_mjcf -> from_mjcf ->
# make_model (umaze, solver 4/3) beside the hand spec's model.  Every
# float32 leaf of the same shape within IMPORT_ULPS ulps of the hand
# spec's (the float64 compile rounds both alike: bitwise expected); the
# leaves that may differ otherwise are the chassis hulls (to_mjcf writes
# each chassis mesh proxy as its box, so the imported hulls are the boxes'
# 8 corners, which K1 takes padded).  Both models step the main path's
# 16384 reset states IMPORT_STEPS times through K1 <0,0,0> with the same
# ctrl, held against each other with K1's tolerances (check_k1): no
# chassis touches anything from a reset in 50 steps, so the same bits are
# expected.
IMPORT_STEPS = 50
IMPORT_ULPS = 1
IMPORT_HULL_FIELDS = ("chassis_hull_verts", "chassis_hull_quadrants",
                      "chassis_hull_bias", "chassis_hull_faces")
# the batch-last assembly phase: path B's last states (compat manifolds,
# 16384 envs) stepped BL_STEPS times through the staged step with the rows
# assembled in K3's layout (constraint_bl.make_efc_bl, K3 with
# pre_transposed); on the same states K3 in the kernel layout is held
# bitwise against K3 row-major on the same arrays moved to row-major,
# against its twin with check_k3's rules, and against K3 on the staged
# step's own assembly (engine.newton_inputs) with check_k3's tolerance and
# set_aside rule (the two assemblies sum in other orders: c_aref parts by
# ~1 ulp).  BL_ROWS_TOL: the two assemblies' arrays, (atol, rtol) against
# each array's largest |value| (the Jacobians ~1, c_aref ~1e3-1e4).
BL_STEPS = 20
BL_ROWS_TOL = (1e-6, 1e-6)
OPTIONAL = ("gymnasium", "gymnasium_robotics", "mujoco", "matplotlib",
            "pygame", "glfw")
SB3_EVAL_B = 4096
SB3_EVAL_STEPS = 200
SB3_TOL = dict(layout=1e-5, cpu=1e-4)
SPAWN_STEPS = 4
SIM_STEPS = 50
SIM_TOL = PER_ENV_TOL["cpu"]
# the solved phase: README.md's solved recipe (256x256 towers, obs 81, the
# geodesic shaping and the goal compass, gamma 0.995, 6000-step episodes)
# at 4096 umaze envs, as written and with a random spawn heading; then the
# committed solved policies and a random policy scored with
# rl_logs/solved/EVAL.json's protocol (512 parallel episodes, a
# deterministic policy, eval seed 0, at most 6000 steps, with norm)
EVAL_STEPS = 6000
SOLVED_ENV = ["--maze", "umaze", "--max-velocity", "1.5", "--max-angular",
              "3.0", "--max-episode-steps", str(EVAL_STEPS),
              "--goal-threshold", "0.5",
              "--sane-collision", "--collision-penalty", "-1",
              "--geodesic-reward", "10", "--goal-compass", "--normalize",
              "--hidden", "256", "256"]
SOLVED_TRAIN = ["--algo", "ppo", "--num-envs", "4096", "--anneal-lr",
                "--gamma", "0.995", "--seed", str(SEED)] + SOLVED_ENV
HEADING_NOISE = ["--spawn-heading-noise", "3.14159265"]
EVAL_EPISODES = 512
# (run under rl_logs/, its checkpoint's step, its extra env flags)
SOLVED_RUNS = (("solved", 1500119040, []),
               ("solved_randyaw", 3000107008, HEADING_NOISE))
# the evaluations play EVAL.json's own 512 episodes: each one's spawn,
# goal and spawn yaw as the JAX package drew them for eval seed 0, and the
# random baseline's actions (one uniform draw per episode, held on every
# step, as scripts/solved_eval.py's fixed key gives them), stored beside
# each converted checkpoint by scripts/torch_convert_solved.py
EVAL_DRAWS = "eval_seed0.npz"
# a success rate may lie this many binomial standard deviations (at
# EVAL_EPISODES) from EVAL.json's: the episodes are the same, but the
# float arithmetic of the card and the TPU differs, and a trajectory of up
# to 6000 steps carries a difference on
SUCCESS_SDS = 3.0
HEADING_COL = 74   # the heading column of the observation
# the off-policy phase: the committed SAC/TD3 runs' configuration
# (rl_logs/offpolicy/EVAL.json; BENCHMARKS.md) at its width, 256 umaze
# envs, cut from 20M env steps to one warm-up iteration and two chunks of
# 97 iterations (199,680); a resume adds one chunk
OFFPOLICY_ENV = ["--maze", "umaze", "--progress-reward", "3"]
OFFPOLICY_TRAIN = (["--num-envs", "256", "--seed", str(SEED),
                    "--save-freq", str(10**9)] + OFFPOLICY_ENV)
OFFPOLICY_STEPS = 199680
OFFPOLICY_EVAL_EPISODES = 256
OFFPOLICY_EVAL_STEPS = 1000
# a mean return may lie this many standard errors (EVAL.json's
# std_return / sqrt(256)) from EVAL.json's, on the same episodes
RETURN_SES = 3.0
# A few of these episodes are chaotic: a wall contact decides whether the
# robot slides off or stays pinned, at -50 a step, for hundreds of steps.
# Moving one spawn by one float32 ulp moves SAC's episode 29 from -190 to
# -3,598 or -18,749 (PERF.md §6), and EVAL.json's figure is one draw of
# that chaos on the TPU's arithmetic.  So each policy is also scored with
# every spawn coordinate moved one ulp up or down (a seeded direction),
# NUDGES times, and the mean return held is the median over the 1 + NUDGES
# evaluations; the success rate is held on EVAL.json's episodes as drawn.
NUDGES = 16
# one minibatch update on the card against the same update on the CPU:
# loss parts within 1e-5 (abs, and of their size), gradients within 1e-4
# of each tensor's largest |gradient|, parameters after the Adam step
# within 1e-6; the same update with TF32 matmuls on must miss one of them
UPDATE_TOL = dict(loss=1e-5, grad=1e-4, param=1e-6)
# a run resumed from a checkpoint against the straight run: parameters
# within 1e-6 (the card's kernels and torch's ops here repeat their bits,
# so the runs should agree bitwise; the line says whether they do)
RESUME_TOL = 1e-6
# the data-parallel phase (parallel_phase): the README PPO recipe at 4096
# global envs and SAC/TD3 at the committed runs' configuration (256 envs,
# progress reward 3; one warm-up iteration of uniform actions), PAR_ITERS
# iterations each, through scripts/torch_multihost_train.py's flags.  (a)
# in this process: without a process group and as an NCCL group of world
# size 1, in the order A B B A, which must be bitwise the same; (b) two
# gloo ranks of the script sharing the card (NCCL refuses two ranks on one
# device): their hashes equal, their parameters within PAR_PARAM_TOL of
# the largest |parameter| of (a)'s one-process run
# (tests/test_torch_parallel.py's PARAM_TOL: each rank's policy forward
# runs on its own rows, which may round differently); (c)
# scripts/torch_scale_bench.py at N=1, SCALE_ENVS envs and the main path's
# step count.  Before all three, K1 and K2 against their twins at the
# ranks' local batches, PAR_LOCAL_B
PAR_ITERS = 1
PAR_PPO = ["--algo", "ppo", "--num-envs", "4096", "--unroll", "32",
           "--minibatches", "32", "--epochs", "10", "--normalize"]
PAR_OFF = ["--algo", "sac", "td3", "--num-envs", "256",
           "--progress-reward", "3"]
PAR_COMMON = ["--solver-iterations", "4", "--ls-iterations", "3",
              "--steps", str(PAR_ITERS), "--seed", str(SEED)]
PAR_PARAM_TOL = 1e-5
PAR_COLLECTIVE_REPS = 50
PAR_LOCAL_B = (2048, 128)    # 4096 and 256 envs over 2 ranks
SCALE_ENVS = B_MAIN
SCALE_STEPS = STEPS - WARMUP
# the capability phase (the JAX package's learning record): K1 <0,0,0>
# and K2 at the 1-env recipe's odd partial blocks; K1 with the evaluation's
# flag set <1,0,0> and K2 on medium-maze states at the medium evaluation's
# width (CAP_MEDIUM_WARM random-action steps from EVAL.json's episodes);
# the converted medium policy on rl_logs/solved_medium/EVAL.json's own
# episodes (512 x 12000); the scripted expert on umaze with PARITY.md's
# protocol (512 x 6000, scripts/torch_scripted_ceiling.py); one iteration
# of the 1-env reference-compat recipe on the open floor
# (scripts/torch_reference_compat_run.py), whose two finished episodes pay
# the -50 collision penalty on each of their 1000 steps
CAP_SMALL_B = (1, 3)
CAP_MEDIUM = ("solved_medium", 3000107008)
CAP_MEDIUM_WARM = 200
CAP_SCRIPTED = ["--max-velocity", "1.5", "--max-angular", "3.0",
                "--max-episode-steps", "6000", "--episodes", "512"]
CAP_COMPAT_STEPS = 2048
CAP_EPISODE_BOUNDS = (1000 * REWARD_BOUNDS[0], 1000 * REWARD_BOUNDS[1])

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 and float64
# FLOP/s outside the tensor cores, at the 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12      # float64 outside the tensor cores (K3's arithmetic)

# (atol, rtol) of each K1 output against the plain twin on the same inputs,
# about 10x the largest difference read on an H100 (PERF.md).  qpos, xpos
# and xquat: float32 rounding of ~1 m values.  qvel and qacc are held per
# env, normwise: the Newton solve mixes all dofs of an env, so rtol
# multiplies the env's largest |value| of that output (accelerations reach
# 1e4 in wall contacts; the readings are ~3e-5 of that).  Env slab: lidar
# readings, in meters, lose relative precision where a beam meets the floor
# at a grazing angle (~1e-5 of the reading).
K1_TOL = dict(qpos=(1e-6, 0.0), qvel=(1e-5, 3e-4), xpos=(1e-6, 0.0),
              xquat=(1e-6, 0.0), qacc=(1e-2, 3e-4), slab=(1e-5, 1e-4))
K1_NORMWISE = ("qvel", "qacc")
K2_TOL = (5e-6, 0.0)
# K2 with a per-env floor, held on path C's stepped frames: tilted robots
# aim beams at the floor, and a beam that meets it at a grazing angle
# loses relative precision (~1e-5 of the reading), as K1's fused scans on
# stepped frames do: K1's slab tolerance (K2_TOL holds reset frames, whose
# beams are level)
K2F_TOL = K1_TOL["slab"]
# K3's qacc against its twin, per env and normwise like K1's qacc: the
# kernel computes in float64 and the twin (the yardstick) in float32, whose
# rounding the tolerance covers where the solve is well-conditioned; beside
# that the two sum the Hessian and gradients over the contact rows in
# different orders (the kernel row by row over the rows in contact, the
# twin over all rows at once), and the solve mixes every dof of an env.
# The kernel is also held, with no set-aside, to the twin run in float64
# on the same inputs (k3_states_check, the captured envs)
K3_TOL = (1e-2, 3e-4)
# K1 is held strictly.  Its per-env program computes every decision it
# shares with its float32 twin (contact activity, the rim point of a wheel
# against a box, the deepest hull vertex, a joint limit's side, a pyramid
# edge or a friction row inside the solve) from the same IEEE operations
# in the same order, so the physics outputs are the twin's bits: sin and
# cos by one shared polynomial (csrc/lanes.cuh sincos_k1), sqrt correctly
# rounded, the state-independent entries of M as the twin folds them, and
# the sums over contact rows run by run (PERF.md).  Before that, one
# wall-contact env step in about 5,000 (host build; one env step in about
# 165,000 on an H100) parted from the twin by up to 6,400x the tolerance,
# where a disc end's center lay inside a wall box and the direction to the
# rim point was rounding noise, or a stiff row sat on a pyramid edge's
# kink inside an unconverged solve (K1_MISSES holds 43 such envs).  The
# one-ulp rule below stays for K3, whose float64 solve is held to a
# float32 twin: an env over the tolerance is set aside only if the twins
# show it ill-conditioned without the kernel (fed the same inputs with
# qpos, qvel and the warm start, K3: the smooth acceleration, the
# reference accelerations and the warm start, each moved one float32 ulp
# up or down at random, the float64 or the float32 twin moves by more than
# the tolerance in one of ULP_DRAWS draws), or where the float32 twin is
# the one that is wrong (more than the tolerance from the float64 twin on
# the same inputs, the kernel within the tolerance of it).  K1's and K1e's
# checks on wall-contact states and at the paths' B=16384 still run the
# rule and print how many envs each verdict took, but fail on any env set
# aside as ill-conditioned.  At most MAX_FLIPS envs may be set aside, of
# both kinds together; their ids, the twins' moves and the three distances
# (kernel to the float32 twin, float32 twin to the float64 twin, kernel to
# the float64 twin) are printed, and max_abs_err covers all envs.
MAX_FLIPS = 16
ULP_DRAWS = 8


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms per call of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_times(events):
    """(device us, count, name) of each kernel in a profiler's
    key_averages(), the largest first.  Operator entries are left out:
    their device time is that of the kernels they launched, which the trace
    lists as well; so are user annotations on the device's timeline (such
    as ``Optimizer.step#Adam.step``), which span kernels listed too."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total, e.count, e.key) for e in events
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0), reverse=True)


def graph_ms(fn, reps):
    """Mean device ms per call of fn, timed by CUDA events around one replay
    of a CUDA graph of reps calls: no host work between the launches, so a
    kernel shorter than its wrapper's host path is timed by itself.  fn
    launches on the current stream and allocates only through PyTorch."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_err(got, want, atol, rtol, normwise=False):
    """(max abs error, max error relative to the reference, worst excess
    over atol + rtol |want|) of (rows, B) outputs; ``normwise`` measures
    each env (column) by its largest |error| and largest |want|."""
    d = (got - want).abs()
    ref = want.abs()
    if normwise:
        d, ref = d.amax(0), ref.amax(0)
    rel = float((d / ref.clamp_min(1e-30)).max())
    return float(d.max()), rel, float((d - atol - rtol * ref).max())


def env_ratio(got, want, atol, rtol, normwise):
    """Per env (column): its largest |got - want| in units of atol + rtol
    |want| (normwise: the env's largest |error| against its largest
    |want|); over 1 is over tolerance."""
    d = (got.double() - want.double()).abs()
    ref = want.double().abs()
    if normwise:
        return d.amax(0) / (atol + rtol * ref.amax(0))
    return (d / (atol + rtol * ref)).amax(0)


def outputs_ratio(got, want, tols):
    """Per env: env_ratio's largest value over the outputs."""
    return torch.stack([env_ratio(g, w, *tol)
                        for g, w, tol in zip(got, want, tols)]).amax(0)


def nudge(t, gen):
    """Float32 t with every entry moved one ulp up or down at random."""
    up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
    inf = torch.full_like(t, math.inf)
    return torch.nextafter(t, torch.where(up, inf, -inf))


def ill_conditioned(run, tols, gen, got, draws=ULP_DRAWS):
    """Per env of a subset, how far the twins move when the inputs move one
    ulp: ``run(dtype, nudged)`` gives the twin's outputs in dtype on the
    subset's inputs, ``nudged`` with one-ulp moves; tols lists (atol, rtol,
    normwise) per output; got is the kernel's outputs on the subset.
    Returns the largest move of the float64 and of the float32 twin over
    ``draws`` draws (none: zeros), the kernel's distance to the nearest
    twin run, and on the inputs as they are the kernel's distance to the
    float64 twin and the float32 twin's, all in units of the tolerance
    (outputs_ratio)."""
    moved, near, bases = [], None, []
    for dtype in (torch.float64, torch.float32):
        base = run(dtype, False)
        bases.append(base)
        most = torch.zeros(got[0].shape[-1], dtype=torch.float64,
                           device=got[0].device)
        for draw in range(draws + 1):
            out = base if draw == 0 else run(dtype, True)
            most = torch.maximum(most, outputs_ratio(out, base, tols))
            gap = outputs_ratio(got, out, tols)
            near = gap if near is None else torch.minimum(near, gap)
        moved.append(most)
    return (moved[0], moved[1], near, outputs_ratio(got, bases[0], tols),
            outputs_ratio(bases[1], bases[0], tols))


def set_aside(label, ratio, witness, got, failures, ill_ok=True):
    """Of the envs over tolerance (``ratio`` (B,), each env's distance to
    the float32 twin in units of it, over 1), at most MAX_FLIPS, those where
    the float32 twin is more than the tolerance from the float64 twin and
    the kernel within it, or, of the others, those that ``witness`` (env
    ids, the kernel's outputs on them and the number of nudged draws ->
    ill_conditioned's numbers) shows ill-conditioned without the kernel (a
    twin moves by more than the tolerance); with ``ill_ok`` False (K1 and
    K1e) an env shown ill-conditioned fails too.  Appends a failure for any
    env not admitted, and prints how many envs each verdict took.  Returns
    the bool (B,) mask of the envs set aside."""
    over = ratio > 1
    ids = torch.nonzero(over).flatten()
    aside = torch.zeros_like(over)

    def verdicts(off, ill, refused):
        print(f"check {label}: set_aside verdicts: {off} set aside with the "
              f"float32 twin off the float64 answer, {ill} "
              f"ill-conditioned{'' if ill_ok else ' (not admitted)'}, "
              f"{refused} not ill-conditioned")
    if len(ids) > MAX_FLIPS:
        print(f"check {label}: {len(ids)} envs over tolerance (allowed: "
              f"{MAX_FLIPS} if ill-conditioned)")
        failures.append(f"{label} envs over tolerance")
        return aside
    print(f"check {label}: envs over tolerance {ids.tolist()}")
    if not len(ids):
        verdicts(0, 0, 0)
        return aside
    *_, k64, t32_64 = witness(ids, [g[..., ids] for g in got], 0)
    yardstick = (t32_64 > 1) & (k64 <= 1)
    # the one-ulp nudges only for the envs the float64 twin does not settle
    ill = torch.zeros_like(yardstick)
    rest = torch.nonzero(~yardstick).flatten()
    moves = {}
    if len(rest):
        moved64, moved32, near, _, _ = witness(
            ids[rest], [g[..., ids[rest]] for g in got])
        ill[rest] = (moved64 > 1) | (moved32 > 1)
        moves = dict(zip(rest.tolist(), zip(moved64.tolist(),
                                            moved32.tolist(), near.tolist())))
    ill = ill & ~yardstick
    admitted = yardstick | ill if ill_ok else yardstick
    aside[ids[admitted]] = True
    verdicts(int(yardstick.sum()), int(ill.sum()),
             int((~(ill | yardstick)).sum()))
    for i, env in enumerate(ids.tolist()):
        line = (f"  env {env}: the kernel {float(ratio[env]):.3g}x the "
                f"tolerance from the float32 twin, the float32 twin "
                f"{float(t32_64[i]):.3g}x from the float64 twin, the kernel "
                f"{float(k64[i]):.3g}x from it")
        if i in moves:
            m64, m32, nr = moves[i]
            line += (f"; under one-ulp input moves the float64 twin moves "
                     f"{m64:.3g}x and the float32 twin {m32:.3g}x; the "
                     f"kernel is {nr:.3g}x from the nearest twin run")
        verdict = ("set aside: the float32 twin is off the float64 answer"
                   if bool(yardstick[i]) else
                   ("set aside: ill-conditioned" if ill_ok else
                    "ill-conditioned, NOT admitted for this kernel")
                   if bool(ill[i]) else "NOT ill-conditioned")
        print(f"{line}; {verdict}")
    if not bool((ill | yardstick).all()):
        failures.append(f"{label} envs over tolerance, not ill-conditioned")
    if not ill_ok and bool(ill.any()):
        failures.append(f"{label} envs over tolerance, ill-conditioned")
    return aside


def angle_free(slab, model):
    """The env slab with its goal-angle row as sin and cos rows (a wrap may
    differ by 2 pi at +-pi)."""
    a = model.nsite + 6
    return torch.cat([slab[:a], slab[a + 1:], torch.sin(slab[a:a + 1]),
                      torch.cos(slab[a:a + 1])])


K1_TOLS = [K1_TOL[n] + (n in K1_NORMWISE,) for n in K1_TOL]


def k1_views(outs, model):
    """K1's outputs as the checks compare them (the slab angle-free)."""
    return [angle_free(t, model) if name == "slab" else t
            for name, t in zip(K1_TOL, outs)]


def check_outputs(label, names, tols, got, want, failures, witness=None,
                  ill_ok=True):
    """Prints each output's max error against the twin; appends the ones
    over tolerance to failures; returns the max abs error over all envs.
    With ``witness`` (see set_aside) envs over tolerance may be set aside,
    and each output's error is printed over all envs and over the rest."""
    aside = None
    if witness is not None:
        aside = set_aside(label, outputs_ratio(got, want, tols), witness,
                          got, failures, ill_ok)
    worst = 0.0
    for name, g, w, (atol, rtol, normwise) in zip(names, got, want, tols):
        err, rel, excess = max_err(g, w, atol, rtol, normwise)
        per = " per env" if normwise else ""
        relative = f", max |err|/|ref|{per} {rel:.3e}" if rtol else ""
        rest = ""
        if aside is not None and bool(aside.any()):
            err_r, rel_r, excess = max_err(g[..., ~aside], w[..., ~aside],
                                           atol, rtol, normwise)
            rest = (f"; other envs {err_r:.3e}"
                    + (f", {rel_r:.3e}" if rtol else ""))
        print(f"check {label} {name}: max |err| {err:.3e}{relative}{rest} "
              f"(tol {atol:g} + {rtol:g}|ref|{per})")
        if not math.isfinite(err) or excess > 0:
            failures.append(f"{label} {name}")
        worst = max(worst, err)
    return worst


def check_k1(label, got, want, model, failures, witness=None):
    """K1's (K1e's) outputs against the twin's; an env shown
    ill-conditioned by ``witness`` is not admitted (set_aside).  Prints how
    many envs have physics outputs (qpos, qvel, xpos, xquat, qacc) that
    differ from the twin's in any bit."""
    apart = torch.stack([(g != w).any(0) for g, w in
                         zip(got[:5], want[:5])]).any(0)
    print(f"check K1 {label}: physics outputs not bitwise on "
          f"{int(apart.sum())} of {apart.shape[0]} envs")
    return check_outputs(f"K1 {label}", list(K1_TOL), K1_TOLS,
                         k1_views(got, model), k1_views(want, model),
                         failures, witness, ill_ok=False)


def check_k3(label, got, want, failures, witness=None):
    return check_outputs(f"K3 {label}", ["qacc"], [K3_TOL + (True,)],
                         [got], [want], failures, witness)


def k1_witness(args, gen, dr_params=None):
    """set_aside's witness for K1's (with ``dr_params`` K1e's) check on
    ``args`` (step_plain's)."""
    from mujoco_playground_tpu_torch.ops import step as k1
    model, q, v, ctrl, ws, env_in, statics, fresh, ws_compare = args

    def witness(ids, got, draws=ULP_DRAWS):
        def run(dtype, nudged):
            def sub(t, move=False):
                if t is None:
                    return None
                t = t[:, ids].contiguous()
                return (nudge(t, gen) if move and nudged else t).to(dtype)
            return k1_views(k1.step_plain(
                model, sub(q, True), sub(v, True), sub(ctrl), sub(ws, True),
                sub(env_in), statics, fresh, ws_compare,
                dr_params=None if dr_params is None else sub(dr_params)),
                model)
        return ill_conditioned(run, K1_TOLS, gen, got, draws)
    return witness


def k3_witness(args, ws, gen):
    """set_aside's witness for K3's check on ``args`` (newton_solve's)."""
    from mujoco_playground_tpu_torch.ops import newton as k3
    moved = (1, 3, 11)     # a_s, j_aref, c_aref

    def witness(ids, got, draws=ULP_DRAWS):
        def run(dtype, nudged):
            def sub(i, t, move=False):
                if not isinstance(t, torch.Tensor):
                    return t
                t = t[..., ids].contiguous()
                return (nudge(t, gen) if move and nudged else t).to(dtype)
            return [k3.newton_solve_plain(
                *(sub(i, t, i in moved) for i, t in enumerate(args)),
                warmstart=sub(-1, ws, True))]
        return ill_conditioned(run, [K3_TOL + (True,)], gen, got, draws)
    return witness


def load_k3_misses(path, device):
    """The K3 inputs that scripts/torch_k3_probe.py --save wrote: (each
    newton_solve argument with the envs batch-last, the warm start, [(seed,
    step, env)] of each env)."""
    z = np.load(path)
    args = []
    for name in K3_ARG_NAMES:
        v = z[name]
        if name == "j_kind":
            args.append(tuple(int(k) for k in v))
        elif v.ndim == 0:
            args.append(int(v))
        else:
            args.append(torch.from_numpy(v).to(device))
    ids = list(zip(z["seed"].tolist(), z["step"].tolist(),
                   z["env"].tolist()))
    return args, torch.from_numpy(z["warmstart"]).to(device), ids


def load_k1_misses(path, device):
    """What scripts/torch_k1_probe.py --save wrote: the captured envs' K1
    inputs (envs last) on ``device``, their flag sets (variant, (N, 4)
    bool) and what the probe recorded (path, seed, step, env, kind and
    distances, as numpy arrays)."""
    z = np.load(path)
    out = {k: z[k] for k in z.files}
    for name in ("qpos", "qvel", "ctrl", "warmstart", "env_in", "dr"):
        out[name] = torch.from_numpy(z[name]).to(device)
    out["variant"] = z["variant"].astype(bool)
    return out


def base_dr_params(model, B):
    """K1e's packed parameters with every env on the model's own values."""
    from types import SimpleNamespace

    from mujoco_playground_tpu_torch.ops import step as k1
    return k1.pack_dr_params(SimpleNamespace(**{
        name: getattr(model, name).expand((B,) + getattr(model, name).shape)
        for name in k1.DR_SUPPORTED}), k1.DR_SUPPORTED).to(model.dtype)


def k1_miss_groups(env, z, with_k1e=False):
    """The captured envs by flag set: (key, step_plain's args, dr_params
    or None, their indices in the file).  With ``with_k1e`` each K1 group
    is also given to K1e, on the model's own parameters."""
    model = env.model
    keys = [tuple(bool(x) for x in v) for v in z["variant"]]
    for key in sorted(set(keys)):
        idx = [j for j, k in enumerate(keys) if k == key]
        with_env, with_fresh, ws_compare, dr_on = key

        def cols(t, rows=None):
            t = t[:rows] if rows is not None else t
            return t[:, idx].contiguous()
        args = (model, cols(z["qpos"]), cols(z["qvel"]), cols(z["ctrl"]),
                cols(z["warmstart"]),
                cols(z["env_in"], 7 if with_fresh else 5) if with_env
                else None,
                env._env_statics() if with_env else None,
                env._fresh_statics() if with_fresh else None, ws_compare)
        dr = cols(z["dr"]) if dr_on else None
        yield key, args, dr, idx
        if with_k1e and not dr_on and not ws_compare:
            yield key[:3] + (True,), args, base_dr_params(
                model, len(idx)).to(z["qpos"].device), idx


def k1_misses_check(env, dev, failures, run=None):
    """K1 and K1e on the captured envs (K1_MISSES), held strictly:
    ``run(args, dr)`` gives the kernel's outputs (the card's by default).
    Returns the largest error."""
    from mujoco_playground_tpu_torch.ops import step as k1
    run = run or (lambda a, dr: k1.step_fused(*a, dr_params=dr))
    z = load_k1_misses(K1_MISSES, dev)
    worst = 0.0
    for key, args, dr, idx in k1_miss_groups(env, z, with_k1e=True):
        got = run(args, dr)
        want = k1.step_plain(*args, dr_params=dr)
        worst = max(worst, check_k1(
            f"captured {'K1e' if key[3] else 'K1'} "
            f"<{','.join(str(int(x)) for x in key)}> ({len(idx)} envs)",
            got, want, env.model, failures))
    return worst


def as_f64(args):
    """A kernel's arguments with every float tensor in float64."""
    return [t.double() if isinstance(t, torch.Tensor) and t.is_floating_point()
            else t for t in args]


def check_k3_f64(label, got, args, ws, failures):
    """K3's qacc against its twin run in float64 on the same inputs, with
    K3_TOL and no set-aside (the kernel computes in float64).  Returns the
    worst env's distance in units of the tolerance."""
    from mujoco_playground_tpu_torch.ops import newton as k3
    want = k3.newton_solve_plain(*as_f64(args), warmstart=ws.double())
    worst = float(outputs_ratio([got], [want], [K3_TOL + (True,)]).max())
    print(f"check K3 {label} against the float64 twin: worst env "
          f"{worst:.3g}x the tolerance")
    if not worst <= 1:
        failures.append(f"K3 {label} against the float64 twin")
    return worst


def k3_states_check(label, model, states, gen, failures):
    """K3 against its twin (check_k3 with set_aside) and against the twin in
    float64 (check_k3_f64) on the Newton system of ``states``
    (engine.newton_inputs) with their warm start, outside the launch
    counts: K3's counts are as they were before.  Returns the worst env's
    distance to the float32 twin and to the float64 one in units of the
    tolerance."""
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.physics import engine
    counts = (k3.newton_solve.launches, k3.newton_solve.launches_kernel_layout)
    args = engine.newton_inputs(model, states.physics)
    ws = states.physics.qacc_warmstart.T.contiguous()
    got = k3.newton_solve(*args, warmstart=ws)
    want = k3.newton_solve_plain(*args, warmstart=ws)
    worst = float(outputs_ratio([got], [want], [K3_TOL + (True,)]).max())
    check_k3(label, got, want, failures, k3_witness(args, ws, gen))
    worst64 = check_k3_f64(label, got, args, ws, failures)
    (k3.newton_solve.launches,
     k3.newton_solve.launches_kernel_layout) = counts
    return worst, worst64


def check_repeat(label, first, second, failures):
    """Two launches on the same inputs must give the same bits."""
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"check {label} B={B_MAIN}: a second launch on the same inputs is "
          f"bitwise equal: {same}")
    if not same:
        failures.append(f"{label} repeat")


def check_k2(label, got, want, failures, tol=K2_TOL):
    err, rel, excess = max_err(got, want, *tol)
    print(f"check K2 {label}: max |err| {err:.3e}, max |err|/|ref| "
          f"{rel:.3e} (tol {tol[0]:g} + {tol[1]:g}|ref|)")
    if not math.isfinite(err) or excess > 0:
        failures.append(f"K2 {label}")
    return err


def ptxas_report(logs):
    """Per kernel function: registers, stack and spill bytes from -Xptxas -v."""
    rows = []
    for src, text in logs.items():
        fn = None
        for line in text.splitlines():
            if "Compiling entry function" in line or "Function properties" in line:
                fn = line.split("'")[1] if "'" in line else line.split()[-1]
            if "bytes stack frame" in line or "Used" in line:
                rows.append(f"{src} {fn}: {line.split(':', 1)[-1].strip()}")
    return rows


def k1_occupancy_report(build):
    """Per K1/K1e flag set: shared bytes per block and resident warps per
    SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes
    from mujoco_playground_tpu_torch.ops import step as k1
    rows = []
    for (with_env, with_fresh, ws_compare, dr) in k1.K1_VARIANTS:
        src = "step_kernel_dr.cu" if dr else "step_kernel.cu"
        fn = getattr(build.load(src),
                     "k1e_occupancy" if dr else "k1_occupancy")
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 3)()
        err = fn(int(with_env), int(with_fresh), int(ws_compare), out)
        if err != 0:
            fail(f"{src} occupancy query: CUDA error {err}")
        rows.append(f"{src} <{int(with_env)},{int(with_fresh)},"
                    f"{int(ws_compare)}{',1' if dr else ''}>: {out[0]} B "
                    f"shared per block of {out[1]} threads, {out[2]} blocks"
                    f" = {out[2] * out[1] // 32} warps per SM")
    return rows


def occupancy_line(lib, name):
    """Shared bytes per block and resident warps per SM of a kernel
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, through the library's
    ``name`` export), or None where the library does not export it."""
    import ctypes
    fn = getattr(lib, name, None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(out)
    if err != 0:
        fail(f"{name}: CUDA error {err}")
    return (f"{out[0]} B shared per block of {out[1]} threads, {out[2]} "
            f"blocks = {out[2] * out[1] // 32} warps per SM")


def k23_occupancy_report(build):
    """K2's and K3's occupancy lines."""
    rows = []
    for src, name in (("lidar_kernel.cu", "k2_occupancy"),
                      ("newton_kernel.cu", "k3_occupancy")):
        line = occupancy_line(build.load(src), name)
        if line is None:
            fail(f"{src} does not export {name}")
        rows.append(f"{src}: {line}")
    return rows


def chol_ops(pat, order):
    """(factor, solve) float32 operations of the Cholesky of an SPD matrix
    whose structural nonzeros are ``pat``, eliminated in ``order``, fill-in
    included: 2 per update L[i,j] -= L[i,k] L[j,k] with both factors
    nonzero, then 1 per scaled entry and the pivot's rsqrt; 2 per
    off-diagonal nonzero and 1 division per row in each triangular solve."""
    p = list(order)
    L = np.tril(pat[np.ix_(p, p)])
    fac = 0
    for j in range(len(p)):
        for k in range(j):
            if L[j, k]:
                rows = j + np.flatnonzero(L[j:, k])
                fac += 2 * len(rows)
                L[rows, j] = True
        fac += 1 + int(L[j:, j].sum())
    return fac, 2 * (2 * int(np.tril(L, -1).sum()) + len(p))


def k1_ops(model, slot_active, fresh=True, ws_compare=False, env=True):
    """Float32 operations one env step of K1 needs (an FMA counts 2),
    counted over the structural nonzeros only, as the TPU kernel's static
    pruning keeps them: each body's Jacobian over its ancestor dofs (CRBA,
    RNEA, contact rows), the tree-sparse factor and solves of M and of the
    Newton Hessian (M's pattern plus the equality rows' couplings) in the
    leaves-first order, and only the contact rows this run's data makes
    active (``slot_active``: each slot's mean activity over the envs).  The
    per-stage constants are the operations of the kernel's code
    (csrc/step_model.cuh, step_newton.cuh, lidar.cuh).  ``env=False``: the
    plain physics step (``<0,0,0>``), without the scans and env rows."""
    from mujoco_playground_tpu_torch.ops import step as k1
    sm = k1.static_model(model)
    nv, nbox, ns = sm.nv, sm.num_scene_boxes, sm.nsite
    anc = [np.flatnonzero(sm.ancestor_mask[b]) for b in range(sm.nbody)]
    n = {b: len(anc[b]) for b in range(sm.nbody)}
    m_pat = np.eye(nv, dtype=bool)
    for b in sm.bodies:
        m_pat[np.ix_(anc[b], anc[b])] = True
    h_pat = m_pat.copy()
    for d1, d2 in sm.eq_dof_pairs:
        h_pat[d1, d2] = h_pat[d2, d1] = True
    slot_body = [s[0] for s in k1.slot_statics(sm)]
    for b in set(slot_body):
        h_pat[np.ix_(anc[b], anc[b])] = True
    nnz_m = int(m_pat.sum())
    fac_m, sol_m = chol_ops(m_pat, sm.order)
    fac_h, sol_h = chol_ops(h_pat, sm.order)
    nj = (len(sm.eq_dof_pairs) + len(sm.friction_dofs)
          + 2 * len(sm.limited_dofs))

    def contacts(f):
        """Expected sum of f(n) over this run's active contact rows, n the
        row's dof count."""
        return sum(p * f(n[b]) for p, b in zip(slot_active, slot_body))

    types = list(sm.jnt_type)
    fk = (61 * (sm.nbody - 1) + 100 * types.count(1) + 12 * types.count(0)
          + 34 * (len(types) - types.count(0) - types.count(1)))
    crba = sum(150 + 72 * n[b] + 6 * n[b] * (n[b] + 1) + 12 * n[b]
               for b in sm.bodies)
    rnea = (sum(18 * n[b] + 174 for b in sm.bodies)
            + 36 * sum(sm.carried) + 25 * nv)
    smooth = 12 * sm.nu + 3 * nv + fac_m + sol_m
    nw, nh = len(sm.wheel_body), len(sm.chassis_box_body)
    nhv = sm.chassis_hull_verts.shape[1]
    collide = (nw * (120 + (12 * nbox + 280 if nbox else 0))
               + nh * (30 + 18 * nhv + 60
                       + (12 * nbox + 50 * nhv + 180 if nbox else 0)))
    rows = 25 * nj + contacts(lambda k: 33 * k + 40)
    newton_it = (20 * nj + contacts(lambda k: 20 * k + 3 * k * (k + 1) + 36)
                 + 36 + 2 * nnz_m + fac_h + sol_h
                 + 3 * nj + contacts(lambda k: 6 * k + 4) + 2 * nnz_m + 48
                 + sm.ls_iterations * (5 + 10 * nj + contacts(lambda k: 42))
                 + 2 * nv)
    ws = (2 * (12 * nj + contacts(lambda k: 6 * k + 24)) + 2 * nnz_m + 36
          if ws_compare else 0)
    euler = 2 * nnz_m + 4 * nv + fac_m + sol_m + nv + 56 + 2 * (nv - 6)
    lidar = (int(env) + int(fresh)) * ns * (72 + 27 * nbox)
    env_rows = (60 + ns + (8 * sm.nbody if fresh else 0)) if env else 0
    return (2 * fk + crba + rnea + smooth + collide + rows
            + sm.iterations * newton_it + ws + euler + lidar + env_rows)


def bound_ms(nbytes, flops, peak=PEAK_F32):
    t_b = nbytes / PEAK_BYTES * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def k3_bytes(nv, nj, nc, na):
    """Bytes one env of K3 must move, counted as k3_ops counts operations:
    M, a_s, the warm start and every joint row in, the nc active flags, the
    na rows in contact (Jn, Jt1, Jt2, c_aref, c_R, c_mu) in, qacc out."""
    return 4 * (nv * nv + 3 * nv + nj * (nv + 4) + nc
                + na * (3 * nv + 6))


def k3_ops(nv, jg, na, iterations, ls_iterations, warm):
    """Float64 operations of one env of K3 (an FMA counts 2), counted over
    the dense rows csrc/newton_kernel.cu processes: every joint row (jg: the
    nonzero count of each row's G, which the Hessian and J^T f loops skip
    to) and the na contact rows in contact, each with all nv columns."""
    nj = len(jg)
    chol = sum((nv - j) * (2 * j + 1) + 1 for j in range(nv)) + 2 * nv * nv
    rows_val = nj * (2 * nv + 2) + na * (6 * nv + 12)
    cost = nj * (2 * nv + 12) + na * (6 * nv + 40)
    ws = 2 * cost + 2 * nv * nv + 4 * nv if warm else 0
    it = (rows_val + nj * 8 + na * 16                      # values, forces
          + sum(2 * g + g * (g + 1) for g in jg)           # J^T f, G^T w G
          + na * (6 * nv + 16 + 8 * nv + 3 * nv * (nv + 1))  # contact blocks
          + 2 * nv * nv + 3 * nv + nv + chol               # grad, solve
          + nj * 2 * nv + na * (6 * nv + 4) + 2 * nv * nv + 4 * nv
          + ls_iterations * (5 + 10 * nj + 38 * na)         # line search
          + 2 * nv)
    return ws + iterations * it


def reset_counts():
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.ops import step as k1
    k1.step_fused.launches = k1.step_fused.launches_dr = 0
    k1.step_fused.by_variant.clear()
    k2.lidar.launches = k2.lidar.launches_floor = 0
    k3.newton_solve.launches = 0
    k3.newton_solve.launches_kernel_layout = 0


def read_counts():
    """Launches since reset_counts: K1, K1e, K2 with the model's floor, K2
    with a per-env floor (K2f) and K3."""
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.ops import step as k1
    return {"K1": k1.step_fused.launches, "K1e": k1.step_fused.launches_dr,
            "K2": k2.lidar.launches, "K3": k3.newton_solve.launches,
            "K2f": k2.lidar.launches_floor}


def check_finite(label, states, obs_size, B):
    for name, x in (("obs", states.obs), ("reward", states.reward),
                    ("qpos", states.physics.qpos),
                    ("qvel", states.physics.qvel),
                    ("final_obs", states.final_obs)):
        if not bool(torch.isfinite(x).all()):
            fail(f"{label}: non-finite {name}")
    if tuple(states.obs.shape) != (B, obs_size):
        fail(f"{label}: obs shape {tuple(states.obs.shape)}")


def profile_steps(label, step, n, card):
    """Device time by kernel and the device's idle share over n steps."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    kern = kernel_times(prof.key_averages())
    busy_us = sum(k[0] for k in kern)
    print(f"profile of {n} {label} steps: wall {wall_us / n:.1f} us/step, "
          f"device busy {busy_us / n:.1f} us/step, idle share "
          f"{1 - busy_us / wall_us:.3f} ({card})")
    for us, count, name in kern[:8]:
        print(f"  {us / n:9.1f} us/step  x{count // n:<3d} {name[:90]}")


def _tree_diff(a, b):
    """(largest |a - b| over float tensors, whether every leaf is equal)
    of two nested dicts/lists of tensors and plain values."""
    if isinstance(a, dict):
        out = [_tree_diff(a[k], b[k]) for k in a]
    elif isinstance(a, (list, tuple)):
        out = [_tree_diff(x, y) for x, y in zip(a, b)]
    elif isinstance(a, torch.Tensor):
        d = (float((a.double() - b.double()).abs().max())
             if a.is_floating_point() and a.numel() else 0.0)
        return d, torch.equal(a, b)
    else:
        return 0.0, a == b
    return (max((d for d, _ in out), default=0.0),
            all(e for _, e in out))


def ulp_distance(a, b):
    """Per element, the count of float32 values from a to b (0: the same
    bits; +0 and -0 are 0 apart)."""
    def ordered(x):
        i = x.float().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def model_leaf_diff(a, b):
    """The fields of two compiled models that differ, as {name: what}:
    "value" for a static field, "shape (..) vs (..)" for arrays of other
    shapes, else (max |a - b|, max ulps apart)."""
    from mujoco_playground_tpu_torch.physics.model import (ARRAY_FIELDS,
                                                           STATIC_FIELDS)
    out = {}
    for name in STATIC_FIELDS:
        if getattr(a, name) != getattr(b, name):
            out[name] = "value"
    for name in ARRAY_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if x.shape != y.shape:
            out[name] = f"shape {tuple(x.shape)} vs {tuple(y.shape)}"
        elif not torch.equal(x, y):
            out[name] = (float((x.double() - y.double()).abs().max()),
                         int(ulp_distance(x, y).max()))
    return out


def k3_to_rows(args):
    """K3's arguments in the kernel layout moved to row-major (G, Jn, Jt1,
    Jt2, c_aref), contiguous: the same values at other addresses."""
    return tuple(torch.movedim(t, 0, 1).contiguous()
                 if i in (2, 8, 9, 10, 11) else t
                 for i, t in enumerate(args))


def profiled_device_ms(fn, n):
    """Device ms per call of fn over n calls: the kernels' device time in a
    torch.profiler trace (for work a CUDA graph cannot capture, such as
    host-to-device copies of pageable constants)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(k[0] for k in kernel_times(prof.key_averages())) / n / 1e3


def import_phase(card, dev, env, reset_states):
    """The imported robot (module docstring) through K1 at the main path's
    width, beside the hand spec's model."""
    from mujoco_playground_tpu_torch.physics import engine
    from mujoco_playground_tpu_torch.physics.model import make_model
    from mujoco_playground_tpu_torch.spec import mjcf, mjcf_import, robot
    t = time.perf_counter()
    hand = robot.ackermann_robot_v2()
    xml = mjcf.to_mjcf(hand)
    spec = mjcf_import.from_mjcf(xml)
    kw = dict(solver_iterations=4, ls_iterations=3, device=dev)
    m_i = make_model(spec, env.scene, **kw)
    m_h = make_model(hand, env.scene, **kw)
    print(f"import: to_mjcf ({len(xml)} chars) -> from_mjcf -> make_model "
          f"in {time.perf_counter() - t:.2f} s; {m_i.nbody} bodies, "
          f"{m_i.nv} dofs, {m_i.nsite} sites, {m_i.nu} actuators")
    diff = model_leaf_diff(m_i, m_h)
    print(f"import: leaves that differ from the hand spec's model "
          f"(max |diff|, max ulps): {diff or 'none'}")
    bad = [n for n, d in diff.items() if n not in IMPORT_HULL_FIELDS
           and not (isinstance(d, tuple) and d[1] <= IMPORT_ULPS)]
    if bad:
        fail(f"import: leaves beyond {IMPORT_ULPS} ulp of the hand spec's "
             f"(other than the chassis hulls): {bad}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    ctrls = [torch.rand((B_MAIN, m_h.nu), generator=gen, device=dev) * 2 - 1
             for _ in range(IMPORT_STEPS)]
    start = reset_states.physics
    out, ms = {}, {}
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    reset_counts()
    for name, model in (("imported", m_i), ("hand", m_h)):
        s = start
        torch.cuda.synchronize()
        t0.record()
        for c in ctrls:
            s = engine.step_batch(model, s.replace(ctrl=c))
        t1.record()
        torch.cuda.synchronize()
        out[name], ms[name] = s, t0.elapsed_time(t1) / IMPORT_STEPS
    counts, variants = read_counts(), read_variants()
    want = 2 * IMPORT_STEPS
    print(f"import: B={B_MAIN}, {IMPORT_STEPS} steps of each model "
          f"through engine.step_batch, launches {counts} by flag set "
          f"{variants}; {ms['imported']:.4f} ms per step (imported), "
          f"{ms['hand']:.4f} ms (hand spec) ({card})")
    if counts != {"K1": want, "K1e": 0, "K2": 0, "K3": 0, "K2f": 0} or \
            variants != {PLAIN: want}:
        fail(f"import: launches {counts} {variants}, expected K1 <0,0,0> "
             f"{want} ({IMPORT_STEPS} per model)")
    failures = []
    views = {k: [s.qpos.T, s.qvel.T, s.xpos.reshape(B_MAIN, -1).T,
                 s.xquat.reshape(B_MAIN, -1).T, s.qacc_warmstart.T]
             for k, s in out.items()}
    check_k1(f"imported vs hand spec, {IMPORT_STEPS} steps B={B_MAIN}",
             views["imported"], views["hand"], m_h, failures)
    same = all(torch.equal(x, y) for x, y in zip(views["imported"],
                                                 views["hand"]))
    moved = float((out["hand"].qpos[:, :2] - start.qpos[:, :2]).norm(
        dim=-1).max())
    print(f"import: the imported model's states are bitwise the hand "
          f"spec's: {same}; robots moved up to {moved:.4f} m")
    if failures or not bool(torch.isfinite(out["imported"].qvel).all()):
        fail(f"import: the imported model parts from the hand spec's: "
             f"{failures}")
    return dict(ms=ms, counts=counts)


def constraint_bl_phase(card, dev, cenv, cstates, logs):
    """The batch-last assembly in K3's layout (module docstring) on path
    B's last states.  Returns the numbers of the kernel-layout K3's entry
    of the kernels line."""
    from mujoco_playground_tpu_torch.ops import build
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.physics import engine
    model, cph = cenv.model, cstates.physics
    lib = build.load("newton_kernel.cu")
    for row in ptxas_report({"newton_kernel.cu":
                             logs.get("newton_kernel.cu", "")}):
        print(f"  ptxas {row}")
    for name in ("k3_occupancy", "k3_occupancy_kernel_layout"):
        print(f"  occupancy newton_kernel.cu {name}: "
              f"{occupancy_line(lib, name)}")
    # the path: staged steps with the rows assembled in K3's layout
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    reset_counts()
    s = cph
    torch.cuda.synchronize()
    t0.record()
    for _ in range(BL_STEPS):
        s = engine.staged_step(model, s, kernel_layout=True)
    t1.record()
    torch.cuda.synchronize()
    counts, launches = read_counts(), k3.newton_solve.launches_kernel_layout
    step_ms = t0.elapsed_time(t1) / BL_STEPS
    print(f"batch-last assembly: B={B_MAIN}, {BL_STEPS} staged steps from "
          f"path B's last states, K3 kernel layout {launches}, launches "
          f"{counts}, {step_ms:.4f} ms per step ({card})")
    if launches != BL_STEPS or any(counts.values()):
        fail(f"batch-last assembly: K3 kernel layout {launches}, {counts}")
    if not all(bool(torch.isfinite(x).all()) for x in (s.qpos, s.qvel)):
        fail("batch-last assembly: non-finite states")

    failures = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    ws = cph.qacc_warmstart.T.contiguous()
    kl = engine.newton_inputs(model, cph, kernel_layout=True)
    rm = engine.newton_inputs(model, cph)
    rows = k3_to_rows(kl)
    got = k3.newton_solve(*kl, warmstart=ws, pre_transposed=True)
    same = torch.equal(got, k3.newton_solve(*rows, warmstart=ws))
    print(f"check K3 kernel layout B={B_MAIN}: bitwise equal to K3 "
          f"row-major on the same arrays moved to row-major: {same}")
    if not same:
        failures.append("K3 kernel layout vs row-major bits")
    err = check_k3(f"kernel layout B={B_MAIN}", got,
                   k3.newton_solve_plain(*kl, warmstart=ws,
                                         pre_transposed=True),
                   failures, k3_witness(rows, ws, gen))
    check_repeat("K3 kernel layout", [got],
                 [k3.newton_solve(*kl, warmstart=ws, pre_transposed=True)],
                 failures)
    names = ("M", "a_s", "G", "j_aref", "j_R", "j_floss", "j_active",
             "j_kind", "Jn", "Jt1", "Jt2", "c_aref", "c_R", "c_mu",
             "c_active")
    for i, name in enumerate(names):
        a, b = rows[i], rm[i]
        if not isinstance(a, torch.Tensor):
            continue
        scale = max(float(b.abs().max()), 1e-30)
        d = float((a - b).abs().max())
        print(f"check assembly {name}: batch-last against the staged "
              f"step's, max |diff| {d:.3e} (max |value| {scale:.3e}; tol "
              f"{BL_ROWS_TOL[0]:g} + {BL_ROWS_TOL[1]:g} max|value|)")
        if not d <= BL_ROWS_TOL[0] + BL_ROWS_TOL[1] * scale:
            failures.append(f"assembly {name}")
    check_k3(f"kernel layout vs the staged assembly B={B_MAIN}", got,
             k3.newton_solve(*rm, warmstart=ws), failures,
             k3_witness(rm, ws, gen))
    if failures:
        fail(f"batch-last assembly: {failures}")

    # times: each assembly with K3, then K3 alone in each layout (A B B A)
    def bl_call():
        return k3.newton_solve(*engine.newton_inputs(model, cph, True),
                               warmstart=ws, pre_transposed=True)

    def rm_call():
        return k3.newton_solve(*engine.newton_inputs(model, cph),
                               warmstart=ws)

    asm = {}
    for name, fn in (("row-major", rm_call), ("batch-last", bl_call),
                     ("batch-last ", bl_call), ("row-major ", rm_call)):
        asm.setdefault(name.strip(), []).append(
            (cuda_ms(fn, 4), profiled_device_ms(fn, 2)))
    for name, runs in asm.items():
        print(f"assembly + K3 ({name}): "
              + ", ".join(f"{m:.4f} ms per call, {d:.4f} ms on the device"
                          for m, d in runs) + f" (B={B_MAIN}, {card})")
    kl_call = functools.partial(k3.newton_solve, *kl, warmstart=ws,
                                pre_transposed=True)
    rm_k3 = functools.partial(k3.newton_solve, *rm, warmstart=ws)
    order = (("row-major", rm_k3), ("kernel layout", kl_call),
             ("kernel layout", kl_call), ("row-major", rm_k3))
    k3_times = {}
    for name, fn in order:
        k3_times.setdefault(name, []).append((cuda_ms(fn, 20),
                                              graph_ms(fn, 20)))
    for name, runs in k3_times.items():
        print(f"K3 {name} alone: " + ", ".join(
            f"{m:.4f} ms per call, {d:.4f} ms on the device"
            for m, d in runs) + f" (B={B_MAIN}, {card})")
    plain_ms = cuda_ms(lambda: k3.newton_solve_plain(
        *kl, warmstart=ws, pre_transposed=True), 1)
    na = float(kl[14].sum(0).float().mean())
    nbytes = k3_bytes(model.nv, kl[2].shape[1], kl[8].shape[1], na)
    jg = (kl[2][:, :, 0] != 0).sum(0).tolist()
    flop = k3_ops(model.nv, jg, na, model.solver_iterations,
                  model.ls_iterations, True)
    bound, by = bound_ms(nbytes * B_MAIN, flop * B_MAIN, PEAK_F64)
    ms_kl = [m for m, _ in k3_times["kernel layout"]]
    dev_kl = [d for _, d in k3_times["kernel layout"]]
    print(f"K3 kernel layout: plain {plain_ms:.2f} ms, bound {bound:.5f} ms "
          f"by {by} ({nbytes:.0f} B and {flop:.0f} operations per env with "
          f"{na:.2f} of {kl[8].shape[1]} contact rows in contact)")
    return dict(launches=launches, err=err, ms=min(ms_kl),
                dev_ms=min(dev_kl), plain_ms=plain_ms, bound=bound, by=by)


# K1_VARIANTS keys: <with_env, with_fresh, ws_compare, dr>
FUSED = (True, True, False, False)
PLAIN = (False, False, False, False)
PLAIN_DR = (False, False, False, True)
ENV_DR = (True, False, False, True)


def read_variants():
    """K1 and K1e launches since reset_counts, by flag set."""
    from mujoco_playground_tpu_torch.ops import step as k1
    return dict(k1.step_fused.by_variant)


def shifted_ranges(model, B):
    """Per-env joint ranges: the limited joints' ranges shifted by -0.7 ..
    0.7 rad across the B envs, so that q = 0 lies outside some envs'."""
    rng = model.jnt_range.expand((B,) + model.jnt_range.shape).clone()
    shift = torch.linspace(-0.7, 0.7, B, device=rng.device)
    for d in model.limited_dofs:
        rng[:, model.dof_jnt[d]] += shift[:, None]
    return rng


def run_path(label, step, states, n, warmup, t0, t1, want, variants, card):
    """n steps of ``states = step(states, i)`` after a reset already
    counted; CUDA events over steps warmup..n.  Fails unless the launch
    counts equal ``want`` and the K1/K1e counts by flag set ``variants``.
    Returns (states, counts, ms per env step)."""
    for i in range(n):
        if i == warmup:
            torch.cuda.synchronize()
            t0.record()
        states = step(states, i)
    t1.record()
    torch.cuda.synchronize()
    counts, by_variant = read_counts(), read_variants()
    ms = t0.elapsed_time(t1) / (n - warmup)
    B = states.steps.shape[0]
    print(f"{label}: B={B}, {n} steps, launches {counts}, K1/K1e by flag "
          f"set <env,fresh,ws_compare,dr> {by_variant}, {ms:.4f} ms/env "
          f"step, {B / ms * 1e3:.0f} env-steps/s ({card})")
    if counts != want or by_variant != variants:
        fail(f"{label}: launches {counts} {by_variant}, expected {want} "
             f"{variants}")
    return states, counts, ms


def compat_paths(card, dev, env, cenv, random_actions, t0, t1):
    """Paths R, R under DR, S, C (and C at B_CHECK with per-env joint
    ranges) and A with heading noise (module docstring), each with its
    exact launch counts.  Returns each path's last states, models and
    counts for the kernel checks at the paths' shapes."""
    from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                                  RandomizationConfig,
                                                  make_ackermann_env,
                                                  randomize_model)
    solver = dict(solver_iterations=4, ls_iterations=3, seed=SEED)
    out = {}

    def step_of(e, same=None):
        def step(s, i):
            a = same if same is not None and i < SAME_STEPS else \
                random_actions()
            return e.step_autoreset_batch(s, a)
        return step

    # path R: delayed obs + lidar aliasing (--reference-compat)
    renv = make_ackermann_env("maze", "umaze", reference_delayed_obs=True,
                              reference_lidar_aliasing=True, **solver)
    reset_counts()
    st, counts, ms = run_path(
        "path R (delayed obs + aliasing)", step_of(renv),
        renv.reset(B_MAIN), STEPS, WARMUP, t0, t1,
        {"K1": STEPS, "K1e": 0, "K2": 2 * STEPS + 1, "K3": 0, "K2f": 0},
        {PLAIN: STEPS}, card)
    check_finite("path R", st, renv.obs_size, B_MAIN)
    alias = bool((st.obs[:, :10] == st.obs[:, 71:72]).all())
    print(f"path R: obs columns 0-9 equal column 71: {alias}")
    if not alias:
        fail("path R: the aliased lidar columns differ from beam 71")
    out["R"] = dict(states=st, counts=counts, ms=ms)

    def r_step():
        nonlocal st
        st = renv.step_autoreset_batch(st, random_actions())

    profile_steps("path R", r_step, PROFILE_STEPS, card)

    # path R under the default randomization: K1e <0,0,0,dr>, the pre-step
    # observation through K2 with each env's floor, the fresh batch's on
    # the base model's
    rdr = DomainRandomizedEnv(
        renv, B_MAIN, torch.Generator(device=dev).manual_seed(SEED + 7),
        RandomizationConfig())
    reset_counts()
    st, counts, ms = run_path(
        "path R under DR", step_of(rdr), rdr.reset(), STEPS, WARMUP, t0,
        t1, {"K1": 0, "K1e": STEPS, "K2": STEPS + 1, "K3": 0, "K2f": STEPS},
        {PLAIN_DR: STEPS}, card)
    check_finite("path R under DR", st, renv.obs_size, B_MAIN)
    out["RD"] = dict(states=st, counts=counts, ms=ms, models=rdr.models)

    # path S: two physics substeps
    senv = make_ackermann_env("maze", "umaze", physics_substeps=2, **solver)
    reset_counts()
    st, counts, ms = run_path(
        "path S (two physics substeps)", step_of(senv), senv.reset(B_MAIN),
        SUBSTEP_STEPS, WARMUP, t0, t1,
        {"K1": 2 * SUBSTEP_STEPS, "K1e": 0, "K2": 1, "K3": 0, "K2f": 0},
        {PLAIN: SUBSTEP_STEPS, FUSED: SUBSTEP_STEPS}, card)
    check_finite("path S", st, senv.obs_size, B_MAIN)
    out["S"] = dict(counts=counts, ms=ms)

    # path C: the staged DR fallback, the default randomization over the
    # compat manifolds; identical starts and actions for SAME_STEPS steps,
    # so only the parameters spread the velocities
    cdr = DomainRandomizedEnv(
        cenv, B_MAIN, torch.Generator(device=dev).manual_seed(SEED + 5),
        RandomizationConfig())
    same = random_actions()[:1].expand(B_MAIN, 2)
    spread = {}

    def c_step(s, i):
        s = cdr.step_autoreset_batch(s, same if i < SAME_STEPS
                                     else random_actions())
        spread.setdefault("done", torch.zeros_like(s.done))
        if i < SAME_STEPS:
            spread["done"] |= s.done
        if i == SAME_STEPS - 1:
            spread["std"] = float(
                s.physics.qvel[~spread["done"]].std(0).max())
        return s

    reset_counts()
    st, counts, ms = run_path(
        "path C (staged DR fallback, compat manifolds)", c_step,
        cdr.reset(core=expand_tree(cenv.reset_core(1), B_MAIN)),
        STAGED_DR_STEPS, STAGED_WARMUP, t0, t1,
        {"K1": 0, "K1e": 0, "K2": 1, "K3": STAGED_DR_STEPS,
         "K2f": 2 * STAGED_DR_STEPS}, {}, card)
    print(f"path C: after {SAME_STEPS} steps from one shared start with "
          f"one shared action, max over dofs of the std of qvel: "
          f"{spread['std']:.4e}")
    if not spread["std"] > 1e-4:
        fail("path C: identical starts and actions did not spread qvel")
    check_finite("path C", st, cenv.obs_size, B_MAIN)
    out["C"] = dict(states=st, counts=counts, ms=ms, models=cdr.models)

    # the staged DR fallback on the default manifolds: per-env joint ranges
    # (outside DR_SUPPORTED) beside the default randomization, B_CHECK envs
    model = env.model
    models = randomize_model(model, torch.Generator(
        device=dev).manual_seed(SEED + 8), B_CHECK)
    models = dataclasses.replace(models,
                                 jnt_range=shifted_ranges(model, B_CHECK))
    acts = torch.Generator(device=dev).manual_seed(SEED + 9)
    reset_counts()
    st, counts, ms = run_path(
        "path C, default manifolds, per-env joint ranges",
        lambda s, i: env.step_autoreset_batch(
            s, torch.rand((B_CHECK, 2), generator=acts, device=dev) * 2 - 1,
            models=models, base_model=model),
        env.reset(B_CHECK), JNT_RANGE_STEPS, 5, t0, t1,
        {"K1": 0, "K1e": 0, "K2": 1, "K3": JNT_RANGE_STEPS,
         "K2f": 2 * JNT_RANGE_STEPS}, {}, card)
    check_finite("path C with joint ranges", st, env.obs_size, B_CHECK)

    # path A with heading noise: K1e <1,0,0,dr>, then the merged state
    # observed through K2 with each env's floor
    henv = make_ackermann_env("maze", "umaze",
                              spawn_heading_noise=3.14159265, **solver)
    hdr = DomainRandomizedEnv(
        henv, B_MAIN, torch.Generator(device=dev).manual_seed(SEED + 6),
        RandomizationConfig())
    reset_counts()
    st, counts, ms = run_path(
        "path A with heading noise", step_of(hdr), hdr.reset(),
        HEADING_STEPS, WARMUP, t0, t1,
        {"K1": 0, "K1e": HEADING_STEPS, "K2": 1, "K3": 0,
         "K2f": HEADING_STEPS}, {ENV_DR: HEADING_STEPS}, card)
    check_finite("path A with heading noise", st, henv.obs_size, B_MAIN)
    out["AH"] = dict(counts=counts, ms=ms)
    return out


def trainer_phase(card, dev):
    """The trainer through its CLI entry point at 4096 envs, its checks and
    its times (module docstring)."""
    from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
    from mujoco_playground_tpu_torch.rl import networks, ppo
    from mujoco_playground_tpu_torch.rl import train as train_lib
    from mujoco_playground_tpu_torch.rl.evaluate import (deterministic_policy,
                                                         evaluate_agent)
    from torch.profiler import ProfilerActivity, profile

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)

    def cli(run, steps, *extra):
        return (TRAIN_FLAGS + ["--timesteps", str(steps), "--log-dir",
                               os.path.join(work, run)] + list(extra))

    def config_of(argv):
        return train_lib.config_from_args(
            train_lib.make_parser().parse_args(argv))

    def latest(run):
        return ckpt_lib.latest_checkpoint(
            os.path.join(work, run, train_lib.CKPT_SUBDIR))

    def load(run):
        return torch.load(latest(run), map_location="cpu", weights_only=True)

    cfg = config_of(cli("main", 0, "--anneal-lr"))
    T, B = cfg.unroll_length, cfg.num_envs
    spi = T * B
    steps_main = TRAIN_ITERS * spi

    # the parts of the launch counts: the env's settle at construction, and
    # one evaluation (10 episodes, max_episode_steps steps each)
    reset_counts()
    env = train_lib.build_env(cfg, dev)
    settle = read_counts()
    net0 = train_lib.make_network(cfg, env)
    reset_counts()
    evaluate_agent(env, deterministic_policy(net0),
                   num_episodes=cfg.eval_episodes)
    one_eval = read_counts()
    print(f"trainer parts: the env's settle launches {settle}; one "
          f"evaluation of {cfg.eval_episodes} episodes x "
          f"{cfg.max_episode_steps} steps launches {one_eval}; a rollout "
          f"launches K1 {T} times")

    def run_main(label, argv, iters):
        reset_counts()
        t0 = time.perf_counter()
        train_lib.main(argv)
        torch.cuda.synchronize()
        got = read_counts()
        want = {"K1": settle["K1"] + iters * T + 2 * one_eval["K1"],
                "K2": settle["K2"] + 1 + 2 * one_eval["K2"], "K1e": 0,
                "K3": 0, "K2f": 0}
        print(f"trainer {label}: {time.perf_counter() - t0:.1f} s, launches "
              f"{got}; expected {want} = settle + {iters} x {T} rollout "
              f"steps + 2 evaluations (in the loop and main's), K2 at the "
              f"init reset and each evaluation's reset")
        if got != want:
            fail(f"trainer {label}: launches {got}, expected {want}")

    # the main run, then its resume for one more iteration
    run_main(f"main run ({TRAIN_ITERS} iterations)", cli("main", steps_main,
                                            "--anneal-lr"), TRAIN_ITERS)
    if ckpt_lib.checkpoint_step(latest("main")) != steps_main:
        fail(f"trainer: the last checkpoint is {latest('main')}, not step "
             f"{steps_main}")
    with open(os.path.join(work, "main", train_lib.CKPT_SUBDIR,
                           "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    losses = [x[k] for x in lines if "policy_loss" in x for k in ppo.AUX_KEYS]
    if not losses or not all(math.isfinite(v) for v in losses):
        fail(f"trainer: metrics.jsonl losses {losses}")
    saved = load("main")["network"]
    moved = max(float((saved[k] - v.cpu()).abs().max())
                for k, v in net0.state_dict().items())
    print(f"trainer main run: checkpoint {os.path.basename(latest('main'))}, "
          f"{len(lines)} metrics lines, losses finite, largest parameter "
          f"move from the seed's init {moved:.4e}")
    if not moved > 0:
        fail("trainer: the parameters did not move")
    run_main("resume (1 iteration)", cli("main", steps_main + spi,
                                         "--anneal-lr", "--resume"), 1)
    if ckpt_lib.checkpoint_step(latest("main")) != steps_main + spi:
        fail(f"trainer: the resumed run's last checkpoint is "
             f"{latest('main')}")

    # a resumed run against the straight run, with a constant learning rate
    # (--anneal-lr fits its schedule to each run's --timesteps, so a run
    # resumed to another target follows another schedule by design)
    train_lib.main(cli("split", steps_main))
    train_lib.main(cli("split", steps_main + spi, "--resume"))
    train_lib.main(cli("straight", steps_main + spi))
    a, b = load("straight"), load("split")
    d_params, same_params = _tree_diff(a["network"], b["network"])
    _, same_all = _tree_diff(a, b)
    print(f"trainer resume check: {TRAIN_ITERS} iterations + a resume for "
          f"one against {TRAIN_ITERS + 1} straight: largest parameter "
          f"difference {d_params:.3e} (tol {RESUME_TOL:g}); parameters "
          f"bitwise equal: {same_params}; whole train state (optimizer, env "
          f"states, norm statistics, generators) bitwise equal: {same_all}")
    if not d_params <= RESUME_TOL:
        fail("trainer: the resumed run departs from the straight run")

    # the iteration's times, on the straight run's trained state
    tcfg = config_of(cli("straight", steps_main + spi))
    env = train_lib.build_env(tcfg, dev)
    net = train_lib.make_network(tcfg, env)
    ts = ppo.init_train_state(env, net, tcfg,
                              torch.Generator(device=dev).manual_seed(SEED))
    ts = ckpt_lib.restore_checkpoint(latest("straight"), ts)
    rollout, update = ppo.make_train_fns(env, tcfg)
    ts, data, _ = rollout(ts)
    ts, _ = update(ts, data)
    torch.cuda.synchronize()
    # host syncs inside one iteration (CUDA's sync debug mode warns on each)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ts, data, _ = rollout(ts)
            ts, _ = update(ts, data)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message)[:120] for w in caught
             if "called a synchronizing" in str(w.message)]
    print(f"trainer: host syncs in one iteration (rollout_gae + update): "
          f"{len(syncs)} {syncs[:3]}")
    if syncs:
        fail("trainer: an iteration waits on the card")
    ts, r_ms, u_ms = timed_iterations(rollout, update, ts, TIMED_ITERS)
    roll_ms, upd_ms = sum(r_ms) / TIMED_ITERS, sum(u_ms) / TIMED_ITERS
    obs = ts.env_states.obs

    @torch.no_grad()
    def policy_step():
        mean, log_std, _ = net(ppo.normalize_obs(ts.norm, obs))
        networks.sample_action(mean, log_std, ts.generator)

    fwd_ms = cuda_ms(policy_step, T) * T

    def profiled(phase):
        """(wall us, kernels) of one call of phase under torch.profiler."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            phase()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e6
        return wall, kernel_times(prof.key_averages())

    def rollout_phase():
        nonlocal ts, data
        ts, data, _ = rollout(ts)

    def update_phase():
        nonlocal ts
        ts, _ = update(ts, data)

    windows = [("rollout_gae", *profiled(rollout_phase)),
               ("update", *profiled(update_phase))]
    wall_us = sum(w for _, w, _ in windows)
    busy_us = sum(us for _, _, kern in windows for us, _, _ in kern)
    k1_us = sum(us for us, _, name in windows[0][2] if "k1_kernel" in name)
    it_ms = roll_ms + upd_ms
    each = lambda ms: ", ".join(f"{x:.2f}" for x in ms)  # noqa: E731
    print(f"trainer iteration at B={B}, T={T} (mean of {TIMED_ITERS}): "
          f"rollout_gae {roll_ms:.2f} ms (each: {each(r_ms)}), "
          f"update {upd_ms:.2f} ms (each: {each(u_ms)}; "
          f"{tcfg.ppo_epochs} x {tcfg.num_minibatches} minibatches, "
          f"{upd_ms / (tcfg.ppo_epochs * tcfg.num_minibatches):.3f} ms "
          f"each); training {spi / it_ms * 1e3:.0f} env-steps/s ({card})")
    print(f"trainer: the policy forward and action draw, {T} per rollout, "
          f"{fwd_ms:.2f} ms = {fwd_ms / roll_ms:.3f} of the rollout; "
          f"profiled iteration: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms, idle share {1 - busy_us / wall_us:.3f}, "
          f"K1 {k1_us / 1e3:.2f} ms on the device ({card})")
    for label, wall, kern in windows:
        n = sum(count for _, count, _ in kern)
        busy = sum(us for us, _, _ in kern)
        print(f"  profiled {label}: wall {wall / 1e3:.2f} ms, device busy "
              f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall:.3f}, "
              f"{n} kernel launches")
        for us, count, name in kern[:6]:
            print(f"    {us / 1e3:9.3f} ms  x{count:<5d} {name[:80]}")

    # one minibatch update on the card against the same update on the CPU,
    # with TF32 matmuls off (the port's setting), then with them on as a
    # control: the check must see TF32
    batch, advs, rets = data
    take = ppo.make_epoch_shuffle(spi, tcfg.num_minibatches,
                                  tcfg.shuffle_block_size, ts.generator, dev)
    mb = {k: take(batch[k])[0] for k in ("obs", "action", "logp")}
    adv, ret = take(advs)[0], take(rets)[0]

    def card_vs_cpu(tf32):
        """Loss-part, gradient and parameter differences of one minibatch
        update from copies of ts's network and optimizer, card against
        CPU, with TF32 matmuls on the card set to ``tf32``."""
        nets = [copy.deepcopy(ts.network), copy.deepcopy(ts.network).cpu()]
        opts = [ppo.make_optimizer(tcfg, n.parameters()) for n in nets]
        for opt in opts:
            opt.load_state_dict(copy.deepcopy(ts.optimizer.state_dict()))
        allowed = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            aux_gpu = ppo.minibatch_step(nets[0], opts[0], tcfg, mb, adv,
                                         ret).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allowed
        aux_cpu = ppo.minibatch_step(nets[1], opts[1], tcfg,
                                     {k: v.cpu() for k, v in mb.items()},
                                     adv.cpu(), ret.cpu())
        pairs = list(zip(nets[0].parameters(), nets[1].parameters()))
        return dict(
            loss=float(((aux_gpu - aux_cpu).abs()
                        / (1 + aux_cpu.abs())).max()),
            grad=max(float((p.grad.cpu() - q.grad).abs().max()
                           / q.grad.abs().max().clamp_min(1e-30))
                     for p, q in pairs),
            param=max(float((p.detach().cpu() - q.detach()).abs().max())
                      for p, q in pairs))

    def within(d):
        return all(d[k] <= UPDATE_TOL[k] for k in UPDATE_TOL)

    for tf32 in (False, True):
        d = card_vs_cpu(tf32)
        role = "the control" if tf32 else "the check"
        print(f"trainer minibatch update, card against CPU ({len(adv)} rows; "
              f"TF32 matmuls allowed: {tf32}, {role}): loss parts "
              f"{d['loss']:.3e} (tol {UPDATE_TOL['loss']:g}), gradients "
              f"{d['grad']:.3e} of each tensor's largest (tol "
              f"{UPDATE_TOL['grad']:g}), parameters {d['param']:.3e} (tol "
              f"{UPDATE_TOL['param']:g}); within all three: {within(d)}")
        if within(d) == tf32:
            fail("trainer: the card's minibatch update departs from the "
                 "CPU's" if not tf32 else
                 "trainer: the card-against-CPU check does not see TF32")
    shutil.rmtree(work, ignore_errors=True)


def timed_iterations(rollout, update, ts, n):
    """n more PPO iterations from ts: (ts, each rollout's ms, each update's
    ms), by CUDA events."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    r_ms, u_ms = [], []
    for _ in range(n):
        ev[0].record()
        ts, data, _ = rollout(ts)
        ev[1].record()
        ts, _ = update(ts, data)
        ev[2].record()
        torch.cuda.synchronize()
        r_ms.append(ev[0].elapsed_time(ev[1]))
        u_ms.append(ev[1].elapsed_time(ev[2]))
    return ts, r_ms, u_ms


def compat_trainer_phase(card, dev):
    """``rl.train.main`` with ``--reference-compat`` (delayed obs and lidar
    aliasing) at 4096 envs on the open floor, the CLI's default arena and
    that of PARITY.md's reproduction of the reference's collapse: 3
    iterations and a resume of one, K1 <0,0,0> once per rollout and
    evaluation step, K2 twice per rollout step (the pre-step observation
    and the fresh batch) and once per evaluation step; the rollout's mean
    reward per step within REWARD_BOUNDS; training env-steps/s."""
    from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
    from mujoco_playground_tpu_torch.rl import ppo
    from mujoco_playground_tpu_torch.rl import train as train_lib
    from mujoco_playground_tpu_torch.rl.evaluate import (deterministic_policy,
                                                         evaluate_agent)
    t_phase = time.perf_counter()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_compat")
    shutil.rmtree(work, ignore_errors=True)

    def cli(steps, *extra):
        return (COMPAT_TRAIN + ["--timesteps", str(steps), "--log-dir",
                                work] + list(extra))

    cfg = train_lib.config_from_args(train_lib.make_parser().parse_args(
        cli(0)))
    T, B = cfg.unroll_length, cfg.num_envs
    spi = T * B
    reset_counts()
    env = train_lib.build_env(cfg, dev)
    settle = read_counts()
    net0 = train_lib.make_network(cfg, env)
    reset_counts()
    evaluate_agent(env, deterministic_policy(net0),
                   num_episodes=cfg.eval_episodes)
    one_eval, eval_variants = read_counts(), read_variants()
    print(f"compat trainer parts: arena {env.arena}, the env's settle "
          f"launches {settle}; one evaluation of {cfg.eval_episodes} "
          f"episodes x {cfg.max_episode_steps} steps launches {one_eval} "
          f"{eval_variants}")
    if eval_variants != {PLAIN: cfg.max_episode_steps}:
        fail(f"compat trainer: an evaluation launched {eval_variants}")

    def run(label, argv, iters):
        reset_counts()
        t0 = time.perf_counter()
        train_lib.main(argv)
        torch.cuda.synchronize()
        got, variants = read_counts(), read_variants()
        want = {"K1": settle["K1"] + iters * T + 2 * one_eval["K1"],
                "K1e": 0, "K2": settle["K2"] + 1 + 2 * iters * T
                + 2 * one_eval["K2"], "K3": 0, "K2f": 0}
        print(f"compat trainer {label}: {time.perf_counter() - t0:.1f} s, "
              f"launches {got} {variants}; expected {want} = {iters} x {T} "
              f"rollout steps (K1 <0,0,0> and two K2 each) + 2 evaluations "
              f"+ the init reset's K2")
        if got != want or set(variants) != {PLAIN}:
            fail(f"compat trainer {label}: launches {got} {variants}, "
                 f"expected {want}")

    run(f"main run ({TRAIN_ITERS} iterations)", cli(TRAIN_ITERS * spi),
        TRAIN_ITERS)
    run("resume (1 iteration)", cli((TRAIN_ITERS + 1) * spi, "--resume"), 1)
    ckpts = os.path.join(work, train_lib.CKPT_SUBDIR)
    latest = ckpt_lib.latest_checkpoint(ckpts)
    if ckpt_lib.checkpoint_step(latest) != (TRAIN_ITERS + 1) * spi:
        fail(f"compat trainer: the last checkpoint is {latest}")
    with open(os.path.join(ckpts, "metrics.jsonl")) as f:
        rewards = [json.loads(x)["mean_reward"] for x in f
                   if "mean_reward" in x]
    lo, hi = REWARD_BOUNDS
    print(f"compat trainer: the rollouts' mean reward per step {rewards} "
          f"(bounds [{lo}, {hi}]: the -50 collision penalty on every step "
          f"of the open floor)")
    if not rewards or not all(lo <= r <= hi for r in rewards):
        fail(f"compat trainer: mean reward per step {rewards}")

    # the iteration's times on the resumed run's state
    env = train_lib.build_env(cfg, dev)
    net = train_lib.make_network(cfg, env)
    ts = ppo.init_train_state(env, net, cfg,
                              torch.Generator(device=dev).manual_seed(SEED))
    ts = ckpt_lib.restore_checkpoint(latest, ts)
    rollout, update = ppo.make_train_fns(env, cfg)
    ts, _, _ = timed_iterations(rollout, update, ts, 1)
    ts, r_ms, u_ms = timed_iterations(rollout, update, ts, TIMED_ITERS)
    roll_ms, upd_ms = sum(r_ms) / TIMED_ITERS, sum(u_ms) / TIMED_ITERS
    print(f"compat trainer iteration at B={B}, T={T} (mean of "
          f"{TIMED_ITERS}): rollout_gae {roll_ms:.2f} ms ("
          f"{roll_ms / T:.3f} ms per env step), update {upd_ms:.2f} ms; "
          f"training {spi / (roll_ms + upd_ms) * 1e3:.0f} env-steps/s "
          f"({card})")
    shutil.rmtree(work, ignore_errors=True)
    print(f"compat trainer phase: {time.perf_counter() - t_phase:.1f} s")


def per_env_phase(card, dev, env):
    """The per-env step on the card: PER_ENV_B umaze envs stepped one at a
    time through ``AckermannEnv.step`` for PER_ENV_STEPS steps, each step
    held against ``engine.staged_step`` (K3) on the same envs as a batch
    from the same states (both make MuJoCo's warm-start pick), and the
    same envs' per-env step on the CPU held against the card's."""
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.physics import engine
    from mujoco_playground_tpu_torch.physics.state import State
    t_phase = time.perf_counter()
    cpu_env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                                 ls_iterations=3, device="cpu", seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    batch = env.reset(PER_ENV_B)
    ones = [_index_tree(batch, i) for i in range(PER_ENV_B)]
    cpu_ones = [_to_device(s, "cpu") for s in ones]
    worst = dict(qpos=0.0, qvel=0.0, cpu_qpos=0.0, cpu_qvel=0.0, obs=0.0)
    k3_launches = 0
    step_s = 0.0
    for _ in range(PER_ENV_STEPS):
        actions = torch.rand((PER_ENV_B, 2), generator=gen, device=dev) * 2 - 1
        prev = State(**{f.name: torch.stack(
            [getattr(s.physics, f.name) for s in ones])
            for f in dataclasses.fields(State)})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ones = [env.step(s, a) for s, a in zip(ones, actions)]
        torch.cuda.synchronize()
        step_s += time.perf_counter() - t0
        cpu_ones = [cpu_env.step(s, a) for s, a in
                    zip(cpu_ones, actions.cpu())]
        reset_counts()
        staged = engine.staged_step(env.model, prev.replace(
            ctrl=torch.stack([s.physics.ctrl for s in ones])))
        k3_launches += read_counts()["K3"]
        for i, (s, c) in enumerate(zip(ones, cpu_ones)):
            for name in ("qpos", "qvel"):
                ref = getattr(staged, name)[i]
                worst[name] = max(worst[name], float(
                    (getattr(s.physics, name) - ref).abs().max()
                    / (1 if name == "qpos" else 1 + ref.abs().max())))
                worst[f"cpu_{name}"] = max(worst[f"cpu_{name}"], float(
                    (getattr(c.physics, name) - getattr(s.physics,
                                                        name).cpu())
                    .abs().max()))
            worst["obs"] = max(worst["obs"], float(
                (c.obs - s.obs.cpu()).abs().max()))
        # carry the card's states on, the CPU's from the card's
        cpu_ones = [_to_device(s, "cpu") for s in ones]
    print(f"per-env step on the card: {PER_ENV_B} envs x {PER_ENV_STEPS} "
          f"steps, {step_s / (PER_ENV_B * PER_ENV_STEPS) * 1e3:.1f} ms per "
          f"env step ({card}); against engine.staged_step on the same envs "
          f"as a batch (K3 {k3_launches} launches): qpos {worst['qpos']:.3e}"
          f" (tol {PER_ENV_TOL['qpos']:g}), qvel {worst['qvel']:.3e} of "
          f"1 + each env's largest |qvel| (tol {PER_ENV_TOL['qvel']:g}); "
          f"the CPU's per-env step against the card's: qpos "
          f"{worst['cpu_qpos']:.3e}, qvel {worst['cpu_qvel']:.3e}, obs "
          f"{worst['obs']:.3e} (tol {PER_ENV_TOL['cpu']:g})")
    if k3_launches != PER_ENV_STEPS:
        fail(f"per-env phase: K3 ran {k3_launches} times")
    if not (worst["qpos"] <= PER_ENV_TOL["qpos"]
            and worst["qvel"] <= PER_ENV_TOL["qvel"]
            and max(worst["cpu_qpos"], worst["cpu_qvel"], worst["obs"])
            <= PER_ENV_TOL["cpu"]):
        fail(f"per-env phase: {worst}")
    print(f"per-env phase: {time.perf_counter() - t_phase:.1f} s")


def sb3_zip(path, policy_sd, pytorch_vars=None):
    """A minimal Stable-Baselines3 checkpoint zip: policy.pth (and
    pytorch_variables.pth) as torch.save writes them."""
    import io
    import zipfile
    with zipfile.ZipFile(path, "w") as zf:
        for member, sd in (("policy.pth", policy_sd),
                           ("pytorch_variables.pth", pytorch_vars)):
            if sd is not None:
                buf = io.BytesIO()
                torch.save(sd, buf)
                zf.writestr(member, buf.getvalue())
    return path


def sb3_linear(sd, key, n_in, n_out, gen):
    """An SB3 Linear's weight and bias drawn from gen, the weight with a
    1/sqrt(fan_in) scale."""
    sd[f"{key}.weight"] = torch.randn(n_out, n_in, generator=gen) * (
        n_in ** -0.5)
    sd[f"{key}.bias"] = torch.randn(n_out, generator=gen) * 0.1


def sb3_layers(sd, prefix, dims, gen):
    """SB3 Sequential Linear layers for dims (keys at stride 2: the
    activations sit between)."""
    for i in range(len(dims) - 1):
        sb3_linear(sd, f"{prefix}.{2 * i}", dims[i], dims[i + 1], gen)


def sb3_forward(x, sd, prefix, n, act, last=None):
    """SB3's Sequential forward: n Linear layers, ``act`` between them,
    ``last`` (if any) after the last."""
    import torch.nn.functional as F
    for i in range(n):
        x = F.linear(x, sd[f"{prefix}.{2 * i}.weight"],
                     sd[f"{prefix}.{2 * i}.bias"])
        if i < n - 1:
            x = act(x)
    return x if last is None else last(x)


def tooling_phase(card, dev, main_ms):
    """The interop and tooling layer on the card (module docstring):
    ``GymVectorAckermannEnv`` at the main path's width against
    ``step_autoreset_batch``, ``GymAckermannEnv``, the SB3 loaders and a
    PPO evaluation of a loaded policy, the spawners and ``main_sim``."""
    import contextlib
    import importlib.util
    import io
    import re

    from mujoco_playground_tpu_torch import main_sim
    from mujoco_playground_tpu_torch.core.controller import \
        bicycle_cmd_vel_to_controls
    from mujoco_playground_tpu_torch.envs import (gym_wrapper,
                                                  make_ackermann_env, spawner)
    from mujoco_playground_tpu_torch.physics import engine
    from mujoco_playground_tpu_torch.rl import sac, sb3_import, td3
    from mujoco_playground_tpu_torch.rl.evaluate import (deterministic_policy,
                                                         evaluate_agent)
    from mujoco_playground_tpu_torch.rl.networks import ActorCritic
    t_phase = time.perf_counter()
    present = [m for m in OPTIONAL if importlib.util.find_spec(m)]
    print(f"tooling: optional packages on this machine: {present or 'none'};"
          f" the Gym wrappers' bases: {gym_wrapper._BASE.__module__}."
          f"{gym_wrapper._BASE.__qualname__}, "
          f"{gym_wrapper._VBASE.__module__}."
          f"{gym_wrapper._VBASE.__qualname__}")

    # -- the Gym vector env at the main path's width -----------------------
    # a timed run whose caller drops each step's arrays, as a training loop
    # that consumes them does (a caller that keeps them all pays the host's
    # page faults on fresh memory instead: PERF.md), then a checked run in
    # lockstep with step_autoreset_batch on the same env, seed and actions
    # (the env's own generator is seeded SEED as the wrapper's is)
    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, seed=SEED, device=dev)
    venv = gym_wrapper.GymVectorAckermannEnv(GYM_B, env=env, seed=SEED)
    rng = np.random.default_rng(SEED + 20)
    actions = [rng.uniform(-1.0, 1.0, (GYM_B, 2)).astype(np.float32)
               for _ in range(GYM_STEPS)]
    to_host, host_s, timing = venv.to_host, [0.0], [False]

    def timed_to_host(s):
        # the device-to-host copies of a step, timed once the step's
        # kernels are done (to_host waits for them at its first copy)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = to_host(s)
        if timing[0]:
            host_s[0] += time.perf_counter() - t
        return out

    venv.to_host = timed_to_host
    reset_counts()
    venv.reset(seed=SEED)
    step_bytes = 0
    for i, a in enumerate(actions):
        if i == WARMUP:
            timing[0] = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        obs, rew, term, trunc, info = venv.step(a)
        if i >= WARMUP:
            step_bytes += sum(x.nbytes for x in (obs, rew, term, trunc)) + (
                sum(x.nbytes for x in info.values()
                    if isinstance(x, np.ndarray)))
    gym_s = time.perf_counter() - t0
    counts = read_counts()
    venv.to_host = to_host
    if counts != {"K1": GYM_STEPS, "K1e": 0, "K2": 1, "K3": 0, "K2f": 0}:
        fail(f"tooling: the Gym vector env launched {counts} in "
             f"{GYM_STEPS} steps (K1 {GYM_STEPS} and K2 1 expected)")
    obs0, _ = venv.reset(seed=SEED)
    states = env.reset(GYM_B)
    same = np.array_equal(states.obs.cpu().numpy(), obs0)
    n_final = 0

    def check_step(i, out, states):
        """One step's outputs: numpy of the contract's shapes, final_obs
        and its masks exactly where an env is done, and the bits of
        step_autoreset_batch's state."""
        obs, rew, term, trunc, info = out
        arrays = [obs, rew, term, trunc, info["goal_distance"],
                  info["collision"]]
        if not all(isinstance(x, np.ndarray) for x in arrays):
            fail(f"tooling: step {i} returned a non-numpy output")
        if obs.shape != (GYM_B, env.obs_size) or obs.dtype != np.float32 \
                or any(x.shape != (GYM_B,) for x in arrays[1:]):
            fail(f"tooling: step {i} shapes {[x.shape for x in arrays]}")
        if not np.isfinite(obs).all() or not np.isfinite(rew).all():
            fail(f"tooling: step {i}: non-finite obs or reward")
        done = term | trunc
        if ("final_obs" in info) != bool(done.any()):
            fail(f"tooling: step {i}: final_obs {'final_obs' in info} with "
                 f"{int(done.sum())} envs done")
        want = [states.obs, states.reward, states.terminated,
                states.truncated, states.goal_distance, states.collision]
        if done.any():
            if (info["final_obs"].shape != obs.shape
                    or not np.array_equal(info["_final_obs"], done)
                    or not np.array_equal(info["_final_info"], done)):
                fail(f"tooling: step {i}: final_obs or its masks are wrong")
            arrays.append(info["final_obs"])
            want.append(states.final_obs)
        return bool(done.any()), all(
            np.array_equal(g, w.cpu().numpy()) for g, w in zip(arrays, want))

    for i, a in enumerate(actions):
        out = venv.step(a)
        states = env.step_autoreset_batch(states,
                                          torch.from_numpy(a).to(dev))
        ended, equal = check_step(i, out, states)
        n_final += ended
        same = same and equal
    # one more step with the even envs one step from truncation, so that
    # final_obs shows however many episodes the random run ended
    last = env.config.max_episode_steps - 1
    even = torch.arange(GYM_B, device=dev) % 2 == 0
    states.steps[even] = last
    venv._states.steps[even] = last
    out = venv.step(actions[0])
    states = env.step_autoreset_batch(states,
                                      torch.from_numpy(actions[0]).to(dev))
    ended, equal = check_step(GYM_STEPS, out, states)
    if not (ended and (out[2] | out[3])[::2].all()):
        fail("tooling: the truncating step ended no episode")
    if not (same and equal):
        fail("tooling: the Gym vector env's trajectory is not bitwise "
             "step_autoreset_batch's")
    n_timed = GYM_STEPS - WARMUP
    gym_ms = gym_s / n_timed * 1e3
    print(f"Gym vector env: B={GYM_B}, {GYM_STEPS} steps, launches "
          f"{counts}, bitwise equal to step_autoreset_batch (final_obs on "
          f"{n_final} of its {GYM_STEPS} steps and on a truncating step); "
          f"{gym_ms:.4f} ms per step by host clock, "
          f"{GYM_B * n_timed / gym_s:.0f} env-steps/s, against the main "
          f"path's {main_ms:.4f} ms, {GYM_B / main_ms * 1e3:.0f} "
          f"env-steps/s (CUDA events) in this call; device-to-host copies "
          f"{host_s[0] / n_timed * 1e3:.4f} ms per step, "
          f"{host_s[0] / gym_s:.3f} of a step, "
          f"{step_bytes / n_timed / 1e6:.2f} MB per step "
          f"({step_bytes / host_s[0] / 1e9:.2f} GB/s) ({card})")

    # -- the single Gym env (the per-env step) ------------------------------
    genv = gym_wrapper.GymAckermannEnv(env=env)
    first, _ = genv.reset(seed=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GYM_SINGLE_STEPS):
        obs, rew, term, trunc, info = genv.step(
            rng.uniform(-1.0, 1.0, 2).astype(np.float32))
    single_ms = (time.perf_counter() - t0) / GYM_SINGLE_STEPS * 1e3
    again, _ = genv.reset(seed=3)
    if not np.array_equal(first, again):
        fail("tooling: GymAckermannEnv.reset(seed=3) did not repeat its obs")
    if obs.shape != (env.obs_size,) or not np.isfinite(obs).all() \
            or info["step"] != GYM_SINGLE_STEPS:
        fail(f"tooling: the single Gym env's step: {obs.shape}, {info}")
    print(f"Gym single env: {GYM_SINGLE_STEPS} steps, {single_ms:.1f} ms "
          f"per step by host clock; reset(seed=3) repeats bitwise ({card})")

    # -- the SB3 loaders, and a loaded PPO policy's evaluation -------------
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_sb3")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gen = torch.Generator().manual_seed(SEED + 30)
    n_obs, n_act = env.obs_size, 2
    ppo_sd, sac_sd, td3_sd = {}, {}, {}
    for prefix in ("mlp_extractor.policy_net", "mlp_extractor.value_net"):
        sb3_layers(ppo_sd, prefix, (n_obs, 64, 64), gen)
    sb3_linear(ppo_sd, "action_net", 64, n_act, gen)
    sb3_linear(ppo_sd, "value_net", 64, 1, gen)
    ppo_sd["log_std"] = torch.randn(n_act, generator=gen) * 0.3
    sb3_layers(sac_sd, "actor.latent_pi", (n_obs, 256, 256), gen)
    for k in ("actor.mu", "actor.log_std"):
        sb3_linear(sac_sd, k, 256, n_act, gen)
    for prefix in ("actor.mu", "actor_target.mu"):
        sb3_layers(td3_sd, prefix, (n_obs, 400, 300, n_act), gen)
    for sd, h in ((sac_sd, (256, 256)), (td3_sd, (400, 300))):
        for crit in ("critic", "critic_target"):
            for qf in ("qf0", "qf1"):
                sb3_layers(sd, f"{crit}.{qf}", (n_obs + n_act,) + h + (1,),
                           gen)
    paths = {
        "ppo": sb3_zip(os.path.join(work, "ppo.zip"), ppo_sd),
        "sac": sb3_zip(os.path.join(work, "sac.zip"), sac_sd,
                       {"log_ent_coef": torch.tensor([-1.3])}),
        "td3": sb3_zip(os.path.join(work, "td3.zip"), td3_sd)}
    obs = torch.from_numpy(obs0[:SB3_EVAL_B]).to(dev)
    act = torch.rand((SB3_EVAL_B, n_act), generator=torch.Generator(
        device=dev).manual_seed(SEED + 31), device=dev) * 2 - 1

    def loaded_outputs(device):
        """Every loaded module's outputs on device, and the SB3-layout
        forward of the same weights."""
        x, a = obs.to(device), act.to(device)
        sds = {k: {n: t.to(device) for n, t in v.items()}
               for k, v in (("ppo", ppo_sd), ("sac", sac_sd),
                            ("td3", td3_sd))}
        out, ref = {}, {}
        p = sb3_import.load_sb3_ppo_params(paths["ppo"], device=device)
        net = ActorCritic(n_obs, n_act, hidden=(64, 64)).to(device)
        net.load_state_dict(p["params"])
        s = sb3_import.load_sb3_sac_params(paths["sac"], device=device)
        t = sb3_import.load_sb3_td3_params(paths["td3"], device=device)
        with torch.no_grad():
            out["ppo mean"], _, out["ppo value"] = net(x)
            sd = sds["ppo"]
            ref["ppo mean"] = torch.nn.functional.linear(
                sb3_forward(x, sd, "mlp_extractor.policy_net", 2,
                            torch.tanh, torch.tanh),
                sd["action_net.weight"], sd["action_net.bias"])
            ref["ppo value"] = torch.nn.functional.linear(
                sb3_forward(x, sd, "mlp_extractor.value_net", 2,
                            torch.tanh, torch.tanh),
                sd["value_net.weight"], sd["value_net.bias"])[:, 0]
            actor = sac.TanhGaussianActor(n_obs, n_act,
                                          hidden=s["hidden"]).to(device)
            actor.load_state_dict(s["actor"])
            out["sac mean"], out["sac log_std"] = actor(x)
            sd = sds["sac"]
            z = sb3_forward(x, sd, "actor.latent_pi", 2, torch.relu,
                            torch.relu)
            ref["sac mean"] = torch.nn.functional.linear(
                z, sd["actor.mu.weight"], sd["actor.mu.bias"])
            ref["sac log_std"] = torch.clamp(torch.nn.functional.linear(
                z, sd["actor.log_std.weight"], sd["actor.log_std.bias"]),
                -20.0, 2.0)
            for algo, mod, q_hidden in (("sac", sac, s["hidden"]),
                                        ("td3", td3, t["hidden"])):
                loaded = s if algo == "sac" else t
                for key, crit in (("q", "critic"),
                                  ("q_target", "critic_target")):
                    q = mod.TwinQ(n_obs, n_act, hidden=q_hidden).to(device)
                    q.load_state_dict(loaded[key])
                    for i, v in enumerate(q(x, a)):
                        out[f"{algo} {key}{i + 1}"] = v
                        ref[f"{algo} {key}{i + 1}"] = sb3_forward(
                            torch.cat([x, a], -1), sds[algo],
                            f"{crit}.qf{i}", 3, torch.relu)[:, 0]
            for key, prefix in (("actor", "actor.mu"),
                                ("actor_target", "actor_target.mu")):
                actor = td3.DeterministicActor(
                    n_obs, n_act, hidden=t["hidden"]).to(device)
                actor.load_state_dict(t[key])
                out[f"td3 {key}"] = actor(x)
                ref[f"td3 {key}"] = sb3_forward(x, sds["td3"], prefix, 3,
                                                torch.relu, torch.tanh)
        if s["log_alpha"] is None or float(s["log_alpha"]) != float(
                np.float32(-1.3)):
            fail(f"tooling: SAC log_alpha {s['log_alpha']}")
        return out, ref, net, (s["hidden"], t["hidden"])

    card_out, card_ref, net, hidden = loaded_outputs(dev)
    cpu_out, _, _, _ = loaded_outputs("cpu")
    layout_err = max(float((card_out[k] - card_ref[k]).abs().max())
                     for k in card_out)
    cpu_err = max(float((card_out[k].cpu() - cpu_out[k]).abs().max())
                  for k in card_out)
    print(f"SB3 import: PPO 64x64, SAC {hidden[0]}, TD3 {hidden[1]} zips "
          f"loaded on the card; {len(card_out)} outputs against an "
          f"SB3-layout forward on the card: max |diff| {layout_err:.3e} "
          f"(tol {SB3_TOL['layout']:g}); against the CPU's: {cpu_err:.3e} "
          f"(tol {SB3_TOL['cpu']:g})")
    if not (layout_err <= SB3_TOL["layout"] and cpu_err <= SB3_TOL["cpu"]):
        fail("tooling: the loaded SB3 policies disagree")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = evaluate_agent(env, deterministic_policy(net),
                           num_episodes=SB3_EVAL_B, max_steps=SB3_EVAL_STEPS,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED))
    eval_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"SB3 PPO policy evaluated: {SB3_EVAL_B} envs x {SB3_EVAL_STEPS} "
          f"steps in {eval_s:.2f} s, launches {counts}, mean return "
          f"{stats['mean_return']:.3f}, success {stats['success_rate']:.4f}")
    if counts != {"K1": SB3_EVAL_STEPS, "K1e": 0, "K2": 1, "K3": 0,
                  "K2f": 0}:
        fail(f"tooling: the SB3 evaluation launched {counts}")
    if not all(math.isfinite(v) for v in stats.values()):
        fail(f"tooling: the SB3 evaluation's stats {stats}")

    # -- the spawners (the per-env step on the card) -----------------------
    simple = spawner.SimpleMapSpawner(seed=SEED, device=dev)
    maps = spawner.MapSpawner(seed=SEED, device=dev)
    spawns = {"simple_floor": simple.load_random_environment()[:2]}
    for _ in range(200):
        model, state, name = maps.load_random_environment()
        spawns.setdefault(name, (model, state))
    if set(spawns) != {"simple_floor"} | {sc.name for sc in maps.scenes}:
        fail(f"tooling: MapSpawner reached only {sorted(spawns)}")
    spawn_s = 0.0
    ctrl = bicycle_cmd_vel_to_controls(torch.tensor(0.5, device=dev),
                                       torch.tensor(0.4, device=dev))
    for name, (model, state) in spawns.items():
        state = state.replace(ctrl=ctrl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPAWN_STEPS):
            state = engine.step(model, state)
        torch.cuda.synchronize()
        spawn_s += time.perf_counter() - t0
        if not all(bool(torch.isfinite(getattr(state, f)).all())
                   for f in ("qpos", "qvel", "xpos", "xquat")):
            fail(f"tooling: the {name} spawn stepped to a non-finite state")
    print(f"spawners: {sorted(spawns)} each stepped {SPAWN_STEPS} per-env "
          f"steps on the card, finite; "
          f"{spawn_s / (len(spawns) * SPAWN_STEPS) * 1e3:.1f} ms per step "
          f"({card})")

    # -- main_sim --headless, on the card and on the CPU -------------------
    argv = ["--headless", "--steps", str(SIM_STEPS), "--print-every", "50"]
    finals, printed = {}, ""
    for device in (str(dev), "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            finals[device] = main_sim.main(argv + ["--device", device])
        if not printed:
            sim_s = time.perf_counter() - t0
            printed = buf.getvalue()
    odom = re.findall(r"Odometry - Position: \[([^\]]*)\], Heading: (\S+), "
                      r"Distance: (\S+)", printed)
    values = [float(v) for pos, h, d in odom
              for v in pos.split() + [h, d]]
    if len(odom) != SIM_STEPS // 50 or not all(map(math.isfinite, values)):
        fail(f"tooling: main_sim's odometry printout {odom}")
    gap = {f: float((getattr(finals[str(dev)], f).cpu()
                     - getattr(finals["cpu"], f)).abs().max())
           for f in ("qpos", "qvel")}
    print(f"main_sim --headless: {SIM_STEPS} steps on the card in "
          f"{sim_s:.2f} s, {SIM_STEPS / sim_s:.2f} steps/s against the "
          f"loop's 500 Hz pace ({500 * sim_s / SIM_STEPS:.1f}x slower); "
          f"odometry finite (last: {odom[-1]}); final state against the "
          f"CPU's: qpos {gap['qpos']:.3e}, qvel {gap['qvel']:.3e} (tol "
          f"{SIM_TOL:g}) ({card})")
    if max(gap.values()) > SIM_TOL:
        fail(f"tooling: main_sim on the card against the CPU: {gap}")
    loaded = [m for m in OPTIONAL if sys.modules.get(m) is not None]
    print(f"tooling: optional packages imported: {loaded or 'none'}")
    print(f"tooling phase: {time.perf_counter() - t_phase:.1f} s")


def _index_tree(tree, i):
    """Env i of a batched dataclass tree, as one env's (unbatched)."""
    if isinstance(tree, torch.Tensor):
        return tree[i].clone()
    return dataclasses.replace(tree, **{
        f.name: _index_tree(getattr(tree, f.name), i)
        for f in dataclasses.fields(tree)})


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return dataclasses.replace(tree, **{
        f.name: _to_device(getattr(tree, f.name), device)
        for f in dataclasses.fields(tree)})


def eval_draws(run, dev):
    """EVAL.json's own episodes of ``rl_logs/<run>`` (``EVAL_DRAWS`` beside
    its converted checkpoint) on ``dev``."""
    from mujoco_playground_tpu_torch.rl.train import CKPT_SUBDIR
    root = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(root, "rl_logs", run, CKPT_SUBDIR,
                              EVAL_DRAWS)) as d:
        return {k: torch.from_numpy(d[k][:EVAL_EPISODES]).to(dev)
                for k in d.files}


def eval_on_draws(env, policy, draws, **kw):
    """``evaluate_agent`` on the episodes ``draws``, timed: (statistics,
    seconds)."""
    from mujoco_playground_tpu_torch.rl.evaluate import evaluate_agent
    core = env.maze_core(draws["start_xy"], draws["goal_xy"],
                         draws["goal_cell"], draws.get("yaw"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = evaluate_agent(env, policy, core=core, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def eval_cli_on_draws(log_dir, run, step, env_argv, dev):
    """``rl.train.main --eval-only`` of the committed policy
    ``rl_logs/<run>/ppo_torch/step_<step>.pt`` (copied to ``log_dir``) with
    the env flags ``env_argv``, its evaluation played on EVAL.json's own
    episodes: (statistics, seconds of the evaluation, launches)."""
    from mujoco_playground_tpu_torch.rl import train as train_lib
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(log_dir, train_lib.CKPT_SUBDIR))
    shutil.copy(os.path.join(root, "rl_logs", run, train_lib.CKPT_SUBDIR,
                             f"step_{step:010d}.pt"),
                os.path.join(log_dir, train_lib.CKPT_SUBDIR))
    draws, timed = eval_draws(run, dev), {}

    def timed_eval(env, *a, **kw):
        out, timed["s"] = eval_on_draws(env, *a, draws, **kw)
        return out

    evaluate_cli = train_lib.evaluate_agent
    train_lib.evaluate_agent = timed_eval
    try:
        reset_counts()
        stats = train_lib.main(
            ["--algo", "ppo", "--eval-only", "--log-dir", log_dir,
             "--num-envs", str(EVAL_EPISODES), "--eval-episodes",
             str(EVAL_EPISODES), "--seed", "0"] + env_argv)
        return stats, timed["s"], read_counts()
    finally:
        train_lib.evaluate_agent = evaluate_cli


def judge_eval(label, stats, ref, seconds, counts, want, steps, card):
    """A success rate within SUCCESS_SDS binomial SDs of EVAL.json's
    ``ref`` and the launches ``want``, or fail."""
    sd = math.sqrt(ref["success_rate"] * (1 - ref["success_rate"])
                   / EVAL_EPISODES)
    far = abs(stats["success_rate"] - ref["success_rate"])
    print(f"{label}: success_rate {stats['success_rate']:.4f} (EVAL.json "
          f"{ref['success_rate']:.4f}; {far / sd:.2f} SD, 1 SD {sd:.4f}), "
          f"mean_return {stats['mean_return']:.2f} "
          f"({ref['mean_return']:.2f}), mean_length "
          f"{stats['mean_length']:.1f} ({ref['mean_length']:.1f}); "
          f"{EVAL_EPISODES} x {steps} steps in {seconds:.2f} s, "
          f"{EVAL_EPISODES * steps / seconds:.0f} env-steps/s; launches "
          f"{counts}, expected {want} ({card})")
    if counts != want:
        fail(f"{label}: launches {counts}, expected {want}")
    if not far <= SUCCESS_SDS * sd:
        fail(f"{label}: success rate {stats['success_rate']:.4f} is "
             f"{far / sd:.2f} SD from EVAL.json's {ref['success_rate']:.4f}")


def solved_phase(card, dev):
    """The solved recipe's trainer through ``rl.train.main`` at 4096 envs,
    as written and with a random spawn heading, its launch counts, checks
    and times; the share of the geodesic lookups in a rollout step; then
    the capability figures against EVAL.json (module docstring)."""
    from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
    from mujoco_playground_tpu_torch.rl import ppo
    from mujoco_playground_tpu_torch.rl import train as train_lib
    from torch.profiler import ProfilerActivity, profile

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_solved")
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()

    def config_of(argv):
        return train_lib.config_from_args(
            train_lib.make_parser().parse_args(argv))

    # -- (a) the trainer, T=32, 10 epochs x 32 minibatches of 4096 rows
    for name, extra in (("solved", []), ("solved_randyaw", HEADING_NOISE)):
        t0 = time.perf_counter()
        log_dir = os.path.join(work, "train_" + name)
        argv = SOLVED_TRAIN + extra + ["--log-dir", log_dir]
        cfg = config_of(argv)
        T, B, ep = cfg.unroll_length, cfg.num_envs, cfg.max_episode_steps
        spi = T * B
        reset_counts()
        # the loop's own evaluation is the trainer phase's to check: here
        # it waits past the run, and main's final one runs
        train_lib.main(argv + ["--timesteps", str(spi), "--eval-freq",
                               str(2 * spi)])
        torch.cuda.synchronize()
        got = read_counts()
        # settle 3; one iteration; main's evaluation of ep steps, with one
        # batched reset, as the init has
        want = {"K1": 3 + T + ep, "K1e": 0,
                "K2": 2 + (T if extra else 0), "K3": 0, "K2f": 0}
        print(f"solved trainer {name}: main() for one iteration, "
              f"{time.perf_counter() - t0:.1f} s, launches {got}; expected "
              f"{want} = settle 3 + {T} rollout steps + main's evaluation of "
              f"{ep} steps, K2 at 2 batched resets"
              + (f" and on each of the {T} rollout steps" if extra else ""))
        if got != want:
            fail(f"solved trainer {name}: launches {got}, expected {want}")

        env = train_lib.build_env(cfg, dev)
        net = train_lib.make_network(cfg, env)
        ts = ppo.init_train_state(
            env, net, cfg, torch.Generator(device=dev).manual_seed(SEED))
        ts = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(
            os.path.join(log_dir, train_lib.CKPT_SUBDIR)), ts)
        rollout, update = ppo.make_train_fns(env, cfg)
        # the warm-up iteration, with every step's obs and final_obs held
        step = env.step_autoreset_batch
        finite, widths = [], set()

        def checked(states, actions, fresh=None):
            st = step(states, actions, fresh=fresh)
            widths.update({tuple(st.obs.shape), tuple(st.final_obs.shape)})
            finite.append(torch.isfinite(st.obs).all()
                          & torch.isfinite(st.final_obs).all())
            return st

        env.step_autoreset_batch = checked
        ts, data, _ = rollout(ts)
        ts, _ = update(ts, data)
        del env.step_autoreset_batch
        all_finite = bool(torch.stack(finite).all())
        print(f"solved trainer {name}: warm-up iteration, {len(finite)} env "
              f"steps: obs and final_obs shapes {sorted(widths)}, all "
              f"finite: {all_finite}")
        if widths != {(B, 81)} or not all_finite or len(finite) != T:
            fail(f"solved trainer {name}: obs/final_obs {sorted(widths)}, "
                 f"finite {all_finite}")

        reset_counts()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        r_ms, u_ms = [], []
        for _ in range(TIMED_ITERS):
            ev[0].record()
            ts, data, _ = rollout(ts)
            ev[1].record()
            ts, _ = update(ts, data)
            ev[2].record()
            torch.cuda.synchronize()
            r_ms.append(ev[0].elapsed_time(ev[1]))
            u_ms.append(ev[1].elapsed_time(ev[2]))
        got = read_counts()
        n = TIMED_ITERS * T
        want = {"K1": n, "K1e": 0, "K2": n if extra else 0, "K3": 0, "K2f": 0}
        roll_ms, upd_ms = sum(r_ms) / TIMED_ITERS, sum(u_ms) / TIMED_ITERS
        each = lambda ms: ", ".join(f"{x:.2f}" for x in ms)  # noqa: E731
        print(f"solved trainer {name} at B={B}, T={T}, hidden "
              f"{cfg.hidden_sizes}, obs {env.obs_size} (mean of "
              f"{TIMED_ITERS} after a warm-up): rollout_gae {roll_ms:.2f} ms "
              f"(each: {each(r_ms)}; {roll_ms / T:.3f} ms per env step), "
              f"update {upd_ms:.2f} ms (each: {each(u_ms)}), training "
              f"{spi / (roll_ms + upd_ms) * 1e3:.0f} env-steps/s; launches "
              f"{got}, expected {want} ({card})")
        if got != want:
            fail(f"solved trainer {name}: {n} rollout steps launched {got}, "
                 f"expected {want}")
        if extra:
            continue

        # the geodesic lookups of one env step (the shaping and the compass,
        # plain torch ops beside K1) against a profiled rollout step
        s = ts.env_states
        xy = s.physics.xpos[:, 1, :2]
        goal_vec = s.goal - (xy - s.odom_ref.position[:, :2])

        def geo_part():
            geo = env._geo_eval(s.goal_cell, xy)
            comp = env._compass_from(geo[..., 1:3], s.obs[:, HEADING_COL],
                                     goal_vec)
            torch.cat([s.obs[:, :79], comp], dim=-1)
            env._geo_delta(s.physics, s.physics, s.goal_cell, geo)

        def profiled(fn, reps):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - w0) * 1e6 / reps
            kern = kernel_times(prof.key_averages())
            return (wall, sum(us for us, _, _ in kern) / reps,
                    sum(c for _, c, _ in kern) / reps)

        def rollout_once():
            nonlocal ts
            ts, _, _ = rollout(ts)

        geo_ms = cuda_ms(geo_part, 200)
        g_wall, g_busy, g_n = profiled(geo_part, 32)
        r_wall, r_busy, r_n = profiled(rollout_once, 1)
        print(f"solved trainer: the geodesic lookups of one env step at "
              f"B={B} (a packed sample, the compass, the shaping's second "
              f"sample): {geo_ms:.4f} ms (events), profiled wall "
              f"{g_wall:.1f} us, device busy {g_busy:.1f} us, {g_n:.0f} "
              f"kernel launches; a profiled rollout step: wall "
              f"{r_wall / T:.1f} us, device busy {r_busy / T:.1f} us, "
              f"{r_n / T:.1f} launches; share of the rollout step: "
              f"{g_wall / (r_wall / T):.3f} of the wall, "
              f"{g_busy / max(r_busy / T, 1e-9):.3f} of the device time "
              f"({card})")

    # -- (b) the capability figures, with EVAL.json's protocol and episodes
    for run, step, extra in SOLVED_RUNS:
        with open(os.path.join(root, "rl_logs", run, "EVAL.json")) as f:
            ref = json.load(f)
        stats, secs, counts = eval_cli_on_draws(
            os.path.join(work, "eval_" + run), run, step,
            SOLVED_ENV + extra, dev)
        judge_eval(f"solved eval {run}", stats, ref["eval"], secs, counts,
                   {"K1": 3 + EVAL_STEPS, "K1e": 0, "K2": 2, "K3": 0,
                    "K2f": 0}, EVAL_STEPS, card)

    with open(os.path.join(root, "rl_logs", "solved", "EVAL.json")) as f:
        ref = json.load(f)["random_baseline"]
    env = train_lib.build_env(config_of(SOLVED_ENV), dev)
    draws = eval_draws("solved", dev)
    held = draws["random_actions"]
    reset_counts()
    stats, secs = eval_on_draws(env, lambda obs: held, draws,
                                num_episodes=EVAL_EPISODES)
    judge_eval("solved eval random policy in the solved env (one uniform "
               "action per episode)", stats, ref, secs, read_counts(),
               {"K1": EVAL_STEPS, "K1e": 0, "K2": 1, "K3": 0, "K2f": 0},
               EVAL_STEPS, card)
    shutil.rmtree(work, ignore_errors=True)
    print(f"solved phase: {time.perf_counter() - t_phase:.1f} s")


def offpolicy_phase(card, dev):
    """SAC and TD3 through ``rl.train.main`` at 256 envs, their launch
    counts, checks and times; a resume against a straight run; one SAC
    gradient step on the card against the CPU; the committed policies
    scored against EVAL.json (module docstring)."""
    from mujoco_playground_tpu_torch.rl import checkpoint as ckpt_lib
    from mujoco_playground_tpu_torch.rl import sac, td3
    from mujoco_playground_tpu_torch.rl import replay_buffer as rb
    from mujoco_playground_tpu_torch.rl import train as train_lib
    from mujoco_playground_tpu_torch.rl.evaluate import evaluate_agent
    from torch.profiler import ProfilerActivity, profile

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_offpolicy")
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()

    def config_of(argv):
        return train_lib.config_from_args(
            train_lib.make_parser().parse_args(argv))

    for algo, mod, make in (("sac", sac, "make_sac"),
                            ("td3", td3, "make_td3")):
        def cli(run, steps, *extra):
            return (["--algo", algo] + OFFPOLICY_TRAIN
                    + ["--timesteps", str(steps), "--log-dir",
                       os.path.join(work, run)] + list(extra))

        def latest(run):
            return ckpt_lib.latest_checkpoint(os.path.join(
                work, run, train_lib.ckpt_subdir(algo)))

        def load(run):
            return torch.load(latest(run), map_location="cpu",
                              weights_only=True)

        cfg = config_of(cli("main", OFFPOLICY_STEPS))
        B = min(cfg.num_envs, train_lib.OFFPOLICY_MAX_ENVS)
        cfg = dataclasses.replace(cfg, num_envs=B)
        spi = 4 * B
        chunk = min(train_lib.OFFPOLICY_LOG_STEPS, OFFPOLICY_STEPS) // spi
        warm = -(-cfg.sac_learning_starts // spi)
        iters = warm + 2 * chunk
        if warm * spi + 2 * chunk * spi != OFFPOLICY_STEPS:
            fail(f"offpolicy {algo}: {OFFPOLICY_STEPS} steps are not "
                 f"{warm} warm-up iterations and two chunks of {chunk}")

        # the parts of the launch counts: the env's settle, and the final
        # evaluation (eval_episodes episodes of max_episode_steps steps)
        reset_counts()
        env = train_lib.build_env(cfg, dev)
        settle = read_counts()
        init, make_step = getattr(mod, make)(env, cfg)
        state0 = init()
        reset_counts()
        evaluate_agent(env, mod.deterministic_policy(state0),
                       num_episodes=cfg.eval_episodes)
        one_eval = read_counts()
        del state0

        # CUDA events around each training iteration of main()'s loop
        real_make = getattr(mod, make)
        spans = []

        def spying(*a, **kw):
            init_fn, make_fn = real_make(*a, **kw)

            def make_timed(random_actions=False):
                step = make_fn(random_actions)
                if random_actions:
                    return step

                def timed(state, *sa, **skw):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    out = step(state, *sa, **skw)
                    ev[1].record()
                    spans.append(ev)
                    return out
                return timed
            return init_fn, make_timed

        def run_main(label, argv, n_iters):
            reset_counts()
            t0 = time.perf_counter()
            train_lib.main(argv)
            torch.cuda.synchronize()
            got = read_counts()
            want = {"K1": settle["K1"] + 4 * n_iters + one_eval["K1"],
                    "K1e": 0, "K2": settle["K2"] + 1 + one_eval["K2"],
                    "K3": 0, "K2f": 0}
            print(f"offpolicy {algo} {label}: {time.perf_counter() - t0:.1f}"
                  f" s, launches {got}; expected {want} = settle "
                  f"{settle['K1']} + {n_iters} iterations x 4 collect steps"
                  f" + one evaluation of {cfg.eval_episodes} x "
                  f"{cfg.max_episode_steps} steps, K2 at the init reset "
                  f"and the evaluation's")
            if got != want:
                fail(f"offpolicy {algo} {label}: launches {got}, expected "
                     f"{want}")

        setattr(mod, make, spying)
        try:
            run_main(f"main run ({warm} warm-up + 2 x {chunk} iterations)",
                     cli("main", OFFPOLICY_STEPS), iters)
        finally:
            setattr(mod, make, real_make)
        if ckpt_lib.checkpoint_step(latest("main")) != OFFPOLICY_STEPS:
            fail(f"offpolicy {algo}: the last checkpoint is "
                 f"{latest('main')}")
        with open(os.path.join(work, "main", train_lib.ckpt_subdir(algo),
                               "metrics.jsonl")) as f:
            lines = [json.loads(x) for x in f]
        want_steps = [warm * spi + (k + 1) * chunk * spi for k in range(2)]
        if [x["step"] for x in lines] != want_steps or not all(
                math.isfinite(v) for x in lines for v in x.values()):
            fail(f"offpolicy {algo}: metrics.jsonl {lines}")
        saved = load("main")
        finite = all(bool(torch.isfinite(v).all()) for m in mod_names(saved)
                     for v in saved[m].values()) and all(
            bool(torch.isfinite(saved["buffer"][k]).all())
            for k in rb.FIELDS)
        print(f"offpolicy {algo}: checkpoint "
              f"{os.path.basename(latest('main'))}, buffer "
              f"{saved['buffer']['size']} rows (ptr {saved['buffer']['ptr']})"
              f", buffer and parameters finite: {finite}; metrics lines at "
              f"{[x['step'] for x in lines]}")
        if not finite or saved["buffer"]["size"] != cfg.sac_buffer_size:
            fail(f"offpolicy {algo}: a non-finite buffer row or parameter, "
                 f"or buffer size {saved['buffer']['size']}")
        if len(spans) != 2 * chunk:
            fail(f"offpolicy {algo}: {len(spans)} timed iterations")
        ev_ms = spans[chunk][0].elapsed_time(spans[-1][1])
        print(f"offpolicy {algo} training at B={B} (second chunk, {chunk} "
              f"iterations of {spi} env steps): {ev_ms:.2f} ms by CUDA "
              f"events, {chunk * spi / ev_ms * 1e3:.0f} env-steps/s; the "
              f"loop's steps_per_second {lines[1]['steps_per_second']:.0f} "
              f"(first chunk {lines[0]['steps_per_second']:.0f}); "
              f"{ev_ms / chunk:.3f} ms per iteration ({card})")

        # one iteration from the trained state: host syncs, then profiled
        env = train_lib.build_env(cfg, dev)
        init, make_step = getattr(mod, make)(env, cfg)
        state = ckpt_lib.restore_checkpoint(latest("main"), init())
        step = make_step(random_actions=False)
        state, _ = step(state)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, _ = step(state)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = [str(w.message)[:120] for w in caught
                 if "called a synchronizing" in str(w.message)]
        print(f"offpolicy {algo}: host syncs in one iteration: {len(syncs)} "
              f"{syncs[:3]}")
        if syncs:
            fail(f"offpolicy {algo}: an iteration waits on the card")

        def profiled(phase):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                phase()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - w0) * 1e6
            return wall, kernel_times(prof.key_averages())

        def collect_part():
            nonlocal state
            state, _ = step.collect(state)

        def update_part():
            nonlocal state
            state, _ = step.update(state)

        windows = [("collect (4 env steps)", *profiled(collect_part)),
                   ("gradient steps (4)", *profiled(update_part))]
        wall_us = sum(w for _, w, _ in windows)
        busy_us = sum(us for _, _, kern in windows for us, _, _ in kern)
        print(f"offpolicy {algo}: profiled iteration: wall "
              f"{wall_us / 1e3:.2f} ms, device busy {busy_us / 1e3:.3f} ms, "
              f"idle share {1 - busy_us / wall_us:.3f} ({card})")
        for label, wall, kern in windows:
            n = sum(count for _, count, _ in kern)
            busy = sum(us for us, _, _ in kern)
            print(f"  {label}: wall {wall / 1e3:.2f} ms, device busy "
                  f"{busy:.1f} us, {n} kernel launches, idle share "
                  f"{1 - busy / wall:.3f}")
            for us, count, name in kern[:5]:
                print(f"    {us:9.1f} us  x{count:<4d} {name[:80]}")

        if algo == "sac":
            sac_card_vs_cpu(step, state, cfg)
        del state

        # the main run against a split one: the warm-up and the first
        # chunk, then a resume for the second
        train_lib.main(cli("split", OFFPOLICY_STEPS - chunk * spi))
        run_main(f"resume ({chunk} iterations)",
                 cli("split", OFFPOLICY_STEPS, "--resume"), chunk)
        a, b = load("main"), load("split")
        d_params, _ = _tree_diff({m: a[m] for m in mod_names(a)},
                                 {m: b[m] for m in mod_names(b)})
        _, same_all = _tree_diff(a, b)
        print(f"offpolicy {algo} resume check: {iters - chunk} iterations + "
              f"a resume for {chunk} against the main run's {iters} "
              f"straight: largest parameter difference {d_params:.3e}; "
              f"whole train state (networks, targets, optimizers, buffer, "
              f"env states, generators, step"
              f"{', update count' if algo == 'td3' else ''}) bitwise equal: "
              f"{same_all}")
        if not same_all:
            fail(f"offpolicy {algo}: the resumed run departs from the "
                 f"straight run")
        shutil.rmtree(os.path.join(work, "split"), ignore_errors=True)
        shutil.rmtree(os.path.join(work, "main"), ignore_errors=True)

    offpolicy_eval(card, dev, work)
    shutil.rmtree(work, ignore_errors=True)
    print(f"offpolicy phase: {time.perf_counter() - t_phase:.1f} s")


def mod_names(d):
    """The network entries of an off-policy checkpoint dict."""
    return [k for k in ("actor", "actor_target", "q", "q_target") if k in d]


def sac_card_vs_cpu(step, state, cfg):
    """One SAC gradient step (``train_step.gradient_step``) on the card
    against the same step on the CPU from copies of ``state``'s networks
    and optimizers, on the same minibatch and draws, with TF32 matmuls off
    and then on (the control, which must miss)."""
    from torch import nn

    from mujoco_playground_tpu_torch.rl import replay_buffer as rb
    dev = state.log_alpha.device
    batch = rb.sample(state.buffer, cfg.sac_batch_size, state.generator)
    A = batch[1].shape[1]
    eps = [torch.randn((cfg.sac_batch_size, A), generator=state.generator,
                       device=dev) for _ in range(2)]

    def copy_to(device):
        mods = {k: copy.deepcopy(getattr(state, k)).to(device)
                for k in ("actor", "q", "q_target")}
        log_alpha = nn.Parameter(state.log_alpha.detach().clone().to(device))
        opts = {}
        for name, params in (("actor_opt", mods["actor"].parameters()),
                             ("q_opt", mods["q"].parameters()),
                             ("alpha_opt", [log_alpha])):
            opt = torch.optim.Adam(params, lr=cfg.sac_learning_rate)
            opt.load_state_dict(copy.deepcopy(
                getattr(state, name).state_dict()))
            opts[name] = opt
        return state.replace(log_alpha=log_alpha, **mods, **opts)

    def params_of(st):
        return ([p for k in ("actor", "q", "q_target")
                 for p in getattr(st, k).parameters()] + [st.log_alpha])

    def run(tf32):
        sts = [copy_to(dev), copy_to("cpu")]
        allowed = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            l_gpu = torch.stack(step.gradient_step(sts[0], batch, *eps)).cpu()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allowed
        l_cpu = torch.stack(step.gradient_step(
            sts[1], tuple(x.cpu() for x in batch), *(e.cpu() for e in eps)))
        pairs = list(zip(params_of(sts[0]), params_of(sts[1])))
        grads = [(p.grad, q.grad) for p, q in pairs if q.grad is not None]
        return dict(
            loss=float(((l_gpu - l_cpu).abs() / (1 + l_cpu.abs())).max()),
            grad=max(float((g.cpu() - h).abs().max()
                           / h.abs().max().clamp_min(1e-30))
                     for g, h in grads),
            param=max(float((p.detach().cpu() - q.detach()).abs().max())
                      for p, q in pairs)), len(grads)

    for tf32 in (False, True):
        d, n_grads = run(tf32)
        within = all(d[k] <= UPDATE_TOL[k] for k in UPDATE_TOL)
        role = "the control" if tf32 else "the check"
        print(f"offpolicy sac gradient step, card against CPU "
              f"({cfg.sac_batch_size} rows, {n_grads} gradient tensors; "
              f"TF32 matmuls allowed: {tf32}, {role}): q/actor/alpha losses"
              f" {d['loss']:.3e} (tol {UPDATE_TOL['loss']:g}), gradients "
              f"{d['grad']:.3e} of each tensor's largest (tol "
              f"{UPDATE_TOL['grad']:g}), parameters and targets "
              f"{d['param']:.3e} (tol {UPDATE_TOL['param']:g}); within all "
              f"three: {within}")
        if within == tf32:
            fail("offpolicy sac: the card's gradient step departs from the "
                 "CPU's" if not tf32 else
                 "offpolicy sac: the card-against-CPU check does not see "
                 "TF32")


def offpolicy_eval(card, dev, work):
    """The committed SAC and TD3 policies through ``--eval-only`` with
    rl_logs/offpolicy/EVAL.json's protocol on its own episodes, and on
    NUDGES copies of them with the spawns moved by one float32 ulp."""
    from mujoco_playground_tpu_torch.rl import train as train_lib
    from mujoco_playground_tpu_torch.rl.evaluate import evaluate_agent

    root = os.path.dirname(os.path.abspath(__file__))
    run = os.path.join(root, "rl_logs", "offpolicy")
    with open(os.path.join(run, "EVAL.json")) as f:
        ref_all = json.load(f)
    with np.load(os.path.join(run, EVAL_DRAWS)) as d:
        draws = {k: torch.from_numpy(d[k]).to(dev) for k in d.files}
    timed = {}

    def nudged_xy(k):
        """EVAL.json's spawns (k = 0), or each coordinate moved one ulp
        in a direction drawn from seed k."""
        xy = draws["start_xy"]
        if not k:
            return xy
        g = torch.Generator(device=dev).manual_seed(k)
        up = torch.randint(0, 2, xy.shape, generator=g, device=dev).bool()
        return torch.nextafter(xy, torch.where(up, math.inf, -math.inf))

    def timed_eval(env, *a, **kw):
        """evaluate_agent on EVAL.json's episodes, timed, then on NUDGES
        nudged copies (``timed["means"]``, ``timed["success"]``)."""
        runs = []
        for k in range(1 + NUDGES):
            core = env.maze_core(nudged_xy(k), draws["goal_xy"],
                                 draws["goal_cell"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(evaluate_agent(env, *a, core=core, **kw))
            torch.cuda.synchronize()
            if not k:
                timed["s"] = time.perf_counter() - t0
        timed["means"] = [r["mean_return"] for r in runs]
        timed["success"] = [r["success_rate"] for r in runs]
        return runs[0]

    evaluate_cli = train_lib.evaluate_agent
    train_lib.evaluate_agent = timed_eval
    try:
        for algo in ("sac", "td3"):
            ref = ref_all[algo]
            src = os.path.join(run, train_lib.ckpt_subdir(algo))
            log_dir = os.path.join(work, "eval_" + algo)
            dst = os.path.join(log_dir, train_lib.ckpt_subdir(algo))
            os.makedirs(dst)
            for name in os.listdir(src):
                shutil.copy(os.path.join(src, name), dst)
            reset_counts()
            stats = train_lib.main(
                ["--algo", algo, "--eval-only", "--log-dir", log_dir,
                 "--num-envs", str(OFFPOLICY_EVAL_EPISODES),
                 "--eval-episodes", str(OFFPOLICY_EVAL_EPISODES),
                 "--max-episode-steps", str(OFFPOLICY_EVAL_STEPS),
                 "--seed", "0"] + OFFPOLICY_ENV)
            counts = read_counts()
            runs = 1 + NUDGES
            want = {"K1": 3 + runs * OFFPOLICY_EVAL_STEPS, "K1e": 0,
                    "K2": 1 + runs, "K3": 0, "K2f": 0}
            n = OFFPOLICY_EVAL_EPISODES
            sd = math.sqrt(ref["success_rate"] * (1 - ref["success_rate"])
                           / n)
            se = ref["std_return"] / math.sqrt(n)
            far = abs(stats["success_rate"] - ref["success_rate"])
            means = timed["means"]
            median = float(np.median(means))
            off = abs(median - ref["mean_return"])
            print(f"offpolicy eval {algo} (the committed policy, step "
                  f"{ref['timesteps']}) on EVAL.json's episodes: "
                  f"success_rate {stats['success_rate']:.4f} (EVAL.json "
                  f"{ref['success_rate']:.4f}; {far / sd:.2f} SD, 1 SD "
                  f"{sd:.4f}), mean_return {stats['mean_return']:.2f} "
                  f"(EVAL.json {ref['mean_return']:.2f}; "
                  f"{abs(stats['mean_return'] - ref['mean_return']) / se:.2f}"
                  f" SE, 1 SE {se:.2f}), std_return "
                  f"{stats['std_return']:.2f} ({ref['std_return']:.2f}), "
                  f"mean_length {stats['mean_length']:.1f}; {n} x "
                  f"{OFFPOLICY_EVAL_STEPS} steps in {timed['s']:.2f} s, "
                  f"{n * OFFPOLICY_EVAL_STEPS / timed['s']:.0f} env-steps/s "
                  f"({card})")
            print(f"offpolicy eval {algo} with the spawns moved one ulp, "
                  f"{NUDGES} times: mean returns "
                  f"{', '.join(f'{m:.2f}' for m in means[1:])}; success "
                  f"rates {min(timed['success']):.4f}-"
                  f"{max(timed['success']):.4f}; the median mean return of "
                  f"the {runs} evaluations {median:.2f} ({off / se:.2f} SE "
                  f"from EVAL.json's); launches {counts}, expected {want}")
            if counts != want:
                fail(f"offpolicy eval {algo}: launches {counts}, expected "
                     f"{want}")
            if not far <= SUCCESS_SDS * sd:
                fail(f"offpolicy eval {algo}: success rate "
                     f"{stats['success_rate']:.4f} is {far / sd:.2f} SD from "
                     f"EVAL.json's {ref['success_rate']:.4f}")
            if not off <= RETURN_SES * se:
                fail(f"offpolicy eval {algo}: the median mean return "
                     f"{median:.2f} is {off / se:.2f} SE from EVAL.json's "
                     f"{ref['mean_return']:.2f}")
    finally:
        train_lib.evaluate_agent = evaluate_cli


def load_script(name):
    """A script of ``scripts/`` as a module (its ``main`` not run)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def local_batch_checks(env, b, gen, failures):
    """K1 as the main path calls it and K2 against their twins at ``b``
    envs (a rank's local batch): reset states, CHECK_STEPS chained steps,
    and the lidar of the reset frames."""
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import step as k1

    def rows(x):
        return x.reshape(x.shape[0], -1).T.contiguous()

    model, dev = env.model, env.device
    st = env.reset(b)
    env_in = torch.cat([st.odom_ref.position[:, :2], st.goal,
                        st.prev_goal_distance[:, None],
                        env.reset_core(b).physics.qpos[:, :2]],
                       -1).T.contiguous()
    q, v, ws = rows(st.physics.qpos), rows(st.physics.qvel), rows(
        st.physics.qacc_warmstart)
    for step in range(CHECK_STEPS):
        ctrl = torch.rand((3, b), generator=gen, device=dev) * 2 - 1
        args = (model, q, v, ctrl, ws, env_in, env._env_statics(),
                env._fresh_statics(), False)
        got, want = k1.step_fused(*args), k1.step_plain(*args)
        torch.cuda.synchronize()
        check_k1(f"parallel B_local={b} step {step}", got, want, model,
                 failures)
        q, v, ws = want[0], want[1], want[4]
    xp, xq = rows(st.physics.xpos), rows(st.physics.xquat)
    check_k2(f"parallel B_local={b}", k2.lidar(model, xp, xq),
             k2.lidar_plain(model, xp, xq), failures)


def capability_phase(card, dev):
    """The JAX package's learning record at the smoke run's depth (module
    docstring, CAP_* constants); returns the kernels-line numbers of the
    shapes it adds."""
    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import step as k1
    from mujoco_playground_tpu_torch.rl import train as train_lib
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_capability")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    compat = load_script("torch_reference_compat_run")
    solved_eval = load_script("torch_solved_eval")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    failures = []

    def rows(x):
        return x.reshape(x.shape[0], -1).T.contiguous()

    # (a) K1 <0,0,0> and K2 at the 1-env recipe's odd partial blocks: the
    # open floor of the recipe and the medium maze's walls
    with open(os.path.join(root, "rl_logs", CAP_MEDIUM[0], "EVAL.json")) as f:
        medium_ref = json.load(f)
    medium_argv = solved_eval.eval_flags(medium_ref["env"])
    cenv = train_lib.build_env(compat.recipe(False, CAP_COMPAT_STEPS,
                                             CAP_COMPAT_STEPS), dev)
    menv = make_ackermann_env("maze", medium_ref["env"]["maze_id"],
                              solver_iterations=4, ls_iterations=3,
                              device=dev, seed=SEED)
    small = {}
    for arena, env in (("open floor", cenv), ("medium", menv)):
        for b in CAP_SMALL_B:
            st = env.reset(b)
            q, v = rows(st.physics.qpos), rows(st.physics.qvel)
            ws = rows(st.physics.qacc_warmstart)
            for step in range(CHECK_STEPS):
                ctrl = torch.rand((3, b), generator=gen, device=dev) * 2 - 1
                args = (env.model, q, v, ctrl, ws, None, None, None, False)
                got, want = k1.step_fused(*args), k1.step_plain(*args)
                torch.cuda.synchronize()
                small.setdefault("K1p", []).append(check_k1(
                    f"<0,0,0> {arena} B={b} step {step}", got, want,
                    env.model, failures))
                xp, xq = want[2], want[3]
                small.setdefault("K2", []).append(check_k2(
                    f"{arena} B={b} step {step} frames", k2.lidar(
                        env.model, xp, xq), k2.lidar_plain(env.model, xp, xq),
                    failures, K2F_TOL))
                q, v, ws = want[0], want[1], want[4]
            small[(arena, b)] = args
    # (b) K1 with the evaluation's flag set and K2 on medium-maze states:
    # EVAL.json's episodes after CAP_MEDIUM_WARM random-action steps
    draws = eval_draws(CAP_MEDIUM[0], dev)
    B = draws["start_xy"].shape[0]
    st = menv.reset(core=menv.maze_core(draws["start_xy"], draws["goal_xy"],
                                        draws["goal_cell"]))
    xp, xq = rows(st.physics.xpos), rows(st.physics.xquat)
    medium_k2 = [check_k2(f"medium reset frames B={B}",
                          k2.lidar(menv.model, xp, xq),
                          k2.lidar_plain(menv.model, xp, xq), failures)]
    for _ in range(CAP_MEDIUM_WARM):
        st = menv.step_batch(st, torch.rand((B, 2), generator=gen,
                                            device=dev) * 2 - 1)
    q, v = rows(st.physics.qpos), rows(st.physics.qvel)
    ws = rows(st.physics.qacc_warmstart)
    env_in = torch.cat([st.odom_ref.position[:, :2], st.goal,
                        st.prev_goal_distance[:, None]], -1).T.contiguous()
    active = k1.contact_activity(menv.model, q).sum(0).float()
    print(f"capability: medium states B={B} after {CAP_MEDIUM_WARM} "
          f"random-action steps, {float(active.mean()):.2f} active contact "
          f"rows per env (max {int(active.max())}), "
          f"{menv.model.num_scene_boxes} scene boxes")
    medium_k1 = []
    for step in range(CHECK_STEPS):
        ctrl = torch.rand((3, B), generator=gen, device=dev) * 2 - 1
        margs = (menv.model, q, v, ctrl, ws, env_in, menv._env_statics(),
                 None, False)
        got, want = k1.step_fused(*margs), k1.step_plain(*margs)
        torch.cuda.synchronize()
        medium_k1.append(check_k1(f"<1,0,0> medium B={B} step {step}", got,
                                  want, menv.model, failures,
                                  k1_witness(margs, gen)))
        medium_k2.append(check_k2(
            f"medium B={B} step {step} frames",
            k2.lidar(menv.model, want[2], want[3]),
            k2.lidar_plain(menv.model, want[2], want[3]), failures,
            K2F_TOL))
        q, v, ws = want[0], want[1], want[4]
    again = k1.step_fused(*margs)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"check K1 <1,0,0> medium B={B}: a second launch on the same "
          f"inputs is bitwise equal: {same}")
    if not same:
        failures.append("K1 <1,0,0> medium repeat")
    if failures:
        fail(f"capability: kernels disagree with their plain twins: "
             f"{failures}")

    # the new shapes' times beside their bounds
    model1, cq = cenv.model, small[("open floor", 1)][1]
    k1p1 = functools.partial(k1.step_fused, *small[("open floor", 1)])
    st1 = cenv.reset(1)
    xp1, xq1 = rows(st1.physics.xpos), rows(st1.physics.xquat)
    k21 = functools.partial(k2.lidar, model1, xp1, xq1)
    k1m = functools.partial(k1.step_fused, *margs)
    xpm, xqm = want[2], want[3]
    k2m = functools.partial(k2.lidar, menv.model, xpm, xqm)
    times = {}
    for name, call, plain, reps in (
            ("K1p1", k1p1, lambda: k1.step_plain(*small[("open floor", 1)]),
             50),
            ("K21", k21, lambda: k2.lidar_plain(model1, xp1, xq1), 100),
            ("K1m", k1m, lambda: k1.step_plain(*margs), 20),
            ("K2m", k2m, lambda: k2.lidar_plain(menv.model, xpm, xqm), 50)):
        times[name] = (cuda_ms(call, reps), graph_ms(call, reps),
                       cuda_ms(plain, 1))

    def k2_bound(model, b):
        return bound_ms((model.nbody * 7 + model.nsite) * 4 * b,
                        model.nsite * (72 + 27 * model.num_scene_boxes) * b)

    mm = menv.model
    m_bytes = (mm.nq + 2 * mm.nv + mm.nu + 5 + mm.nq + mm.nv + mm.nbody * 7
               + mm.nv + mm.nsite + 12) * 4 * B
    m_flop = k1_ops(mm, k1.contact_activity(mm, q).float().mean(1).tolist(),
                    fresh=False)
    p_bytes = (2 * model1.nq + 4 * model1.nv + model1.nu
               + model1.nbody * 7) * 4
    p_flop = k1_ops(model1, k1.contact_activity(model1, cq).float().mean(
        1).tolist(), fresh=False, env=False)
    bounds = {"K1p1": bound_ms(p_bytes, p_flop), "K21": k2_bound(model1, 1),
              "K1m": bound_ms(m_bytes, m_flop * B), "K2m": k2_bound(mm, B)}
    for name, label in (("K1p1", "K1 <0,0,0> B=1 (open floor)"),
                        ("K21", "K2 B=1 (open floor)"),
                        ("K1m", f"K1 <1,0,0> B={B} (medium)"),
                        ("K2m", f"K2 B={B} (medium)")):
        ms, dev_ms, plain = times[name]
        print(f"capability {label}: {ms:.4f} ms per call, {dev_ms:.4f} ms "
              f"on the device (plain {plain:.2f} ms, bound "
              f"{bounds[name][0]:.3e} ms by {bounds[name][1]}) ({card})")

    # (c) the converted medium policy on EVAL.json's own episodes
    steps = medium_ref["env"]["max_episode_steps"]
    stats, secs, counts_m = eval_cli_on_draws(
        os.path.join(work, "medium"), CAP_MEDIUM[0], CAP_MEDIUM[1],
        medium_argv, dev)
    judge_eval("capability medium policy", stats, medium_ref["eval"], secs,
               counts_m, {"K1": 3 + steps, "K1e": 0, "K2": 2, "K3": 0,
                          "K2f": 0}, steps, card)

    # (d) the scripted expert on umaze, PARITY.md's protocol
    scripted = load_script("torch_scripted_ceiling")
    reset_counts()
    t0 = time.perf_counter()
    res = scripted.main(CAP_SCRIPTED + ["--out", os.path.join(
        work, "scripted_umaze.json")])
    counts_s = read_counts()
    want_s = {"K1": 3 + 6000, "K1e": 0, "K2": 1, "K3": 0, "K2f": 0}
    print(f"capability scripted expert (umaze, 512 x 6000): success_rate "
          f"{res['success_rate']:.4f} (the JAX script's "
          f"{res['jax_success_rate']:.3f}, 3 SDs {3 * res['binomial_sd']:.4f}"
          f"), in {time.perf_counter() - t0:.1f} s, launches {counts_s}, "
          f"expected {want_s} ({card})")
    if counts_s != want_s:
        fail(f"capability scripted expert: launches {counts_s}")
    if not res["within_3sd"]:
        fail(f"capability scripted expert: success {res['success_rate']}")

    # (e) one iteration of the 1-env reference-compat recipe
    reset_counts()
    it_s = []
    path, _ = compat.run(False, dev, CAP_COMPAT_STEPS, CAP_COMPAT_STEPS,
                         work, lambda i, sec: it_s.append(sec))
    counts_c, variants_c = read_counts(), read_variants()
    with open(path) as f:
        returns = [json.loads(x)["episode_return"] for x in f
                   if "episode_return" in x]
    want_c = {"K1": CAP_COMPAT_STEPS, "K1e": 0,
              "K2": 1 + 2 * CAP_COMPAT_STEPS, "K3": 0, "K2f": 0}
    lo, hi = CAP_EPISODE_BOUNDS
    print(f"capability 1-env reference-compat recipe, one iteration of "
          f"{CAP_COMPAT_STEPS} steps on the open floor: episode returns "
          f"{returns} (bounds [{lo:.0f}, {hi:.0f}]); {it_s[0]:.1f} s, "
          f"{CAP_COMPAT_STEPS / it_s[0]:.0f} env-steps/s; launches "
          f"{counts_c} {variants_c}, expected {want_c} ({card})")
    if counts_c != want_c or set(variants_c) != {PLAIN}:
        fail(f"capability compat: launches {counts_c} {variants_c}")
    if len(returns) != 2 or not all(lo <= r <= hi for r in returns):
        fail(f"capability compat: episode returns {returns}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"capability phase: {time.perf_counter() - t_phase:.1f} s")
    return {
        "K1p1": (counts_c["K1"], max(small["K1p"]), *times["K1p1"],
                 *bounds["K1p1"]),
        "K21": (counts_c["K2"], max(small["K2"]), *times["K21"],
                *bounds["K21"]),
        "K1m": (counts_m["K1"], max(medium_k1), *times["K1m"],
                *bounds["K1m"]),
        "K2m": (counts_m["K2"], max(medium_k2), *times["K2m"],
                *bounds["K2m"])}


def parallel_phase(card, dev, main_rate):
    """Data parallelism over the env batch (module docstring, and the
    PAR_* constants): K1 and K2 at the ranks' local batches; (a) NCCL at
    world size 1 bitwise the run without a group, with the slab gather's
    cost; (b) two gloo ranks of ``scripts/torch_multihost_train.py``
    sharing the card; (c) the scaling bench at N=1."""
    import torch.distributed as dist

    from mujoco_playground_tpu_torch.envs import make_ackermann_env
    from mujoco_playground_tpu_torch.parallel import (dryrun,
                                                      initialize_distributed,
                                                      mesh)
    from mujoco_playground_tpu_torch.rl import replay_buffer as rb

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    t_phase = time.perf_counter()
    failures = []
    kenv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for b in PAR_LOCAL_B:
        local_batch_checks(kenv, b, gen, failures)
    del kenv
    if failures:
        fail(f"parallel: kernels disagree with their twins at the local "
             f"batches: {failures}")
    mh = load_script("torch_multihost_train")
    runs = {}
    for flags in (PAR_PPO, PAR_OFF):
        args = mh.make_parser().parse_args(flags + PAR_COMMON)
        for algo in args.algo:
            runs[algo] = dryrun.algo_config(mh.config_of(args), algo)

    def cpu_tree(run):
        st = run["state"]
        out = {"params": {k: v.detach().cpu() for k, v in
                          mesh.named_tensors(st).items()},
               "env_states": {k: v.cpu() for k, v in
                              mh.env_state_tensors(st.env_states).items()}}
        if getattr(st, "norm", None) is not None:
            out["norm"] = {k: v.cpu() for k, v in
                           dataclasses.asdict(st.norm).items()}
        if "warm_buffer" in run:
            for name, buf in (("warm_buffer", run["warm_buffer"]),
                              ("buffer", st.buffer)):
                out[name] = {k: (v.cpu() if isinstance(v, torch.Tensor)
                                 else v)
                             for k, v in rb.state_dict(buf).items()}
        return out

    # (a) NCCL at world size 1 against no process group, A B B A
    init = f"tcp://127.0.0.1:{dryrun.free_port()}"
    single, gather_ms = {}, None
    order = ("no group", "NCCL world size 1", "NCCL world size 1",
             "no group")
    for algo, cfg in runs.items():
        got = []
        for label in order:
            if label != "no group" and not dist.is_initialized():
                if not initialize_distributed(init, 1, 0, device=dev):
                    fail("parallel: initialize_distributed returned False")
                if dist.get_backend() != "nccl":
                    fail(f"parallel: backend {dist.get_backend()}")
            shard = (mesh.make_mesh(cfg.num_envs) if label != "no group"
                     else None)
            reset_counts()
            run = dryrun.train_run(algo, cfg, PAR_ITERS, shard, dev)
            torch.cuda.synchronize()
            counts = read_counts()
            got.append((cpu_tree(run), counts, run["seconds"],
                        dryrun.param_sha256(run["state"])))
            iters = PAR_ITERS + (0 if algo == "ppo" else 1)
            steps = cfg.unroll_length if algo == "ppo" else 4
            want = {"K1": 3 + iters * steps, "K1e": 0, "K2": 1, "K3": 0,
                    "K2f": 0}
            if counts != want:
                fail(f"parallel (a) {algo} {label}: launches {counts}, "
                     f"expected {want} (the env's settle, one K1 a "
                     f"rollout or collect step, K2 at the first reset)")
            if shard is not None and algo == "ppo" and gather_ms is None:
                # the one collective of an iteration alone, at this run's
                # shapes: the gather of the slab after GAE
                slab = {k: torch.ones((cfg.unroll_length, cfg.num_envs, w),
                                      device=dev)
                        for k, w in (("obs", 79), ("action", 2), ("logp", 1),
                                     ("value", 1), ("reward", 1),
                                     ("terminated", 1), ("done", 1),
                                     ("raw_obs", 79), ("adv", 1),
                                     ("ret", 1))}
                floats = sum(v.numel() for v in slab.values())
                gather_ms = cuda_ms(
                    lambda: mesh.all_gather_env(slab, shard, dim=1),
                    PAR_COLLECTIVE_REPS)
                print(f"parallel (a) NCCL world size 1, all_gather_env of "
                      f"the PPO slab ({floats} floats): {gather_ms:.4f} ms "
                      f"per call ({card})")
                del slab
            del run
        ref = got[0]
        same = all(_tree_diff(ref[0], g[0])[1] and g[3] == ref[3]
                   and g[1] == ref[1] for g in got[1:])
        print(f"parallel (a) {algo} at {cfg.num_envs} envs, {PAR_ITERS} "
              f"iterations, runs {' / '.join(order)}: all bitwise the same "
              f"(parameters, env states"
              f"{', norm statistics' if 'norm' in ref[0] else ''}"
              f"{', replay buffer after the warm-up and at the end' if 'buffer' in ref[0] else ''}"
              f"): {same}; sha256 {ref[3][:16]}; launches {ref[1]}; s per "
              f"iteration "
              f"{' / '.join(str([round(x, 4) for x in g[2]]) for g in got)}"
              f" ({card})")
        if not same:
            fail(f"parallel (a) {algo}: world size 1 departs from the run "
                 f"without a group")
        single[algo] = ref[0]
    dist.destroy_process_group()

    # (b) two gloo ranks of the script sharing the card
    env = dict(os.environ, PYTHONPATH=root)
    for flags in (PAR_PPO, PAR_OFF):
        init = f"tcp://127.0.0.1:{dryrun.free_port()}"
        dump = os.path.join(work, "two")
        procs, logs = [], []
        for r in range(2):
            logs.append(os.path.join(work, f"{flags[1]}_rank{r}.log"))
            os.makedirs(work, exist_ok=True)
            with open(logs[-1], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(root, "scripts",
                                                  "torch_multihost_train.py")]
                    + flags + PAR_COMMON
                    + ["--init-method", init, "--world-size", "2", "--rank",
                       str(r), "--backend", "gloo", "--device", dev.type,
                       "--dump", dump], cwd=root, env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        for p in procs:
            try:
                p.wait(timeout=600)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                fail(f"parallel (b): the ranks of {flags[1]} timed out")
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                with open(log) as f:
                    fail(f"parallel (b): {log} exited {p.returncode}:\n"
                         f"{f.read()[-3000:]}")
    for algo, cfg in runs.items():
        ranks = [torch.load(os.path.join(work, "two", f"{algo}_rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        res = [d["result"] for d in ranks]
        want = single[algo]["params"]
        scale = max(float(v.abs().max()) for v in want.values())
        err = max(float((ranks[0]["params"][k] - v).abs().max())
                  for k, v in want.items())
        env_err = max(float((torch.cat([ranks[0]["env_states"][k],
                                        ranks[1]["env_states"][k]]).double()
                             - v.double()).abs().max())
                      for k, v in single[algo]["env_states"].items())
        iters = PAR_ITERS + (0 if algo == "ppo" else 1)
        steps = cfg.unroll_length if algo == "ppo" else 4
        k1_want = 3 + iters * steps
        print(f"parallel (b) {algo}: 2 gloo ranks x "
              f"{res[0]['local_envs']} envs on one card, sha256 "
              f"{res[0]['param_sha256'][:16]} / {res[1]['param_sha256'][:16]}"
              f"; largest parameter difference from (a)'s one-process run "
              f"{err:.3e} (tol {PAR_PARAM_TOL:g} x {scale:.4f}); largest "
              f"env-state difference {env_err:.3e}; launches "
              f"{res[0]['launches']} / {res[1]['launches']}; s per "
              f"iteration rank 0 "
              f"{[round(x, 4) for x in res[0]['seconds_per_iteration']]}, "
              f"rank 1 "
              f"{[round(x, 4) for x in res[1]['seconds_per_iteration']]} "
              f"({card})")
        if res[0]["param_sha256"] != res[1]["param_sha256"]:
            fail(f"parallel (b) {algo}: the ranks' parameters differ")
        if not err <= PAR_PARAM_TOL * scale:
            fail(f"parallel (b) {algo}: the 2-rank parameters depart from "
                 f"the one-process run")
        if [r["local_envs"] for r in res] != [cfg.num_envs // 2] * 2:
            fail(f"parallel (b) {algo}: local envs {res}")
        for r in res:
            if r["launches"] != {"K1": k1_want, "K2": 1}:
                fail(f"parallel (b) {algo}: rank {r['rank']} launches "
                     f"{r['launches']}, expected K1 {k1_want} (one a "
                     f"step), K2 1")

    # (c) the scaling bench at N=1
    out = subprocess.run(
        [sys.executable, os.path.join(root, "scripts", "torch_scale_bench.py"),
         "--envs-per-gpu", str(SCALE_ENVS), "--steps", str(SCALE_STEPS)],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"parallel (c): torch_scale_bench exited {out.returncode}:\n"
             f"{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    bench = json.loads(next(x for x in lines if x.startswith("{")))
    print(f"parallel (c) torch_scale_bench N={bench['ranks']}: "
          f"{bench['env_steps_per_s']:.0f} env-steps/s at {bench['envs']} "
          f"envs, {bench['steps']} steps after {bench['warmup']} "
          f"({bench['card']}); the main path in this call, the same loop "
          f"in this process, {main_rate:.0f} env-steps/s ({card}); "
          f"launches {bench['launches']}")
    for x in lines:
        if x.startswith("N>=2"):
            print(f"parallel (c) {x}")
    if bench["ranks"] != 1 or not bench["finite"]:
        fail(f"parallel (c): {bench}")
    if bench["launches"] != {"K1": bench["warmup"] + SCALE_STEPS, "K2": 1}:
        fail(f"parallel (c): launches {bench['launches']}")
    if torch.cuda.device_count() < 2 and not any(
            x.startswith("N>=2: not measured") for x in lines):
        fail("parallel (c): the bench did not say that N>=2 is not "
             "measured")
    print(f"parallel phase: {time.perf_counter() - t_phase:.1f} s")


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke run needs one NVIDIA GPU")
    from mujoco_playground_tpu_torch.envs import (DomainRandomizedEnv,
                                                  RandomizationConfig,
                                                  make_ackermann_env,
                                                  randomize_model)
    from mujoco_playground_tpu_torch.envs.poses import wall_poses
    from mujoco_playground_tpu_torch.ops import build
    from mujoco_playground_tpu_torch.ops import lidar as k2
    from mujoco_playground_tpu_torch.ops import newton as k3
    from mujoco_playground_tpu_torch.ops import step as k1
    from mujoco_playground_tpu_torch.physics import engine
    from mujoco_playground_tpu_torch.physics.state import make_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_name_and_limit()

    # -- phase 1: build ----------------------------------------------------
    t = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t:.1f} s for {', '.join(logs)} "
          f"(nvcc {' '.join(build.NVCC_FLAGS)}; per source "
          f"{build.SOURCE_FLAGS})")
    for row in ptxas_report(logs):
        print(f"  ptxas {row}")
    for row in k1_occupancy_report(build) + k23_occupancy_report(build):
        print(f"  occupancy {row}")
    print(f"card: {card}")

    env = make_ackermann_env("maze", "umaze", solver_iterations=4,
                             ls_iterations=3, seed=SEED)
    model = env.model
    statics, fresh = env._env_statics(), env._fresh_statics()

    def rows(x):
        """A batch's leaf (B, ...) as the kernels' (rows, B); one env's
        leaf as (rows, 1)."""
        if x.dim() == 1:
            return x[:, None].contiguous()
        return x.reshape(x.shape[0], -1).T.contiguous()

    # -- phase 2: kernels against their plain twins -------------------------
    # K1's two variants at B_CHECK from reset states, 3 chained steps; the
    # settle variant (ws_compare, no env rows) also at B=1 on the settle
    # input, as AckermannEnv.__init__ runs it; K2 on the reset frames
    failures = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    st = env.reset(B_CHECK)
    env_in = torch.cat([st.odom_ref.position[:, :2], st.goal,
                        st.prev_goal_distance[:, None],
                        env.reset_core(B_CHECK).physics.qpos[:, :2]],
                       -1).T.contiguous()
    qpos_settle = model.qpos0.clone()
    qpos_settle[2] = env.scene.floor_z + 0.055
    settle = make_state(model, qpos=qpos_settle)
    runs = ((f"env+fresh B={B_CHECK}", st.physics, True, False, B_CHECK),
            (f"ws_compare B={B_CHECK}", st.physics, False, True, B_CHECK),
            ("ws_compare settle B=1", settle, False, True, 1))
    for label, ph, with_env, ws_compare, b in runs:
        q, v = rows(ph.qpos), rows(ph.qvel)
        ws = rows(ph.qacc_warmstart)
        for step in range(CHECK_STEPS):
            ctrl = (rows(settle.ctrl) if b == 1 else
                    torch.rand((3, b), generator=gen, device=dev) * 2 - 1)
            args = (model, q, v, ctrl, ws,
                    env_in if with_env else None,
                    statics if with_env else None,
                    fresh if with_env else None, ws_compare)
            got = k1.step_fused(*args)
            want = k1.step_plain(*args)
            torch.cuda.synchronize()
            check_k1(f"{label} step {step}", got, want, model, failures)
            q, v, ws = want[0], want[1], want[4]
    # K1 on states against the maze walls, the many-row workspace cases that
    # reset states never reach: the auto-reset step, 3 chained steps; an env
    # over tolerance must be shown ill-conditioned (set_aside)
    wgen = torch.Generator(device=dev).manual_seed(SEED + 4)
    wall = wall_poses(env, B_CHECK, wgen)
    q, v, ws = rows(wall.qpos), rows(wall.qvel), rows(wall.qacc_warmstart)
    active = k1.contact_activity(model, q).sum(0).float()
    print(f"K1 wall contacts B={B_CHECK}: {float(active.mean()):.2f} active "
          f"contact rows per env (max {int(active.max())})")
    for step in range(CHECK_STEPS):
        ctrl = torch.rand((3, B_CHECK), generator=wgen, device=dev) * 2 - 1
        args = (model, q, v, ctrl, ws, env_in, statics, fresh, False)
        got = k1.step_fused(*args)
        want = k1.step_plain(*args)
        torch.cuda.synchronize()
        check_k1(f"wall B={B_CHECK} step {step}", got, want, model, failures,
                 k1_witness(args, wgen))
        q, v, ws = want[0], want[1], want[4]
    xp, xq = rows(st.physics.xpos), rows(st.physics.xquat)
    check_k2(f"B={B_CHECK}", k2.lidar(model, xp, xq),
             k2.lidar_plain(model, xp, xq), failures)

    # K1e's two variants at B_CHECK, 3 chained steps, on parameters with a
    # +-2 cm floor offset (a wrong plane_z would show in the lidar rows)
    dr_cfg = RandomizationConfig(floor_z_offset=(-0.02, 0.02))
    params = engine.dr_params(randomize_model(model, gen, B_CHECK, dr_cfg),
                              model, B_CHECK)
    for with_fresh in (True, False):
        label = f"e {'env+fresh' if with_fresh else 'env'} B={B_CHECK}"
        q, v = rows(st.physics.qpos), rows(st.physics.qvel)
        ws = rows(st.physics.qacc_warmstart)
        e_in = env_in if with_fresh else env_in[:5].contiguous()
        for step in range(CHECK_STEPS):
            ctrl = torch.rand((3, B_CHECK), generator=gen, device=dev) * 2 - 1
            args = (model, q, v, ctrl, ws, e_in, statics,
                    fresh if with_fresh else None, False)
            got = k1.step_fused(*args, dr_params=params)
            want = k1.step_plain(*args, dr_params=params)
            torch.cuda.synchronize()
            check_k1(f"{label} step {step}", got, want, model, failures)
            q, v, ws = want[0], want[1], want[4]

    # the plain physics step (K1 <0,0,0>, K1e <0,0,0,dr>: physics substeps
    # and delayed obs) on the wall-contact states, 3 chained steps each,
    # with the set_aside rule of the wall checks
    for dr in (None, params):
        label = f"{'e ' if dr is not None else ''}<0,0,0> wall B={B_CHECK}"
        q, v, ws = rows(wall.qpos), rows(wall.qvel), rows(wall.qacc_warmstart)
        for step in range(CHECK_STEPS):
            ctrl = torch.rand((3, B_CHECK), generator=wgen, device=dev) * 2 - 1
            args = (model, q, v, ctrl, ws, None, None, None, False)
            got = k1.step_fused(*args, dr_params=dr)
            want = k1.step_plain(*args, dr_params=dr)
            torch.cuda.synchronize()
            check_k1(f"{label} step {step}", got, want, model, failures,
                     k1_witness(args, wgen, dr))
            q, v, ws = want[0], want[1], want[4]
    # K1 and K1e strictly on the envs where K1 once missed its twins
    k1_misses_check(env, dev, failures)

    # K3 at B_CHECK on the system the staged step assembles for compat-path
    # states next to walls, with a warm start
    cenv = make_ackermann_env("maze", "umaze", solver_iterations=4,
                              ls_iterations=3, seed=SEED,
                              reference_flat_manifold=True,
                              reference_wheel_patch=True)
    # the system the staged step assembles (engine.newton_inputs), with a
    # warm start 1 m/s^2 (normal per dof) away from the smooth acceleration
    sys_args = engine.newton_inputs(cenv.model,
                                    wall_poses(cenv, B_CHECK, gen))
    sys_ws = (sys_args[1] + torch.randn(sys_args[1].shape, generator=gen,
                                        device=dev)).contiguous()
    active = sys_args[14].sum(0)
    print(f"K3 system B={B_CHECK}: {sys_args[8].shape[0]} contact rows, "
          f"{float(active.mean()):.2f} in contact per env (max "
          f"{int(active.max())})")
    check_k3(f"B={B_CHECK}", k3.newton_solve(*sys_args, warmstart=sys_ws),
             k3.newton_solve_plain(*sys_args, warmstart=sys_ws), failures)
    # the same system with every contact row in contact: K3's block pool
    # overflows, and an env whose rows do not fit runs them through its
    # window of the pool in chunks
    dense = list(sys_args)
    dense[14] = torch.ones_like(sys_args[14])
    check_k3(f"all {sys_args[8].shape[0]} rows in contact B={B_CHECK}",
             k3.newton_solve(*dense, warmstart=sys_ws),
             k3.newton_solve_plain(*dense, warmstart=sys_ws), failures)
    del dense
    # the path-B envs where K3 once missed its twins (K3_MISSES), at their
    # own batch: a partial block
    t_check = time.perf_counter()
    margs, mws, mids = load_k3_misses(K3_MISSES, dev)
    got = k3.newton_solve(*margs, warmstart=mws)
    want = k3.newton_solve_plain(*margs, warmstart=mws)
    r = outputs_ratio([got], [want], [K3_TOL + (True,)])
    active = margs[14].sum(0)
    for e, (seed, step, env_id) in enumerate(mids):
        print(f"K3 captured env {e} (seed {seed}, step {step}, env "
              f"{env_id}, {int(active[e])} rows in contact): "
              f"{float(r[e]):.3f}x the tolerance from the float32 twin")
    check_k3(f"captured path-B envs B={len(mids)}", got, want, failures,
             k3_witness(margs, mws, gen))
    check_k3_f64(f"captured path-B envs B={len(mids)}", got, margs, mws,
                 failures)
    print(f"K3 captured envs: {time.perf_counter() - t_check:.1f} s")
    del margs, mws, got, want
    if failures:
        fail(f"kernels disagree with their plain twins: {failures}")

    # -- phase 3: the main path ---------------------------------------------
    act_gen = torch.Generator(device=dev).manual_seed(SEED + 2)

    def random_actions():
        return torch.rand((B_MAIN, 2), generator=act_gen, device=dev) * 2 - 1

    reset_counts()
    states = reset_states = env.reset(B_MAIN)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for i in range(STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0.record()
        states = env.step_autoreset_batch(states, random_actions())
    t1.record()
    torch.cuda.synchronize()
    launches = read_counts()
    step_ms = t0.elapsed_time(t1) / (STEPS - WARMUP)
    print(f"main path: B={B_MAIN}, {STEPS} steps, launches {launches}, "
          f"{step_ms:.4f} ms/env step, "
          f"{B_MAIN / step_ms * 1e3:.0f} env-steps/s ({card})")
    if launches["K1"] != STEPS:
        fail(f"K1 ran {launches['K1']} times in {STEPS} main-path steps")
    if launches["K2"] < 1:
        fail("K2 did not run at reset")
    if launches["K1e"] or launches["K3"]:
        fail(f"the main path launched K1e or K3: {launches}")
    check_finite("main path", states, env.obs_size, B_MAIN)
    print(f"main path outputs finite; obs {tuple(states.obs.shape)}, "
          f"{int(states.done.sum())} envs done on the last step")

    # where a main-path step's time goes: device time by kernel over a
    # short profiled window, and the device's idle share of the wall time
    def main_step():
        nonlocal states
        states = env.step_autoreset_batch(states, random_actions())

    profile_steps("main-path", main_step, PROFILE_STEPS, card)

    # -- phase 3b: path A, domain randomization through K1e ----------------
    # the default randomization (RandomizationConfig()); every env starts
    # from one shared reset sample and takes one shared action for
    # SAME_STEPS steps, so only the parameters spread their velocities;
    # then random actions
    dr_env = DomainRandomizedEnv(
        env, B_MAIN, torch.Generator(device=dev).manual_seed(SEED + 3),
        RandomizationConfig())
    core = expand_tree(env.reset_core(1), B_MAIN)
    same = random_actions()[:1].expand(B_MAIN, 2)
    reset_counts()
    dstates = dr_env.reset(core=core)
    ever_done = torch.zeros(B_MAIN, dtype=torch.bool, device=dev)
    for i in range(DR_STEPS):
        if i == WARMUP:
            torch.cuda.synchronize()
            t0.record()
        dstates = dr_env.step_autoreset_batch(
            dstates, same if i < SAME_STEPS else random_actions())
        if i < SAME_STEPS:
            ever_done |= dstates.done
        if i == SAME_STEPS - 1:
            kept = dstates.physics.qvel[~ever_done]
            spread = float(kept.std(0).max())
    t1.record()
    torch.cuda.synchronize()
    launches_dr = read_counts()
    dr_ms = t0.elapsed_time(t1) / (DR_STEPS - WARMUP)
    print(f"path A (DomainRandomizedEnv): B={B_MAIN}, {DR_STEPS} steps, "
          f"launches {launches_dr}, {dr_ms:.4f} ms/env step, "
          f"{B_MAIN / dr_ms * 1e3:.0f} env-steps/s ({card})")
    print(f"path A: after {SAME_STEPS} steps from one shared start with "
          f"one shared action, max over dofs of the std of qvel across "
          f"{kept.shape[0]} envs: {spread:.4e}")
    if launches_dr["K1e"] != DR_STEPS:
        fail(f"K1e ran {launches_dr['K1e']} times in {DR_STEPS} path A steps")
    if launches_dr["K1"] or launches_dr["K3"]:
        fail(f"path A launched K1 or K3: {launches_dr}")
    if launches_dr["K2"] < 1:
        fail("K2 did not run at the path A reset")
    if not spread > 1e-4:
        fail("path A: identical starts and actions did not spread qvel; "
             "the randomized parameters did not reach K1e")
    check_finite("path A", dstates, env.obs_size, B_MAIN)

    # -- phase 3c: path B, the compat manifolds through the staged step ----
    # with K3 held against its twin on the states after every
    # K3_PATH_EVERY-th step from K3_PATH_FROM on; the checks are left out of
    # the launch counts and of the timed stretches (pairs of events)
    reset_counts()
    cstates = cenv.reset(B_MAIN)
    stretches, path_checks, check_s = [], [], 0.0
    for i in range(STAGED_STEPS):
        if i == STAGED_WARMUP:
            torch.cuda.synchronize()
            stretches.append([torch.cuda.Event(enable_timing=True), None])
            stretches[-1][0].record()
        cstates = cenv.step_autoreset_batch(cstates, random_actions())
        step = i + 1
        if step < K3_PATH_FROM or step % K3_PATH_EVERY:
            continue
        if stretches:
            stretches[-1][1] = torch.cuda.Event(enable_timing=True)
            stretches[-1][1].record()
        t_check = time.perf_counter()
        path_checks.append((step, *k3_states_check(
            f"path B step {step} B={B_MAIN}", cenv.model, cstates, gen,
            failures)))
        torch.cuda.synchronize()
        check_s += time.perf_counter() - t_check
        if step < STAGED_STEPS and stretches:
            stretches.append([torch.cuda.Event(enable_timing=True), None])
            stretches[-1][0].record()
    if stretches[-1][1] is None:
        stretches[-1][1] = torch.cuda.Event(enable_timing=True)
        stretches[-1][1].record()
    torch.cuda.synchronize()
    launches_st = read_counts()
    st_ms = (sum(a.elapsed_time(b) for a, b in stretches)
             / (STAGED_STEPS - STAGED_WARMUP))
    print(f"path B: K3 on the states after steps "
          f"{[c[0] for c in path_checks]}: worst env "
          f"{', '.join(f'{c[1]:.3f}' for c in path_checks)}x the tolerance "
          f"from the float32 twin, "
          f"{', '.join(f'{c[2]:.3g}' for c in path_checks)}x from the "
          f"float64 twin; the {len(path_checks)} checks took {check_s:.1f} s")
    if failures:
        fail(f"K3 disagrees with its twin on path B's states: {failures}")
    print(f"path B (compat manifolds, staged step): B={B_MAIN}, "
          f"{STAGED_STEPS} steps, launches {launches_st}, {st_ms:.4f} "
          f"ms/env step, {B_MAIN / st_ms * 1e3:.0f} env-steps/s ({card})")
    if launches_st["K3"] != STAGED_STEPS:
        fail(f"K3 ran {launches_st['K3']} times in {STAGED_STEPS} path B "
             f"steps")
    if launches_st["K1"] or launches_st["K1e"]:
        fail(f"path B launched K1 or K1e: {launches_st}")
    if launches_st["K2"] < STAGED_STEPS:
        fail(f"K2 ran {launches_st['K2']} times in {STAGED_STEPS} path B "
             f"steps")
    check_finite("path B", cstates, cenv.obs_size, B_MAIN)

    def staged_step():
        nonlocal cstates
        cstates = cenv.step_autoreset_batch(cstates, random_actions())

    profile_steps("path B", staged_step, STAGED_PROFILE, card)

    # -- phases 3d-3g: the reference-compat knobs, the staged DR fallback
    # and DR with heading noise (compat_paths)
    paths = compat_paths(card, dev, env, cenv, random_actions, t0, t1)

    # -- phase 4: the kernels at the paths' shapes ---------------------------
    # K1 as the main path calls it (<with_env, with_fresh, !ws_compare>) on
    # the last main-path states, K2 on the reset frames it scanned, K1e on
    # the last path A states with its parameters, K3 on the system of the
    # last path B states; each held against its twin on the same inputs,
    # then timed
    ph = states.physics
    q, v, ws = rows(ph.qpos), rows(ph.qvel), rows(ph.qacc_warmstart)
    ctrl = torch.rand((3, B_MAIN), generator=gen, device=dev) * 2 - 1
    fresh_xy = env.reset_core(B_MAIN).physics.qpos[:, :2]
    env_in = torch.cat([states.odom_ref.position[:, :2], states.goal,
                        states.prev_goal_distance[:, None], fresh_xy],
                       -1).T.contiguous()
    args = (model, q, v, ctrl, ws, env_in, statics, fresh, False)
    xp, xq = rows(reset_states.physics.xpos), rows(reset_states.physics.xquat)
    got, want = k1.step_fused(*args), k1.step_plain(*args)
    # the twin in float64 on the same inputs: the conditioning behind the
    # tolerances
    exact = k1.step_plain(model, *(t.double() for t in args[1:6]),
                          *args[6:])
    k1_err = check_k1(f"main B={B_MAIN}", got, want, model, failures)
    check_repeat("K1", got, k1.step_fused(*args), failures)
    got_k2 = k2.lidar(model, xp, xq)
    k2_err = check_k2(f"B={B_MAIN}", got_k2, k2.lidar_plain(model, xp, xq),
                      failures)
    check_repeat("K2", [got_k2], [k2.lidar(model, xp, xq)], failures)
    del got_k2
    dph = dstates.physics
    dparams = engine.dr_params(dr_env.models, model, B_MAIN)
    d_env_in = torch.cat([dstates.odom_ref.position[:, :2], dstates.goal,
                          dstates.prev_goal_distance[:, None], fresh_xy],
                         -1).T.contiguous()
    dargs = (model, rows(dph.qpos), rows(dph.qvel), ctrl,
             rows(dph.qacc_warmstart), d_env_in, statics, fresh, False)
    got_e = k1.step_fused(*dargs, dr_params=dparams)
    k1e_err = check_k1(
        f"e main B={B_MAIN}", got_e,
        k1.step_plain(*dargs, dr_params=dparams), model, failures,
        k1_witness(dargs, gen, dparams))
    check_repeat("K1e", got_e, k1.step_fused(*dargs, dr_params=dparams),
                 failures)
    del got_e
    cph = cstates.physics
    sys_args = engine.newton_inputs(cenv.model, cph)
    sys_ws = cph.qacc_warmstart.T.contiguous()
    active = sys_args[14].sum(0)
    got_k3 = k3.newton_solve(*sys_args, warmstart=sys_ws)
    k3_err = check_k3(f"B={B_MAIN}", got_k3,
                      k3.newton_solve_plain(*sys_args, warmstart=sys_ws),
                      failures, k3_witness(sys_args, sys_ws, gen))
    check_repeat("K3", [got_k3], [k3.newton_solve(*sys_args,
                                                  warmstart=sys_ws)],
                 failures)
    del got_k3
    # the plain physics step: K1 <0,0,0> on path R's last states (strict),
    # K1e <0,0,0,dr> on path R under DR's with its parameters (set_aside);
    # K2 with each env's floor on path C's last frames and floors
    rph = paths["R"]["states"].physics
    pargs = (model, rows(rph.qpos), rows(rph.qvel), ctrl,
             rows(rph.qacc_warmstart), None, None, None, False)
    got_p = k1.step_fused(*pargs)
    k1p_err = check_k1(f"<0,0,0> B={B_MAIN}", got_p, k1.step_plain(*pargs),
                       model, failures)
    check_repeat("K1 <0,0,0>", got_p, k1.step_fused(*pargs), failures)
    del got_p
    rdph = paths["RD"]["states"].physics
    pdparams = engine.dr_params(paths["RD"]["models"], model, B_MAIN)
    pdargs = (model, rows(rdph.qpos), rows(rdph.qvel), ctrl,
              rows(rdph.qacc_warmstart), None, None, None, False)
    got_pe = k1.step_fused(*pdargs, dr_params=pdparams)
    k1pe_err = check_k1(
        f"e <0,0,0> B={B_MAIN}", got_pe,
        k1.step_plain(*pdargs, dr_params=pdparams), model, failures,
        k1_witness(pdargs, gen, pdparams))
    check_repeat("K1e <0,0,0,dr>", got_pe,
                 k1.step_fused(*pdargs, dr_params=pdparams), failures)
    del got_pe
    fph = paths["C"]["states"].physics
    fxp, fxq = rows(fph.xpos), rows(fph.xquat)
    floor = paths["C"]["models"].plane_z
    got_k2f = k2.lidar(model, fxp, fxq, floor)
    k2f_err = check_k2(f"per-env floor B={B_MAIN}", got_k2f,
                       k2.lidar_plain(model, fxp, fxq, floor), failures,
                       K2F_TOL)
    check_repeat("K2 per-env floor", [got_k2f],
                 [k2.lidar(model, fxp, fxq, floor)], failures)
    del got_k2f
    if failures:
        fail(f"kernels disagree with their plain twins: {failures}")
    # how far the kernel and the float32 twin are from the float64 twin
    for name, g, w, x in zip(K1_TOL, got, want, exact):
        if name == "slab":
            g, w, x = (angle_free(t, model) for t in (g, w, x))
        print(f"float64 twin, {name}: max |kernel - f64| "
              f"{float((g.double() - x).abs().max()):.3e}, max |f32 twin - "
              f"f64| {float((w.double() - x).abs().max()):.3e}")
    del got, want, exact
    # ms: CUDA events around each wrapper call, host path included (the
    # method of every earlier kernels line); device_ms: one replay of a CUDA
    # graph of the calls, the kernel alone
    k1_call = functools.partial(k1.step_fused, *args)
    k2_call = functools.partial(k2.lidar, model, xp, xq)
    k1e_call = functools.partial(k1.step_fused, *dargs, dr_params=dparams)
    k3_call = functools.partial(k3.newton_solve, *sys_args,
                                warmstart=sys_ws)
    k1_ms, k1_dev_ms = cuda_ms(k1_call, 20), graph_ms(k1_call, 20)
    k1_plain_ms = cuda_ms(lambda: k1.step_plain(*args), 1)
    k2_ms, k2_dev_ms = cuda_ms(k2_call, 50), graph_ms(k2_call, 50)
    k2_plain_ms = cuda_ms(lambda: k2.lidar_plain(model, xp, xq), 1)
    k1e_ms, k1e_dev_ms = cuda_ms(k1e_call, 20), graph_ms(k1e_call, 20)
    k1e_plain_ms = cuda_ms(lambda: k1.step_plain(*dargs, dr_params=dparams),
                           1)
    k3_ms, k3_dev_ms = cuda_ms(k3_call, 20), graph_ms(k3_call, 20)
    k3_plain_ms = cuda_ms(
        lambda: k3.newton_solve_plain(*sys_args, warmstart=sys_ws), 1)
    k1p_call = functools.partial(k1.step_fused, *pargs)
    k1p_ms, k1p_dev_ms = cuda_ms(k1p_call, 20), graph_ms(k1p_call, 20)
    k1p_plain_ms = cuda_ms(lambda: k1.step_plain(*pargs), 1)
    k1pe_call = functools.partial(k1.step_fused, *pdargs,
                                  dr_params=pdparams)
    k1pe_ms, k1pe_dev_ms = cuda_ms(k1pe_call, 20), graph_ms(k1pe_call, 20)
    k1pe_plain_ms = cuda_ms(
        lambda: k1.step_plain(*pdargs, dr_params=pdparams), 1)
    k2f_call = functools.partial(k2.lidar, model, fxp, fxq, floor)
    k2f_ms, k2f_dev_ms = cuda_ms(k2f_call, 50), graph_ms(k2f_call, 50)
    k2f_plain_ms = cuda_ms(lambda: k2.lidar_plain(model, fxp, fxq, floor),
                           1)

    nbox = model.num_scene_boxes
    k1_bytes = (model.nq + 2 * model.nv + model.nu + 7 + model.nq
                + model.nv + model.nbody * 7 + model.nv
                + 2 * model.nsite + 12) * 4 * B_MAIN
    slot_active = k1.contact_activity(model, q).float().mean(1).tolist()
    k1_flop = k1_ops(model, slot_active)
    k1_bound, k1_by = bound_ms(k1_bytes, k1_flop * B_MAIN)
    k1e_bytes = k1_bytes + dparams.shape[0] * 4 * B_MAIN
    slot_active_e = k1.contact_activity(
        model, dargs[1], dparams).float().mean(1).tolist()
    k1e_flop = k1_ops(model, slot_active_e)
    k1e_bound, k1e_by = bound_ms(k1e_bytes, k1e_flop * B_MAIN)
    k2_bytes = (model.nbody * 7 + model.nsite) * 4 * B_MAIN
    k2_bound, k2_by = bound_ms(
        k2_bytes, model.nsite * (72 + 27 * nbox) * B_MAIN)
    na = float(active.float().mean())
    k3_env_bytes = k3_bytes(model.nv, sys_args[2].shape[0],
                            sys_args[8].shape[0], na)
    jg = (sys_args[2][:, :, 0] != 0).sum(1).tolist()
    k3_flop = k3_ops(model.nv, jg, na, cenv.model.solver_iterations,
                     cenv.model.ls_iterations, True)
    k3_bound, k3_by = bound_ms(k3_env_bytes * B_MAIN, k3_flop * B_MAIN,
                               PEAK_F64)
    # the plain physics step moves qpos, qvel, ctrl and the warm start in
    # and qpos, qvel, the frames and qacc out (K1e: and its parameters);
    # K2 with a per-env floor reads 4 B more per env
    k1p_bytes = (2 * model.nq + 4 * model.nv + model.nu
                 + model.nbody * 7) * 4 * B_MAIN
    slot_active_p = k1.contact_activity(model, pargs[1]).float().mean(
        1).tolist()
    k1p_flop = k1_ops(model, slot_active_p, fresh=False, env=False)
    k1p_bound, k1p_by = bound_ms(k1p_bytes, k1p_flop * B_MAIN)
    k1pe_bytes = k1p_bytes + pdparams.shape[0] * 4 * B_MAIN
    slot_active_pe = k1.contact_activity(
        model, pdargs[1], pdparams).float().mean(1).tolist()
    k1pe_flop = k1_ops(model, slot_active_pe, fresh=False, env=False)
    k1pe_bound, k1pe_by = bound_ms(k1pe_bytes, k1pe_flop * B_MAIN)
    k2f_bound, k2f_by = bound_ms(
        k2_bytes + 4 * B_MAIN, model.nsite * (72 + 27 * nbox) * B_MAIN)
    print(f"K1 <0,0,0>: {k1p_ms:.4f} ms per call, {k1p_dev_ms:.4f} ms on "
          f"the device (plain {k1p_plain_ms:.2f} ms, bound {k1p_bound:.5f} "
          f"ms by {k1p_by}: {k1p_flop:.0f} operations per env with "
          f"{sum(slot_active_p):.2f} active contact rows per env); K1e "
          f"<0,0,0,dr>: {k1pe_ms:.4f} ms per call, {k1pe_dev_ms:.4f} ms on "
          f"the device (plain {k1pe_plain_ms:.2f} ms, bound "
          f"{k1pe_bound:.5f} ms by {k1pe_by}: {k1pe_flop:.0f} operations "
          f"per env with {sum(slot_active_pe):.2f} active contact rows per "
          f"env); K2 with a per-env floor: {k2f_ms:.4f} ms per call, "
          f"{k2f_dev_ms:.4f} ms on the device (plain {k2f_plain_ms:.2f} ms, "
          f"bound {k2f_bound:.5f} ms by {k2f_by}) at B={B_MAIN} ({card})")
    print(f"K1: {k1_ms:.4f} ms per call, {k1_dev_ms:.4f} ms on the device "
          f"(plain {k1_plain_ms:.2f} ms, bound "
          f"{k1_bound:.5f} ms by {k1_by}: {k1_flop:.0f} operations per env"
          f" with {sum(slot_active):.2f} active contact rows per env); K2: "
          f"{k2_ms:.4f} ms per call, {k2_dev_ms:.4f} ms on the device "
          f"(plain {k2_plain_ms:.2f} ms, bound "
          f"{k2_bound:.5f} ms by {k2_by}) at B={B_MAIN} ({card})")
    print(f"K1e: {k1e_ms:.4f} ms per call, {k1e_dev_ms:.4f} ms on the "
          f"device (plain {k1e_plain_ms:.2f} ms, bound "
          f"{k1e_bound:.5f} ms by {k1e_by}: {k1e_bytes / B_MAIN:.0f} B and "
          f"{k1e_flop:.0f} operations per env with {sum(slot_active_e):.2f}"
          f" active contact rows per env); K3: {k3_ms:.4f} ms per call, "
          f"{k3_dev_ms:.4f} ms on the device (plain "
          f"{k3_plain_ms:.2f} ms, bound {k3_bound:.5f} ms by {k3_by}: "
          f"{k3_env_bytes:.0f} B and {k3_flop:.0f} operations per env "
          f"with {na:.2f} of "
          f"{sys_args[8].shape[0]} contact rows in contact) at B={B_MAIN} "
          f"({card})")

    # -- phase 4b: the imported robot through K1 ---------------------------
    t0 = time.perf_counter()
    import_phase(card, dev, env, reset_states)
    print(f"import phase: {time.perf_counter() - t0:.1f} s")

    # -- phase 4c: the batch-last assembly feeding K3 in its layout -------
    t0 = time.perf_counter()
    bl = constraint_bl_phase(card, dev, cenv, cstates, logs)
    print(f"batch-last assembly phase: {time.perf_counter() - t0:.1f} s")

    # -- phase 5: the trainer ---------------------------------------------
    t0 = time.perf_counter()
    trainer_phase(card, dev)
    print(f"trainer phase: {time.perf_counter() - t0:.1f} s")

    # -- phase 5b: the reference-compat trainer ----------------------------
    compat_trainer_phase(card, dev)

    # -- phase 6: the solved recipe and the solved policies ----------------
    solved_phase(card, dev)

    # -- phase 7: SAC and TD3, and the committed off-policy policies -------
    offpolicy_phase(card, dev)

    # -- phase 8: the per-env step -----------------------------------------
    per_env_phase(card, dev, env)

    # -- phase 9: the interop and tooling layer ----------------------------
    tooling_phase(card, dev, step_ms)

    # -- phase 10: data parallelism over the env batch ---------------------
    parallel_phase(card, dev, B_MAIN / step_ms * 1e3)

    # -- phase 11: the JAX package's learning record -----------------------
    cap = capability_phase(card, dev)

    def entry(name, source, replaces, n, err, ms, dev_ms, plain, bound, by):
        return {"name": name, "route": "cuda",
                "source": f"mujoco_playground_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": None}

    step_src = "mujoco_playground_tpu/ops/step_pallas.py:955"
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        entry("K1 step (fused env + fresh scan)", "step_kernel.cu", step_src,
              launches["K1"], k1_err, k1_ms, k1_dev_ms, k1_plain_ms,
              k1_bound, k1_by),
        entry("K1e step with domain-randomized parameters",
              "step_kernel_dr.cu", step_src, launches_dr["K1e"], k1e_err,
              k1e_ms, k1e_dev_ms, k1e_plain_ms, k1e_bound, k1e_by),
        entry("K2 lidar", "lidar_kernel.cu",
              "mujoco_playground_tpu/ops/lidar_pallas.py:114", launches["K2"],
              k2_err, k2_ms, k2_dev_ms, k2_plain_ms, k2_bound, k2_by),
        entry("K3 Newton solve (staged step)", "newton_kernel.cu",
              "mujoco_playground_tpu/ops/newton_pallas.py:366",
              launches_st["K3"], k3_err, k3_ms, k3_dev_ms, k3_plain_ms,
              k3_bound, k3_by),
        entry("K3 Newton solve, kernel-layout input (batch-last assembly)",
              "newton_kernel.cu",
              "mujoco_playground_tpu/ops/newton_pallas.py:366",
              bl["launches"], bl["err"], bl["ms"], bl["dev_ms"],
              bl["plain_ms"], bl["bound"], bl["by"]),
        entry("K1 plain physics step <0,0,0> (path R)", "step_kernel.cu",
              step_src, paths["R"]["counts"]["K1"], k1p_err, k1p_ms,
              k1p_dev_ms, k1p_plain_ms, k1p_bound, k1p_by),
        entry("K1e plain physics step <0,0,0,dr> (path R under DR)",
              "step_kernel_dr.cu", step_src, paths["RD"]["counts"]["K1e"],
              k1pe_err, k1pe_ms, k1pe_dev_ms, k1pe_plain_ms, k1pe_bound,
              k1pe_by),
        entry("K2 lidar with a per-env floor (path C)", "lidar_kernel.cu",
              "mujoco_playground_tpu/ops/lidar_pallas.py:114",
              paths["C"]["counts"]["K2f"], k2f_err, k2f_ms, k2f_dev_ms,
              k2f_plain_ms, k2f_bound, k2f_by),
        entry("K1 plain physics step <0,0,0> at B=1 (1-env reference-compat "
              "recipe)", "step_kernel.cu", step_src, *cap["K1p1"]),
        entry("K2 lidar at B=1 (1-env reference-compat recipe)",
              "lidar_kernel.cu",
              "mujoco_playground_tpu/ops/lidar_pallas.py:114", *cap["K21"]),
        entry(f"K1 step <1,0,0> on medium-maze states (B={EVAL_EPISODES}, "
              "the medium evaluation)", "step_kernel.cu", step_src,
              *cap["K1m"]),
        entry(f"K2 lidar on medium-maze frames (B={EVAL_EPISODES})",
              "lidar_kernel.cu",
              "mujoco_playground_tpu/ops/lidar_pallas.py:114", *cap["K2m"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def expand_tree(tree, B):
    """A one-env dataclass tree of (1, ...) leaves repeated to B envs."""
    if isinstance(tree, torch.Tensor):
        return tree.expand((B,) + tree.shape[1:]).clone()
    return dataclasses.replace(tree, **{
        f.name: expand_tree(getattr(tree, f.name), B)
        for f in dataclasses.fields(tree)})


if __name__ == "__main__":
    main()
