"""The port's capability scripts against their JAX counterparts, on the CPU.

* ``scripts/torch_scripted_ceiling.py::scripted_policy`` against
  ``scripts/dev_scripted_ceiling.py::scripted_policy`` on 256 seeded
  79-wide observations: no-hit beams (-1), walls within the repulsion and
  clearance distances, goals in both hemispheres and under 0.3 m; within
  1e-6.
* ``scripts/torch_failure_modes.py::classify`` on seeded per-episode
  arrays, with values on each threshold, against the counts of
  ``dev_failure_modes.py``'s four rules written out here; ``summarize``'s
  counts and its start x goal ``pair_success`` matrix.
* ``scripts/torch_reference_compat_run.py::compat_summary`` on the episode
  lines of the JAX package's committed ``episodes.jsonl`` and
  ``episodes_umaze.jsonl``: their committed ``summary`` lines within 1e-9.
* ``torch_reference_compat_run.py --device cpu`` at 32 steps (one
  iteration of T=32, one env) writes a well-formed file to a temporary
  directory.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPAT = os.path.join(ROOT, "rl_logs", "reference_compat")


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scripted_obs(n=256, seed=0):
    """Observations that reach every branch of the scripted policy."""
    rng = np.random.default_rng(seed)
    obs = np.zeros((n, 79), np.float32)
    lidar = rng.uniform(0.05, 3.0, (n, 72))
    lidar[rng.uniform(size=(n, 72)) < 0.3] = -1.0          # no hit
    near = rng.uniform(size=n) < 0.3                        # walls close by
    lidar[near, rng.integers(0, 72, near.sum())] = rng.uniform(
        0.05, 0.25, near.sum())
    lidar[:4] = -1.0                                        # all beams miss
    obs[:, :72] = lidar
    obs[:, 72:77] = rng.normal(size=(n, 5))
    obs[:, 77] = rng.uniform(0.0, 2.0, n)                   # dist
    obs[:, 78] = rng.uniform(-np.pi, np.pi, n)              # both hemispheres
    obs[4:8, 78] = [np.pi / 2, -np.pi / 2, 0.0, np.pi]
    return obs


def test_scripted_policy_matches_jax():
    import jax.numpy as jnp
    jax_policy = load_script("dev_scripted_ceiling").scripted_policy(None)
    port = load_script("torch_scripted_ceiling")
    obs = scripted_obs()
    want = np.asarray(jax_policy(jnp.asarray(obs)))
    got = port.scripted_policy(torch.from_numpy(obs)).numpy()
    assert got.dtype == np.float32 and got.shape == (256, 2)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # every branch was taken: reverse, repulsion, slow near walls / goals
    assert (got[:, 0] < 0).any() and (got[:, 0] > 0).any()
    assert (np.abs(got[:, 1]) == 1.0).any()
    assert np.isin(np.abs(got[:, 0]), np.float32([0.35, 0.45])).any()


def episode_arrays(n=512, seed=0):
    rng = np.random.default_rng(seed)
    length = rng.integers(1, 6000, n)
    ep = dict(succ=rng.uniform(size=n) < 0.6, length=length,
              coll=rng.integers(0, 50, n),
              slow=(rng.uniform(size=n) * length).astype(np.int64),
              min_lidar=rng.uniform(0.1, 1.0, n).astype(np.float32),
              goal_distance=rng.uniform(0, 5, n).astype(np.float32),
              phi0=rng.uniform(0.5, 8.0, n).astype(np.float32))
    ep["phi_n"] = (ep["phi0"] * rng.uniform(0, 1.2, n)).astype(np.float32)
    # values on each threshold: slow exactly 0.3 of the length, the lidar
    # at exactly 0.4 m, phi exactly half the spawn's
    ep["succ"][:12] = False
    ep["length"][:4], ep["slow"][:4] = 1000, 300
    ep["min_lidar"][:4] = 0.1
    ep["length"][4:8], ep["slow"][4:8] = 1000, 900
    ep["min_lidar"][4:8] = 0.4
    ep["phi_n"][:8] = ep["phi0"][:8]
    ep["phi0"][8:12], ep["phi_n"][8:12] = 2.0, 1.0
    ep["slow"][8:12], ep["length"][8:12] = 0, 100
    return ep


def test_failure_mode_classifier_matches_the_jax_rules():
    fm = load_script("torch_failure_modes")
    ep = episode_arrays()
    got = fm.classify(ep["succ"], ep["length"], ep["slow"], ep["min_lidar"],
                      ep["phi0"], ep["phi_n"])
    # dev_failure_modes.py:130-134, written out
    fail = ~ep["succ"]
    stuck = fail & (ep["slow"] > 0.3 * ep["length"]) & (ep["min_lidar"]
                                                         < 0.4)
    closer = ep["phi_n"] < 0.5 * ep["phi0"]
    want = dict(success=ep["succ"], stuck=stuck,
                timeout_progress=fail & ~stuck & closer,
                lost=fail & ~stuck & ~closer)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].sum() > 0, k
    # the edges: none of the first twelve is stuck or closer
    assert not got["stuck"][:12].any()
    assert got["lost"][:12].all()
    total = sum(int(v.sum()) for v in got.values())
    assert total == ep["succ"].shape[0]        # a partition
    cells = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0]])
    rng = np.random.default_rng(1)
    start, goal = rng.integers(0, 3, 512), rng.integers(0, 3, 512)
    out = fm.summarize(ep, cells, start, goal)
    assert {k: out[k] for k in want} == {k: int(v.sum())
                                         for k, v in want.items()}
    for i in range(3):
        for j in range(3):
            sel = (start == i) & (goal == j)
            assert out["pair_success"][i][j] == (
                f"{int(ep['succ'][sel].sum())}/{int(sel.sum())}")


@pytest.mark.parametrize("name", ["episodes.jsonl", "episodes_umaze.jsonl"])
def test_compat_summary_reproduces_the_jax_summary(name):
    compat = load_script("torch_reference_compat_run")
    with open(os.path.join(COMPAT, name)) as f:
        lines = [json.loads(line) for line in f]
    eps = [x for x in lines if "episode_return" in x]
    want = lines[-1]["summary"]
    got = compat.compat_summary([e["episode_return"] for e in eps],
                                [e["global_step"] for e in eps])
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, list):
            np.testing.assert_allclose(got[k][:2], v[:2], rtol=0, atol=1e-9)
            assert got[k][2] == v[2]
        elif isinstance(v, bool):
            assert got[k] is v
        else:
            assert abs(got[k] - v) <= 1e-9, k
    # the episode walk rebuilds the committed lines from their steps
    rewards, dones = [], []
    for e in eps:
        n = e["episode_length"]
        rewards += [e["episode_return"] / n] * n
        dones += [False] * (n - 1) + [True]
    rebuilt, ret, length, gs = compat.episodes_of(rewards, dones, 0.0, 0, 0)
    assert (ret, length, gs) == (0.0, 0, eps[-1]["global_step"])
    assert [r["global_step"] for r in rebuilt] == [e["global_step"]
                                                   for e in eps]
    np.testing.assert_allclose([r["episode_return"] for r in rebuilt],
                               [e["episode_return"] for e in eps],
                               rtol=1e-12)


def test_compat_run_writes_a_well_formed_file(tmp_path):
    compat = load_script("torch_reference_compat_run")
    path, summary = compat.main(["--device", "cpu", "--total-steps", "32",
                                 "--unroll-length", "32", "--out-dir",
                                 str(tmp_path)])
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) == "episodes_torch.jsonl"
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["flags"] == compat.HEADER["flags"]
    assert lines[0]["port"]["arena"] == "open floor"
    assert lines[0]["port"]["card"] == "cpu"
    assert lines[-1]["summary"] == summary
    assert set(summary) == {"late_mean", "collapsed"}   # no episode ended
    assert lines[1:-1] == []
    assert lines[-1]["seconds"] > 0
