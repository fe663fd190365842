"""The JAX package's learning record, reproduced by the port on the card:
the committed files against the JAX package's committed ones.

The rules (each is also checked on itself: the JAX curves pass against
themselves, and a curve held at its first log fails):

* PPO (``rl_logs/shuffle_ab_torch/blk128_s{0,1,2}``, the solved recipe at
  a constant learning rate, as the JAX A/B ran it, for 20,054,016 steps
  against ``rl_logs/shuffle_ab/``'s six runs): with S a
  run's mean of its last 3 logged ``mean_reward``s, the port's mean S lies
  within 3 x SD x sqrt(1/k + 1/6) of the six JAX runs' mean S (k the
  port's runs, SD the JAX runs' sample SD), and each port run's S exceeds
  its own first log by at least half the JAX runs' mean gain.
* SAC and TD3 (``rl_logs/offpolicy_torch/``, against
  ``rl_logs/offpolicy/{sac,td3}``): the mean of the last 20 logged
  ``mean_reward``s is at least the JAX run's minus 3 of its last 20 logs'
  sample SDs.  A TD3 run whose last-20 mean is at most -20 has collapsed
  (as the JAX package's seed 0 did); then the rule holds if one of the
  seeds 1, 0 and 2 meets it.
* The evaluations on the card, each within 3 binomial SDs (n=512) of the
  JAX figure: the medium policy (``rl_logs/solved_medium/EVAL_torch.json``
  against EVAL.json's 0.1777) and the scripted expert on umaze
  (``rl_logs/scripted_torch/EVAL_umaze.json`` against PARITY.md's 44.3%).
  The failure classes of the solved policy
  (``rl_logs/solved/FAILURE_MODES_torch.json``) against the JAX script's
  own on the same episodes on the CPU, within 3 SDs of a difference.
* The reference-compat runs (``rl_logs/reference_compat/*_torch.jsonl``):
  the open floor collapses with ``late_mean`` in [-52,000, -49,000]; the
  umaze run's summary is written.

Every file names the card and its power limit.
"""
import json
import math
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = os.path.join(ROOT, "rl_logs")
JAX_PPO = [os.path.join(LOGS, "shuffle_ab", f"blk{b}_s{s}", "ppo",
                        "metrics.jsonl") for b in (1, 128) for s in (0, 1, 2)]
PORT_PPO = [os.path.join(LOGS, "shuffle_ab_torch", f"blk128_s{s}", "ppo",
                         "metrics.jsonl") for s in (0, 1, 2)]
COLLAPSED = -20.0
CARD = "H100"


def rewards(path):
    with open(path) as f:
        return [json.loads(x)["mean_reward"] for x in f if "mean_reward" in x]


def ppo_rule(port, jax):
    """The PPO rule on lists of curves (each a list of mean rewards):
    (passes, the port's mean S, the bound, the gains, the least gain)."""
    s_jax = [np.mean(c[-3:]) for c in jax]
    mean, sd = np.mean(s_jax), np.std(s_jax, ddof=1)
    s_port = [np.mean(c[-3:]) for c in port]
    half = 3 * sd * math.sqrt(1 / len(port) + 1 / len(jax))
    gains = [s - c[0] for s, c in zip(s_port, port)]
    least = 0.5 * np.mean([s - c[0] for s, c in zip(s_jax, jax)])
    ok = abs(np.mean(s_port) - mean) <= half and min(gains) >= least
    return ok, float(np.mean(s_port)), (mean - half, mean + half), gains, least


def offpolicy_rule(port, jax):
    """The off-policy rule: (passes, the port's last-20 mean, the bound)."""
    bound = np.mean(jax[-20:]) - 3 * np.std(jax[-20:], ddof=1)
    return float(np.mean(port[-20:])) >= bound, float(np.mean(port[-20:])), \
        float(bound)


def test_ppo_rule_checks_itself():
    jax = [rewards(p) for p in JAX_PPO]
    assert [len(c) for c in jax] == [22] * 6
    ok, mean, (lo, hi), gains, least = ppo_rule(jax, jax)
    assert ok and abs(mean - (-0.3039)) < 1e-4
    assert abs(least - 0.035) < 1e-3
    # the bound of the issue for three port seeds
    _, _, (lo3, hi3), _, _ = ppo_rule(jax[:3], jax)
    assert abs(lo3 - (-0.337)) < 1e-3 and abs(hi3 - (-0.270)) < 1e-3
    flat = [[c[0]] * len(c) for c in jax[3:]]
    assert not ppo_rule(flat, jax)[0]


def test_port_ppo_curves_learn_as_the_jax_runs_do():
    jax = [rewards(p) for p in JAX_PPO]
    port = [rewards(p) for p in PORT_PPO]
    assert [len(c) for c in port] == [22] * 3      # JAX's log cadence
    with open(PORT_PPO[0]) as f:
        last = [json.loads(x) for x in f][-1]
    assert last["step"] == 20054016
    ok, mean, bound, gains, least = ppo_rule(port, jax)
    assert ok, (mean, bound, gains, least)


def test_port_ppo_runs_with_readmes_annealing_learn():
    """README's solved command anneals the learning rate to zero over the
    run; the JAX A/B's curves do not (their approx_kl grows to the last
    log).  The annealed port runs are kept beside: each learns by the
    rule's least gain, and their KL falls to ~0 at the end."""
    jax = [rewards(p) for p in JAX_PPO]
    paths = [p.replace("blk128_s", "blk128_anneal_s") for p in PORT_PPO]
    port = [rewards(p) for p in paths]
    _, _, _, gains, least = ppo_rule(port, jax)
    assert min(gains) >= least, (gains, least)
    for p in paths + JAX_PPO:
        with open(p) as f:
            kl = json.loads(f.readlines()[-1])["approx_kl"]
        assert (kl < 1e-3) == ("anneal" in p), (p, kl)


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_offpolicy_rule_checks_itself(algo):
    jax = rewards(os.path.join(LOGS, "offpolicy", algo, "metrics.jsonl"))
    assert len(jax) == 202
    assert offpolicy_rule(jax, jax)[0]
    assert not offpolicy_rule([jax[0]] * len(jax), jax)[0]
    want = {"sac": -2.49, "td3": -0.884}[algo]
    assert abs(offpolicy_rule(jax, jax)[2] - want) < 5e-3


@pytest.mark.parametrize("algo", ["sac", "td3"])
def test_port_offpolicy_curves_learn_as_the_jax_runs_do(algo):
    jax = rewards(os.path.join(LOGS, "offpolicy", algo, "metrics.jsonl"))
    runs = [algo] + (["td3_s0", "td3_s2"] if algo == "td3" else [])
    results = {}
    for run in runs:
        path = os.path.join(LOGS, "offpolicy_torch", run, "metrics.jsonl")
        if run != algo and not os.path.exists(path):
            continue
        port = rewards(path)
        assert len(port) == len(jax) == 202
        results[run] = offpolicy_rule(port, jax)
    first = results[algo]
    if algo == "td3" and first[1] <= COLLAPSED:
        assert len(results) == 3, "a collapsed seed 1 needs seeds 0 and 2"
        assert any(r[0] for r in results.values()), results
    else:
        assert first[0], first
    with open(os.path.join(LOGS, "offpolicy_torch", "EVAL.json")) as f:
        ev = json.load(f)
    assert CARD in ev["card"]
    for run in results:
        assert ev[run]["timesteps"] >= 20_000_000
        assert 0.0 <= ev[run]["success_rate"] <= 1.0
        assert ev[run]["train_reward_per_step"]["last_20_logs"] == (
            pytest.approx(results[run][1]))


def test_every_port_curve_names_the_card():
    paths = (PORT_PPO
             + [p.replace("blk128_s", "blk128_anneal_s") for p in PORT_PPO]
             + [os.path.join(LOGS, "offpolicy_torch", run, "metrics.jsonl")
                for run in ("sac", "td3", "td3_s0", "td3_s2")])
    for p in paths:
        with open(p) as f:
            lines = [json.loads(x) for x in f]
        assert lines and all(CARD in x["card"] and "steps_per_second" in x
                             for x in lines), p


def within_3sd(rate, ref, n=512):
    return abs(rate - ref) <= 3 * math.sqrt(ref * (1 - ref) / n)


def test_medium_policy_scores_as_the_jax_package():
    with open(os.path.join(LOGS, "solved_medium", "EVAL_torch.json")) as f:
        ev = json.load(f)
    with open(os.path.join(LOGS, "solved_medium", "EVAL.json")) as f:
        ref = json.load(f)["eval"]["success_rate"]
    assert CARD in ev["card"]
    assert ev["env"]["max_episode_steps"] == 12000
    rate = ev["eval"]["jax"]["success_rate"]
    assert 0.127 <= rate <= 0.228 and within_3sd(rate, ref)


@pytest.mark.parametrize("arena,ref", [("umaze", 0.443),
                                       ("umaze_heading", 0.455),
                                       ("medium", 0.254)])
def test_scripted_expert_on_the_jax_episodes(arena, ref):
    with open(os.path.join(LOGS, "scripted_torch",
                           f"EVAL_{arena}.json")) as f:
        ev = json.load(f)
    assert CARD in ev["card"] and ev["arena"] == arena
    assert ev["eval"]["jax_success_rate"] == ref
    assert ev["flags"]["max_episode_steps"] == (12000 if arena == "medium"
                                                else 6000)
    # the bound is PARITY.md's umaze figure's; the other two are reported
    # beside JAX's with the same bound stated
    if arena == "umaze":
        assert within_3sd(ev["eval"]["success_rate"], ref)


def test_failure_modes_of_the_solved_policy():
    """The port's classes against the JAX script's own on the same 512
    episodes on the CPU (``FAILURE_MODES_jax_cpu.json``): within 3 SDs of
    the difference of two binomials.  PARITY.md's success (74%) and
    out-of-budget (under 1%) figures hold too; its 3% stuck does not, for
    the port nor for the JAX script itself (9.0% and 10.5%: a figure the
    committed checkpoint does not reproduce on the CPU), and the port's
    16.0% lost sits 0.5 points under the 3-SD bound of PARITY.md's 22%
    (the JAX script's 18.75% inside it, 1.15 SDs of a difference from the
    port's)."""
    with open(os.path.join(LOGS, "solved", "FAILURE_MODES_torch.json")) as f:
        fm = json.load(f)
    with open(os.path.join(LOGS, "solved",
                           "FAILURE_MODES_jax_cpu.json")) as f:
        jx = json.load(f)
    assert CARD in fm["card"] and fm["episodes"] == jx["episodes"] == 512
    n = fm["episodes"]
    classes = ("success", "stuck", "timeout_progress", "lost")
    for f_ in (fm, jx):
        assert sum(f_[c] for c in classes) == n
    for cls in classes:
        p = (fm[cls] + jx[cls]) / (2 * n)
        sd = math.sqrt(2 * p * (1 - p) / n)
        assert abs(fm[cls] - jx[cls]) / n <= 3 * sd, (cls, fm[cls], jx[cls])
    assert within_3sd(fm["success"] / n, 0.74)
    assert fm["timeout_progress"] / n <= 0.01 + 3 * math.sqrt(
        0.01 * 0.99 / n)
    for f_ in (fm, jx):
        assert not within_3sd(f_["stuck"] / n, 0.03)


@pytest.mark.parametrize("name", ["episodes_torch.jsonl",
                                  "episodes_umaze_torch.jsonl"])
def test_reference_compat_runs(name):
    with open(os.path.join(LOGS, "reference_compat", name)) as f:
        lines = [json.loads(x) for x in f]
    head, tail = lines[0], lines[-1]
    assert head["flags"]["num_envs"] == 1 and CARD in head["port"]["card"]
    assert head["port"]["total_steps"] == 65536
    eps = [x for x in lines if "episode_return" in x]
    assert eps[-1]["global_step"] <= 65536 and len(eps) >= 60
    summary = tail["summary"]
    assert set(summary) >= {"at_10000", "at_20000", "at_30000",
                            "late_mean", "collapsed"}
    if name == "episodes_torch.jsonl":
        assert summary["collapsed"] is True
        assert -52_000 <= summary["late_mean"] <= -49_000
