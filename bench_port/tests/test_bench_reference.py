"""The plain reference against the port's CPU path (its plain twins) at 8
envs over a few steps, on both configurations: the reset, the physics
step, the lidar and observation, reward and flags, the auto-reset merge
of fresh spawns and, on the medium maze, the policy's action.  Each side
follows its own states, from the same draws."""
import pytest
import torch

from bench_port import check, manifest, program
from bench_port.reference import policy as ref_policy
from bench_port.reference.env import LEAVES, RefEnv
from bench_port.traffic import Traffic

STEPS = 6


@pytest.mark.parametrize("cell", ["umaze_random_64k", "medium_policy_128k"])
def test_reference_follows_the_port(cell):
    wl = manifest.workload(cell)
    cfg = manifest.config(wl["config"])
    spec = dict(manifest.traffic(wl["traffic"]), num_envs=8)
    prog = program.Program(cfg, "cpu")
    ref = RefEnv(cfg["env"], "cpu")
    tr = Traffic(spec, cfg["env"], ref.free_cells, ref.cell_size, 3, "cpu")
    draws = tr.spawns()
    # episode phases near the end, so that envs truncate and reset here
    phases = torch.full((8,), cfg["env"]["max_episode_steps"] - 3,
                        dtype=torch.int32)
    p = prog.reset(draws).replace(steps=phases)
    r = ref.reset(*draws)
    r["steps"] = phases
    net = None
    if cfg["policy"]:
        net = ref_policy.load_weights(manifest.policy_path(cfg), "cpu")
    resets = 0
    for _ in range(STEPS):
        pf = program.flat(p)
        for k in LEAVES:
            assert torch.equal(pf[k], r[k]), k
        if net is None:
            act = tr.actions(None)
            ref_act = act
        else:
            act = prog.act(p.obs)
            ref_act = ref_policy.action(*net, r["obs"])
            assert torch.equal(act, ref_act)
        d = tr.spawns()
        p = prog.step(p, act, prog.spawn(d))
        r = ref.step_autoreset(r, ref_act, ref.spawn(*d))
        resets += int(r["done"].sum())
    assert resets >= 8
    pf = program.flat(p)
    g = check.gaps(pf, r, [k for k in LEAVES
                           if k not in check.DISCRETE_LEAVES])
    assert float(g.max()) == 0.0 and not check.flags(pf, r).any()
