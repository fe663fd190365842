"""A whole run of the harness on the CPU at 8 envs (the look for a card
skipped; the port takes its plain twins there): ``correct`` holds for
the program as it is, and comes out false with the timed path broken
underneath, once for each fault a cell can have.  The control (the
reference in bfloat16 put in the program's place) fails the limits at
this size too, as on the card at the cells' own size."""
import dataclasses

import pytest
import torch

from bench_port import control, manifest, program, run


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    return dataclasses.replace(t, **{
        f.name: _tree_map(fn, *(getattr(x, f.name) for x in trees))
        for f in dataclasses.fields(t)})


def _broken(step, fault):
    """The program's step with a fault underneath: ``unchanged`` returns
    its input state, ``half`` leaves the second half of the batch
    unstepped, ``altered`` moves one env's stepped x by 1 mm."""
    def wrapped(self, states, actions, fresh):
        if fault == "unchanged":
            return states
        new = step(self, states, actions, fresh)
        if fault == "half":
            h = states.steps.shape[0] // 2
            return _tree_map(lambda n, o: torch.cat([n[:h], o[h:]]), new,
                             states)
        qpos = new.physics.qpos.clone()
        qpos[0, 0] += 1e-3
        return new.replace(physics=new.physics.replace(qpos=qpos))
    return wrapped


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_faults_make_correct_false(fault, monkeypatch):
    if fault is not None:
        monkeypatch.setattr(program.Program, "step",
                            _broken(program.Program.step, fault))
    line, rows = run.run_cell("umaze_random_64k", 2**31 + 11, 0.4, False,
                              device="cpu", num_envs=8)
    assert line["correct"] is (fault is None)
    assert (line["failed"] == 0) is (fault is None)
    assert list(line)[-1] == "checks"
    for name, value, limit in rows:
        assert line["checks"][name] == {"value": value, "limit": limit}


def test_policy_cell_runs_correct():
    line, _ = run.run_cell("medium_policy_128k", 7, 0.4, False,
                           device="cpu", num_envs=8)
    assert line["correct"] and "action_gap" in line["checks"]
    assert set(line["metrics"]) == {"env_steps_per_s", "step_ms_p95",
                                    "setup_s"}


def test_control_fails_the_limits():
    cfg = manifest.config("umaze_flagship")
    rows = control.readings("umaze_random_64k", [5], [5], steps=4,
                            device="cpu", num_envs=8)
    prog = dict((k, r) for k, _, r in rows)
    assert all(v <= cfg["limits"][k] for k, v in prog["program"].items())
    assert any(v > cfg["limits"][k] for k, v in prog["control"].items())
    assert prog["control"]["reset_gap"] > cfg["limits"]["reset_gap"]
