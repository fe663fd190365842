"""The port's spans and counters (``utils/profiler.py``) on the CPU: one
env step of the umaze env with geodesic shaping and the goal compass, and
a small policy, at B=4 on the plain twins (no kernel is built; ``ops.k1``
marks K1's launch path, which runs only on the card).  K1's twin runs
once; later steps reuse its outputs, since the spans mark the glue around
it and the twin's thousands of small ops would make a profiled step take
seconds.

* off, the default: ``span`` hands out one shared null context, never
  calls into torch's profiler and allocates nothing;
* memory mode: recording a span allocates nothing; the step's spans nest as the env's stages nest, with one
  step id, the next step's spans carry the next id, and a full buffer
  drops spans without losing the tree above them;
* profiler mode: a ``torch.profiler`` Chrome trace holds the same spans,
  nested the same way;
* ``counters`` names every counter of the port;
* ``trace_context`` turns the spans on for its block only.
"""
import json
import sys

import pytest
import torch

from mujoco_playground_tpu_torch.envs.make_env import make_ackermann_env
from mujoco_playground_tpu_torch.ops import step as k1
from mujoco_playground_tpu_torch.rl import ppo
from mujoco_playground_tpu_torch.rl.evaluate import deterministic_policy
from mujoco_playground_tpu_torch.rl.networks import ActorCritic
from mujoco_playground_tpu_torch.utils import profiler

B = 4
# span -> its parent in one policy step and one env step on the CPU
TREE = {"rl.policy": None, "rl.normalize_obs": "rl.policy",
        "rl.actor": "rl.policy", "rl.critic": "rl.policy",
        "envs.maze_core": None, "envs.step_autoreset_batch": None,
        "envs.step_batch": "envs.step_autoreset_batch",
        "envs.outcome": "envs.step_batch",
        "envs.merge": "envs.step_autoreset_batch",
        "envs.fresh_obs": "envs.step_autoreset_batch"}
# the packed geodesic lookups: the shaping's two and the compass's one
# after the step, the compass's one for the fresh observation
GEODESIC = {"envs.outcome": 2, "envs.fresh_obs": 1}


@pytest.fixture(scope="module")
def step():
    """One lockstep step as the benchmark's loop makes it: the policy's
    action, the fresh spawns (``maze_core``), the auto-reset step."""
    torch.set_num_threads(1)
    env = make_ackermann_env("maze", "umaze", device="cpu",
                             geodesic_reward_scale=10.0, goal_compass=True)
    g = torch.Generator().manual_seed(0)
    states = env.reset(B, generator=g)
    core = env.reset_core(B, g)
    net = ActorCritic(env.obs_size, env.action_size, hidden=(8, 8),
                      generator=torch.Generator().manual_seed(1))
    n = env.obs_size
    norm = ppo.NormState(obs_mean=torch.zeros(n), obs_var=torch.ones(n),
                         ret_mean=torch.zeros(()), ret_var=torch.ones(()),
                         count=torch.ones(()), env_returns=torch.zeros(B))
    policy = deterministic_policy(net, norm)
    start = core.physics.xpos[:, 1, :2]

    def one():
        with torch.no_grad():
            actions = policy(states.obs)
            fresh = env.maze_core(start, start + core.goal, core.goal_cell)
            return env.step_autoreset_batch(states, actions, fresh=fresh)

    twin, outputs = k1.step_plain, []

    def once(*args, **kw):
        if not outputs:
            outputs.extend(twin(*args, **kw))
        return tuple(t.clone() for t in outputs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k1, "step_plain", once)
        one()
        yield one


def _tree(rows):
    """{name: parent name} and {parent: count of geodesic lookups} from
    (name, parent index) rows."""
    tree, geo = {}, {}
    for name, parent in rows:
        up = rows[parent][0] if parent >= 0 else None
        if name == "envs.geodesic":
            geo[up] = geo.get(up, 0) + 1
        else:
            assert tree.setdefault(name, up) == up, name
    return tree, geo


def test_off_records_nothing_and_makes_no_span(step, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span called into torch's profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    null = profiler.span("envs.step_batch")
    assert profiler.span("rl.actor") is null
    step()
    assert _blocks_per_span() == 0


def _blocks_per_span(n=1000):
    """Memory blocks left allocated by ``n`` spans of one name."""
    with profiler.span("envs.merge"):
        pass
    before = sys.getallocatedblocks()
    for _ in range(n):
        with profiler.span("envs.merge"):
            pass
    return (sys.getallocatedblocks() - before) // n


def test_memory_mode_makes_no_object_per_span():
    rec = profiler.Recorder(1001)
    with profiler.tracing(rec):
        assert _blocks_per_span() == 0
    assert rec.n == 1001 and rec.names == ["envs.merge"]


def test_memory_mode_nests_the_step(step):
    rec = profiler.Recorder(64)
    with profiler.tracing(rec):
        step()
        step()
    assert profiler.span("envs.step_batch") is profiler.span("rl.policy")
    records = rec.records()
    assert rec.step == 2 and rec.dropped == 0 and rec.open == -1
    half = len(records) // 2
    assert [r[2] for r in records] == [0] * half + [1] * half
    tree, geo = _tree([(n, p) for n, p, *_ in records[:half]])
    assert tree == TREE and geo == GEODESIC
    assert "ops.k1" not in tree         # K1 launches only on the card
    for n, p, _, a, b in records:
        assert 0 < a <= b
        if p >= 0:
            assert records[p][3] <= a and b <= records[p][4]


def test_memory_mode_drops_what_does_not_fit(step):
    rec = profiler.Recorder(3)
    with profiler.tracing(rec):
        step()
    names = [r[0] for r in rec.records()]
    assert names == ["rl.policy", "rl.normalize_obs", "rl.actor"]
    assert rec.dropped == len(TREE) + sum(GEODESIC.values()) - 3
    assert rec.step == 1 and rec.lost_depth == 0 and rec.open == -1
    assert all(r[4] >= r[3] > 0 for r in rec.records())


def _trace_spans(path):
    """(name, parent index) of the port's spans in a Chrome trace, parents
    found by nesting on the trace's clock."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(((float(e["ts"]), -float(e["dur"]), e["name"])
                    for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(("envs.", "rl.", "ops."))))
    rows, open_ = [], []
    for a, neg, name in spans:
        while open_ and spans[open_[-1]][0] - spans[open_[-1]][1] < a - neg:
            open_.pop()
        rows.append((name, open_[-1] if open_ else -1))
        open_.append(len(rows) - 1)
    return rows


def test_profiler_mode_gives_the_same_tree(step, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.tracing(profiler.PROFILER):
            step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert _tree(_trace_spans(path)) == (TREE, GEODESIC)


def test_counters_name_every_counter():
    from mujoco_playground_tpu_torch.ops import build
    c = profiler.counters()
    variants = {f"k1.by_variant.<{','.join(str(int(f)) for f in key)}>"
                for key in k1.K1_VARIANTS}
    assert set(c) == {"k1.launches", "k1e.launches", "k2.launches",
                      "k2.launches_floor", "k3.launches",
                      "k3.launches_kernel_layout", "build.loads",
                      "build.compiles", "build.uploads"} | variants
    assert all(isinstance(v, int) and v >= 0 for v in c.values())
    before = build.load.loads
    build.load.loads += 1
    try:
        assert profiler.counters()["build.loads"] == before + 1
    finally:
        build.load.loads = before


def test_trace_context_turns_the_spans_on_for_its_block(tmp_path):
    with profiler.trace_context(str(tmp_path)):
        inside = profiler.span("envs.merge")
        with inside:
            torch.ones(3).sum()
    assert isinstance(inside, torch.profiler.record_function)
    assert profiler.span("envs.merge") is profiler.span("envs.fresh_obs")
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "envs.merge" in names
