"""The frozen plain reference against the program's plain versions on the
CPU (to the bit), and the frozen operation counts against the
configuration files."""

import pytest
import torch

from benchmark import harness, roofline
from benchmark.reference import halfcheetah, humanoid_standup, plan, seeding


def _program_env(name):
    from icem_torch.envs import env_from_string

    cfg = harness.config(name)["settings"]
    return env_from_string(cfg["env"], **cfg.get("env_params", {}))


CASES = [("halfcheetah_running.i-cem-blitz", halfcheetah), ("humanoid_standup.i-cem-blitz",
                                                            humanoid_standup)]


@pytest.mark.parametrize("name,module", CASES)
def test_reference_task_is_the_program_env_to_the_bit(name, module):
    env = _program_env(name)
    task = module.Task(harness.config(name)["settings"].get("env_params", {}))
    s_prog = env.init_state(torch.Generator().manual_seed(5))
    s_ref = task.init_state(torch.Generator().manual_seed(5))
    assert torch.equal(s_prog, s_ref)
    g = torch.Generator().manual_seed(6)
    P = 4
    states = s_prog[None].expand(P, -1) + 0.05 * torch.randn(P, s_prog.shape[0], generator=g)
    actions = torch.rand(P, task.action_dim, generator=g) * 2.4 - 1.2
    new_p, obs_p, rew_p, _ = env.step_batched(states, actions)
    new_r, obs_r, rew_r = plan.step(task, states, actions)
    assert torch.equal(new_p, new_r) and torch.equal(obs_p, obs_r) and torch.equal(rew_p, rew_r)
    seqs = torch.rand(P, 3, task.action_dim, generator=g) * 2 - 1
    traj = env.rollout_batched(states, seqs)
    cost_p = torch.sum(env.cost_fn(traj[0], traj[2], traj[1]), dim=0)
    cost_r, last_r = plan.trajectory_costs(task, states, seqs)
    assert torch.equal(cost_p, cost_r) and torch.equal(traj[1][-1], last_r)


@pytest.mark.parametrize("name,module", CASES)
def test_frozen_operation_count_is_the_configuration_files(name, module):
    cfg = harness.config(name)
    task = module.Task(cfg["settings"].get("env_params", {}))
    count = roofline.plain_ops_per_trajectory_step(task.engine, task.model)
    assert count == cfg["kernel"]["ops_per_trajectory_step"]
    assert (task.model.ndof, len(task.model.actuator_dof)) == (cfg["kernel"]["ndof"],
                                                               cfg["kernel"]["nact"])


def test_stream_seeds_are_the_programs():
    from icem_torch.runtime.seeding import Seeding

    for root in (0, 7, 2**31 + 5, 3_000_000_019):
        Seeding.set_seed(root)
        for name in ("rollout/train/0/1/0/env", "rollout/train/0/12"):
            assert seeding.stream_seed(root, name) == Seeding.stream_seed(name)


def test_colored_noise_and_plan_step_are_the_programs():
    from icem_torch.controllers import icem
    from icem_torch.ops.colored_noise import sample_colored_action_noise

    for beta, h in ((0.25, 30), (2.0, 7)):
        a = sample_colored_action_noise(torch.Generator().manual_seed(3), beta, 5, h, 6)
        b = plan.colored_noise(torch.Generator().manual_seed(3), beta, 5, h, 6)
        assert torch.equal(a, b)

    name = "halfcheetah_running.i-cem-blitz"
    env = _program_env(name)
    cp = dict(harness.config(name)["settings"]["controller_params"], horizon=5,
              num_simulated_trajectories=12)
    task = halfcheetah.Task(harness.config(name)["settings"]["env_params"])
    cfg = icem.ICemConfig(horizon=5, num_simulated_trajectories=12, action_dim=6,
                          action_low=(-1.0,) * 6, action_high=(1.0,) * 6,
                          **cp["action_sampler_params"])
    rcfg = plan.Config(cp, 6, -1.0, 1.0)
    from icem_torch.models.ground_truth import GroundTruthModel

    model = GroundTruthModel(env=env)
    state = env.init_state(torch.Generator().manual_seed(9))
    pstate = icem.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(4))
    for _ in range(3):
        before = pstate
        gen_state = before.generator.get_state()
        res = icem.plan_step(cfg, model.predict_fn, env.cost_fn, before, env.observation(state),
                             state)
        g = torch.Generator()
        g.set_state(gen_state)
        a, elites, costs, _ = plan.plan_steps(
            rcfg, task, [g], state[None], before.mean[None], before.std[None],
            before.elite_actions[None], before.elite_costs[None], [before.have_elites])
        assert torch.equal(a[0], res.action)
        assert torch.equal(elites[0], res.state.elite_actions)
        assert torch.equal(costs[0], res.state.elite_costs)
        pstate = res.state
        state = env.step(state, res.action)[0]


def test_scanned_plan_step_is_the_programs():
    """The reference's scanned loop against the program's ``_plan_step_scan``
    on the 23-dof HumanoidStandup: the same noise order, the decayed rows
    masked (16 / 12 / 9 of 16 valid), the tail of shifted and kept elites."""
    from icem_torch.controllers import icem
    from icem_torch.models.ground_truth import GroundTruthModel

    name = "humanoid_standup.i-cem-blitz"
    settings = harness.config(name)["settings"]
    env = _program_env(name)
    asp = dict(settings["controller_params"]["action_sampler_params"], elites_size=4)
    cp = dict(settings["controller_params"], horizon=2, num_simulated_trajectories=16,
              action_sampler_params=asp)
    task = humanoid_standup.Task(settings["env_params"])
    cfg = icem.ICemConfig(horizon=2, num_simulated_trajectories=16, action_dim=17,
                          action_low=(-1.0,) * 17, action_high=(1.0,) * 17, cem_loop="scan",
                          **asp)
    rcfg = plan.Config(cp, 17, -1.0, 1.0, loop="scan")
    assert rcfg.populations == [16, 12, 9] and rcfg.kept == 1
    model = GroundTruthModel(env=env)
    state = env.init_state(torch.Generator().manual_seed(9))
    pstate = icem.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(4))
    for _ in range(2):
        before = pstate
        gen_state = before.generator.get_state()
        res = icem.plan_step(cfg, model.predict_fn, env.cost_fn, before, env.observation(state),
                             state)
        g = torch.Generator()
        g.set_state(gen_state)
        a, elites, costs, extra = plan.plan_steps(
            rcfg, task, [g], state[None], before.mean[None], before.std[None],
            before.elite_actions[None], before.elite_costs[None], [before.have_elites],
            extra=res.state.elite_actions[None])
        assert torch.equal(a[0], res.action)
        assert torch.equal(elites[0], res.state.elite_actions)
        assert torch.equal(costs[0], res.state.elite_costs)
        assert torch.equal(g.get_state(), res.state.generator.get_state())
        # the program's elites rolled out beside the first iteration
        assert torch.equal(extra[0], res.state.elite_costs)
        pstate = res.state
        state = env.step(state, res.action)[0]


def test_the_unrolled_order_is_not_the_scanned_one():
    """Replayed in the other loop's order, a scanned step draws other noise."""
    cp = dict(harness.config("humanoid_standup.i-cem-blitz")["settings"]["controller_params"])
    scan = plan.Config(cp, 17, -1.0, 1.0, loop="scan")
    unrolled = plan.Config(cp, 17, -1.0, 1.0)
    assert [scan.draws(i) for i in range(3)] == [(40, 3), (40, 3), (40, 3)]
    assert [unrolled.draws(i) for i in range(3)] == [(40, 3), (32, 0), (25, 0)]
    assert scan.populations == unrolled.populations == [40, 32, 25]
