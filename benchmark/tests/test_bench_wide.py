"""The wide configuration (HalfCheetah iCEM at population 32,768, 512
elites) and its cell ``cheetah_wide.episodes``.

At this width the cell's replay cannot hold: a replayed plan step executes
the action that roundoff picks among near-equal costs, so ``check.py``'s
``replay_mismatch`` checks nothing there (PERF.md §2). The noise, the
rollouts of every row, the select and the refit are held here instead,
iteration by iteration from the program's own inputs, where roundoff cannot
compound: each CEM iteration's candidates against the reference's draws
from the same generator state and the same mean and std, every row's cost
against the reference's rollout of the same actions, the elites against a
stable sort of the program's own costs, and the refit against its formula
in float64. On the CPU the program runs its plain versions, so every number
but the refit's reads 0 at a cut structure; the card tests run the full
width."""

import pytest
import torch

from benchmark import check, harness, roofline
from benchmark.reference import halfcheetah, plan
from benchmark.tests.test_bench_correct import (_action_altered, _fails, _half_population,
                                                _run, _state_unchanged)
from benchmark.tests.test_bench_reference import _program_env

WIDE = "halfcheetah_running.i-cem-wide"

# the wide setting's structure on the CPU: pop // 64 elites, one of them
# kept, 256 / 204 / 163 rows
WIDE_TINY = {"controller_params.num_simulated_trajectories": 256,
             "controller_params.action_sampler_params.elites_size": 4,
             "controller_params.horizon": 4, "rollout_params.task_horizon": 6}

SEED = 2**31 + 77

# an iteration's candidates, refit and executed action against the
# reference: the same float32 operations on the same inputs, so only the
# order of a sum may differ
ACTION_TOL = 1e-5
# the share of an iteration's rows, in percent, whose cost may differ from
# the reference's by more than ``check.ELITE_COST_TOL``: over 30 steps a
# contact met within roundoff sends a sound row elsewhere now and then, a
# lower-precision rollout moves most rows (readings in PERF.md §2)
COST_MISMATCH_LIMIT = 1.0


def test_the_wide_setting_is_the_cells():
    cfg = harness.config(WIDE)
    cp = cfg["settings"]["controller_params"]
    assert cp["num_simulated_trajectories"] == 32768
    assert cp["action_sampler_params"]["elites_size"] == 512
    assert cfg["settings_file"] == "settings/halfcheetah_running/i-cem-wide.json"


def test_rollouts_and_bounds_of_the_wide_control_step():
    """80,106 trajectories of 30 steps and the real step; bound 0.678 ms."""
    cfg = harness.config(WIDE)
    shapes = [(32921, 30), (26214, 30), (20971, 30), (1, 1)]
    assert roofline.rollouts_per_control_step(cfg["settings"]["controller_params"]) == shapes
    assert roofline.control_step_ops(cfg) == 18894 * (80106 * 30 + 1)
    bound = sum(max(18894 * P * h / 67e12, 4 * (18 * P + 6 * P * h + 18 * h * P) / 3.35e12)
                for P, h in shapes)
    assert roofline.control_step_bound_s(cfg) == pytest.approx(bound)
    assert 1e3 * bound == pytest.approx(0.678, abs=5e-4)


def _planner(pop: int, elites_size: int, horizon: int):
    """(program config, reference config, program env, model, reference
    task) of the wide setting at ``pop`` rows and ``elites_size`` elites."""
    from icem_torch.controllers import icem
    from icem_torch.models.ground_truth import GroundTruthModel

    settings = harness.config(WIDE)["settings"]
    asp = dict(settings["controller_params"]["action_sampler_params"], elites_size=elites_size)
    cp = dict(settings["controller_params"], horizon=horizon, num_simulated_trajectories=pop,
              action_sampler_params=asp)
    cfg = icem.ICemConfig(horizon=horizon, num_simulated_trajectories=pop, action_dim=6,
                          action_low=(-1.0,) * 6, action_high=(1.0,) * 6, **asp)
    env = _program_env(WIDE)
    return (cfg, plan.Config(cp, 6, -1.0, 1.0), env, GroundTruthModel(env=env),
            halfcheetah.Task(settings["env_params"]))


def test_the_wide_plan_step_is_the_references_at_a_cut_structure():
    """Pop 1,024, pop // 64 = 16 elites, h 5, three plan steps: 4 kept
    elites and the decayed rows 1,024 / 819 / 655, to the bit."""
    from icem_torch.controllers import icem

    cfg, rcfg, env, model, task = _planner(1024, 16, 5)
    assert list(cfg.population_schedule) == rcfg.populations == [1024, 819, 655]
    assert cfg.elites_kept == rcfg.kept == 4
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


def _planned(cfg, env, model, pstate, state, monkeypatch):
    """One program plan step, recording each CEM iteration's refit: its
    inputs (mean, std, candidates, their costs) and outputs (mean, std,
    elites, their costs). Returns (result, records, generator state before)."""
    from icem_torch.controllers import icem

    records = []
    refit = icem._refit

    def recording(cfg_, mean, std, cand_actions, cand_costs, cand_last_obs):
        out = refit(cfg_, mean, std, cand_actions, cand_costs, cand_last_obs)
        records.append(dict(mean=mean, std=std, cand=cand_actions, costs=cand_costs,
                            new_mean=out[0], new_std=out[1], elites=out[2],
                            elite_costs=out[3]))
        return out

    gen_state = pstate.generator.get_state()
    with monkeypatch.context() as m:
        m.setattr(icem, "_refit", recording)
        res = icem.plan_step(cfg, model.predict_fn, env.cost_fn, pstate,
                             env.observation(state), state)
    return res, records, gen_state


def _costs(task, state, actions, chunk: int = 8192):
    """The reference's open-loop costs of action sequences [P, h, A] from one
    state, a chunk of rows at a time."""
    out = []
    for a in actions.split(chunk):
        out.append(plan.trajectory_costs(task, state[None].expand(a.shape[0], -1), a)[0])
    return torch.cat(out)


def _mismatch(program, reference) -> float:
    """Percent of rows whose costs differ by more than the check's tolerance;
    a row the program ranks last (inf) matches a non-finite reference cost."""
    p, r = program.double().cpu(), reference.double().cpu()
    gap = (p - r).abs() / (1.0 + r.abs())
    same = (gap <= check.ELITE_COST_TOL) | (torch.isinf(p) & ~torch.isfinite(r))
    return 100.0 * float((~same).double().mean())


def iteration_numbers(rcfg, task, state, before, gen_state, records, res,
                      costs: bool = True, control: bool = False) -> dict:
    """Each CEM iteration of one program plan step held to the reference
    from the program's own inputs (``_planned``): ``noise_gap`` (the fresh
    and shifted rows against the reference's draws from the same generator
    state, mean and std, the kept rows against the previous iteration's
    elites), ``masked_rows`` (rows the program ranks although they are
    invalid), ``cost_mismatch`` (the widest iteration's percent of rows whose
    cost differs from the reference's rollout of the same actions),
    ``select_mismatch`` (iterations whose elites are not the stable sort's
    prefix of the program's own costs), ``refit_gap`` (mean and std against
    their formula in float64, and the mean's shift) and ``action_gap``.
    ``control`` computes the costs in bfloat16 (``check.Lower``)."""
    g = torch.Generator(device=before.mean.device)
    g.set_state(gen_state)
    E, K, last = rcfg.kept, rcfg.num_elites, rcfg.iterations - 1
    prev_actions, prev_costs = before.elite_actions, before.elite_costs
    out = dict(noise_gap=0.0, masked_rows=0.0, cost_mismatch=0.0, select_mismatch=0.0,
               refit_gap=0.0)
    assert len(records) == rcfg.iterations
    for i, (n, rec) in enumerate(zip(rcfg.populations, records)):
        cand, ccost = rec["cand"], rec["costs"]
        want = plan._samples(rcfg, g, rec["mean"], rec["std"], n)
        if rcfg.use_mean and i == last:
            want[0] = rec["mean"]
        valid = torch.ones(n, dtype=torch.bool)
        if i == 0 and rcfg.shift and E > 0:
            tail = plan._samples(rcfg, g, rec["mean"], rec["std"], E)[:, -1:, :]
            want = torch.cat([want, torch.cat([prev_actions[:E, 1:], tail], dim=1)])
            valid = torch.cat([valid, torch.full((E,), bool(before.have_elites))])
        m = want.shape[0]
        gaps = [float((cand[:m] - want).abs().max())]
        if i > 0 and rcfg.keep and E > 0:
            gaps.append(float((cand[m:] - prev_actions[:E]).abs().max()))
            gaps.append(0.0 if torch.equal(ccost[m:], prev_costs[:E]) else float("inf"))
        out["noise_gap"] = max(out["noise_gap"], *gaps)
        sim_costs = ccost[:m].cpu()
        out["masked_rows"] += float(torch.isfinite(sim_costs[~valid]).sum())
        if costs:
            if control:
                with check.Lower():
                    ref = _costs(task, state, cand[:m])
            else:
                ref = _costs(task, state, cand[:m])
            out["cost_mismatch"] = max(out["cost_mismatch"],
                                       _mismatch(sim_costs[valid], ref.cpu()[valid]))
        host = torch.where(torch.isfinite(ccost), ccost, float("inf")).cpu()
        idx = torch.argsort(host, stable=True)[:K]
        if not (torch.equal(rec["elites"].cpu(), cand.cpu()[idx])
                and torch.equal(rec["elite_costs"].cpu(), host[idx])):
            out["select_mismatch"] += 1.0
        a = rec["elites"].double()
        mean = (1.0 - rcfg.alpha) * a.mean(dim=0) + rcfg.alpha * rec["mean"].double()
        std = (1.0 - rcfg.alpha) * a.std(dim=0, correction=0) + rcfg.alpha * rec["std"].double()
        out["refit_gap"] = max(out["refit_gap"], float((rec["new_mean"] - mean).abs().max()),
                               float((rec["new_std"] - std).abs().max()))
        prev_actions, prev_costs = rec["elites"], rec["elite_costs"]
    shifted = torch.cat([records[-1]["new_mean"][1:], records[-1]["new_mean"][-1:]])
    out["refit_gap"] = max(out["refit_gap"], float((res.state.mean - shifted).abs().max()))
    best = records[-1]["cand"][torch.argmin(records[-1]["costs"])]
    out["action_gap"] = float((res.action - best[0]).abs().max())
    return out


def _passes(numbers: dict) -> bool:
    return (numbers["noise_gap"] <= ACTION_TOL and numbers["masked_rows"] == 0
            and numbers["cost_mismatch"] <= COST_MISMATCH_LIMIT
            and numbers["select_mismatch"] == 0 and numbers["refit_gap"] <= ACTION_TOL
            and numbers["action_gap"] <= ACTION_TOL)


def _noise_recoloured(monkeypatch):
    """The sampler draws noise of another colour: beta one higher."""
    from icem_torch.controllers import icem

    sample = icem.sample_colored_action_noise

    def recoloured(generator, beta, *args, **kwargs):
        return sample(generator, beta + 1.0, *args, **kwargs)

    monkeypatch.setattr(icem, "sample_colored_action_noise", recoloured)


def _select_off_by_one(monkeypatch):
    """The select keeps the rows ranked 2nd to (K+1)th, not the best K."""
    from icem_torch.controllers import icem

    def shifted(costs, k: int):
        costs = torch.where(torch.isfinite(costs), costs, float("inf"))
        return torch.argsort(costs, stable=True)[1:k + 1]

    monkeypatch.setattr(icem, "top_k_ascending", shifted)


PLAN_FAULTS = [_noise_recoloured, _select_off_by_one, _half_population]


def _plan_steps(pop, elites_size, horizon, steps, device, monkeypatch, **kw):
    """The numbers of ``steps`` program plan steps at the wide setting's
    structure, from a fixed start, the first without elites."""
    from icem_torch.controllers import icem

    cfg, rcfg, env, model, task = _planner(pop, elites_size, horizon)
    state = env.init_state(torch.Generator(device=device).manual_seed(9))
    pstate = icem.init_state(cfg, env.obs_dim, torch.Generator(device=device).manual_seed(4))
    numbers = []
    for _ in range(steps):
        res, records, gen_state = _planned(cfg, env, model, pstate, state, monkeypatch)
        numbers.append(iteration_numbers(rcfg, task, state, pstate, gen_state, records, res,
                                         **kw))
        pstate, state = res.state, env.step(state, res.action)[0]
    return numbers


def test_each_iteration_is_the_references_at_a_cut_structure(monkeypatch):
    """Pop 1,024, 16 elites, h 5: over two plan steps (the shifted rows
    masked, then kept) every number reads 0 on the CPU but the refit's,
    which is float32 against float64; the bfloat16 costs do not pass."""
    sound = _plan_steps(1024, 16, 5, 2, "cpu", monkeypatch)
    assert all(_passes(n) for n in sound), sound
    assert all(v == 0.0 for n in sound for k, v in n.items() if k != "refit_gap"), sound
    control = _plan_steps(1024, 16, 5, 1, "cpu", monkeypatch, control=True)
    assert control[0]["cost_mismatch"] > COST_MISMATCH_LIMIT, control


@pytest.mark.parametrize("fault", PLAN_FAULTS)
def test_a_fault_in_an_iteration_is_seen_at_a_cut_structure(fault, monkeypatch):
    fault(monkeypatch)
    numbers = _plan_steps(1024, 16, 5, 2, "cpu", monkeypatch)
    assert not all(_passes(n) for n in numbers), numbers


@pytest.mark.parametrize("overrides", [WIDE_TINY], ids=["wide-tiny"])
def test_a_sound_wide_run_is_correct_and_its_control_is_not(overrides):
    r = _run("cheetah_wide.episodes", overrides=overrides, control=True)
    assert r["correct"] is True, r["checks"]
    assert all(v == 0.0 for v in r["_numbers"].values())
    assert _fails(r["_control"], "cheetah_wide.episodes")


@pytest.mark.parametrize("fault", [_state_unchanged, _half_population, _action_altered])
def test_a_fault_in_the_wide_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = _run("cheetah_wide.episodes", overrides=WIDE_TINY)
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
def test_each_iteration_at_the_full_width_is_the_references(cuda_device, monkeypatch):
    """32,921 / 26,214 / 20,971 rows, 512 elites, h 30 on the card, two plan
    steps: B1's throughput instantiation on every row, the select and the
    refit pass; the bfloat16 costs do not."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    sound = _plan_steps(32768, 512, 30, 2, cuda_device, monkeypatch)
    assert all(_passes(n) for n in sound), sound
    control = _plan_steps(32768, 512, 30, 1, cuda_device, monkeypatch, control=True)
    assert control[0]["cost_mismatch"] > COST_MISMATCH_LIMIT, control


@pytest.mark.cuda
@pytest.mark.parametrize("fault", PLAN_FAULTS)
def test_a_fault_in_an_iteration_is_seen_at_the_full_width(fault, cuda_device, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    fault(monkeypatch)
    costs = fault is _half_population
    numbers = _plan_steps(32768, 512, 30, 2, cuda_device, monkeypatch, costs=costs)
    assert not all(_passes(n) for n in numbers), numbers
