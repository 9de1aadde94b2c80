"""icem_torch's EnsembleModel against the JAX package's, on the CPU.

The weights go from the JAX model to the port through
``icem_torch.convert.ensemble_params_from_arrays``. The draws cannot match
across frameworks (threefry against torch's generators), so they are
injected: the TS1 members and normals into ``apply_fn``, the bootstrap rows
(recomputed from the JAX key outside the jit) into ``fit_epoch``, and the
action noise into both planners by the data of the key it is drawn with, as
``tests/test_torch_icem_scan.py`` does.

Tolerances:
- forward (every member's mu and log-variance, the next obs and reward):
  1e-5, absolute and relative: float32 products of a few hundred terms;
- the loss and its parts 1e-5 relative; gradients 1e-5 absolute plus 1e-4
  relative: a backward pass sums over the batch in another order;
- parameters after k Adam steps: Adam's first step moves an entry by
  lr * m_hat / (sqrt(v_hat) + eps), about lr * sign(g). An entry whose
  gradient is within roundoff of zero can move by +lr in one package and by
  -lr in the other. So entries with |g| > 1e-6 * max|g| (g the first
  step's JAX gradient) are held at 1e-5, and the others at 2 * k * lr,
  their count printed;
- the planners: the executed action, mean, std and costs at 1e-4, as in
  ``tests/test_torch_icem.py``.
"""

import inspect
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icem_tpu.controllers.cem_std as jcs
import icem_tpu.controllers.icem as jic
from icem_torch import main as tmain
from icem_torch.controllers import cem_std as tcs
from icem_torch.controllers import icem as tic
from icem_torch.convert import ensemble_params_from_arrays
from icem_torch.envs.cheetah import HalfCheetah
from icem_torch.models import forward_model_from_string
from icem_torch.models.ensemble import EnsembleModel, member_forward
from icem_torch.runtime.buffer import Rollout, RolloutBuffer
from icem_torch.runtime.config import apply_overrides, resolve_settings
from icem_tpu.envs.cheetah import HalfCheetah as JaxCheetah
from icem_tpu.models.ensemble import EnsembleModel as JaxEnsemble
from icem_tpu.models.ensemble import _member_forward
from icem_tpu.runtime.buffer import Rollout as JaxRollout
from icem_tpu.runtime.buffer import RolloutBuffer as JaxRolloutBuffer

KW = dict(exclude_current_positions_from_observation=True, penalise_flipping=True)
ENV, JENV = HalfCheetah(**KW), JaxCheetah(**KW)
OBS, ACT = ENV.obs_dim, ENV.action_dim
SMALL = dict(ensemble_size=3, hidden=(32, 32))
TOL = dict(atol=1e-5, rtol=1e-5)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(seed: int = 0, **kw):
    """A JAX model (with non-trivial input normalizers) and a port model
    holding its weights."""
    kw = {**SMALL, **kw}
    jm = JaxEnsemble(env=JENV, seed=seed, **kw)
    rng = np.random.default_rng(seed + 100)
    n_in = OBS + ACT
    jm.params = {**jm.params,
                 "in_mu": jnp.asarray(rng.normal(size=n_in).astype(np.float32)),
                 "in_std": jnp.asarray(rng.uniform(0.5, 2.0, n_in).astype(np.float32))}
    jm._opt_state = jm._tx.init(jm.params)
    tm = EnsembleModel(env=ENV, seed=seed, device="cpu", **kw)
    tm.net.assign(ensemble_params_from_arrays(to_numpy(jm.params), "cpu"))
    return jm, tm


def obs_act(P: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, OBS)).astype(np.float32),
            rng.uniform(-1, 1, (P, ACT)).astype(np.float32))


def closure_fn(fn, *names):
    """A function the JAX package defines inside another, by the names of
    the closures that lead to it (e.g. the loss inside ``_make_fit``)."""
    fn = getattr(fn, "__wrapped__", fn)
    for name in names:
        fn = inspect.getclosurevars(fn).nonlocals[name]
    return fn


def port_grads(model) -> dict:
    """The port's gradients in the params layout (None where a leaf is a
    buffer)."""
    named = dict(model.net.named_parameters())
    return jax.tree_util.tree_map(
        lambda name: None if name not in named else named[name].grad.numpy(),
        model.net._layout)


def assert_adam_steps_match(got: dict, want: dict, first_grad: dict, k: int, lr: float):
    """The first-Adam-step rule of the module docstring."""
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(want)
    flat_g = jax.tree_util.tree_leaves(first_grad)
    gmax = max(float(np.abs(g).max()) for g in flat_g)
    near_zero = 0
    for a, b, g in zip(flat_got, flat_want, flat_g):
        a, b, g = np.asarray(a), np.asarray(b), np.asarray(g)
        firm = np.abs(g) > 1e-6 * gmax
        near_zero += int((~firm).sum())
        np.testing.assert_allclose(a[firm], b[firm], atol=1e-5, rtol=0)
        np.testing.assert_allclose(a[~firm], b[~firm], atol=2 * k * lr, rtol=0)
    print(f"{near_zero} entries with |g| <= 1e-6 max|g| held at {2 * k * lr}")


# ---------------------------------------------------------------------------
# forward

def test_registry_resolves_the_jax_strings():
    assert forward_model_from_string("EnsembleModel") is EnsembleModel


@pytest.mark.parametrize("name,kw", [("EnsembleModel", dict(hidden=(16,))),
                                     ("RSSM", dict(hidden=16))])
def test_learned_models_are_built_on_the_card_unless_told(monkeypatch, name, kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        forward_model_from_string(name)(env=ENV, **kw)
    assert forward_model_from_string(name)(env=ENV, device="cpu", **kw).device.type == "cpu"


def test_every_member_matches_jax():
    jm, tm = pair()
    obs, act = obs_act(64)
    jp, tp = jm.params, tm.params
    jx = (jnp.concatenate([obs, act], -1) - jp["in_mu"]) / jp["in_std"]
    jmu, jlv = jax.jit(jax.vmap(lambda net: _member_forward(
        net, jx, jp["max_logvar"], jp["min_logvar"], OBS + 1)))(jp["net"])
    tx = (torch.cat([torch.from_numpy(obs), torch.from_numpy(act)], -1) - tp["in_mu"]) \
        / tp["in_std"]
    tmu, tlv = member_forward(tp["net"], tx, tp["max_logvar"], tp["min_logvar"], OBS + 1)
    assert tuple(tmu.shape) == (3, 64, OBS + 1)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), **TOL)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), **TOL)


def _jax_apply(jm, obs, act):
    ms = jm.init_model_state(obs[0])
    return jax.jit(jax.vmap(lambda o, a: jm.apply_fn(jm.params, ms, o, a)[1:]))(obs, act)


def test_expectation_matches_jax_apply_fn():
    jm, tm = pair(propagation="expectation")
    obs, act = obs_act(64, seed=1)
    jobs, jrew = _jax_apply(jm, obs, act)
    ms, tobs, trew = tm.apply_fn(tm.params, {}, torch.from_numpy(obs), torch.from_numpy(act))
    assert ms == {}
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)


def test_ts1_with_the_jax_members_matches_jax_apply_fn():
    """JAX's TS1 draws a member per trajectory from its key; each row of its
    output is one member's prediction. Those members, given to the port,
    give the same rows."""
    jm, tm = pair()
    obs, act = obs_act(64, seed=2)
    jobs, jrew = _jax_apply(jm, obs, act)
    tx = (torch.cat([torch.from_numpy(obs), torch.from_numpy(act)], -1)
          - tm.params["in_mu"]) / tm.params["in_std"]
    mu, _ = member_forward(tm.params["net"], tx, tm.params["max_logvar"],
                           tm.params["min_logvar"], OBS + 1)
    per_member = obs[None] + mu[..., :OBS].numpy()          # [E, P, obs]
    dist = np.abs(per_member - np.asarray(jobs)[None]).max(-1)
    members = dist.argmin(0)
    assert np.all(dist[members, np.arange(64)] < 1e-5)
    assert len(set(members.tolist())) == 3  # every member drawn at P = 64
    _, tobs, trew = tm.apply_fn(tm.params, {}, torch.from_numpy(obs), torch.from_numpy(act),
                                members=torch.from_numpy(members))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)


@pytest.mark.parametrize("deterministic", [True, False])
def test_ts1_with_injected_draws_matches_jnp_take(deterministic):
    jm, tm = pair(deterministic=deterministic)
    obs, act = obs_act(32, seed=3)
    rng = np.random.default_rng(4)
    members = rng.integers(0, 3, 32)
    normals = rng.standard_normal((32, OBS + 1)).astype(np.float32)
    jp = jm.params
    jx = (jnp.concatenate([obs, act], -1) - jp["in_mu"]) / jp["in_std"]
    jmu, jlv = jax.vmap(lambda net: _member_forward(
        net, jx, jp["max_logvar"], jp["min_logvar"], OBS + 1))(jp["net"])
    take = jax.vmap(lambda x, m: jnp.take(x, m, axis=0), in_axes=(1, 0))
    pred = take(jmu, jnp.asarray(members))
    if not deterministic:
        pred = pred + jnp.exp(0.5 * take(jlv, jnp.asarray(members))) * normals
    _, tobs, trew = tm.apply_fn(tm.params, {}, torch.from_numpy(obs), torch.from_numpy(act),
                                members=torch.from_numpy(members),
                                normals=torch.from_numpy(normals))
    np.testing.assert_allclose(tobs.numpy(), obs + np.asarray(pred[:, :OBS]), **TOL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(pred[:, OBS]), **TOL)


def test_ts1_draws_come_from_the_models_generator():
    _, tm = pair(deterministic=False)
    obs, act = (torch.from_numpy(a) for a in obs_act(256, seed=5))
    _, o1, _ = tm.predict_fn({}, obs, act)
    _, o2, _ = tm.predict_fn({}, obs, act)
    assert not torch.equal(o1, o2)
    _, tm2 = pair(deterministic=False)
    assert torch.equal(tm2.predict_fn({}, obs, act)[1], o1)  # the same seed, the same draws


# ---------------------------------------------------------------------------
# training

def _batch(E: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(E, B, OBS + ACT)).astype(np.float32),
            rng.normal(size=(E, B, OBS + 1)).astype(np.float32))


def test_loss_and_gradients_match_jax():
    jm, tm = pair()
    x, t = _batch(3, 40, seed=6)
    nll_loss = closure_fn(jm._fit, "update", "nll_loss")
    (jtotal, (jnll, jmse)), jgrads = jax.jit(jax.value_and_grad(nll_loss, has_aux=True))(
        jm.params, x, t)
    total, nll, mse = tm.loss(tm.net.tree(detach=False), torch.from_numpy(x),
                              torch.from_numpy(t))
    total.backward()
    for got, want in ((total, jtotal), (nll, jnll), (mse, jmse)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grads = port_grads(tm)
    for k in ("in_mu", "in_std"):  # buffers in the port, zero gradients in JAX
        assert grads[k] is None and not np.any(np.asarray(jgrads[k]))
    got = {k: v for k, v in grads.items() if k not in ("in_mu", "in_std")}
    want = {k: to_numpy(v) for k, v in jgrads.items() if k not in ("in_mu", "in_std")}
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


def test_fit_epoch_matches_jax_with_the_same_bootstrap_rows():
    jm, tm = pair(batch_size=16)
    rng = np.random.default_rng(7)
    n = 50  # 3 minibatches of 16
    x = rng.normal(size=(n, OBS + ACT)).astype(np.float32)
    t = rng.normal(size=(n, OBS + 1)).astype(np.float32)
    key = jax.random.key(9)
    idx = np.array(jax.random.randint(key, (3, 48), 0, n))  # fit_epoch's own draw
    nll_loss = closure_fn(jm._fit, "update", "nll_loss")
    first = jax.grad(lambda p: nll_loss(p, x[idx[:, :16]], t[idx[:, :16]])[0])(jm.params)
    jparams, _, jnll, jmse = jm._fit(jm.params, jm._opt_state, key, x, t)
    nll, mse = tm.fit_epoch(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(idx))
    np.testing.assert_allclose(float(nll), float(jnll), rtol=1e-4)
    np.testing.assert_allclose(float(mse), float(jmse), rtol=1e-4)
    assert_adam_steps_match(pack(tm.params), to_numpy(jparams), to_numpy(first), k=3, lr=1e-3)


def pack(params):
    return jax.tree_util.tree_map(lambda v: v.numpy(), params)


def buffers(n_rollouts: int, T: int, seed: int, obs_dim: int = OBS, act_dim: int = ACT):
    """The same transitions in a JAX and a port buffer."""
    rng = np.random.default_rng(seed)
    fields = ("observations", "next_observations", "actions", "rewards")
    jb, tb = [], []
    for _ in range(n_rollouts):
        o = rng.normal(size=(T + 1, obs_dim)).astype(np.float32)
        a = rng.uniform(-1, 1, (T, act_dim)).astype(np.float32)
        r = rng.normal(size=T).astype(np.float32)
        trans = [(o[i], o[i + 1], a[i], float(r[i])) for i in range(T)]
        jb.append(JaxRollout(fields, trans))
        tb.append(Rollout(fields, trans))
    return JaxRolloutBuffer(rollouts=jb), RolloutBuffer(rollouts=tb)


def test_train_matches_jax_end_to_end_over_three_epochs():
    """bootstrap=False and batch_size = N: each epoch is one update on the
    whole set, whose mean does not depend on the permutation."""
    jbuf, tbuf = buffers(3, 20, seed=8)
    jm, tm = pair(bootstrap=False, batch_size=60, epochs=3)
    x = np.concatenate([jbuf.flat["observations"], jbuf.flat["actions"]], -1)
    mu, std = x.mean(0), x.std(0) + 1e-6
    target = np.concatenate([jbuf.flat["next_observations"] - jbuf.flat["observations"],
                             jbuf.flat["rewards"][:, None]], -1).astype(np.float32)
    nll_loss = closure_fn(jm._fit, "update", "nll_loss")
    xn = ((x - mu) / std)[None].repeat(3, 0)
    first = jax.grad(lambda p: nll_loss(p, xn, target[None].repeat(3, 0))[0])(
        {**jm.params, "in_mu": jnp.asarray(mu), "in_std": jnp.asarray(std)})
    jinfo, tinfo = jm.train(jbuf), tm.train(tbuf)
    assert tinfo["num_transitions"] == jinfo["num_transitions"] == 60
    for k in ("nll", "mse"):
        np.testing.assert_allclose(tinfo[k], jinfo[k], rtol=1e-4)
    # the normalizers are the numpy statistics in both: JAX's weight decay
    # of -1e-8 p rounds away in float32, and the port keeps them as buffers
    for k in ("in_mu", "in_std"):
        np.testing.assert_array_equal(tm.params[k].numpy(), np.asarray(jm.params[k]))
        np.testing.assert_array_equal(tm.params[k].numpy(), mu if k == "in_mu" else std)
    assert_adam_steps_match(pack(tm.params), to_numpy(jm.params), to_numpy(first), k=3,
                            lr=1e-3)
    assert tm.trained and tm.version == 1


# ---------------------------------------------------------------------------
# files

def test_save_load_round_trips_the_ports_own_file(tmp_path):
    jbuf, tbuf = buffers(2, 10, seed=10)
    _, tm = pair(epochs=2, batch_size=8)
    tm.train(tbuf)
    path = str(tmp_path / "forward_model")
    tm.save(path)
    _, fresh = pair(seed=1, epochs=2, batch_size=8)
    fresh.load(path)
    assert fresh.trained and fresh.version == 1
    for a, b in zip(jax.tree_util.tree_leaves(pack(fresh.params)),
                    jax.tree_util.tree_leaves(pack(tm.params))):
        np.testing.assert_array_equal(a, b)
    # the optimizer state came along: one more epoch gives the same weights
    for m in (tm, fresh):
        m._generator.manual_seed(3)
        m.train(tbuf)
    for a, b in zip(jax.tree_util.tree_leaves(pack(fresh.params)),
                    jax.tree_util.tree_leaves(pack(tm.params))):
        np.testing.assert_array_equal(a, b)


def test_a_jax_written_file_loads_through_the_converter(tmp_path, capsys):
    jbuf, _ = buffers(2, 10, seed=11)
    jm, _ = pair(propagation="expectation", epochs=1, batch_size=8)
    jm.train(jbuf)
    path = str(tmp_path / "forward_model")
    jm.save(path)
    _, tm = pair(seed=2, propagation="expectation")
    tm.load(path)
    assert "written by the JAX package" in capsys.readouterr().out
    assert tm.trained and tm.version == 1
    obs, act = obs_act(16, seed=12)
    jobs, jrew = _jax_apply(jm, obs, act)
    _, tobs, trew = tm.predict_fn({}, torch.from_numpy(obs), torch.from_numpy(act))
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **TOL)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), **TOL)
    assert not tm._opt.state  # a fresh optimizer


# ---------------------------------------------------------------------------
# the planners with a learned model

def _key_id(data) -> tuple:
    return tuple(int(v) for v in np.asarray(data).reshape(-1))


def injected_icem_noise(monkeypatch, cfg, h: int, d: int, seed: int):
    """Both iCEM planners draw from one numpy table: the port in order, the
    JAX loops by the data of each draw's key (see test_torch_icem_scan.py).
    Returns ``plan_noise(key)``, which makes the draws of one plan step."""
    rng = np.random.default_rng(seed)
    queue, by_key = [], {}
    E = cfg.elites_kept
    scan = cfg.cem_loop == "scan"
    use_tail = E > 0 and (cfg.shift_elites_over_time or cfg.keep_previous_elites)

    def plan_noise(key):
        for i, n_i in enumerate(cfg.population_schedule):
            key, k_sample, k_shift = jax.random.split(key, 3)
            draws = [(k_sample, cfg.population_schedule[0] if scan else n_i)]
            if (use_tail if scan else (i == 0 and cfg.shift_elites_over_time and E > 0)):
                draws.append((k_shift, E))
            for k, n in draws:
                noise = rng.standard_normal((n, h, d)).astype(np.float32)
                queue.append(noise)
                by_key[_key_id(jax.random.key_data(k))] = noise
        return key

    def port_sampler(cfg_, generator, mean, std, num_traj):
        noise = queue.pop(0)
        assert noise.shape[0] == num_traj
        low, high = cfg_.bounds(mean.device)
        return torch.clamp(torch.from_numpy(noise) * std + mean, low, high)

    def jax_sampler(cfg_, key, mean, std, num_traj):
        shape = jax.ShapeDtypeStruct((num_traj, h, d), jnp.float32)
        noise = jax.pure_callback(lambda data: by_key[_key_id(data)], shape,
                                  jax.random.key_data(key))
        return jnp.clip(noise * std + mean, cfg_.low, cfg_.high)

    monkeypatch.setattr(tic, "sample_action_sequences", port_sampler)
    monkeypatch.setattr(jic, "sample_action_sequences", jax_sampler)
    return plan_noise, queue


def assert_plans_match(res, jres, msg: str, elites: bool = True):
    np.testing.assert_allclose(res.action.numpy(), np.asarray(jres.action), atol=1e-4,
                               err_msg=msg)
    np.testing.assert_allclose(float(res.expected_cost), float(jres.expected_cost),
                               atol=1e-4, rtol=1e-5, err_msg=msg)
    names = ("mean", "std") + (("elite_actions", "elite_costs") if elites else ())
    for name in names:
        np.testing.assert_allclose(getattr(res.state, name).numpy(),
                                   np.asarray(getattr(jres.state, name)),
                                   atol=1e-4, rtol=1e-5, err_msg=f"{name}, {msg}")


def icem_plan_parity(monkeypatch, loop, jm, tm, jenv, env, obs, jms, tms, steps=2, **cfg_kw):
    """``steps`` plan steps of both packages' iCEM with a learned model on
    injected noise; the model state stays the one given (the sync is the
    controllers' business)."""
    kw = dict(horizon=5, num_simulated_trajectories=32, factor_decrease_num=1.25,
              noise_beta=0.25, elites_size=4, cem_loop=loop, action_dim=env.action_dim,
              action_low=tuple(np.asarray(env.action_space.low).ravel().tolist()),
              action_high=tuple(np.asarray(env.action_space.high).ravel().tolist()), **cfg_kw)
    cfg, jcfg = tic.ICemConfig(**kw), jic.ICemConfig(**kw)
    plan_noise, queue = injected_icem_noise(monkeypatch, cfg, cfg.horizon, cfg.action_dim,
                                            seed=13)
    pstate = tic.init_state(cfg, env.obs_dim, torch.Generator().manual_seed(0))
    jpstate = jic.init_state(jcfg, jenv.obs_dim, jax.random.key(0))
    jplan = jax.jit(lambda ps, o, ms, p: jic.plan_step(jcfg, jm.apply_fn, jenv.cost_fn, ps,
                                                       o, ms, model_params=p))
    tobs = torch.from_numpy(np.asarray(obs))
    for step in range(steps):
        plan_noise(jpstate.key)
        res = tic.plan_step(cfg, tm.apply_fn, env.cost_fn, pstate, tobs, tms, tm.params)
        jres = jplan(jpstate, jnp.asarray(obs), jms, jm.params)
        assert not queue
        assert_plans_match(res, jres, f"{loop} plan step {step}")
        pstate, jpstate = res.state, jres.state


@pytest.mark.parametrize("loop", ["unrolled", "scan"])
def test_icem_plan_steps_match_jax_with_the_ensemble(monkeypatch, loop):
    jm, tm = pair(propagation="expectation")
    obs = obs_act(1, seed=14)[0][0]
    icem_plan_parity(monkeypatch, loop, jm, tm, JENV, ENV, obs,
                     jm.init_model_state(jnp.asarray(obs)), {})


def _fake_uniform(queue):
    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        u = next(queue)
        assert tuple(u.shape) == tuple(shape)
        return jnp.asarray(u)
    return uniform


def cem_std_plan_parity(monkeypatch, jm, tm, jenv, env, obs, jms, tms, steps=2):
    """Vanilla CEM of both packages with a learned model, the same uniforms
    injected into both truncated normals (as tests/test_torch_controllers.py)."""
    rng = np.random.default_rng(15)
    draws = []

    def port_uniform(generator, shape):
        u = rng.uniform(1e-6, 1 - 1e-6, shape).astype(np.float32)
        draws.append(u)
        return torch.from_numpy(u)

    monkeypatch.setattr(tcs, "truncated_uniform", port_uniform)
    monkeypatch.setattr(jax.random, "uniform", _fake_uniform(iter(draws)))
    kw = dict(horizon=5, num_simulated_trajectories=32, elites_size=4,
              action_dim=env.action_dim, action_low=tuple(np.asarray(env.action_space.low).ravel().tolist()),
              action_high=tuple(np.asarray(env.action_space.high).ravel().tolist()))
    cfg, jcfg = tcs.CemStdConfig(**kw), jcs.CemStdConfig(**kw)
    pstate = tcs.init_state(cfg, torch.Generator().manual_seed(0))
    jpstate = jcs.init_state(jcfg, jax.random.key(0))
    tobs = torch.from_numpy(np.asarray(obs))
    for step in range(steps):
        res = tcs.plan_step(cfg, tm.apply_fn, env.cost_fn, pstate, tobs, tms, tm.params)
        jres = jcs.plan_step(jcfg, jm.apply_fn, jenv.cost_fn, jpstate, jnp.asarray(obs), jms,
                             model_params=jm.params)
        assert_plans_match(res, jres, f"cem-std plan step {step}", elites=False)
        pstate, jpstate = res.state, jres.state
    assert len(draws) == steps * cfg.opt_iterations


def test_cem_std_plan_steps_match_jax_with_the_ensemble(monkeypatch):
    jm, tm = pair(propagation="expectation")
    obs = obs_act(1, seed=16)[0][0]
    cem_std_plan_parity(monkeypatch, jm, tm, JENV, ENV, obs,
                        jm.init_model_state(jnp.asarray(obs)), {})


def test_controllers_plan_with_the_live_weights_and_verbose_works(capsys):
    """MpcICem hands the planner the model's live weights: a train() between
    two steps changes the plan; verbose=True runs the model advance on the
    ensemble's dict state and skips the state check (a learned model's state
    is not an env state)."""
    _, tm = pair(propagation="expectation", epochs=2, batch_size=8)
    ctrl = tic.MpcICem(env=ENV, forward_model=tm, horizon=4, num_simulated_trajectories=8,
                       action_sampler_params=dict(elites_size=2, opt_iterations=2),
                       verbose=True, seed=1, device="cpu")
    assert ctrl.live_model_params is not None
    state = torch.zeros(18)
    obs = ENV.observation(state)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    a1 = ctrl.get_action(obs, state)
    assert ctrl._model_state == {}
    assert ctrl.check_model_consistency(state) is None
    before = ctrl.live_model_params["net"][0]["w"].clone()
    tm.train(buffers(2, 10, seed=17)[1])
    assert not torch.equal(ctrl.live_model_params["net"][0]["w"], before)
    ctrl.beginning_of_rollout(observation=obs, state=state)
    a2 = ctrl.get_action(obs, state)
    assert np.all(np.isfinite(a1)) and not np.array_equal(a1, a2)
    assert "differs from env" not in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the driver

ROOT = Path(__file__).resolve().parents[1]


def run_learned_setting(name: str, md: str, *overrides):
    """``icem_torch.main.run`` of a shipped setting on the CPU, cut by
    ``overrides``, then a second run that resumes from its checkpoint and
    adds one iteration. Returns both reward dicts."""
    settings = str(ROOT / "settings" / f"{name}.json")
    params = apply_overrides(resolve_settings(settings), [*overrides, f"model_dir={md}"])
    first = tmain.run(params, device="cpu")
    latest = os.path.join(md, "checkpoints_latest")
    assert "forward_model" in os.listdir(latest)
    resumed = tmain.run(apply_overrides(params, [
        f"training_iterations={params.training_iterations + 1}", "checkpoints.load=auto"]),
        device="cpu")
    return first, resumed, [json.loads(line) for line in open(os.path.join(md, "metrics.jsonl"))]


def test_driver_trains_plans_and_resumes_the_ensemble_setting(tmp_path):
    """settings/halfcheetah_running/ensemble-icem.json, cut: a random
    initial episode, one planner iteration with the fused episode, each
    followed by a training of the ensemble; then a resume."""
    first, resumed, logged = run_learned_setting(
        "halfcheetah_running/ensemble-icem", str(tmp_path / "ens"),
        "rollout_params.task_horizon=4", "initial_number_of_rollouts=1",
        "training_iterations=1", "forward_model_params.epochs=2",
        "forward_model_params.hidden=[16, 16]", "controller_params.horizon=3",
        "controller_params.num_simulated_trajectories=8", "seed=3")
    assert first["step"] == [0, 1] and resumed["step"] == [0, 1, 2]
    assert resumed["train_mean_return"][:2] == first["train_mean_return"]
    assert all(np.isfinite(resumed["train_mean_return"]))
    nll = [e for e in logged if e["key"] == "model_nll"]
    assert [e["step"] for e in nll] == [0, 1, 2] and all(np.isfinite([e["value"] for e in nll]))


def test_mpc_random_plans_through_the_live_weights():
    """MpcRandom rolls out the model's ``predict_fn``, which reads the
    weights at each call: rescaled weights change the plan of the same
    sequences."""
    from icem_torch.controllers.random import MpcRandom

    _, tm = pair(propagation="expectation")
    ctrl = MpcRandom(env=ENV, forward_model=tm, horizon=5, num_simulated_trajectories=64,
                     seed=0, device="cpu")
    assert ctrl.live_model_params is None  # as in the JAX package
    obs = torch.from_numpy(obs_act(1, seed=18)[0][0])
    actions = []
    for scale in (1.0, -5.0):
        with torch.no_grad():
            tm.net.net_2_w.mul_(scale)
        ctrl.beginning_of_rollout(observation=obs)  # the same draws each time
        actions.append(ctrl.get_action(obs))
    assert not np.array_equal(*actions)


def test_fused_episodes_plan_with_the_weights_of_their_start():
    """sample_on_device hands the planner the model's live weights: after
    the weights change, the same episode streams plan differently."""
    from icem_torch.runtime.rollout import RolloutManager

    _, tm = pair(propagation="expectation")
    ctrl = tic.MpcICem(env=ENV, forward_model=tm, horizon=3, num_simulated_trajectories=8,
                       action_sampler_params=dict(elites_size=2, opt_iterations=2),
                       seed=1, device="cpu")
    rm = RolloutManager(ENV, {"task_horizon": 3, "fuse_on_device": True}, device="cpu")
    first = rm.sample(ctrl)[0]["actions"]
    with torch.no_grad():
        tm.net.net_2_w.mul_(-5.0)
    rm._episode_counter = 0  # the same episode streams
    again = rm.sample(ctrl)[0]["actions"]
    assert first.shape == again.shape == (3, ACT) and not np.array_equal(first, again)


def test_checkpoint_manager_round_trips_the_forward_model(tmp_path):
    from icem_torch.runtime.checkpoint import CheckpointManager

    _, tm = pair(epochs=1, batch_size=8)
    tm.train(buffers(2, 10, seed=19)[1])
    cpm = CheckpointManager(model_dir=str(tmp_path))
    cpm.update_checkpoint_dir(0)
    cpm.store_forward_model(tm)
    cpm.finalized_checkpoint()
    _, fresh = pair(seed=3)
    CheckpointManager(model_dir=str(tmp_path), load=True).load_forward_model(fresh)
    assert fresh.trained
    for a, b in zip(jax.tree_util.tree_leaves(pack(fresh.params)),
                    jax.tree_util.tree_leaves(pack(tm.params))):
        np.testing.assert_array_equal(a, b)
