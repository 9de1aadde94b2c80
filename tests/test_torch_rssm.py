"""icem_torch's RSSMModel against the JAX package's, on the CPU.

The weights go from the JAX model to the port through
``icem_torch.convert.rssm_params_from_arrays``. The latent noise cannot
match across frameworks, so it is injected: the ELBO's posterior draws are
recomputed from the key the JAX step is given, and the planners run the
model with ``deterministic_plan=True`` on injected action noise
(``tests/test_torch_ensemble.py``'s helpers).

Tolerances:
- the GRU step, prior, posterior, encoder, decoder and reward head: 1e-5
  absolute and relative;
- the ELBO and its three parts 1e-5 relative; its gradients 1e-5 absolute
  plus 1e-4 relative;
- the global-norm clip against optax's: 1e-6 relative (the norm is summed
  in another order);
- parameters after k updates: the first-Adam-step rule of
  ``tests/test_torch_ensemble.py``;
- the controller's synced state h and z after each step: 1e-5; the
  planners' decisions: 1e-4, as in ``tests/test_torch_icem.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import icem_tpu.controllers.icem as jic
from icem_torch.controllers import icem as tic
from icem_torch.convert import rssm_params_from_arrays
from icem_torch.envs.classic import ContinuousPendulum
from icem_torch.models import forward_model_from_string
from icem_torch.models.rssm import RSSMModel, clip_by_global_norm_, gru_step
from icem_tpu.envs.classic import ContinuousPendulum as JaxPendulum
from icem_tpu.models.rssm import RSSMModel as JaxRSSM
from icem_tpu.models.rssm import _gru_step
from tests.test_torch_ensemble import (assert_adam_steps_match, buffers, cem_std_plan_parity,
                                       closure_fn, icem_plan_parity, injected_icem_noise, pack,
                                       port_grads, run_learned_setting, to_numpy)

ENV, JENV = ContinuousPendulum(), JaxPendulum()
OBS, ACT = ENV.obs_dim, ENV.action_dim
SMALL = dict(stoch_dim=4, det_dim=16, hidden=16, embed_dim=8)
TOL = dict(atol=1e-5, rtol=1e-5)
S, D = SMALL["stoch_dim"], SMALL["det_dim"]


def pair(seed: int = 0, **kw):
    """A JAX model (with non-trivial normalizers) and a port model holding
    its weights."""
    kw = {**SMALL, **kw}
    jm = JaxRSSM(env=JENV, seed=seed, **kw)
    rng = np.random.default_rng(seed + 100)
    jm.params = {**jm.params,
                 "obs_mu": jnp.asarray(rng.normal(size=OBS).astype(np.float32)),
                 "obs_std": jnp.asarray(rng.uniform(0.5, 2.0, OBS).astype(np.float32)),
                 "rew_mu": jnp.asarray(np.float32(-1.5)),
                 "rew_std": jnp.asarray(np.float32(0.7))}
    jm._opt_state = jm._tx.init(jm.params)
    tm = RSSMModel(env=ENV, seed=seed, device="cpu", **kw)
    tm.net.assign(rssm_params_from_arrays(to_numpy(jm.params), "cpu"))
    return jm, tm


def segments(L: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(L, B, OBS)).astype(np.float32),
            rng.uniform(-1, 1, (L, B, ACT)).astype(np.float32),
            rng.normal(size=(L, B)).astype(np.float32))


def states(P: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(P, D)).astype(np.float32),
            rng.normal(size=(P, S)).astype(np.float32))


def test_registry_resolves_the_jax_string():
    assert forward_model_from_string("RSSM") is RSSMModel


def test_layers_match_jax():
    jm, tm = pair()
    jp, tp = jm.params, tm.params
    h, z = states(32, seed=1)
    obs = np.random.default_rng(2).normal(size=(32, OBS)).astype(np.float32)
    act = np.random.default_rng(3).uniform(-1, 1, (32, ACT)).astype(np.float32)
    th, tz, tobs = (torch.from_numpy(a) for a in (h, z, obs))
    x = np.concatenate([z, act], -1)
    np.testing.assert_allclose(gru_step(tp["gru"], torch.from_numpy(x), th).numpy(),
                               np.asarray(_gru_step(jp["gru"], x, h)), **TOL)
    e = jm._encode(jp, obs)
    np.testing.assert_allclose(tm._encode(tp, tobs).numpy(), np.asarray(e), **TOL)
    pairs = [(tm._prior(tp, th), jm._prior(jp, h)),
             (tm._posterior(tp, th, torch.from_numpy(np.array(e))), jm._posterior(jp, h, e)),
             ((tm._decode(tp, th, tz),), (jm._decode(jp, h, z),)),
             ((tm._reward(tp, th, tz),), (jm._reward(jp, h, z),))]
    for got, want in pairs:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_open_loop_step_and_filter_match_jax():
    jm, tm = pair(deterministic_plan=True)
    h, z = states(16, seed=4)
    act = np.random.default_rng(5).uniform(-1, 1, (16, ACT)).astype(np.float32)
    obs = np.zeros((16, OBS), np.float32)
    key = jax.random.key(0)
    jstep = jax.vmap(lambda hh, zz, a, o: jm.apply_fn(jm.params, {"h": hh, "z": zz, "key": key},
                                                      o, a))
    jms, jobs, jrew = jstep(h, z, act, obs)
    tms, tobs, trew = tm.apply_fn(tm.params, {"h": torch.from_numpy(h), "z": torch.from_numpy(z)},
                                  torch.from_numpy(obs), torch.from_numpy(act))
    for a, b in ((tms["h"], jms["h"]), (tms["z"], jms["z"]), (tobs, jobs), (trew, jrew)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the filter keeps h and takes z from the posterior of the observation
    o = np.array([0.3, -0.9, 1.2], np.float32)
    jf = jm.got_actual_observation_and_env_state(observation=o, model_state={
        "h": jnp.asarray(h[0]), "z": jnp.asarray(z[0]), "key": key})
    tf = tm.got_actual_observation_and_env_state(observation=torch.from_numpy(o), model_state={
        "h": torch.from_numpy(h[0]), "z": torch.from_numpy(z[0])})
    np.testing.assert_array_equal(tf["h"].numpy(), h[0])
    np.testing.assert_allclose(tf["z"].numpy(), np.asarray(jf["z"]), **TOL)
    assert float(tm.init_model_state(torch.from_numpy(o))["h"].abs().max()) == 0.0


def test_stochastic_draws_are_injectable():
    _, tm = pair()
    h, z = (torch.from_numpy(a) for a in states(8, seed=6))
    act = torch.zeros(8, ACT)
    normals = torch.from_numpy(np.random.default_rng(7).standard_normal((8, S)).astype(np.float32))
    det = RSSMModel(env=ENV, seed=0, device="cpu", deterministic_plan=True, **SMALL)
    det.net.assign(tm.params)
    ms, _, _ = tm.apply_fn(tm.params, {"h": h, "z": z}, None, act, normals=normals)
    mean, _, _ = det.apply_fn(det.params, {"h": h, "z": z}, None, act)
    mu, std = tm._prior(tm.params, ms["h"])
    np.testing.assert_allclose(ms["z"].numpy(), (mu + std * normals).numpy(), **TOL)
    np.testing.assert_array_equal(mean["z"].numpy(), mu.numpy())
    drawn, _, _ = tm.apply_fn(tm.params, {"h": h, "z": z}, None, act)
    assert not torch.equal(drawn["z"], ms["z"])


# ---------------------------------------------------------------------------
# training

def test_elbo_and_gradients_match_jax_with_injected_eps():
    jm, tm = pair()
    obs, act, rew = segments(8, 6, seed=8)
    key = jax.random.key(3)
    eps = np.array(jax.random.normal(key, (8, 6, S)))  # elbo_loss's own draw
    elbo_loss = closure_fn(jm._fit, "elbo_loss")
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(elbo_loss, has_aux=True))(
        jm.params, key, obs, act, rew)
    loss, aux = tm.elbo(tm.net.tree(detach=False), *(torch.from_numpy(a) for a in
                                                     (obs, act, rew, eps)))
    loss.backward()
    for got, want in zip((loss,) + aux, (jloss,) + tuple(jaux)):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    grads = port_grads(tm)
    for k in ("obs_mu", "obs_std", "rew_mu", "rew_std"):
        assert grads[k] is None and not np.any(np.asarray(jgrads[k]))
        del grads[k]
    want = {k: to_numpy(jgrads[k]) for k in grads}
    for a, b in zip(jax.tree_util.tree_leaves(grads), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("norm", [50.0, 150.0])
def test_global_norm_clip_matches_optax(norm):
    rng = np.random.default_rng(9)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((5, 7), (7,), (3, 2, 4))]
    scale = norm / np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
    grads = [g * np.float32(scale) for g in grads]
    clip = optax.clip_by_global_norm(100.0)
    want, _ = clip.update(grads, clip.init(grads))
    got = [torch.from_numpy(g.copy()) for g in grads]
    got_norm = clip_by_global_norm_(got, 100.0)
    np.testing.assert_allclose(float(got_norm), norm, rtol=1e-5)
    for a, b, g in zip(got, want, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
        if norm < 100:
            np.testing.assert_array_equal(a.numpy(), g)


def test_two_fit_steps_match_jax():
    """Two updates with the clip at 1 (so that it acts) from the same keys:
    the port's posterior draws are the JAX step's own, recomputed."""
    jm, tm = pair(grad_clip=1.0)
    elbo_loss = closure_fn(jm._fit, "elbo_loss")
    batches = [segments(8, 6, seed=10 + i) for i in range(2)]
    keys = jax.random.split(jax.random.key(4), 2)
    first = jax.grad(lambda p: elbo_loss(p, keys[0], *batches[0])[0])(jm.params)
    params, opt = jm.params, jm._opt_state
    for key, (obs, act, rew) in zip(keys, batches):
        params, opt, jloss, _ = jm._fit(params, opt, key, obs, act, rew)
        eps = np.array(jax.random.normal(key, (8, 6, S)))
        loss, _ = tm.fit_step(*(torch.from_numpy(a) for a in (obs, act, rew, eps)))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_adam_steps_match(pack(tm.params), to_numpy(params), to_numpy(first), k=2, lr=6e-4)


def test_train_fits_the_buffer_and_sets_the_normalizers():
    _, tbuf = buffers(3, 12, seed=12, obs_dim=OBS, act_dim=ACT)
    _, tm = pair(train_steps=6, seq_length=8, batch_size=4)
    info = tm.train(tbuf)
    assert set(info) == {"loss", "recon", "reward_loss", "kl"}
    assert all(np.isfinite(list(info.values())))
    obs = np.stack([r["observations"] for r in tbuf]).astype(np.float32).reshape(-1, OBS)
    rew = np.stack([r["rewards"] for r in tbuf]).astype(np.float32)
    np.testing.assert_array_equal(tm.params["obs_mu"].numpy(), obs.mean(0))
    np.testing.assert_array_equal(tm.params["obs_std"].numpy(), obs.std(0) + 1e-6)
    assert float(tm.params["rew_mu"]) == float(rew.mean())
    assert float(tm.params["rew_std"]) == float(rew.std() + 1e-6)
    assert tm.trained and tm.version == 1


# ---------------------------------------------------------------------------
# files

def test_save_load_round_trips_and_reads_a_jax_written_file(tmp_path, capsys):
    jm, tm = pair(deterministic_plan=True)
    jm._fit(jm.params, jm._opt_state, jax.random.key(0), *segments(8, 4, seed=13))
    path = str(tmp_path / "jax_model")
    jm.save(path)
    _, fresh = pair(seed=1, deterministic_plan=True)
    fresh.load(path)
    assert "written by the JAX package" in capsys.readouterr().out
    h, z = states(4, seed=14)
    act = np.zeros((4, ACT), np.float32)
    jstep = jax.vmap(lambda hh, zz, a: jm.apply_fn(
        jm.params, {"h": hh, "z": zz, "key": jax.random.key(0)}, a, a)[1])
    ms = {"h": torch.from_numpy(h), "z": torch.from_numpy(z)}
    np.testing.assert_allclose(fresh.predict_fn(ms, None, torch.from_numpy(act))[1].numpy(),
                               np.asarray(jstep(h, z, act)), **TOL)
    # the port's own file, optimizer state included
    tm.fit_step(*(torch.from_numpy(a) for a in segments(8, 4, seed=15)))
    own = str(tmp_path / "own")
    tm.save(own)
    fresh.load(own)
    for a, b in zip(jax.tree_util.tree_leaves(pack(fresh.params)),
                    jax.tree_util.tree_leaves(pack(tm.params))):
        np.testing.assert_array_equal(a, b)
    nxt = [torch.from_numpy(a) for a in segments(8, 4, seed=16)]
    eps = torch.zeros(8, 4, S)
    for m in (tm, fresh):
        m.fit_step(*nxt, eps=eps)
    for a, b in zip(jax.tree_util.tree_leaves(pack(fresh.params)),
                    jax.tree_util.tree_leaves(pack(tm.params))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the planners and the controller

def _start_state(seed: int):
    h, z = states(1, seed)
    return ({"h": jnp.asarray(h[0]), "z": jnp.asarray(z[0]), "key": jax.random.key(0)},
            {"h": torch.from_numpy(h[0]), "z": torch.from_numpy(z[0])})


@pytest.mark.parametrize("loop", ["unrolled", "scan"])
def test_icem_plan_steps_match_jax_with_the_rssm(monkeypatch, loop):
    jm, tm = pair(deterministic_plan=True)
    jms, tms = _start_state(17)
    icem_plan_parity(monkeypatch, loop, jm, tm, JENV, ENV,
                     np.array([0.5, 0.8, -0.2], np.float32), jms, tms,
                     use_env_reward_as_cost=True)


def test_cem_std_plan_steps_match_jax_with_the_rssm(monkeypatch):
    jm, tm = pair(deterministic_plan=True)
    jms, tms = _start_state(18)
    cem_std_plan_parity(monkeypatch, jm, tm, JENV, ENV, np.array([0.5, 0.8, -0.2], np.float32),
                        jms, tms)


def test_controller_advances_then_filters_as_jax(monkeypatch):
    """Two get_action calls of both packages' MpcICem with the RSSM
    (deterministic_plan, the planet settings' planner shape cut down): each
    step syncs by the filter, which keeps h, plans, then advances h and z by
    the executed action. The same actions, and the same h and z after each
    step."""
    jm, tm = pair(deterministic_plan=True)
    kw = dict(horizon=4, num_simulated_trajectories=16, factor_decrease_num=1.0,
              use_env_reward_as_cost=True, cem_loop="scan",
              action_sampler_params=dict(opt_iterations=2, elites_size=4, alpha=0.0,
                                         keep_previous_elites=False,
                                         shift_elites_over_time=False,
                                         use_mean_actions=False, noise_beta=2.5))
    ctrl = tic.MpcICem(env=ENV, forward_model=tm, device="cpu", seed=0, **kw)
    jctrl = jic.MpcICem(env=JENV, forward_model=jm, seed=0, **kw)
    plan_noise, queue = injected_icem_noise(monkeypatch, ctrl.cfg, 4, ACT, seed=19)
    obs_seq = np.array([[1.0, 0.0, 0.0], [0.9, 0.1, 0.5]], np.float32)
    ctrl.beginning_of_rollout(observation=obs_seq[0])
    jctrl.beginning_of_rollout(observation=jnp.asarray(obs_seq[0]))
    np.testing.assert_array_equal(ctrl._model_state["h"].numpy(), np.zeros(D, np.float32))
    for step, obs in enumerate(obs_seq):
        plan_noise(jctrl._pstate.key)
        a = ctrl.get_action(obs)
        ja = jctrl.get_action(jnp.asarray(obs))
        assert not queue
        np.testing.assert_allclose(a, np.asarray(ja), atol=1e-4, err_msg=f"step {step}")
        for k in ("h", "z"):
            np.testing.assert_allclose(ctrl._model_state[k].numpy(),
                                       np.asarray(jctrl._model_state[k]), **TOL)
        assert float(ctrl._model_state["h"].abs().max()) > 0  # advanced


# ---------------------------------------------------------------------------
# the driver

def test_driver_trains_plans_and_resumes_the_planet_setting(tmp_path):
    """settings/planet/cheetah_run.json (action repeat 4, the host-driven
    episode loop), cut: a random initial episode and one planner iteration,
    each followed by a training of the RSSM; then a resume."""
    first, resumed, logged = run_learned_setting(
        "planet/cheetah_run", str(tmp_path / "planet"),
        "rollout_params.task_horizon=4", "initial_number_of_rollouts=1",
        "training_iterations=1", "forward_model_params.train_steps=2",
        "forward_model_params.det_dim=16", "forward_model_params.hidden=16",
        "forward_model_params.stoch_dim=4", "forward_model_params.embed_dim=8",
        "forward_model_params.batch_size=4", "controller_params.horizon=3",
        "controller_params.num_simulated_trajectories=8",
        "controller_params.action_sampler_params.elites_size=3",
        "controller_params.action_sampler_params.opt_iterations=2", "seed=3")
    assert first["step"] == [0, 1] and resumed["step"] == [0, 1, 2]
    assert resumed["train_mean_return"][:2] == first["train_mean_return"]
    assert all(np.isfinite(resumed["train_mean_return"]))
    kl = [e for e in logged if e["key"] == "model_kl"]
    assert [e["step"] for e in kl] == [0, 1, 2] and all(np.isfinite([e["value"] for e in kl]))
