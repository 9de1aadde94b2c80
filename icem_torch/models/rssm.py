"""Recurrent State-Space Model (PlaNet-style) latent forward model.

Counterpart of ``icem_tpu/models/rssm.py``: a deterministic GRU path plus a
stochastic latent, trained on sequences from the rollout buffer with the
ELBO (reconstruction + reward + KL with free nats).

Planning contract:
- ``apply_fn(params, model_state, obs, action)`` advances the latent one
  step open-loop through the PRIOR; obs is ignored,
- ``got_actual_observation_and_env_state`` is the filter: it keeps the
  deterministic state ``h`` (advanced by the executed action through the
  controllers' model advance, since the model is ``stateful``) and draws
  the stochastic latent ``z`` from the posterior given the real
  observation,
- decoded observations feed the env's cost function.

The model state is ``{"h": [det], "z": [S]}`` (a leading population axis
inside the planner). The latent noise comes from the model's
``torch.Generator``; the JAX package folds a hash of the inputs into a
threefry key, which torch cannot reproduce, so every draw can also be
given (``normals``, ``eps``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from icem_torch.convert import rssm_params_from_arrays
from icem_torch.device import resolve_device
from icem_torch.models.ensemble import LearnedModel, ParamTree, affine, init_mlp, mlp_forward
from icem_torch.runtime.seeding import Seeding

_MIN_STD = 0.1

_NORMALIZERS = ("obs_mu", "obs_std", "rew_mu", "rew_std")


def init_gru(generator: torch.Generator, in_dim: int, h_dim: int) -> dict:
    """Normal weights over sqrt(fan-in); one input bias, no hidden bias."""
    dev = generator.device
    return {
        "wx": torch.randn((in_dim, 3 * h_dim), generator=generator, device=dev)
        / float(np.sqrt(in_dim)),
        "wh": torch.randn((h_dim, 3 * h_dim), generator=generator, device=dev)
        / float(np.sqrt(h_dim)),
        "b": torch.zeros(3 * h_dim, device=dev),
    }


def gru_step(p: dict, x, h):
    """Gates in the order r, u, c: c = tanh(xc + r * hc), h' = u h + (1 - u) c."""
    xr, xu, xc = torch.chunk(affine(x, {"w": p["wx"], "b": p["b"]}), 3, dim=-1)
    hr, hu, hc = torch.chunk(torch.matmul(h, p["wh"]), 3, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    c = torch.tanh(xc + r * hc)
    return u * h + (1.0 - u) * c


def gaussian(raw):
    mu, pre_std = torch.chunk(raw, 2, dim=-1)
    return mu, F.softplus(pre_std) + _MIN_STD


def clip_by_global_norm_(grads, max_norm: float):
    """optax.clip_by_global_norm in place: every gradient times
    max_norm / |g| where the global norm |g| is at least max_norm, without a
    read back to the host. g / d * m, with d = m = 1 where it is not
    clipped, leaves those gradients' bits alone."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    clip = norm >= max_norm
    d = torch.where(clip, norm, torch.ones_like(norm))
    m = torch.where(clip, torch.full_like(norm, max_norm), torch.ones_like(norm))
    for g in grads:
        g.div_(d).mul_(m)
    return norm


class RSSMModel(LearnedModel):
    """Latent RSSM forward model with the driver's model lifecycle."""

    stateful = True
    params_from_arrays = staticmethod(rssm_params_from_arrays)

    def __init__(self, *, env, stoch_dim: int = 30, det_dim: int = 128,
                 hidden: int = 128, embed_dim: int = 128,
                 learning_rate: float = 6e-4, grad_clip: float = 100.0,
                 free_nats: float = 3.0, kl_scale: float = 1.0,
                 seq_length: int = 32, batch_size: int = 16,
                 train_steps: int = 100,
                 deterministic_plan: bool = False, seed: Optional[int] = None,
                 device=None, **kwargs):
        super().__init__(env=env)
        self.device = resolve_device(device)
        self.obs_dim = env.observation_space.dim
        self.act_dim = env.action_space.dim
        self.stoch_dim = int(stoch_dim)
        self.det_dim = int(det_dim)
        self.learning_rate = float(learning_rate)
        self.grad_clip = float(grad_clip)
        self.free_nats = float(free_nats)
        self.kl_scale = float(kl_scale)
        self.seq_length = int(seq_length)
        self.batch_size = int(batch_size)
        self.train_steps = int(train_steps)
        self.deterministic_plan = bool(deterministic_plan)

        gen = Seeding.controller_generator(seed, "model/rssm", self.device)
        self._generator = gen
        H, S, E, D = int(hidden), self.stoch_dim, int(embed_dim), self.det_dim
        dev = self.device
        self.net = ParamTree({
            "encoder": init_mlp((self.obs_dim, H, E), gen),
            "gru": init_gru(gen, S + self.act_dim, D),
            "prior": init_mlp((D, H, 2 * S), gen),
            "posterior": init_mlp((D + E, H, 2 * S), gen),
            "decoder": init_mlp((D + S, H, H, self.obs_dim), gen),
            "reward": init_mlp((D + S, H, 1), gen),
            "obs_mu": torch.zeros(self.obs_dim, device=dev),
            "obs_std": torch.ones(self.obs_dim, device=dev),
            "rew_mu": torch.zeros((), device=dev),
            "rew_std": torch.ones((), device=dev),
        }, frozen=_NORMALIZERS)
        self._opt = self._make_optimizer()
        self.trained = False

    def _make_optimizer(self):
        # optax.adam's defaults; the global-norm clip comes first (fit_step)
        return torch.optim.Adam(self.net.parameters(), lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)

    # -- functional pieces ----------------------------------------------------
    @staticmethod
    def _encode(params, obs):
        obs_n = (obs - params["obs_mu"]) / params["obs_std"]
        return F.silu(mlp_forward(params["encoder"], obs_n))

    @staticmethod
    def _decode(params, h, z):
        obs_n = mlp_forward(params["decoder"], torch.cat([h, z], dim=-1))
        return torch.addcmul(params["obs_mu"], obs_n, params["obs_std"])

    @staticmethod
    def _reward(params, h, z):
        r_n = mlp_forward(params["reward"], torch.cat([h, z], dim=-1))[..., 0]
        return torch.addcmul(params["rew_mu"], r_n, params["rew_std"])

    @staticmethod
    def _prior(params, h):
        return gaussian(mlp_forward(params["prior"], h))

    @staticmethod
    def _posterior(params, h, embed):
        return gaussian(mlp_forward(params["posterior"], torch.cat([h, embed], dim=-1)))

    def _normals(self, like, normals):
        if normals is None:
            normals = torch.randn(like.shape, generator=self._generator, device=like.device)
        return normals

    # -- planning core ----------------------------------------------------------
    def apply_fn(self, params, model_state, obs, action, normals=None):
        """Open-loop latent step through the prior; obs is ignored.
        ``normals`` [P, S]: the prior draw, from the generator where not
        given."""
        h, z = model_state["h"], model_state["z"]
        h2 = gru_step(params["gru"], torch.cat([z, action], dim=-1), h)
        mu, std = self._prior(params, h2)
        z2 = mu if self.deterministic_plan else torch.addcmul(mu, std, self._normals(mu, normals))
        return ({"h": h2, "z": z2}, self._decode(params, h2, z2),
                self._reward(params, h2, z2))

    def predict_fn(self, model_state, obs, action):
        """``apply_fn`` bound to the live weights."""
        return self.apply_fn(self.params, model_state, obs, action)

    def _filter(self, observation, model_state, normals=None):
        """Posterior update: keep h (zero without a state), draw z given the
        real observation."""
        params = self.params
        h = model_state["h"] if model_state is not None \
            else torch.zeros(self.det_dim, device=self.device)
        e = self._encode(params, torch.as_tensor(observation, dtype=torch.float32,
                                                 device=self.device))
        mu, std = self._posterior(params, h, e)
        z = mu if self.deterministic_plan else torch.addcmul(mu, std, self._normals(mu, normals))
        return {"h": h, "z": z}

    def got_actual_observation_and_env_state(self, *, observation, env_state=None,
                                             model_state=None):
        return self._filter(observation, model_state)

    def init_model_state(self, observation, env_state=None):
        return self._filter(observation, None)

    def reset(self, observation):
        return self._filter(observation, None)

    # -- training ----------------------------------------------------------------
    def elbo(self, params, obs_seq, act_seq, rew_seq, eps):
        """(loss, (reconstruction, reward, KL)) on time-major segments
        obs / act / rew [L, B, ...] with the posterior draws eps [L, B, S].

        Observe pass: h_t from (h_{t-1}, z_{t-1}, a_{t-1}); the posterior
        given e_t; reconstruct obs_t; the reward head at t predicts r_{t-1}.
        The normalizers are buffers, so they take no gradient."""
        L, B = obs_seq.shape[0], obs_seq.shape[1]
        obs_n = (obs_seq - params["obs_mu"]) / params["obs_std"]
        embed = F.silu(mlp_forward(params["encoder"], obs_n))
        h = torch.zeros((B, self.det_dim), device=obs_seq.device)
        z = torch.zeros((B, self.stoch_dim), device=obs_seq.device)
        a_prev = torch.cat([torch.zeros_like(act_seq[:1]), act_seq[:-1]], dim=0)
        hs, zs, post_mu, post_std = [], [], [], []
        for t in range(L):
            h = gru_step(params["gru"], torch.cat([z, a_prev[t]], dim=-1), h)
            mu, std = self._posterior(params, h, embed[t])
            z = mu + std * eps[t]
            hs.append(h)
            zs.append(z)
            post_mu.append(mu)
            post_std.append(std)
        hs, zs = torch.stack(hs), torch.stack(zs)
        post_mu, post_std = torch.stack(post_mu), torch.stack(post_std)
        # the prior of h_t does not feed the recurrence: one pass over all t
        pri_mu, pri_std = self._prior(params, hs)

        hz = torch.cat([hs, zs], dim=-1)
        recon_n = mlp_forward(params["decoder"], hz)
        recon_loss = 0.5 * torch.mean(torch.sum((recon_n - obs_n) ** 2, dim=-1))
        rew_pred = mlp_forward(params["reward"], hz)[..., 0]
        rew_n = (rew_seq - params["rew_mu"]) / params["rew_std"]
        # the reward at t is for the transition t-1 -> t: skip t = 0
        rew_loss = 0.5 * torch.mean((rew_pred[1:] - rew_n[:-1]) ** 2)
        kl = (torch.log(pri_std / post_std)
              + (post_std ** 2 + (post_mu - pri_mu) ** 2) / (2 * pri_std ** 2) - 0.5)
        kl_loss = torch.mean(torch.clamp(torch.sum(kl, dim=-1), min=self.free_nats))
        loss = recon_loss + rew_loss + self.kl_scale * kl_loss
        return loss, (recon_loss, rew_loss, kl_loss)

    def fit_step(self, obs_seq, act_seq, rew_seq, eps=None):
        """One update: ELBO gradient, global-norm clip, Adam. ``eps``
        [L, B, S] from the generator where not given. Returns (loss, aux)
        as tensors."""
        L, B = obs_seq.shape[0], obs_seq.shape[1]
        if eps is None:
            eps = torch.randn((L, B, self.stoch_dim), generator=self._generator,
                              device=self.device)
        self._opt.zero_grad(set_to_none=True)
        loss, aux = self.elbo(self.net.tree(detach=False), obs_seq, act_seq, rew_seq, eps)
        loss.backward()
        clip_by_global_norm_([p.grad for p in self.net.parameters()], self.grad_clip)
        self._opt.step()
        return loss.detach(), tuple(a.detach() for a in aux)

    @staticmethod
    def _stacked_sequences(buffer):
        """[R, T, ...] arrays from possibly ragged rollouts, trimmed to the
        shortest (early-terminated episodes) so that batches stay
        rectangular."""
        rollouts = [r for r in buffer if len(r) >= 2]
        if not rollouts:
            return None
        t_min = min(len(r) for r in rollouts)
        try:
            return tuple(np.stack([np.asarray(r[k][:t_min], np.float32) for r in rollouts])
                         for k in ("observations", "actions", "rewards"))
        except (KeyError, ValueError):
            return None

    def train(self, buffer):
        """Sequence-ELBO training on the rollout buffer."""
        data = self._stacked_sequences(buffer)
        if data is None:
            return {}
        obs, act, rew = data
        if act.ndim == 2:
            act = act[..., None]
        R, T = obs.shape[0], obs.shape[1]
        L = min(self.seq_length, T)
        if R == 0 or T < 2:
            return {}

        # population statistics (ddof 0) in numpy, as the JAX package takes them
        flat = obs.reshape(-1, obs.shape[-1])
        norm = np.concatenate([flat.mean(axis=0), flat.std(axis=0) + 1e-6,
                               [rew.mean(), rew.std() + 1e-6]]).astype(np.float32)
        # the segments' start rows, drawn in the JAX package's order from a
        # numpy generator seeded off the model's stream: one read of the card
        seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self._generator,
                                 device=self.device))
        rng = np.random.default_rng(seed)
        starts = []
        for _ in range(self.train_steps):
            r_idx = rng.integers(0, R, self.batch_size)
            t_idx = rng.integers(0, T - L + 1, self.batch_size)
            starts.append((r_idx, t_idx))
        starts = np.asarray(starts, np.int64).reshape(self.train_steps, 2, self.batch_size)
        d = self.obs_dim
        obs_t, act_t, rew_t, norm_t, starts_t = (
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (obs, act, rew, norm, starts))
        self.net.obs_mu.copy_(norm_t[:d])
        self.net.obs_std.copy_(norm_t[d:2 * d])
        self.net.rew_mu.copy_(norm_t[2 * d])
        self.net.rew_std.copy_(norm_t[2 * d + 1])

        offsets = torch.arange(L, device=self.device)[:, None]
        hist = []
        for r_idx, t_idx in starts_t:
            rows, cols = r_idx[None, :].expand(L, -1), t_idx[None, :] + offsets  # [L, B]
            loss, aux = self.fit_step(obs_t[rows, cols], act_t[rows, cols], rew_t[rows, cols])
            hist.append(torch.stack((loss,) + aux))
        self.trained = True
        self.version += 1
        # means over the last quarter of the steps (one batch's values are noisy)
        hist = torch.stack(hist)
        tail = hist[-max(len(hist) // 4, 1):].mean(dim=0).tolist()
        return {"loss": tail[0], "recon": tail[1], "reward_loss": tail[2], "kl": tail[3]}
