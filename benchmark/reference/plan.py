"""Plain iCEM: the environment's step, open-loop trajectory costs and one
plan step of the unrolled CEM loop, on a reference task.

``plan_step`` follows the published algorithm (arXiv:2008.06389) as the
shipped settings configure it: colored-noise samples clipped to the action
bounds, shifted elites re-simulated at the first iteration, the previous
iteration's best ``fraction_elites_reused`` kept with their costs after it,
the mean as a candidate in the last iteration, an alpha-momentum refit of
mean and std on the top ``elites_size``, and the first action of the last
iteration's best candidate executed. Its random draws are taken from the
generator it is handed, in the order the program takes them, so that a
step replayed from the program's planner state and generator state draws
the same noise. Two orders (``Config.loop``): "unrolled" draws each
iteration's population and, at the first, the shifted elites' last step;
"scan" draws the first iteration's population and the elite tail at every
iteration and keeps the first rows of each draw, as a loop at one fixed
population that masks the decayed rows does.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def step(task, states, actions):
    """(states [P, S], actions [P, A]) -> (next states, next observations, rewards)."""
    nd = task.model.ndof
    acts = torch.clamp(actions, -1.0, 1.0)
    qs, qds = task.engine.rollout(task.model, states[:, :nd].contiguous(),
                                  states[:, nd:2 * nd].contiguous(), acts[:, None, :].contiguous())
    new = torch.cat([qs[0], qds[0], states[:, 2 * nd:]], dim=1)
    return new, task.observation(new), task.reward(states, new, acts)


def trajectory_costs(task, states, actions):
    """Open-loop costs of action sequences [P, h, A] from states [P, S]:
    (summed cost [P], last observation [P, obs])."""
    nd = task.model.ndof
    h = actions.shape[1]
    acts = torch.clamp(actions, -1.0, 1.0)
    qs, qds = task.engine.rollout(task.model, states[:, :nd].contiguous(),
                                  states[:, nd:2 * nd].contiguous(), acts.contiguous())
    extra = states[:, 2 * nd:]
    nxt = torch.cat([qs, qds, extra[None].expand((h,) + extra.shape)], dim=2)
    prev = torch.cat([states[None], nxt[:-1]], dim=0)
    obs, next_obs = task.observation(prev), task.observation(nxt)
    return torch.sum(task.cost(obs, acts.transpose(0, 1), next_obs), dim=0), next_obs[-1]


def _synthesis(n: int):
    nf = n // 2 + 1
    k = np.arange(nf)[:, None]
    t = np.arange(n)[None, :]
    ang = 2.0 * np.pi * k * t / n
    coef = np.full((nf, 1), 2.0)
    coef[0] = 1.0
    if n % 2 == 0 and n > 1:
        coef[-1] = 1.0
    return (coef * np.cos(ang) / n).astype(np.float32), (-coef * np.sin(ang) / n).astype(np.float32)


def _spectrum(n: int, beta: float):
    """(scale [nf], sigma, imaginary mask, real fix) of 1/f^beta noise of length n."""
    dtype = torch.float32
    nf = n // 2 + 1
    f = torch.arange(nf, dtype=dtype) / n
    fmin = 1.0 / n
    ix = min(int(torch.sum(f < torch.tensor(fmin, dtype=dtype))), nf - 1)
    f_eff = torch.where(torch.arange(nf) < ix, f[ix], f)
    f_eff = torch.clamp(f_eff, min=torch.finfo(dtype).tiny)
    s_scale = f_eff ** (-beta / 2.0)
    w = s_scale[1:].clone() if n > 1 else s_scale.clone()
    if n > 1:
        w[-1] = w[-1] * ((1.0 + (n % 2)) / 2.0)
    sigma = 2.0 * torch.sqrt(torch.sum(w**2)) / n
    real_only = torch.zeros(nf, dtype=torch.bool)
    real_only[0] = True
    if n % 2 == 0 and n > 1:
        real_only[-1] = True
    return s_scale, sigma, (~real_only).to(dtype), torch.where(real_only, math.sqrt(2.0), 1.0)


def colored_noise(gen: torch.Generator, beta: float, num: int, h: int, d: int):
    """[num, h, d] unit-variance 1/f^beta noise along the horizon (Timmer and
    Koenig's power-law spectrum, synthesised by a float32 inverse-DFT product)."""
    nf = h // 2 + 1
    kw = dict(generator=gen, dtype=torch.float32, device=gen.device)
    wr = torch.randn((num, d, nf), **kw)
    wi = torch.randn((num, d, nf), **kw)
    s_scale, sigma, imag_keep, real_fix = (x.to(gen.device) for x in _spectrum(h, float(beta)))
    C, D = (torch.from_numpy(x).to(gen.device) for x in _synthesis(h))
    y = (wr * s_scale * real_fix) @ C + (wi * s_scale * imag_keep) @ D
    return (y / sigma).transpose(-1, -2)


class Config:
    """The planner's settings, from a resolved settings dict's
    ``controller_params``."""

    def __init__(self, controller_params: dict, action_dim: int, low: float, high: float,
                 loop: str = "unrolled"):
        if loop not in ("unrolled", "scan"):
            raise ValueError(f"loop must be 'unrolled' or 'scan', got {loop!r}")
        self.loop = loop
        p = dict(controller_params)
        s = dict(p.get("action_sampler_params", {}))
        self.horizon = int(p.get("horizon", 30))
        self.num = int(p.get("num_simulated_trajectories", 40))
        self.decay = float(p.get("factor_decrease_num", 1.25))
        self.alpha = float(s.get("alpha", 0.1))
        self.elites_size = int(s.get("elites_size", 10))
        self.iterations = int(s.get("opt_iterations", 3))
        self.init_std = float(s.get("init_std", 0.5))
        self.use_mean = bool(s.get("use_mean_actions", True))
        self.keep = bool(s.get("keep_previous_elites", True))
        self.shift = bool(s.get("shift_elites_over_time", True))
        self.reused = float(s.get("fraction_elites_reused", 0.3))
        self.beta = float(s.get("noise_beta", 1.0))
        self.action_dim, self.low, self.high = action_dim, float(low), float(high)

    @property
    def num_elites(self) -> int:
        return max(min(self.elites_size, self.num // 2), 2)

    @property
    def kept(self) -> int:
        return int(self.num_elites * self.reused)

    @property
    def populations(self) -> list:
        """Candidates drawn fresh at each iteration; the scanned loop draws
        the first iteration's count every time and so holds no more."""
        sizes, n = [], self.num
        for i in range(self.iterations):
            if i > 0:
                n = max(self.elites_size * 2, int(n / self.decay))
            sizes.append(min(n, self.num) if self.loop == "scan" else n)
        return sizes

    def draws(self, i: int) -> tuple:
        """(fresh rows, tail rows) drawn at iteration ``i``, in this order."""
        if self.loop == "scan":
            tail = self.kept if self.kept > 0 and (self.shift or self.keep) else 0
            return self.num, tail
        return self.populations[i], self.kept if i == 0 and self.shift and self.kept > 0 else 0


def _samples(cfg: Config, gen, mean, std, num: int):
    if cfg.beta > 0:
        noise = colored_noise(gen, cfg.beta, num, cfg.horizon, cfg.action_dim)
    else:
        noise = torch.randn((num, cfg.horizon, cfg.action_dim), generator=gen, device=gen.device)
    noise = noise.to(mean.device)
    return torch.clamp(noise * std + mean, cfg.low, cfg.high)


def plan_steps(cfg: Config, task, gens, states, mean, std, elite_actions, elite_costs,
               have_elites, extra=None):
    """One plan step for each of S independent planners, batched: planner s
    starts from ``states[s]`` with its state before the step (``mean``,
    ``std`` [S, h, A], ``elite_actions`` [S, K, h, A], ``elite_costs`` [S, K],
    ``have_elites`` [S] bools) and draws from ``gens[s]``. Returns the
    executed actions [S, A], the elites [S, K, h, A], their costs [S, K] and
    the open-loop costs [S, X] of ``extra`` [S, X, h, A], action sequences
    from the same states rolled out beside the first iteration's (None
    without them)."""
    S, E, K, h = states.shape[0], cfg.kept, cfg.num_elites, cfg.horizon
    dev = mean.device
    last = cfg.iterations - 1
    rows = torch.arange(S, device=dev)
    best = extra_costs = None
    for i, n in enumerate(cfg.populations):
        n_draw, e_draw = cfg.draws(i)
        fresh, tail = [], []
        for s, g in enumerate(gens):
            fresh.append(_samples(cfg, g, mean[s], std[s], n_draw)[:n])
            if e_draw:
                tail.append(_samples(cfg, g, mean[s], std[s], e_draw)[:, -1:, :])
        fresh = torch.stack(fresh)
        if cfg.use_mean and i == last:
            fresh[:, 0] = mean
        valid = torch.ones((S, n), dtype=torch.bool, device=dev)
        if i == 0 and cfg.shift and E > 0:
            tail = torch.stack(tail)
            sim = torch.cat([fresh, torch.cat([elite_actions[:, :E, 1:, :], tail], dim=2)], dim=1)
            have = torch.as_tensor(have_elites, dtype=torch.bool, device=dev)
            valid = torch.cat([valid, have[:, None].expand(S, E)], dim=1)
        else:
            sim = fresh
        m = sim.shape[1]
        rolled = sim if i > 0 or extra is None else torch.cat([sim, extra.to(sim.device)], dim=1)
        r = rolled.shape[1]
        costs, _ = trajectory_costs(task, states[:, None].expand(S, r, -1).reshape(S * r, -1),
                                    rolled.reshape(S * r, h, -1))
        costs = costs.reshape(S, r)
        if r > m:
            extra_costs = costs[:, m:]
        costs = costs[:, :m]
        if i > 0 and cfg.keep and E > 0:
            cand = torch.cat([sim, elite_actions[:, :E]], dim=1)
            cand_costs = torch.cat([costs, elite_costs[:, :E]], dim=1)
            valid = torch.cat([valid, torch.ones((S, E), dtype=torch.bool, device=dev)], dim=1)
        else:
            cand, cand_costs = sim, costs
        cand_costs = torch.where(valid & torch.isfinite(cand_costs), cand_costs, float("inf"))
        best = cand[rows, torch.argmin(cand_costs, dim=1)]
        idx = torch.argsort(cand_costs, dim=1, stable=True)[:, :K]
        elite_actions = cand[rows[:, None], idx]
        elite_costs = torch.gather(cand_costs, 1, idx)
        mean = (1.0 - cfg.alpha) * elite_actions.mean(dim=1) + cfg.alpha * mean
        std = (1.0 - cfg.alpha) * elite_actions.std(dim=1, correction=0) + cfg.alpha * std
    return best[:, 0], elite_actions, elite_costs, extra_costs
