"""Probabilistic ensemble forward model (PETS-style).

Counterpart of ``icem_tpu/models/ensemble.py``: an ensemble of Gaussian MLPs
predicting the observation delta and the reward, trained by negative
log-likelihood on the rollout buffer (the driver's
``forward_model.train(rollout_buffer)`` hook).

- One ``nn.Module`` holds the stacked member weights, ``[E, n_in, n_out]``
  per layer: every member evaluates in one batched product per layer.
- ``apply_fn(params, model_state, obs, action)`` is the core over a dict of
  tensors with a leading population axis; ``params`` is that dict for the
  live weights, sharing their storage, so a planner that was handed it
  plans with the weights of the latest ``train``.
- TS1 propagation draws a member per trajectory and step (and, with
  ``deterministic=False``, a Gaussian draw) from the model's
  ``torch.Generator`` on its device. The JAX package derives these draws
  from a threefry key folded with a hash of the inputs' bits, which torch
  cannot reproduce; ``apply_fn`` takes them as arguments instead
  (``members [P]``, ``normals [P, out]``) so that they can be given.
- The model state is an empty dict: the draws need no key in it.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from icem_torch.convert import ensemble_params_from_arrays
from icem_torch.device import resolve_device
from icem_torch.models.base import ForwardModel
from icem_torch.runtime.checkpoint import pack_pytree, tree_map, unpack_pytree
from icem_torch.runtime.seeding import Seeding

_LOGVAR_MAX_INIT = 0.5
_LOGVAR_MIN_INIT = -10.0

# tags the files the port writes; a file without it is the JAX package's
FILE_FORMAT = "icem_torch"


def init_mlp(sizes: Sequence[int], generator: torch.Generator, members: Optional[int] = None):
    """Layer dicts ``{"w", "b"}``: w a normal truncated to [-2, 2] over
    sqrt(n_in), b zero; with ``members`` a leading member axis on both."""
    lead = () if members is None else (members,)
    layers = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        w = torch.empty(lead + (n_in, n_out), device=generator.device)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        layers.append({"w": w / float(np.sqrt(n_in)),
                       "b": torch.zeros(lead + (n_out,), device=generator.device)})
    return layers


def affine(x, layer):
    """x @ w + b, one launch. With member-stacked weights ``[E, n_in,
    n_out]``, x is ``[B, n_in]`` (shared by every member) or
    ``[E, B, n_in]``; else x is ``[..., n_in]``."""
    w, b = layer["w"], layer["b"]
    if w.dim() == 3:
        if x.dim() == 2:
            x = x.expand((w.shape[0],) + tuple(x.shape))
        return torch.baddbmm(b.unsqueeze(1), x, w)
    if x.dim() == 2:
        return torch.addmm(b, x, w)
    return torch.addmm(b, x.reshape(-1, x.shape[-1]), w).reshape(x.shape[:-1] + (w.shape[1],))


def mlp_forward(layers, x):
    for layer in layers[:-1]:
        x = F.silu(affine(x, layer))
    return affine(x, layers[-1])


def bound_logvar(logvar, max_logvar, min_logvar):
    """PETS soft bounds keep variances trainable but sane."""
    logvar = max_logvar - F.softplus(max_logvar - logvar)
    return min_logvar + F.softplus(logvar - min_logvar)


def member_forward(net, x, max_logvar, min_logvar, out_dim: int):
    """Every member's (mu, bounded logvar), ``[E, B, out]`` each."""
    raw = mlp_forward(net, x)
    return raw[..., :out_dim], bound_logvar(raw[..., out_dim:], max_logvar, min_logvar)


def _layout(tree, prefix: str = ""):
    """The tree with each leaf replaced by its path, "net_0_w"."""
    if isinstance(tree, dict):
        return {k: _layout(v, f"{prefix}{k}_") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_layout(v, f"{prefix}{i}_") for i, v in enumerate(tree)]
    return prefix[:-1]


class ParamTree(nn.Module):
    """Weights in the JAX package's params layout, nested dicts and lists of
    tensors. The leaves under the ``frozen`` top-level keys (the data
    normalizers, which take no gradient in the JAX package) are buffers, the
    others parameters."""

    def __init__(self, tree: dict, frozen: Sequence[str] = ()):
        super().__init__()
        self._layout = _layout(tree)
        for key, sub in tree.items():
            for name, leaf in _pairs(self._layout[key], sub):
                if key in frozen:
                    self.register_buffer(name, leaf)
                else:
                    self.register_parameter(name, nn.Parameter(leaf))

    def tree(self, detach: bool = True) -> dict:
        """The weights as a params tree; ``detach``: views without autograd
        history that share the weights' storage."""
        if detach:
            return tree_map(lambda name: getattr(self, name).detach(), self._layout)
        return tree_map(lambda name: getattr(self, name), self._layout)

    @torch.no_grad()
    def assign(self, tree: dict):
        """Copy a params tree of the same layout and shapes into the weights."""
        for name, src in _pairs(self._layout, tree):
            dst = getattr(self, name)
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} where the model has "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)


def _pairs(layout, tree):
    """(path name, leaf) of a tree against a layout, dict keys in any order."""
    if isinstance(layout, dict):
        if not isinstance(tree, dict) or set(tree) != set(layout):
            raise ValueError(f"params keys {sorted(tree) if isinstance(tree, dict) else tree} "
                             f"where the model has {sorted(layout)}")
        for k in layout:
            yield from _pairs(layout[k], tree[k])
    elif isinstance(layout, list):
        if len(tree) != len(layout):
            raise ValueError(f"{len(tree)} layers where the model has {len(layout)}")
        for sub_layout, sub in zip(layout, tree):
            yield from _pairs(sub_layout, sub)
    else:
        yield layout, tree


def read_model_file(path: str) -> dict:
    """A model file's contents. A JAX-written file's optimizer state is made
    of optax classes, which need JAX to unpickle: each becomes an opaque
    object."""

    class _Opaque:
        def __new__(cls, *args, **kwargs):
            return object.__new__(cls)

        def __setstate__(self, state):
            pass

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] in ("optax", "jax", "jaxlib", "chex"):
                return _Opaque
            return super().find_class(module, name)

    with open(path, "rb") as f:
        return _Unpickler(f).load()


class LearnedModel(ForwardModel):
    """What the learned models share: weights in a ``ParamTree`` (``net``),
    an optimizer (``_opt``, remade by ``_make_optimizer``), ``params`` and
    ``save`` / ``load``. ``params_from_arrays``: the converter of a
    JAX-written file's params (``icem_torch.convert``)."""

    params_from_arrays = None

    @property
    def params(self) -> dict:
        return self.net.tree()

    def graph_reads(self):
        """The model's generator (the TS1 and prior draws) and its weights."""
        return self._generator, self.params

    def save(self, path):
        state = {"format": FILE_FORMAT,
                 "params": pack_pytree(self.params),
                 "opt_state": pack_pytree(self._opt.state_dict()),
                 "trained": self.trained}
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load(self, path):
        """Restore what ``save`` wrote, or the params of a file the JAX
        package wrote (its optimizer state is not carried over)."""
        name = type(self).__name__
        if not os.path.exists(path):
            print(f"{name}.load: no file at {path}; keeping fresh params")
            return
        state = read_model_file(path)
        if state.get("format") == FILE_FORMAT:
            self.net.assign(unpack_pytree(state["params"], self.device))
            # the optimizer moves its moments onto the weights' device; its
            # step counters stay on the CPU
            self._opt.load_state_dict(unpack_pytree(state["opt_state"], "cpu"))
        else:
            self.net.assign(self.params_from_arrays(state["params"], self.device))
            self._opt = self._make_optimizer()
            print(f"{name}.load: {path} was written by the JAX package; its params are "
                  f"loaded and the optimizer state starts fresh")
        self.trained = bool(state["trained"])
        self.version += 1


class EnsembleModel(LearnedModel):
    """Gaussian-MLP ensemble over (obs, action) -> (delta obs, reward)."""

    params_from_arrays = staticmethod(ensemble_params_from_arrays)

    def __init__(self, *, env, ensemble_size: int = 5, hidden: Sequence[int] = (200, 200, 200),
                 propagation: str = "ts1", deterministic: bool = True,
                 learning_rate: float = 1e-3, weight_decay: float = 1e-5,
                 batch_size: int = 256, epochs: int = 20, bootstrap: bool = True,
                 logvar_bound_weight: float = 0.01, reset_on_train: bool = False,
                 seed: Optional[int] = None, device=None, **kwargs):
        super().__init__(env=env)
        if propagation not in ("ts1", "expectation"):
            raise ValueError(f"unknown propagation {propagation!r}")
        self.device = resolve_device(device)
        self.ensemble_size = int(ensemble_size)
        self.hidden = tuple(int(h) for h in hidden)
        self.propagation = propagation
        self.deterministic = bool(deterministic)
        self.learning_rate = float(learning_rate)
        self.weight_decay = float(weight_decay)
        self.batch_size = int(batch_size)
        self.epochs = int(epochs)
        self.bootstrap = bool(bootstrap)
        self.logvar_bound_weight = float(logvar_bound_weight)
        self.reset_on_train = bool(reset_on_train)

        self.obs_dim = env.observation_space.dim
        self.act_dim = env.action_space.dim
        self.in_dim = self.obs_dim + self.act_dim
        self.out_dim = self.obs_dim + 1  # delta obs + reward

        self._generator = Seeding.controller_generator(seed, "model/ensemble", self.device)
        self._reinit_params()
        self.trained = False

    def _reinit_params(self):
        """Fresh member weights and optimizer state (constructor and
        reset_on_train refits)."""
        sizes = (self.in_dim,) + self.hidden + (2 * self.out_dim,)
        dev = self.device
        self.net = ParamTree({
            "net": init_mlp(sizes, self._generator, members=self.ensemble_size),
            "max_logvar": torch.full((self.out_dim,), _LOGVAR_MAX_INIT, device=dev),
            "min_logvar": torch.full((self.out_dim,), _LOGVAR_MIN_INIT, device=dev),
            "in_mu": torch.zeros(self.in_dim, device=dev),
            "in_std": torch.ones(self.in_dim, device=dev),
        }, frozen=("in_mu", "in_std"))
        self._opt = self._make_optimizer()

    def _make_optimizer(self):
        # optax.adamw's rule: p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
        return torch.optim.AdamW(self.net.parameters(), lr=self.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=self.weight_decay)

    # -- functional core -----------------------------------------------------
    def apply_fn(self, params, model_state, obs, action, members=None, normals=None):
        """(params, {}, obs [P, o], action [P, a]) -> ({}, next_obs, reward).

        ``members`` ([P] indices) and ``normals`` ([P, out]) are the TS1
        draws; where not given they come from the model's generator."""
        x = (torch.cat([obs, action], dim=-1) - params["in_mu"]) / params["in_std"]
        raw = mlp_forward(params["net"], x)  # [E, P, 2 out]
        mu = raw[..., : self.out_dim]
        if self.propagation == "expectation":
            pred = torch.mean(mu, dim=0)
        else:  # ts1
            P = x.shape[0]
            if members is None:
                members = torch.randint(0, self.ensemble_size, (P,),
                                        generator=self._generator, device=x.device)
            pick = members.view(1, P, 1).expand(1, P, self.out_dim)
            pred = torch.gather(mu, 0, pick)[0]
            if not self.deterministic:
                # the bounded log-variance only where a draw needs it
                logvar = bound_logvar(raw[..., self.out_dim:], params["max_logvar"],
                                      params["min_logvar"])
                if normals is None:
                    normals = torch.randn(pred.shape, generator=self._generator,
                                          device=x.device)
                pred = pred + torch.exp(0.5 * torch.gather(logvar, 0, pick)[0]) * normals
        next_obs = obs + pred[..., : self.obs_dim]
        reward = pred[..., self.obs_dim]
        return model_state, next_obs, reward

    def predict_fn(self, model_state, obs, action):
        """``apply_fn`` bound to the live weights."""
        return self.apply_fn(self.params, model_state, obs, action)

    def init_model_state(self, observation, env_state=None):
        return {}

    # -- training --------------------------------------------------------------
    def loss(self, tree, x, target):
        """(NLL + log-variance bound term, NLL, MSE) on member batches
        x [E, B, in] (normalized) and target [E, B, out]."""
        mu, logvar = member_forward(tree["net"], x, tree["max_logvar"], tree["min_logvar"],
                                    self.out_dim)
        nll = 0.5 * ((target - mu) ** 2 * torch.exp(-logvar) + logvar)
        nll = torch.mean(torch.sum(nll, dim=-1))
        bound_reg = self.logvar_bound_weight * (torch.sum(tree["max_logvar"])
                                                - torch.sum(tree["min_logvar"]))
        mse = torch.mean(torch.sum((target - mu) ** 2, dim=-1))
        return nll + bound_reg, nll, mse

    def epoch_indices(self, n: int) -> torch.Tensor:
        """[E, used] row indices of one epoch: bootstrap draws, or a
        permutation per member wrapped to whole batches."""
        used = max(n // self.batch_size, 1) * self.batch_size
        E, gen = self.ensemble_size, self._generator
        if self.bootstrap:
            return torch.randint(0, n, (E, used), generator=gen, device=self.device)
        wrap = torch.arange(used, device=self.device) % n
        return torch.stack([torch.randperm(n, generator=gen, device=self.device)[wrap]
                            for _ in range(E)])

    def fit_epoch(self, x_all, t_all, idx):
        """One epoch over minibatches of the rows ``idx [E, used]`` of
        x_all [N, in] (normalized) and t_all [N, out]; returns the mean
        NLL and MSE as tensors."""
        E, used = idx.shape
        n_batches = used // self.batch_size
        xb = x_all[idx].reshape(E, n_batches, self.batch_size, -1)
        tb = t_all[idx].reshape(E, n_batches, self.batch_size, -1)
        tree = self.net.tree(detach=False)
        nlls, mses = [], []
        for i in range(n_batches):
            self._opt.zero_grad(set_to_none=True)
            total, nll, mse = self.loss(tree, xb[:, i], tb[:, i])
            total.backward()
            self._opt.step()
            nlls.append(nll.detach())
            mses.append(mse.detach())
        return torch.stack(nlls).mean(), torch.stack(mses).mean()

    def train(self, buffer):
        """Fit the ensemble on the buffer (the driver's train hook)."""
        flat = buffer.flat
        if not flat or len(flat.get("observations", ())) < 2:
            return {}
        obs = np.asarray(flat["observations"], np.float32)
        act = np.asarray(flat["actions"], np.float32)
        next_obs = np.asarray(flat["next_observations"], np.float32)
        rew = np.asarray(flat["rewards"], np.float32).reshape(-1, 1)
        if act.ndim == 1:
            act = act[:, None]

        x = np.concatenate([obs, act], axis=-1)
        target = np.concatenate([next_obs - obs, rew], axis=-1)

        if self.reset_on_train:
            self._reinit_params()

        # population statistics (ddof 0) in numpy, as the JAX package takes them
        in_mu = x.mean(axis=0)
        in_std = x.std(axis=0) + 1e-6
        x_n, t, mu_std = (torch.from_numpy(a).to(self.device)
                          for a in ((x - in_mu) / in_std, target, np.stack([in_mu, in_std])))
        self.net.in_mu.copy_(mu_std[0])
        self.net.in_std.copy_(mu_std[1])

        nll = mse = torch.tensor(float("nan"))
        for _ in range(self.epochs):
            nll, mse = self.fit_epoch(x_n, t, self.epoch_indices(x.shape[0]))
        self.trained = True
        self.version += 1
        return {"nll": float(nll), "mse": float(mse), "num_transitions": int(x.shape[0])}
