"""Optimizer and LR schedule (``audio8_tpu/train/optim.py``).

- :func:`create_lrs`: linear warmup -> optional plateau -> decay, every
  ``sched_type`` of the JAX function;
- :func:`create_optimizer`: ``adamw`` and ``fused_adamw`` are both the
  port's fused AdamW (``ops/adamw.py``, one kernel launch per step on the
  card): optax.adamw and ``FusedAdamW`` are the same math. ``adam`` is the
  same kernel with weight decay 0. ``sgd`` is :class:`SGD`, optax.sgd
  without momentum (``p - lr * g``) as plain torch ops: the JAX package
  leaves it to XLA, so it has no kernel;
- :class:`TrainState`: the model's parameters, the optimizer state and
  the step. ``apply_gradients`` folds the grad scale (1/examples) and the
  global-norm clip factor into the optimizer's one scalar, as the JAX
  ``FusedAdamW`` path does.

optax semantics: one global step count; the learning rate comes from the
schedule at the pre-increment count, the bias corrections from the
post-increment count, all in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from audio8_tpu_torch.ops.adamw import adamw_update

_F = np.float32


def create_lrs(lr: float, train_steps: int, sched_type: str = "cosine",
               alpha: float = 0.0, warmup_steps: int = 10_000,
               plateau_steps: int = 0, **kwargs) -> Callable[[int], float]:
    """Composite LR schedule: step -> learning rate (float32 math)."""
    if sched_type not in ("cosine", "linear", "invtime", "inverse-time",
                          "exponential", "constant"):
        raise ValueError(f"Unknown lr scheduler {sched_type!r}")
    lr32, alpha32 = _F(lr), _F(alpha)

    def schedule(step) -> float:
        step = _F(step)
        warm = lr32 * step / _F(max(warmup_steps, 1))
        t = max(step - _F(warmup_steps) - _F(plateau_steps), _F(0.0))
        frac = min(t / _F(max(train_steps, 1)), _F(1.0))
        if sched_type == "cosine":
            decay = lr32 * ((_F(1.0) - alpha32) * _F(0.5)
                            * (_F(1.0) + _F(math.cos(_F(math.pi) * frac)))
                            + alpha32)
        elif sched_type == "linear":
            decay = lr32 * (_F(1.0) - frac) * (_F(1.0) - alpha32) \
                + lr32 * alpha32
        elif sched_type in ("invtime", "inverse-time"):
            decay = lr32 / (_F(1.0) + frac)
        elif sched_type == "exponential":
            rate = alpha32 if alpha > 0 else _F(0.01)
            decay = lr32 * rate ** frac
        else:
            decay = lr32
        if step < warmup_steps:
            return float(warm)
        if step < warmup_steps + plateau_steps:
            return float(lr32)
        return float(_F(decay))

    return schedule


@dataclasses.dataclass
class AdamWState:
    """optax's ``count``, ``mu`` and ``nu``, one moment pair per leaf."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class AdamW:
    """AdamW with optax.adamw semantics through the fused kernel."""

    def __init__(self, lr_schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr_schedule = lr_schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Sequence[torch.Tensor]) -> AdamWState:
        return AdamWState(0, [torch.zeros_like(p, dtype=torch.float32)
                              for p in params],
                          [torch.zeros_like(p, dtype=torch.float32)
                           for p in params])

    def apply(self, grads: Sequence[torch.Tensor], state: AdamWState,
              params: Sequence[torch.Tensor],
              grad_scale: torch.Tensor) -> AdamWState:
        """One in-place update of ``params`` and the moments;
        ``grad_scale`` (0-dim f32 tensor) multiplies every gradient."""
        lr = self.lr_schedule(state.count)
        t = _F(state.count + 1)
        inv_bc1 = _F(1.0) / (_F(1.0) - _F(self.b1) ** t)
        inv_bc2 = _F(1.0) / (_F(1.0) - _F(self.b2) ** t)
        adamw_update(params, grads, state.mu, state.nu, grad_scale, lr,
                     self.b1, self.b2, self.eps, self.weight_decay,
                     float(inv_bc1), float(inv_bc2))
        state.count += 1
        return state


@dataclasses.dataclass
class SGDState:
    """optax.sgd's state without momentum: the step count only."""

    count: int


class SGD:
    """``optax.inject_hyperparams(optax.sgd)(learning_rate=schedule)``
    (no momentum): ``p + (-lr) * (grad_scale * g)`` per leaf, with the
    rate from the schedule at the pre-increment count."""

    def __init__(self, lr_schedule: Callable[[int], float]):
        self.lr_schedule = lr_schedule

    def init(self, params: Sequence[torch.Tensor]) -> SGDState:
        return SGDState(0)

    def apply(self, grads: Sequence[torch.Tensor], state: SGDState,
              params: Sequence[torch.Tensor],
              grad_scale: torch.Tensor) -> SGDState:
        """One in-place update of ``params``; ``grad_scale`` (0-dim f32
        tensor) multiplies every gradient."""
        lr = self.lr_schedule(state.count)
        with torch.no_grad():
            updates = torch._foreach_mul([g.float() for g in grads],
                                         grad_scale)
            torch._foreach_mul_(updates, -lr)
            torch._foreach_add_(list(params), updates)
        state.count += 1
        return state


def create_optimizer(lr_schedule: Callable, optim: str = "adamw",
                     weight_decay: float = 0.0, beta1: float = 0.9,
                     beta2: float = 0.999, eps: float = 1e-8):
    """``AdamW`` (``adamw``, ``fused_adamw``; ``adam`` without weight
    decay) or ``SGD`` (``sgd``), as the JAX ``create_optimizer``."""
    if optim in ("adamw", "fused_adamw"):
        return AdamW(lr_schedule, beta1, beta2, eps, weight_decay)
    if optim == "adam":
        return AdamW(lr_schedule, beta1, beta2, eps, 0.0)
    if optim == "sgd":
        return SGD(lr_schedule)
    raise ValueError(f"Unknown optimizer {optim!r}")


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf (optax.global_norm), as a
    0-dim f32 tensor on the leaves' device."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


class TrainState:
    """The model's parameters (in ``named_parameters`` order), the
    optimizer state and the step count."""

    def __init__(self, model: torch.nn.Module, tx: Union[AdamW, SGD],
                 step: int = 0):
        self.model = model
        self.tx = tx
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        for n, p in zip(self.names, self.params):
            if p.dtype != torch.float32:
                raise TypeError(f"{n}: parameters must be float32")
        self.opt_state = tx.init(self.params)
        self.opt_state.count = step
        self.step = step

    def apply_gradients(self, grads: Union[Dict[str, torch.Tensor],
                                           Sequence[torch.Tensor]],
                        grad_scale: Union[float, torch.Tensor, None] = None,
                        clip_norm: Optional[float] = None) -> torch.Tensor:
        """Scale, clip by global norm, step. Every parameter takes part:
        a frozen one passes a zero gradient, so its moments decay and its
        weight decays, as in the JAX package. Returns the global norm of
        the scaled gradient (before clipping)."""
        if isinstance(grads, dict):
            grads = [grads[n] for n in self.names]
        dev = self.params[0].device
        scale = torch.as_tensor(1.0 if grad_scale is None else grad_scale,
                                dtype=torch.float32, device=dev)
        gnorm = global_norm(grads) * scale
        if clip_norm is not None:
            scale = scale * torch.clamp(
                clip_norm / torch.clamp(gnorm, min=1e-6), max=1.0)
        self.opt_state = self.tx.apply(grads, self.opt_state, self.params,
                                       scale)
        self.step += 1
        return gnorm

    def load_opt_state(self, count: int,
                       mu: Optional[Dict[str, torch.Tensor]] = None,
                       nu: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Take over a step count and, for AdamW, its moments (e.g. from
        the JAX package through ``models.convert.params_from_jax``; SGD
        has none)."""
        if isinstance(self.opt_state, AdamWState):
            if mu is None or nu is None:
                raise ValueError("AdamW state wants its moments")
            for i, n in enumerate(self.names):
                self.opt_state.mu[i].copy_(mu[n])
                self.opt_state.nu[i].copy_(nu[n])
        self.opt_state.count = self.step = int(count)

    @property
    def current_lr(self) -> float:
        return self.tx.lr_schedule(self.opt_state.count)
