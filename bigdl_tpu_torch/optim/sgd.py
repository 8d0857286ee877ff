"""SGD with learning-rate schedules (counterpart of
``bigdl_tpu/optim/sgd.py:25-375``): weight decay, momentum / dampening /
nesterov, and the schedules Default (1/(1 + neval·decay)), Step,
EpochStep, EpochDecay, Poly, Warmup, CosineAnnealing and EpochSchedule.

The schedule is evaluated on the host from the state's counters and
rounded to float32 (Default's decay in float32 arithmetic, as the JAX
step computes it on the device), then every parameter is updated in
place. The JAX package's concatenated small-leaf update is an XLA
launch-count optimisation with no counterpart here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from bigdl_tpu_torch.optim.optim_method import OptimMethod

__all__ = ["SGD", "Default", "Step", "EpochStep", "EpochDecay", "Poly",
           "Regime", "EpochSchedule", "Warmup", "CosineAnnealing"]


class LearningRateSchedule:
    def __call__(self, lr, neval, epoch):
        raise NotImplementedError

    def effective(self) -> "LearningRateSchedule":
        """The schedule whose type governs SGD's special cases (Default
        decay, EpochSchedule weight-decay regimes); wrappers (Warmup)
        return their inner schedule."""
        return self


@dataclass
class Default(LearningRateSchedule):
    """clr = lr / (1 + neval * decay); SGD applies the decay."""

    def __call__(self, lr, neval, epoch):
        return lr


@dataclass
class Step(LearningRateSchedule):
    """clr = lr * gamma^floor(neval / step_size)."""
    step_size: int
    gamma: float

    def __call__(self, lr, neval, epoch):
        return lr * self.gamma ** math.floor(neval / self.step_size)


@dataclass
class EpochStep(LearningRateSchedule):
    """clr = lr * gamma^floor((epoch-1) / step_size)."""
    step_size: int
    gamma: float

    def __call__(self, lr, neval, epoch):
        return lr * self.gamma ** math.floor((epoch - 1) / self.step_size)


@dataclass
class EpochDecay(LearningRateSchedule):
    """clr = lr * 0.1^decay_fn(epoch)."""
    decay_fn: Callable

    def __call__(self, lr, neval, epoch):
        return lr * 0.1 ** self.decay_fn(epoch)


@dataclass
class Poly(LearningRateSchedule):
    """clr = lr * (1 - neval/max_iteration)^power."""
    power: float
    max_iteration: int

    def __call__(self, lr, neval, epoch):
        frac = min(neval / self.max_iteration, 1.0)
        return lr * (1.0 - frac) ** self.power


@dataclass
class Warmup(LearningRateSchedule):
    """Linear warmup over ``warmup_iterations``, then ``after``."""
    warmup_iterations: int
    after: LearningRateSchedule = field(default_factory=Default)

    def __call__(self, lr, neval, epoch):
        if neval < self.warmup_iterations:
            return lr * min((neval + 1) / self.warmup_iterations, 1.0)
        return self.after(lr, neval - self.warmup_iterations, epoch)

    def effective(self):
        return self.after.effective()


@dataclass
class CosineAnnealing(LearningRateSchedule):
    """clr = min_lr + (lr - min_lr) * (1 + cos(pi * t/T)) / 2."""
    max_iteration: int
    min_lr: float = 0.0

    def __call__(self, lr, neval, epoch):
        frac = min(max(neval, 0) / self.max_iteration, 1.0)
        return self.min_lr + (lr - self.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * frac))


@dataclass
class Regime:
    """[start_epoch, end_epoch] -> config overrides."""
    start_epoch: int
    end_epoch: int
    config: dict = field(default_factory=dict)


@dataclass
class EpochSchedule(LearningRateSchedule):
    """Piecewise-per-epoch config regimes."""
    regimes: list

    def _pick(self, key, base, epoch):
        out = base
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                out = r.config.get(key, base)
        return out

    def __call__(self, lr, neval, epoch):
        return self._pick("learningRate", lr, epoch)

    def weight_decay(self, base_wd, epoch):
        return self._pick("weightDecay", base_wd, epoch)


class SGD(OptimMethod):
    """Stochastic gradient descent. ``learning_rates`` /
    ``weight_decays``: per-parameter scales and decays, each a dict keyed
    by parameter name (every parameter) or one number for all."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0,
                 momentum: float = 0.0,
                 dampening: float | None = None,
                 nesterov: bool = False,
                 learning_rate_schedule: LearningRateSchedule | None = None,
                 learning_rates=None, weight_decays=None):
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default()
        self.learning_rates = learning_rates
        self.weight_decays = weight_decays
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError(
                "Nesterov momentum requires momentum > 0 and dampening = 0 "
                "(reference SGD.scala requirement)")

    def init_state(self, params):
        state = {"neval": 0, "epoch": 1}
        if self.momentum > 0:
            state["velocity"] = {n: torch.zeros_like(p)
                                 for n, p in params.items()}
        return state

    def current_lr(self, state) -> float:
        """This step's learning rate, rounded to float32."""
        neval, epoch = int(state["neval"]), int(state["epoch"])
        lr = self.schedule(self.learning_rate, neval, epoch)
        if isinstance(self.schedule.effective(), Default):
            # decay from the post-warmup iteration count, across every
            # Warmup layer; float32 arithmetic as the JAX step does it
            sched = self.schedule
            while isinstance(sched, Warmup):
                neval -= sched.warmup_iterations
                sched = sched.after
            f32 = np.float32
            lr = f32(lr) / (f32(1.0) + f32(max(neval, 0))
                            * f32(self.learning_rate_decay))
        return float(np.float32(lr))

    @staticmethod
    def _per_param(spec, names):
        if spec is None or isinstance(spec, (int, float)):
            return {n: spec for n in names}
        if set(spec) != set(names):
            raise ValueError(
                "SGD: per-parameter hyperparameters must name every "
                f"parameter; missing {sorted(set(names) - set(spec))}, "
                f"unknown {sorted(set(spec) - set(names))}")
        return spec

    def update(self, grads, params, state):
        clr = self.current_lr(state)
        wd = self.weight_decay
        eff = self.schedule.effective()
        if isinstance(eff, EpochSchedule):
            wd = eff.weight_decay(wd, int(state["epoch"]))
        mom, damp = self.momentum, self.dampening
        names = list(params)
        if set(grads) != set(names):
            raise ValueError("SGD.update: gradients and parameters name "
                             "different tensors")
        lrs = self._per_param(self.learning_rates, names)
        wds = self._per_param(self.weight_decays, names)
        velocity = state.get("velocity") if mom > 0 else None
        new_velocity = {}
        with torch.no_grad():
            for n in names:
                p, g = params[n], grads[n]
                wd_eff = wd if wds[n] is None else wds[n]
                if wd_eff:
                    g = g + wd_eff * p
                if mom > 0:
                    v = mom * velocity[n] + (1.0 - damp) * g
                    g = g + mom * v if self.nesterov else v
                    new_velocity[n] = v
                step = clr * g
                if lrs[n] is not None:
                    step = step * lrs[n]
                p.sub_(step)
        new_state = dict(state, neval=int(state["neval"]) + 1)
        if mom > 0:
            new_state["velocity"] = new_velocity
        return new_state
