"""Triggers: predicates over the training state (counterpart of
``bigdl_tpu/optim/trigger.py``, all of it).

Reference parity: optim/Trigger.scala:21-70 — ``everyEpoch``,
``severalIteration(n)``, ``maxEpoch(n)``, ``maxIteration(n)``.
State keys follow the reference's state Table: ``neval`` (iteration count),
``epoch``, plus ``is_epoch_end`` maintained by the optimizers.

``requires`` declares which DEVICE-produced state keys a trigger reads
(``min_loss`` -> ``{"loss"}``); combinators union their children's sets.
The train loop consults it: a
trigger that reads ``loss`` forces a readback every iteration so the
stopping decision sees the true per-step value, while the default
``max_epoch``/``max_iteration`` paths — pure host counters — let the
loop dispatch ahead without ever syncing.
"""
from __future__ import annotations

__all__ = ["Trigger", "every_epoch", "several_iteration", "max_epoch",
           "max_iteration", "min_loss", "or_trigger", "and_trigger"]


class Trigger:
    def __init__(self, fn, desc="", requires=frozenset()):
        self._fn = fn
        self._desc = desc
        #: device-produced state keys the predicate reads (e.g. "loss")
        self.requires = frozenset(requires)

    def __call__(self, state) -> bool:
        return bool(self._fn(state))

    def __repr__(self):
        return f"Trigger({self._desc})"


def every_epoch() -> Trigger:
    """Fires at each epoch boundary (reference Trigger.everyEpoch —
    implemented there with a cached epoch counter; here the optimizers set
    ``is_epoch_end``)."""
    return Trigger(lambda s: s.get("is_epoch_end", False), "everyEpoch")


def several_iteration(interval: int) -> Trigger:
    """(reference Trigger.severalIteration)"""
    return Trigger(lambda s: s["neval"] % interval == 0,
                   f"severalIteration({interval})")


def max_epoch(n: int) -> Trigger:
    """(reference Trigger.maxEpoch)"""
    return Trigger(lambda s: s["epoch"] > n, f"maxEpoch({n})")


def max_iteration(n: int) -> Trigger:
    """(reference Trigger.maxIteration)"""
    return Trigger(lambda s: s["neval"] > n, f"maxIteration({n})")


def min_loss(value: float) -> Trigger:
    return Trigger(lambda s: s.get("loss", float("inf")) < value,
                   f"minLoss({value})", requires={"loss"})


def _combined(op, name, triggers):
    desc = f"{name}({', '.join(t._desc for t in triggers)})"
    requires = frozenset().union(
        *(getattr(t, "requires", frozenset()) for t in triggers))
    return Trigger(lambda s: op(t(s) for t in triggers), desc,
                   requires=requires)


def or_trigger(*triggers: Trigger) -> Trigger:
    return _combined(any, "or", triggers)


def and_trigger(*triggers: Trigger) -> Trigger:
    return _combined(all, "and", triggers)
