"""Optimizer facade + LocalOptimizer (counterpart of
``bigdl_tpu/optim/optimizer.py``: the factory, :91-222, and the
LocalOptimizer loop core, :1147-1329).

The loop: the end trigger over the driver state (epoch, neval,
is_epoch_end, loss), one eager train step per batch
(``accumulation.make_train_step``), losses kept on the device and read
back together once ``max_in_flight`` steps are pending (or at an epoch
end, a validation, the run's end), ``dataset.shuffle()`` at each epoch
end, validation on its trigger. Each drained step's log line and record
go to ``history``; each validation pass to ``validation_results``.

Not ported yet, and refused rather than ignored; each message names
the ROADMAP.md queue A item that brings it: "Single-device training
leftovers" (checkpoint and resume, remat, gradient accumulation over k >
1 microbatches, gradient clipping, input transforms, the readback
window), "Multi-card" (the distributed optimizer, ``mesh=``, pipeline
and expert parallelism, the sharded update), "The host-only planes" (the
telemetry setters: summaries, metrics server, flight recorder, profiler)
and "The rest" (the prefetching input pipeline, the AOT executable
cache). Each such setter raises ``NotImplementedError``.
"""
from __future__ import annotations

import logging
import time

import torch

from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.sgd import SGD
from bigdl_tpu_torch.optim.trigger import Trigger

logger = logging.getLogger("bigdl_tpu_torch.optim")

__all__ = ["Optimizer", "LocalOptimizer"]

# the ROADMAP.md queue A items that bring what is refused (named, not
# numbered, so a renumbering of the queue cannot stale them)
_TRAINING = "ROADMAP.md queue A, Single-device training leftovers"
_MULTI_CARD = "ROADMAP.md queue A, Multi-card"
_HOST_PLANES = "ROADMAP.md queue A, The host-only planes"
_REST = "ROADMAP.md queue A, The rest"


def _not_ported(name: str, what: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"Optimizer.{name}: {what} is not ported yet ({item})")
    method.__name__ = name
    method.__doc__ = f"Not ported yet: {what} ({item}). Raises."
    return method


class Optimizer:
    """Facade + factory: ``Optimizer(model, dataset, criterion)`` returns
    a :class:`LocalOptimizer` (one device, the model's)."""

    #: steps whose losses stay on the device before one readback
    max_in_flight = 2

    def __new__(cls, model=None, dataset=None, criterion=None,
                batch_size=None, **kw):
        if cls is Optimizer:
            if kw.get("mesh") is not None:
                raise NotImplementedError(
                    "Optimizer(mesh=...): the distributed optimizer is not "
                    f"ported yet ({_MULTI_CARD})")
            return super().__new__(LocalOptimizer)
        return super().__new__(cls)

    def __init__(self, model, dataset, criterion, batch_size=None, *,
                 mesh=None, remat_policy: str | None = None,
                 grad_accumulation: int = 1, pipeline_stages: int = 1,
                 pipeline_schedule: str = "1f1b",
                 pipeline_virtual_stages: int = 1,
                 expert_parallel: bool | str = False):
        from bigdl_tpu_torch.dataset.transformer import SampleToBatch
        if mesh is not None:
            raise NotImplementedError(
                f"mesh=: the distributed optimizer is not ported yet "
                f"({_MULTI_CARD})")
        if remat_policy not in (None, "none"):
            self.set_remat_policy(remat_policy)
        if pipeline_stages != 1 or pipeline_virtual_stages != 1 \
                or pipeline_schedule != "1f1b":
            self.set_pipeline(pipeline_stages)
        if expert_parallel:
            self.set_expert_parallel(expert_parallel)
        self.model = model
        if batch_size is not None:
            dataset = dataset >> SampleToBatch(batch_size)
        self.dataset = dataset
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger | None = None
        self.validation_trigger = None
        self.validation_dataset = None
        self.validation_methods = None
        self.grad_accumulation = 1
        self.set_grad_accumulation(grad_accumulation)
        #: one record per drained step: neval, epoch, loss, step_time,
        #: data_time, device_time (host seconds)
        self.history: list[dict] = []
        #: (neval, {method repr: ValidationResult}) per validation pass
        self.validation_results: list[tuple[int, dict]] = []
        self.opt_state = None

    # -- builder API --
    def set_validation(self, trigger, dataset, methods):
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(methods)
        return self

    def set_optim_method(self, method: OptimMethod):
        self.optim_method = method
        return self

    def set_end_when(self, end_when: Trigger):
        self.end_when = end_when
        return self

    def set_grad_accumulation(self, num_microbatches: int = 1):
        """Only ``num_microbatches=1`` (the plain step) is ported."""
        if int(num_microbatches) < 1:
            raise ValueError(
                f"num_microbatches must be >= 1, got {num_microbatches}")
        if int(num_microbatches) != 1:
            raise NotImplementedError(
                f"num_microbatches={num_microbatches}: gradient "
                f"accumulation is not ported yet ({_TRAINING})")
        self.grad_accumulation = 1
        return self

    set_state = _not_ported("set_state", "resuming from a saved state",
                            _TRAINING)
    set_checkpoint = _not_ported("set_checkpoint", "checkpointing",
                                 _TRAINING)
    overwrite_checkpoint = _not_ported("overwrite_checkpoint",
                                       "checkpointing", _TRAINING)
    set_input_pipeline = _not_ported("set_input_pipeline",
                                     "the prefetching input pipeline",
                                     _REST)
    set_input_transform = _not_ported("set_input_transform",
                                      "in-step input transforms",
                                      _TRAINING)
    set_gradient_clipping = _not_ported("set_gradient_clipping",
                                        "gradient clipping", _TRAINING)
    set_remat_policy = _not_ported("set_remat_policy", "remat policies",
                                   _TRAINING)
    set_pipeline = _not_ported("set_pipeline", "pipeline parallelism",
                               _MULTI_CARD)
    set_expert_parallel = _not_ported("set_expert_parallel",
                                      "expert parallelism", _MULTI_CARD)
    set_sharded_update = _not_ported("set_sharded_update",
                                     "the sharded weight update",
                                     _MULTI_CARD)
    set_aot_cache = _not_ported("set_aot_cache",
                                "the AOT executable cache", _REST)
    set_train_summary = _not_ported("set_train_summary", "TrainSummary",
                                    _HOST_PLANES)
    set_val_summary = _not_ported("set_val_summary", "ValidationSummary",
                                  _HOST_PLANES)
    set_metrics_server = _not_ported("set_metrics_server",
                                     "the metrics server", _HOST_PLANES)
    set_flight_recorder = _not_ported("set_flight_recorder",
                                      "the flight recorder", _HOST_PLANES)
    set_profiler = _not_ported("set_profiler", "the profiler hook",
                               _HOST_PLANES)
    set_async_dispatch = _not_ported("set_async_dispatch",
                                     "a settable readback window",
                                     _TRAINING)

    def optimize(self):
        raise NotImplementedError

    # -- shared helpers --
    @staticmethod
    def _header(epoch, count, total, neval, wallclock):
        return f"[Epoch {epoch} {count}/{total}][Iteration {neval}]" \
               f"[Wall Clock {wallclock:.3f}s]"

    def _dispatch_window(self) -> int:
        """``max_in_flight`` unless a trigger reads the loss, which then
        needs every step's value (lockstep)."""
        for t in (self.end_when, self.validation_trigger):
            if t is not None and "loss" in getattr(t, "requires", ()):
                return 1
        return self.max_in_flight

    def _drain_pending(self, pending: list, driver_state: dict) -> None:
        """Read every pending loss back in one transfer, then log and
        record each step under its own neval. The wait is shared evenly
        across the drained steps."""
        if not pending:
            return
        t0 = time.perf_counter()
        losses = torch.stack([e["loss"] for e in pending]).cpu().tolist()
        share = (time.perf_counter() - t0) / len(pending)
        for e, loss in zip(pending, losses):
            e["device_time"] += share
            e["step_time"] += share
            if logger.isEnabledFor(logging.INFO):
                logger.info(
                    self._header(e["epoch"], e["count"], e["epoch_size"],
                                 e["neval"], e["wallclock"])
                    + f" loss is {loss:.6f}, iteration time is "
                    f"{e['step_time']:.4f}s, host input time is "
                    f"{e['data_time']:.4f}s, device step time is "
                    f"{e['device_time']:.4f}s, throughput is "
                    f"{e['n'] / max(e['step_time'], 1e-9):.2f} "
                    "records/second")
            self.history.append({
                "neval": e["neval"], "epoch": e["epoch"], "loss": loss,
                "n": e["n"], "step_time": e["step_time"],
                "data_time": e["data_time"],
                "device_time": e["device_time"]})
            driver_state["loss"] = loss
        pending.clear()

    def _validate(self, device, driver_state):
        model = self.model
        results = [None] * len(self.validation_methods)
        count = 0
        t0 = time.perf_counter()
        model.evaluate()
        try:
            with torch.no_grad():
                for batch in self.validation_dataset.data(train=False):
                    data, labels = _to_device(batch, device)
                    out = model(data)
                    count += data.shape[0]
                    for i, m in enumerate(self.validation_methods):
                        r = m(out, labels)
                        results[i] = r if results[i] is None \
                            else results[i] + r
        finally:
            model.train()
        elapsed = time.perf_counter() - t0
        logger.info(f"validate model throughput is "
                    f"{count / max(elapsed, 1e-9):.2f} records/second")
        for m, r in zip(self.validation_methods, results):
            logger.info(f"{m!r} is {r!r}")
        out = dict(zip([repr(m) for m in self.validation_methods], results))
        self.validation_results.append((driver_state["neval"], out))
        return out


def _to_device(batch, device):
    return (torch.as_tensor(batch.data).to(device),
            torch.as_tensor(batch.labels).to(device))


class LocalOptimizer(Optimizer):
    """Single-device training loop on the model's device."""

    def optimize(self):
        model, optim = self.model, self.optim_method
        from bigdl_tpu_torch.optim.accumulation import make_train_step
        device = next(model.parameters()).device
        model.train()
        params = dict(model.named_parameters())
        driver_state = {"epoch": 1, "neval": 1, "is_epoch_end": False,
                        "loss": float("inf")}
        opt_state = optim.init_state(params)
        train_step = make_train_step(
            fwd=model, criterion=self.criterion, params=params,
            update_fn=optim.update,
            num_microbatches=self.grad_accumulation)

        epoch_size = self.dataset.size()
        count_this_epoch = 0
        batches = self.dataset.data(train=True)
        window = self._dispatch_window()
        pending: list[dict] = []
        wallclock_start = time.perf_counter()
        while self.end_when is None or not self.end_when(driver_state):
            driver_state["is_epoch_end"] = False
            t0 = time.perf_counter()
            data, labels = _to_device(next(batches), device)
            t1 = time.perf_counter()
            n = int(data.shape[0])
            opt_state, loss = train_step(opt_state, data, labels,
                                         driver_state["epoch"])
            t2 = time.perf_counter()
            count_this_epoch += n
            pending.append({"epoch": driver_state["epoch"],
                            "count": count_this_epoch,
                            "epoch_size": epoch_size,
                            "neval": driver_state["neval"],
                            "wallclock": t2 - wallclock_start,
                            "loss": loss, "n": n, "step_time": t2 - t0,
                            "data_time": t1 - t0, "device_time": t2 - t1})
            if len(pending) >= window:
                self._drain_pending(pending, driver_state)
            driver_state["neval"] += 1
            if count_this_epoch >= epoch_size:
                self._drain_pending(pending, driver_state)
                driver_state["epoch"] += 1
                driver_state["is_epoch_end"] = True
                count_this_epoch = 0
                self.dataset.shuffle()
                batches = self.dataset.data(train=True)
            if (self.validation_trigger is not None
                    and self.validation_dataset is not None
                    and self.validation_trigger(driver_state)):
                self._drain_pending(pending, driver_state)
                self._validate(device, driver_state)
        self._drain_pending(pending, driver_state)
        self.opt_state = opt_state
        model.evaluate()
        return model
