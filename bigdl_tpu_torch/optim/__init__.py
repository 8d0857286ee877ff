"""Training loop, optim methods, triggers and validation of the port
(counterpart of ``bigdl_tpu/optim``)."""
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.optimizer import LocalOptimizer, Optimizer
from bigdl_tpu_torch.optim.sgd import (SGD, CosineAnnealing, Default,
                                       EpochDecay, EpochSchedule, EpochStep,
                                       Poly, Regime, Step, Warmup)
from bigdl_tpu_torch.optim.trigger import (Trigger, and_trigger, every_epoch,
                                           max_epoch, max_iteration,
                                           min_loss, or_trigger,
                                           several_iteration)
from bigdl_tpu_torch.optim.validation import (Loss, LossResult,
                                              ValidationMethod,
                                              ValidationResult)

__all__ = ["OptimMethod", "SGD", "Default", "Step", "EpochStep",
           "EpochDecay", "Poly", "Regime", "EpochSchedule", "Warmup",
           "CosineAnnealing", "Trigger", "every_epoch", "several_iteration",
           "max_epoch", "max_iteration", "min_loss", "or_trigger",
           "and_trigger", "ValidationMethod", "ValidationResult",
           "LossResult", "Loss", "Optimizer", "LocalOptimizer"]
