"""Deterministic fault injection and the self-healing drills (copy of
``repro/chaos``).

``plan``   — :class:`FaultPlan` / :class:`Fault`: seeded, schedulable
             faults as pure data, with a firing log.
``inject`` — the injectors that make a plan real: at-rest checkpoint
             corruption, async-save IO failures, data-worker kills,
             NaN-poisoned server slots.

The scripted end-to-end drills live in ``repro_torch.launch.chaos``
(``python -m repro_torch.launch.chaos``); ``docs/robustness.md`` states
the fault model and the recovery contracts they pin.
"""
from repro_torch.chaos.inject import (ChaosInjectionError,
                                      checkpoint_io_hook, corrupt_checkpoint,
                                      flaky_make_batch, poison_server_slot)
from repro_torch.chaos.plan import FAULT_KINDS, Clock, Fault, FaultPlan

__all__ = ["Fault", "FaultPlan", "FAULT_KINDS", "Clock",
           "corrupt_checkpoint", "checkpoint_io_hook", "flaky_make_batch",
           "poison_server_slot", "ChaosInjectionError"]
