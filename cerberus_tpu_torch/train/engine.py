"""Event-driven run engine.

Counterpart of ``cerberus_tpu/train/engine.py`` (reference
``run_utils/engine.py``): the ``Events`` set (:7-14), a ``State`` carrying
step/epoch counters, per-step tracked outputs and chained parent links
(:17-80), and ``RunEngine.run``, which walks the loaders, fires the
callbacks and nests (a validation engine triggered mid-training with shared
state, :140-216).

``NetHolder`` carries the ``TrainStep`` (model, optimizer, update count),
the ``torch.Generator`` that draws the dropout masks (the JAX holder's
PRNG key) and the train-state writer. ``State.wait_seconds`` and
``State.step_seconds`` split a run's wall time into waiting for the
loader's next batch and the step itself.
"""
from __future__ import annotations

import logging
import time
from enum import Enum
from typing import Callable, Dict, Optional

import torch

from ..models.convert import TrainStateWriter


class Events(Enum):
    EPOCH_STARTED = "epoch_started"
    EPOCH_COMPLETED = "epoch_completed"
    STEP_STARTED = "step_started"
    STEP_COMPLETED = "step_completed"
    STARTED = "started"
    COMPLETED = "completed"
    EXCEPTION_RAISED = "exception_raised"


class NetHolder:
    """What the engine and callbacks share about one network: the train
    step (``train_step.model``, ``.optimizer``, ``.count``), the dropout
    generator, the settings' ``extra_info`` and the checkpoint writer."""

    def __init__(self, train_step=None, generator: Optional[torch.Generator]
                 = None, extra_info=None, cfg=None):
        self.train_step = train_step
        self.generator = generator
        self.extra_info = extra_info or {}
        self.cfg = cfg
        self.writer = TrainStateWriter()

    @property
    def model(self):
        return self.train_step.model

    @property
    def step(self) -> int:
        return self.train_step.count

    @property
    def lr(self) -> float:
        if self.train_step is None:
            return float("nan")
        return float(self.train_step.lr)


class State:
    """Shared mutable state passed to every callback."""

    def __init__(self):
        self.logging = None
        self.log_dir = None
        self.log_info = None

        self.loader_name = None
        self.curr_epoch_step = 0
        self.curr_global_step = 0
        self.curr_epoch = 0

        self.tracked_step_output = {"scalar": {}, "image": {}}
        self.epoch_accumulated_output = []
        self.run_accumulated_output = []
        self.step_output = None
        self.global_state = None
        self.run_info: Dict = {}
        self.batch_size = None
        self.wait_seconds = 0.0
        self.step_seconds = 0.0

    def reset_variable(self, reset_tracker: bool = False) -> None:
        self.tracked_step_output = {k: {} for k in self.tracked_step_output}
        if reset_tracker:
            self.curr_epoch_step = 0
            self.curr_global_step = 0
            self.curr_epoch = 0
        self.epoch_accumulated_output = []
        self.step_output = None

    def get_top_parent_state(self) -> "State":
        curr = self
        while curr is not None:
            prev = curr
            curr = curr.global_state
        return prev


class RunEngine:
    def __init__(self, engine_name: str, loader_dict: Dict,
                 run_step: Callable, run_info: Dict,
                 log_info: Optional[Dict] = None,
                 separate_loader_output: bool = True):
        self.engine_name = engine_name
        self.run_step = run_step
        self.loader_dict = loader_dict
        self.separate_loader_output = separate_loader_output

        self.state = State()
        self.state.attached_engine_name = engine_name
        self.state.run_info = run_info
        self.state.log_info = log_info

        self.event_handler_dict = {event: [] for event in Events}
        self.terminate = False

    def add_event_handler(self, event_name: Events, handler) -> None:
        self.event_handler_dict[event_name].append(handler)

    def _trigger_events(self, event: Events) -> None:
        for callback in self.event_handler_dict[event]:
            callback.run(self.state, event)

    def _batches(self, loader):
        """The loader's batches, its waits added to ``wait_seconds``."""
        batches = iter(loader)
        while True:
            start = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                return
            finally:
                self.state.wait_seconds += time.perf_counter() - start
            yield batch

    def run(self, nr_epoch: int = 1, shared_state: Optional[State] = None,
            chained: bool = False) -> None:
        if chained:
            self.state.curr_epoch = 0
        self.state.global_state = shared_state

        self._trigger_events(Events.STARTED)
        while self.state.curr_epoch < nr_epoch:
            if not chained:
                logging.info("EPOCH %d", self.state.curr_epoch + 1)
            self.state.reset_variable(reset_tracker=chained)

            for loader_name, loader in self.loader_dict.items():
                if self.separate_loader_output:
                    self.state.reset_variable(reset_tracker=chained)
                self.state.batch_size = getattr(loader, "batch_size", None)
                self._trigger_events(Events.EPOCH_STARTED)

                for data_batch in self._batches(loader):
                    self._trigger_events(Events.STEP_STARTED)
                    step_run_info = [
                        self.state.run_info,
                        {"epoch": self.state.curr_epoch,
                         "step": self.state.curr_global_step},
                    ]
                    start = time.perf_counter()
                    self.state.step_output = self.run_step(data_batch,
                                                           step_run_info)
                    self.state.step_seconds += time.perf_counter() - start
                    if self.separate_loader_output:
                        self.state.loader_name = loader_name
                    self._trigger_events(Events.STEP_COMPLETED)
                    self.state.curr_global_step += 1
                    self.state.curr_epoch_step += 1

                if self.separate_loader_output:
                    self.state.curr_epoch += 1
                    self._trigger_events(Events.EPOCH_COMPLETED)

            if not self.separate_loader_output:
                self.state.curr_epoch += 1
                self.state.loader_name = None
                self._trigger_events(Events.EPOCH_COMPLETED)

            self.state.run_accumulated_output.append(
                self.state.epoch_accumulated_output)
        self._trigger_events(Events.COMPLETED)
        # a top-level run returns with every checkpoint it scheduled on
        # disk; a chained (validation) run does not wait for them
        if not chained:
            for net in self.state.run_info.values():
                net.writer.flush()
