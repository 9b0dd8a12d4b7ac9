"""Fault-tolerant training loop: checkpoint/restart, the straggler
watchdog, simulated failure injection.  The port's counterpart of
``repro.runtime.fault_tolerance``.

Recovery model: any failure kills the step; the job restarts from the newest
committed checkpoint and the stateless data pipeline (counter -> batch)
resumes at exactly the next step.  ``run_with_restarts`` drives that loop in
one process, so the whole mechanism is testable: it injects failures and
gives the uninterrupted run's loss curve bitwise.

The server also feeds the ``StragglerWatchdog`` the wall time of every
dispatched batch, taken after the batch's results reached the host, and
counts the batches it flags.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt as ckpt_lib


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor: flags steps slower than `threshold`x the mean.

    The flag is recorded for the metrics log (``SearchServer.n_stragglers``,
    ``launch.train``'s step lines) and asserted on in tests.
    """
    alpha: float = 0.1
    threshold: float = 3.0
    ewma: float | None = None
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.flagged.append((step, dt))
        return slow


class InjectedFailure(RuntimeError):
    pass


def train_loop(state: dict, n_steps: int, step_fn: Callable,
               batch_fn: Callable, ckpt_dir: str, *, start_step: int = 0,
               ckpt_every: int = 10, fail_at: int | None = None,
               watchdog: StragglerWatchdog | None = None,
               metrics_log: list | None = None) -> dict:
    """Run steps [start_step, n_steps); checkpoint every `ckpt_every`.

    `state` = {"params": ..., "opt": ...}.  Raises InjectedFailure at step
    `fail_at` AFTER the step (a mid-interval crash, the worst case: the work
    since the last checkpoint is lost).  A step function may update the
    state in place (the port's ``train_step`` does); the checkpointer copies
    it to the host before the next step runs.
    """
    saver = ckpt_lib.AsyncCheckpointer(ckpt_dir)
    watchdog = watchdog or StragglerWatchdog()
    for step in range(start_step, n_steps):
        t0 = time.time()
        batch = batch_fn(step)
        params, opt, metrics = step_fn(state["params"], state["opt"], batch)
        state = {"params": params, "opt": opt}
        watchdog.observe(step, time.time() - t0)
        if metrics_log is not None:
            metrics_log.append((step, {k: float(v) for k, v in metrics.items()}))
        if fail_at is not None and step == fail_at:
            # the write in flight ends first: in one process, the restarted
            # job's checkpointer would otherwise write the same step's
            # directory beside this one's thread
            saver.wait()
            raise InjectedFailure(f"injected node failure at step {step}")
        if (step + 1) % ckpt_every == 0:
            saver.save_async(step + 1, state)
    saver.wait()
    ckpt_lib.save(ckpt_dir, n_steps, state)    # final commit
    return state


def run_with_restarts(init_state: dict, n_steps: int, step_fn, batch_fn,
                      ckpt_dir: str, *, ckpt_every: int = 10,
                      failures: tuple[int, ...] = (),
                      metrics_log: list | None = None) -> dict:
    """The whole job: on a failure, restore the newest checkpoint, each leaf
    onto the device its ``init_state`` leaf is on, and resume — the restart
    path a cluster runtime would drive.  Without a checkpoint yet, the job
    starts again from ``init_state``.  The job runs on copies of
    ``init_state``'s tensors, so a ``step_fn`` that updates its state in
    place leaves the caller's ``init_state`` as it was (at the cost of a
    second copy of the state).
    """
    device = ckpt_lib.tree_map(_device_of, init_state)
    state = ckpt_lib.tree_map(_copy, init_state)
    start = 0
    pending = list(failures)
    while True:
        fail_at = pending[0] if pending else None
        try:
            state = train_loop(state, n_steps, step_fn, batch_fn, ckpt_dir,
                               start_step=start, ckpt_every=ckpt_every,
                               fail_at=fail_at, metrics_log=metrics_log)
            return state
        except InjectedFailure:
            pending.pop(0)
            try:
                state, restored_step = ckpt_lib.restore(ckpt_dir, state,
                                                        device=device)
            except FileNotFoundError:
                state = ckpt_lib.tree_map(_copy, init_state)
                restored_step = 0
            start = restored_step


def _device_of(leaf) -> torch.device:
    return leaf.device if isinstance(leaf, torch.Tensor) else \
        torch.device("cpu")


def _copy(leaf):
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf
