"""The training loop: checkpoint and restart, step retries, stragglers.

Counterpart of `repro.train.trainer`, plain Python around one step function
so that every control-plane feature is visible and testable:

  * periodic background checkpoints (params + optimizer state), committed
    atomically, and always one at the last step;
  * recovery: `resume()` restores the newest committed checkpoint and the
    data stream replays from the step counter (`batch_at(step)` is
    deterministic, so the restart is exact);
  * StepGuard retries transient failures; when its retries run out the
    loop restores the last commit and continues, at most `max_restores`
    times for a step that never completes;
  * StragglerMonitor flags slow steps; a heartbeat file marks liveness;
  * a failure injection hook for tests (fail_at / fail_exc / fail_times);
  * data-parallel ranks (`mesh`): every rank runs the loop; rank 0 alone
    writes the checkpoints, and every rank passes a barrier once rank 0's
    last save has committed, before it restores and at the end of `fit`.
    With a ZeRO-1 `layout` (`distributed.data_parallel.Zero1`) every rank
    gathers the moments (under FSDP the params too) for each save, so that
    rank 0 writes whole arrays in the reference's format, and each rank
    restores only its shards.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.distributed.fault_tolerance import HeartbeatFile, StepGuard, StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    log_every: int = 10
    max_retries: int = 2
    # a step that fails this many times without ever completing is a
    # deterministic fault and re-raises; completing a step resets its budget
    max_restores: int = 3
    heartbeat: str | None = None


@dataclasses.dataclass
class Trainer:
    step_fn: Callable            # (params, opt_state, batch) -> (params, opt_state, metrics)
    batch_at: Callable[[int], Any]
    cfg: TrainerConfig
    fail_at: int | None = None               # test hook: raise at this step
    fail_exc: Exception | None = None
    fail_times: int = 1                      # > max_retries exhausts the StepGuard
    on_checkpoint: Callable[[int], None] | None = None   # after each committed save
    mesh: Any = None                         # a data mesh (launch.mesh.HostMesh)
    layout: Any = None                       # its ZeRO-1 layout of the opt state

    def __post_init__(self):
        self.ckpt = Checkpointer(self.cfg.ckpt_dir, keep_last=self.cfg.keep_last)
        self.monitor = StragglerMonitor()
        self.guard = StepGuard(max_retries=self.cfg.max_retries)
        self.hb = HeartbeatFile(self.cfg.heartbeat) if self.cfg.heartbeat else None
        self.history: list[dict] = []
        self._fail_count = 0
        self._restores_at_step: dict[int, int] = {}

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def _committed(self) -> None:
        """Wait for an in-flight background save to commit (rank 0's), then,
        on a mesh, for every rank."""
        self.ckpt.wait()
        if self.mesh is not None:
            self.mesh.barrier()

    def _save(self, step: int, params: Any, opt_state: Any) -> None:
        tree = {"params": params, "opt": opt_state}
        if self.layout is not None:
            tree = self.layout.gather_state(tree)
        if self.rank == 0:
            self.ckpt.save(step, tree, on_commit=self.on_checkpoint)

    def resume(self, params: Any, opt_state: Any) -> tuple[int, Any, Any]:
        """Restore the newest committed checkpoint if there is one."""
        self._committed()
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, params, opt_state
        cuts = None if self.layout is None else self.layout.cuts(params)
        _, tree = self.ckpt.restore({"params": params, "opt": opt_state}, step=latest,
                                    shardings=cuts)
        return latest, tree["params"], tree["opt"]

    def fit(self, params: Any, opt_state: Any, *, start_step: int | None = None):
        step, params, opt_state = (
            (start_step, params, opt_state) if start_step is not None
            else self.resume(params, opt_state))
        while step < self.cfg.total_steps:
            batch = self.batch_at(step)
            t0 = time.time()

            def run(step=step, batch=batch, params=params, opt_state=opt_state):
                if self.fail_at == step and self._fail_count < self.fail_times:
                    self._fail_count += 1
                    raise (self.fail_exc or RuntimeError("injected failure"))
                return self.step_fn(params, opt_state, batch)

            try:
                params, opt_state, metrics = self.guard.run(run)
            except RuntimeError:
                # retries exhausted: restore the last commit and continue. With
                # nothing committed there is nothing to restore, and a step
                # that keeps failing over max_restores restores is a
                # deterministic fault: re-raise in both cases.
                self.ckpt.wait()
                if self.ckpt.latest_step() is None:
                    raise
                n = self._restores_at_step.get(step, 0) + 1
                self._restores_at_step[step] = n
                if n > self.cfg.max_restores:
                    raise
                step, params, opt_state = self.resume(params, opt_state)
                continue

            self._restores_at_step.pop(step, None)
            rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
            dt = time.time() - t0               # float() above waited for the step
            slow = self.monitor.record(step, dt)
            rec.update(seconds=dt, straggler=slow)
            self.history.append(rec)
            if self.hb:
                self.hb.beat(step, loss=rec["loss"])
            if self.rank == 0 and self.cfg.log_every and step % self.cfg.log_every == 0:
                # the learned temperature falls toward 0 (the argmax limit) as
                # centroid learning sharpens (paper section 3.2)
                temp = (f" t {rec['t_mean']:.3f}/{rec['t_min']:.3f}"
                        if "t_mean" in rec else "")
                kl = f" kl {rec['distill_kl']:.4f}" if "distill_kl" in rec else ""
                print(f"step {step:6d} loss {rec['loss']:.4f} "
                      f"gnorm {rec['grad_norm']:.3f}{temp}{kl} {dt*1e3:.0f}ms"
                      + (" [straggler]" if slow else ""), flush=True)
            step += 1
            if step % self.cfg.ckpt_every == 0 or step == self.cfg.total_steps:
                self._save(step, params, opt_state)
        self._committed()
        return params, opt_state
