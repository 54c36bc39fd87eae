"""Fault tolerance: retrying step execution, elastic re-meshing, and the
resilient train loop (checkpoint/restart + deterministic data replay).

The counterpart of ``repro.train.fault_tolerance`` (the compressed
data-parallel step, ``dp_train_step_compressed``, is not ported yet:
ROADMAP.md §1, the rest of the LM scaffolding).
  * Checkpoint/restart — ``TrainLoop`` saves async every N steps and resumes
    from the newest complete checkpoint; data is a pure function of step, so
    replay after restart is exact.
  * Node failure — on any step exception the loop retries the step.
  * Elastic meshes — ``elastic_mesh`` builds the largest mesh of the
    preferred shape that the visible devices allow, shrinking the data axis
    first.

``TrainLoop`` trains on "cuda" unless told otherwise; without a card it
raises and never moves to the CPU.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import DataConfig, SyntheticLM
from ..launch.mesh import Mesh, _mesh
from ..models.transformer import ModelConfig
from . import checkpoint as ckpt
from .train_step import TrainConfig, init_train_state, make_train_step

log = logging.getLogger("repro_torch.train")


def with_retries(fn: Callable, max_retries: int = 2, on_failure: Optional[Callable] = None):
    def wrapped(*a, **kw):
        err = None
        for attempt in range(max_retries + 1):
            try:
                return fn(*a, **kw)
            except Exception as e:  # noqa: BLE001 — any device/step failure
                err = e
                log.warning("step failed (attempt %d/%d): %s", attempt + 1, max_retries + 1, e)
                if on_failure is not None:
                    on_failure(attempt, e)
        raise err

    return wrapped


def default_ckpt_dir() -> str:
    """Under the temporary directory (``TMPDIR``), as the reference's
    ``/tmp/repro_ckpt``."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class LoopConfig:
    ckpt_dir: str = dataclasses.field(default_factory=default_ckpt_dir)
    ckpt_every: int = 50
    log_every: int = 10
    max_retries: int = 2
    async_ckpt: bool = True


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("TrainLoop on 'cuda' needs a CUDA device; this machine has none "
                           "(pass device='cpu' to train on the CPU)")
    return dev


class TrainLoop:
    """Resilient single-controller loop: the state is {"params" (f32 masters),
    "opt", "step"} on ``device``; each step's batch is
    ``SyntheticLM.batch(step, shard=0)``."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        tcfg: TrainConfig,
        dcfg: DataConfig,
        loop_cfg: Optional[LoopConfig] = None,
        *,
        seed: int = 0,
        device="cuda",
    ):
        self.device = _device(device)
        self.model_cfg, self.tcfg, self.dcfg = model_cfg, tcfg, dcfg
        self.loop_cfg = loop_cfg if loop_cfg is not None else LoopConfig()
        self.data = SyntheticLM(dcfg)
        self.step_fn = make_train_step(model_cfg, tcfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params, opt_state = init_train_state(model_cfg, tcfg, gen)
        self.state = {"params": params, "opt": opt_state, "step": 0}
        self.metrics_history = []

    def maybe_restore(self) -> bool:
        last = ckpt.latest_step(self.loop_cfg.ckpt_dir)
        if last is None:
            return False
        self.state, step = ckpt.restore(self.loop_cfg.ckpt_dir, self.state)
        self.state["step"] = step
        log.info("restored checkpoint at step %d", step)
        return True

    def run(self, n_steps: int, fail_injector: Optional[Callable[[int], None]] = None):
        lc = self.loop_cfg
        start = int(self.state["step"])

        def one_step(step: int):
            if fail_injector is not None:
                fail_injector(step)  # tests: raise to simulate node failure
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in self.data.batch(step, shard=0).items()}
            p, o, m = self.step_fn(self.state["params"], self.state["opt"], batch)
            self.state.update(params=p, opt=o, step=step + 1)
            return m

        guarded = with_retries(one_step, lc.max_retries)
        for step in range(start, start + n_steps):
            m = guarded(step)
            if step % lc.log_every == 0:
                mm = {k: float(v) for k, v in m.items()}
                self.metrics_history.append({"step": step, **mm})
                log.info("step %d: %s", step, mm)
            if lc.ckpt_every and (step + 1) % lc.ckpt_every == 0:
                if lc.async_ckpt:
                    ckpt.save_async(lc.ckpt_dir, step + 1, self.state)
                else:
                    ckpt.save(lc.ckpt_dir, step + 1, self.state)
        ckpt.wait_pending(lc.ckpt_dir)
        return self.metrics_history


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------


def elastic_mesh(preferred_shape: Tuple[int, ...], axis_names: Tuple[str, ...], device="cuda") -> Mesh:
    """The largest mesh of ``axis_names`` that fits the devices actually
    visible (every card for "cuda", which raises without one; the one host
    device otherwise) — degraded-fleet restarts shrink the first (data) axis
    first."""
    dev = _device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    n = len(devices)
    shape = list(preferred_shape)
    total = int(np.prod(shape))
    while total > n and shape[0] > 1:
        shape[0] //= 2
        total = int(np.prod(shape))
    if total > n:
        shape = [1] * (len(shape) - 1) + [n]
        total = n
    return _mesh(devices[:total], tuple(shape), tuple(axis_names))
