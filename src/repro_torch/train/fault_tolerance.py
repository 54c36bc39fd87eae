"""Fault tolerance: retrying step execution, elastic re-meshing, and the
resilient train loop (checkpoint/restart + deterministic data replay).

The counterpart of ``repro.train.fault_tolerance``.
  * Checkpoint/restart — ``TrainLoop`` saves async every N steps and resumes
    from the newest complete checkpoint; data is a pure function of step, so
    replay after restart is exact.
  * Node failure — on any step exception the loop retries the step.
  * Elastic meshes — ``elastic_mesh`` builds the largest mesh of the
    preferred shape that the visible devices allow, shrinking the data axis
    first.
  * Compressed data parallelism — ``dp_train_step_compressed`` exchanges
    int8 error-feedback gradients over the mesh's data ranks.

``TrainLoop`` trains on "cuda" unless told otherwise; without a card it
raises and never moves to the CPU.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import DataConfig, SyntheticLM
from ..distributed import compression as comp
from ..launch.mesh import Mesh, _mesh, canonical_device
from ..models import api
from ..models.transformer import ModelConfig
from ..models.tree import leaves, tree_map
from . import checkpoint as ckpt
from .optimizer import OptConfig, apply_opt, clip_by_global_norm
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


# ---------------------------------------------------------------------------
# compressed data-parallel train step (over the mesh's "data" ranks)
# ---------------------------------------------------------------------------


def dp_train_step_compressed(model_cfg: ModelConfig, opt_cfg: OptConfig, mesh: Mesh):
    """Pure data-parallel step with int8 + error-feedback gradient exchange.

    Returns step(params, opt_state, residuals, batch) -> (params, opt_state,
    residuals, {"loss", "grad_norm"}). Single-controller over
    ``mesh.axis_devices("data")``, as the sharded engine uses the mesh:
    the batch splits along dim 0 in rank order (the reference's
    ``P("data")``); each rank computes ``api.loss_fn`` and its f32
    gradients on its device, then ``compress_tree`` with its own residual;
    ``allreduce_compressed`` averages the int8 payloads on rank 0's device.
    The averaged gradients are the same on every rank, so the clip and the
    optimizer update run once, in place, on the replicated ``params`` and
    ``opt_state`` (f32 masters, as ``make_train_step`` wants). The loss is
    the ranks' mean (``pmean``). Every data rank must sit on the parameters'
    device (``make_test_mesh``: ranks on one card, or on the CPU); a mesh
    whose ranks span devices raises.

    ``residuals`` is one tree per rank, in rank order
    (``[comp.zero_residual(params) for _ in range(n)]`` to start): each
    rank keeps its own
    quantization error, as each device of the reference keeps
    its shard of the residual it returns under ``out_specs=P()`` (which
    reads on the host as rank 0's). Like the parameters and the optimizer
    state, the residuals are updated in place and returned."""
    devices = mesh.axis_devices("data")
    n = len(devices)

    def step(params, opt_state, residuals, batch: Dict[str, torch.Tensor]):
        if len(residuals) != n:
            raise ValueError(f"{len(residuals)} residual trees for {n} data ranks")
        ps = leaves(params)
        for p in ps:
            if p.dtype != torch.float32:
                raise TypeError(f"dp_train_step_compressed wants f32 masters; got a {p.dtype} leaf")
        b = batch["tokens"].shape[0]
        if b % n:
            raise ValueError(f"global batch {b} does not split over {n} data ranks")
        per = b // n
        home = ps[0].device
        if any(canonical_device(dev) != home for dev in devices):
            raise ValueError(f"data ranks on {devices}; every rank must sit on the parameters' device {home}")
        qs, ss, losses = [], [], []
        for r in range(n):
            for p in ps:
                p.requires_grad_(True)
                p.grad = None
            shard = {k: x[r * per:(r + 1) * per].to(home) for k, x in batch.items()}
            loss, _ = api.loss_fn(params, model_cfg, shard)
            loss.backward()
            grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), params)
            q, s, res = comp.compress_tree(grads, residuals[r])
            for p in ps:
                p.grad = None
            del grads
            with torch.no_grad():  # each rank's residual is updated in place
                for old, new in zip(leaves(residuals[r]), leaves(res)):
                    old.copy_(new)
            del res
            qs.append(q)
            ss.append(s)
            losses.append(loss.detach())
        grads, gnorm = clip_by_global_norm(comp.allreduce_compressed(qs, ss), opt_cfg.clip_norm)
        params, opt_state = apply_opt(params, grads, opt_state, opt_cfg)
        return params, opt_state, residuals, {"loss": torch.stack(losses).mean(), "grad_norm": gnorm}

    return step
