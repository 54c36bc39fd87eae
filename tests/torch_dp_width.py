"""How far int8 error-feedback data parallelism falls behind the uncompressed
step as the model widens, in the reference and in the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_dp_width.py --d 1024 --vocab 32000

minicpm-2b's wiring at width ``--d`` (heads of 64, d_ff 2.5 d), ``--layers``
layers and vocabulary ``--vocab``; AdamW at ``--lr`` (warmup 2, cosine over
30); 12 steps of ``SyntheticLM`` batches of 8 x ``--seq`` over four data
ranks. The reference runs its own ``dp_train_step_compressed`` on four
virtual host devices (a subprocess) and ``make_train_step`` with four
microbatches; the port runs its counterparts on the CPU from the same
weights (``params_from_jax``). Prints one JSON object: each side's 12
losses, compressed and uncompressed, the gap at step 12, and the share of
zero int8 codes in each of the reference's leaves at step 2.
"""
import argparse
import json
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

COMMON = """
import dataclasses, json, sys
import numpy as np, jax
from repro.configs import get_config as jget_config
from repro.data.pipeline import DataConfig, SyntheticLM
a = json.loads(sys.argv[1])
kw = dict(n_layers=a["layers"], d_model=a["d"], n_heads=a["d"] // 64, n_kv_heads=a["d"] // 64,
          d_ff=int(a["d"] * 2.5), vocab=a["vocab"], q_chunk=128, kv_chunk=128)
jcfg = dataclasses.replace(jget_config("minicpm-2b"), **kw)
data = SyntheticLM(DataConfig(vocab=a["vocab"], seq_len=a["seq"], global_batch=8))
"""

REFERENCE = COMMON + """
import jax.numpy as jnp
from repro.distributed.compression import compress_tree, zero_residual
from repro.launch.mesh import make_test_mesh
from repro.models import api
from repro.train.fault_tolerance import dp_train_step_compressed
from repro.train.optimizer import OptConfig, init_opt
from repro.train.train_step import TrainConfig, make_train_step
ocfg = OptConfig(peak_lr=a["lr"], warmup_steps=2, total_steps=30)
params = api.init_model(jcfg, jax.random.key(0))
step_c = dp_train_step_compressed(jcfg, ocfg, make_test_mesh((4,), ("data",)))
step_u = jax.jit(make_train_step(jcfg, TrainConfig(opt=ocfg, microbatches=4)))
pc, oc, res = params, init_opt(params, ocfg), zero_residual(params)
pu, ou = params, init_opt(params, ocfg)
out = {"compressed": [], "uncompressed": []}
for s in range(12):
    batch = {k: jnp.asarray(v) for k, v in data.batch(s).items()}
    with make_test_mesh((4,), ("data",)):
        pc, oc, res, mc = step_c(pc, oc, res, batch)
    pu, ou, mu = step_u(pu, ou, batch)
    out["compressed"].append(float(mc["loss"]))
    out["uncompressed"].append(float(mu["loss"]))
    if s == 1:
        g = jax.grad(lambda p: api.loss_fn(p, jcfg, {k: v[:2] for k, v in batch.items()})[0])(pu)
        q, _, _ = compress_tree(g, zero_residual(g))
        out["zero_code_share"] = {"/".join(str(getattr(k, "key", k)) for k in path): float(jnp.mean(x == 0))
                                  for path, x in jax.tree_util.tree_flatten_with_path(q)[0]}
print(json.dumps(out))
"""

PORT = COMMON + """
import torch
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.distributed.compression import zero_residual
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.tree import leaves
from repro_torch.train.fault_tolerance import dp_train_step_compressed
from repro_torch.train.optimizer import OptConfig, init_opt
from repro_torch.train.train_step import TrainConfig, make_train_step
cfg = dataclasses.replace(get_config("minicpm-2b"), **kw)
tree = jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.key(0)))
ocfg = OptConfig(peak_lr=a["lr"], warmup_steps=2, total_steps=30)
out = {}
for kind in ("compressed", "uncompressed"):
    params = params_from_jax(tree, cfg, device="cpu", masters=True)
    for p in leaves(params):
        p.requires_grad_(True)
    state, res = init_opt(params, ocfg), [zero_residual(params) for _ in range(4)]
    step_c = dp_train_step_compressed(cfg, ocfg, make_test_mesh((4,), ("data",), device="cpu"))
    step_u = make_train_step(cfg, TrainConfig(opt=ocfg, microbatches=4))
    out[kind] = []
    for s in range(12):
        batch = {k: torch.from_numpy(v) for k, v in data.batch(s).items()}
        if kind == "compressed":
            params, state, res, m = step_c(params, state, res, batch)
        else:
            params, state, m = step_u(params, state, batch)
        out[kind].append(float(m["loss"]))
print(json.dumps(out))
"""


def run(code: str, args: dict, devices: int) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), json.dumps(args)],
                       capture_output=True, text=True, env=env, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=32_000)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = vars(ap.parse_args(argv))
    ref, port = run(REFERENCE, args, 4), run(PORT, args, 1)
    gap = lambda r: r["compressed"][-1] - r["uncompressed"][-1]
    print(json.dumps({"args": args, "reference": ref, "port": port,
                      "gap_at_step_12": {"reference": gap(ref), "port": gap(port)}}))


if __name__ == "__main__":
    main()
