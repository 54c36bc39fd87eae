"""The port's dry run: the op counter, the kernels' meta charges, the
roofline search step against the reference's, every reduced config counted
on meta, reduced LM cells' FLOPs against the reference's HLO count, the
per-device argument and collective bytes, and the report.

The reference runs in one subprocess (its dry-run module gives it 512 host
devices), started with the module's first test so that it overlaps the
counts made here; the tests that read it come last."""
import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.launch import roofline as ref_rl
from repro_torch.configs import ARCHS, get_reduced, optimizer_for
from repro_torch.core.distributed import make_roofline_search_step, roofline_search_specs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_knn as fk
from repro_torch.launch import dryrun, op_cost, report
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_test_mesh

from conftest import assert_same_results

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = ((1, 1), (1, 2), (1, 4), (2, 4))
N, D, M, K = 4096, 32, 64, 10
PREFILL = ("minicpm-2b", 4, 16)  # arch, batch, seq_len of the argument-bytes cell
# the LM cells counted against the reference's HLO on a (1, 1) mesh: one arch
# each of the dense, moe and ssm families, at batch × seq_len in microbatches
LM_ARCHS = ("minicpm-2b", "deepseek-moe-16b", "mamba2-130m")
LM = (4, 16, 2)

_HEADER = """
import json, sys
import numpy as np
import repro.launch.dryrun as rd  # sets XLA_FLAGS (512 host devices) before jax loads
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_reduced, optimizer_for
from repro.core.distributed import make_roofline_search_step, roofline_search_specs
from repro.distributed.sharding import ShardingRules, tree_param_specs, use_rules
from repro.launch import hlo_cost
from repro.launch.mesh import make_test_mesh
from repro.models import api
from repro.train.optimizer import OptConfig, init_opt
from repro.train.train_step import TrainConfig, make_train_step


def shardings(mesh, tree, rules):
    specs = tree_param_specs(tree, rules)
    return rd._sds(tree, jax.tree.map(lambda s: NamedSharding(mesh, s), specs, is_leaf=lambda x: isinstance(x, P)))


out = {}
"""

# the roofline search step on every mesh, and the prefill cell's argument bytes
_SEARCH = _HEADER + """
data = np.load(sys.argv[1])
for shape in %(meshes)r:
    mesh = make_test_mesh(shape, ("data", "model"))
    for metric in ("ip", "l2"):
        step = make_roofline_search_step(mesh, k=%(k)d, metric=metric)
        with mesh:
            s, i = step(jnp.asarray(data["db"]), jnp.asarray(data["bitmap"]), jnp.asarray(data["queries"]))
        tag = "%%dx%%d/%%s" %% (shape[0], shape[1], metric)
        out[tag + "/scores"], out[tag + "/ids"] = np.asarray(s).tolist(), np.asarray(i).tolist()
        if shape == (2, 4):
            n, d = data["db"].shape
            sds = roofline_search_specs(mesh, n=n, d=d, m=data["queries"].shape[0])
            with mesh:
                hc = hlo_cost.analyze(step.lower(*sds).compile().as_text())
            out[tag + "/coll"] = {k: int(v) for k, v in hc.coll.items()}
            out[tag + "/flops"] = hc.flops
arch, batch, seq = %(prefill)r
cfg = get_reduced(arch)
mesh = make_test_mesh((2, 4), ("data", "model"))
rules = ShardingRules(mesh=mesh, fsdp=False, fsdp_stacked=False)
p0 = api.params_specs(cfg)
ps = jax.tree.map(lambda s: NamedSharding(mesh, s), tree_param_specs(p0, rules), is_leaf=lambda x: isinstance(x, P))
b0 = api.input_specs(cfg, "prefill", batch=batch, seq_len=seq)
with mesh, use_rules(rules):
    c = jax.jit(lambda p, b: api.serve_prefill(p, cfg, b)).lower(
        rd._sds(p0, ps), rd._sds(b0, rd._batch_sharding(mesh, b0, batch))).compile()
out["prefill_argument_bytes"] = int(c.memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
""" % dict(meshes=MESHES, k=K, prefill=PREFILL)

# the LM cells' FLOPs on a (1, 1) mesh
_LM = _HEADER + """
one = make_test_mesh((1, 1), ("data", "model"))
rules = ShardingRules(mesh=one, fsdp=False, fsdp_stacked=False)
B, S, MB = %(lm)r
for arch in %(lm_archs)r:
    cfg = get_reduced(arch)
    p0 = api.params_specs(cfg)
    with one, use_rules(rules):
        tcfg = TrainConfig(opt=OptConfig(name=optimizer_for(arch)), microbatches=MB)
        t0 = api.input_specs(cfg, "train", batch=B, seq_len=S)
        b0 = api.input_specs(cfg, "prefill", batch=B, seq_len=S)
        d0 = api.input_specs(cfg, "decode", batch=B, seq_len=S)
        token = rd._sds({"t": d0["token"]}, rd._batch_sharding(one, {"t": d0["token"]}, B))["t"]
        lowered = {
            "train": jax.jit(make_train_step(cfg, tcfg)).lower(
                shardings(one, p0, rules), shardings(one, jax.eval_shape(lambda q: init_opt(q, tcfg.opt), p0), rules),
                rd._sds(t0, rd._batch_sharding(one, t0, B))),
            "prefill": jax.jit(lambda q, b: api.serve_prefill(q, cfg, b)).lower(
                shardings(one, p0, rules), rd._sds(b0, rd._batch_sharding(one, b0, B))),
            "decode": jax.jit(lambda q, t, c: api.serve_decode(q, cfg, t, c)).lower(
                shardings(one, p0, rules), token, rd._sds(d0["cache"], rd._cache_sharding(one, cfg, d0["cache"], B))),
        }
        for kind, low in lowered.items():
            out[arch + "/" + kind + "/flops"] = hlo_cost.analyze(low.compile().as_text()).flops
print(json.dumps(out))
""" % dict(lm=LM, lm_archs=LM_ARCHS)


def _inputs():
    rng = np.random.default_rng(33)
    return {"db": rng.normal(size=(N, D)).astype(np.float32),
            "bitmap": rng.random(N) < 0.5,
            "queries": rng.normal(size=(M, D)).astype(np.float32)}


class _Reference:
    """A reference subprocess running ``script``, its output to a file,
    read once."""

    def __init__(self, script: str):
        self.dir = tempfile.TemporaryDirectory()
        path = os.path.join(self.dir.name, "inputs.npz")
        np.savez(path, **_inputs())
        env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
        env.pop("XLA_FLAGS", None)
        self.out = open(os.path.join(self.dir.name, "out.txt"), "w+")
        self.proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(script), path],
                                     stdout=self.out, stderr=subprocess.STDOUT, text=True, env=env)
        self._res = None

    def result(self) -> dict:
        if self._res is None:
            rc = self.proc.wait(timeout=600)
            self.out.seek(0)
            text = self.out.read()
            assert rc == 0, text
            self._res = json.loads(text.strip().splitlines()[-1])
        return self._res

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.dir.cleanup()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain scans here are many small ops: one intra-op thread keeps
    them from waiting on each other when the suite runs in several
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def reference():
    """Started with the module's first test, so that it overlaps the counts
    made here; the tests that read it come last."""
    ref = _Reference(_SEARCH)
    yield ref
    ref.close()


@pytest.fixture(scope="module", autouse=True)
def reference_lm():
    """The LM cells' reference, beside ``reference``."""
    ref = _Reference(_LM)
    yield ref
    ref.close()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------------ the counter


def test_python_loop_of_matmuls_counts_every_iteration():
    """A Python loop of 12 [256,256] matmuls counts 12·2·256³ FLOPs, every
    iteration as it runs (the counterpart of test_hlo_cost_trip_counts)."""
    a, b = _meta(256, 256), _meta(256, 256)

    def loop(x, w):
        for _ in range(12):
            x = x @ w
        return x

    _, cost = op_cost.count(loop, a, b)
    assert cost.flops == 12 * 2 * 256**3
    assert cost.flops_by_dtype == {"f32": 12 * 2 * 256**3}
    _, half = op_cost.count(loop, a.bfloat16(), b.bfloat16())
    assert half.flops_by_dtype == {"bf16": 12 * 2 * 256**3}


def test_views_are_free_and_an_add_reads_and_writes_once():
    a, b = _meta(64, 32), _meta(64, 32)
    for view in (lambda x: x.view(-1), lambda x: x.t(), lambda x: x.reshape(32, 64), lambda x: x[3],
                 lambda x: x.unsqueeze(0).expand(2, 64, 32), lambda x: x.detach()):
        assert op_cost.count(view, a)[1].bytes == 0
    copy = op_cost.count(lambda x: x.t().reshape(64 * 32), a)[1]  # a reshape that must copy
    assert copy.bytes == 2 * 64 * 32 * 4
    _, add = op_cost.count(torch.add, a, b)
    assert add.bytes == 3 * 64 * 32 * 4
    _, bcast = op_cost.count(torch.add, a, _meta(1, 32).expand(64, 32))
    assert bcast.bytes == (2 * 64 * 32 + 32) * 4  # the broadcast operand read once
    _, fill = op_cost.count(lambda x: x.zero_(), a)
    assert fill.bytes == 64 * 32 * 4  # written, not read


def test_indexing_touches_only_the_rows_it_indexes():
    """A gather reads its output's size of the table; an in-place scatter
    (a KV-cache write) writes its values' size; an add-scatter reads them
    too."""
    table, idx = _meta(1000, 64), _meta(10, dtype=torch.int64)
    _, gather = op_cost.count(lambda t, i: t[i], table, idx)
    assert gather.bytes == 10 * 64 * 4 + 10 * 8 + 10 * 64 * 4
    _, sel = op_cost.count(lambda t, i: t.index_select(0, i), table, idx)
    assert sel.bytes == gather.bytes
    cache, vals = _meta(4, 1000, 64, dtype=torch.bfloat16), _meta(4, 64, dtype=torch.bfloat16)
    rows, pos = _meta(4, dtype=torch.int64), _meta(4, dtype=torch.int64)

    def write(c, r, p, v):
        c[r, p] = v

    _, put = op_cost.count(write, cache, rows, pos, vals)
    assert put.bytes == 2 * 4 * 8 + 4 * 64 * 2 + 4 * 64 * 2
    _, add = op_cost.count(lambda t, i, v: t.index_add_(0, i, v), table, idx, _meta(10, 64))
    assert add.bytes == 10 * 8 + 10 * 64 * 4 + 2 * 10 * 64 * 4


def test_peak_of_live_bytes_follows_allocations_and_frees():
    def seq():
        x = torch.empty(1000, device="meta")  # 4,000 live
        y = torch.empty(2000, device="meta")  # 12,000
        del x  # 8,000
        z = torch.empty(500, device="meta")  # 10,000
        w = torch.empty(256, dtype=torch.float64, device="meta")  # 12,048
        return y, z, w

    _, cost = op_cost.count(seq)
    assert cost.peak_bytes == 12_048


def test_per_device_division_by_registered_axes():
    """A registered leaf divides by its own shard count, a tensor of its
    shape alike (a gradient, a bf16 cast), everything else by the chips."""
    w, x = _meta(128, 64), _meta(32, 128)
    _, cost = op_cost.count(lambda x, w: (x @ w, w * 2.0), x, w, chips=8, registered=[([w], 4)])
    matmul = 32 * 128 * 4 / 8 + 128 * 64 * 4 / 4 + 32 * 64 * 4 / 8
    scale = 2 * 128 * 64 * 4 / 4  # read w, write a w-shaped f32 tensor
    assert cost.bytes == matmul + scale
    _, cast = op_cost.count(lambda w: w.bfloat16(), w, chips=8, registered=[([w], 4)])
    assert cast.bytes == 128 * 64 * (4 + 2) / 4
    assert cost.flops == 2 * 32 * 128 * 64 / 8


# ------------------------------------------------------------ kernels on meta


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("wrapper", [fk.fused_knn, fk.fused_knn_db_stationary])
def test_scan_meta_charge(wrapper, k):
    """2·TQ·TV·D a unit and pass; operands read each pass, outputs once;
    no launch counted, empty outputs of the kernel's types."""
    W, TQ, TV, Dd = 3, 8, 256, 16
    q, v, valid = _meta(W, TQ, Dd), _meta(W, TV, Dd), _meta(W, TV, dtype=torch.bool)
    live = _meta(W, dtype=torch.int32)
    before = wrapper.launches
    (s, i), cost = op_cost.count(lambda: wrapper(q, v, valid, k=k, n_live=live))
    passes = -(-k // fk.MAX_K)
    assert wrapper.launches == before
    assert (s.shape, s.dtype, i.dtype, s.device.type) == ((W, TQ, k), torch.float32, torch.int32, "meta")
    assert cost.kernels == {wrapper.__name__: 1}
    assert cost.flops_by_dtype == {"f32": 2.0 * W * TQ * TV * Dd * passes}
    operands = (W * TQ * Dd + W * TV * Dd) * 4 + W * TV + W * 4
    assert cost.bytes == operands * passes + W * TQ * k * 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window,dh", [(True, 0, 64), (True, 5, 64), (False, 0, 320)])
def test_attention_meta_charges(dtype, causal, window, dh):
    """Forward 4·dh and backward 10·dh a kept pair and query head at the
    input type; FlashAttentionFn on meta under grad charges both."""
    B, S, T, Hq, Hkv = 2, 24, 24, 4, 2
    q = torch.empty((B, S, Hq, dh), dtype=dtype, device="meta", requires_grad=True)
    k = torch.empty((B, T, Hkv, dh), dtype=dtype, device="meta", requires_grad=True)
    v = torch.empty((B, T, Hkv, dh), dtype=dtype, device="meta", requires_grad=True)
    kept = fa.kept_pairs(S, T, causal, window)
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window else 0
    assert kept == int(np.sum(np.minimum(i, T - 1) + 1 - lo)) if causal else kept == S * T
    es = torch.empty((), dtype=dtype).element_size()

    def step():
        o = fa.flash_attention(q, k, v, causal=causal, window=window)
        o.sum().backward()
        return o

    launches = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    o, cost = op_cost.count(step)
    assert (fa.flash_attention.launches, fa.flash_attention_backward.launches) == launches
    assert o.shape == q.shape and q.grad.shape == q.shape and k.grad.shape == k.shape
    name = "flash_attention_wide" if fa.wide_head(dh) else "flash_attention"
    assert cost.kernels == {name: 1, "flash_attention_backward": 1}
    key = "bf16" if dtype == torch.bfloat16 else "f32"
    assert cost.flops_by_dtype[key] == 14.0 * dh * Hq * B * kept
    # the charges alone: fwd q,k,v,o,lse; bwd q,k,v,o,dO,lse read, dq,dk,dv written
    _, fwd = op_cost.count(lambda: fa.flash_attention(q.detach(), k.detach(), v.detach(), causal=causal,
                                                      window=window, return_lse=True))
    qb, kb = B * S * Hq * dh * es, B * T * Hkv * dh * es
    assert fwd.bytes == qb + 2 * kb + qb + B * Hq * S * 4
    _, bwd = op_cost.count(lambda: fa.flash_attention_backward(
        q.detach(), k.detach(), v.detach(), q.detach(), q.detach(), _meta(B, Hq, S), causal=causal, window=window))
    assert bwd.bytes == 3 * qb + 2 * kb + B * Hq * S * 4 + qb + 2 * kb
    assert bwd.flops == 10.0 * dh * Hq * B * kept


def test_cpu_tensors_take_the_plain_versions_and_charge_nothing():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 4, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 64, 8)).astype(np.float32))
    calls = fk.fused_knn_plain.calls
    _, cost = op_cost.count(lambda: fk.fused_knn(q, v, torch.ones(2, 64, dtype=torch.bool), k=3))
    assert cost.kernels == {} and fk.fused_knn_plain.calls == calls + 1


# ------------------------------------------------------------ every reduced config


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reduced_configs_count_on_meta(arch):
    """Train, prefill and decode of each reduced config run to their end on
    a (2, 4) meta mesh, with positive FLOPs and bytes; model_flops and
    total_params equal the reference's. Every config with attention charges
    its kernels: in training the forward twice a backward (the forward and
    the checkpoint's recompute), in prefill the forward alone."""
    cfg, ref_cfg = get_reduced(arch), ref_get_reduced(arch)
    mesh = make_test_mesh((2, 4), ("data", "model"), device="meta")
    assert rl.total_params(cfg) == ref_rl.total_params(ref_cfg)
    for kind in ("train", "prefill", "decode"):
        terms, cost, argument_bytes = dryrun.count_lm(
            cfg, kind, mesh, batch=4, seq_len=16, microbatches=2 if kind == "train" else 1,
            optimizer=optimizer_for(arch))
        assert terms.model_flops == ref_rl.model_flops(ref_cfg, kind, 4, 16)
        assert cost.flops > 0 and cost.bytes > 0 and argument_bytes > 0, kind
        assert terms.compute_s > 0 and terms.bottleneck in ("compute", "memory", "collective")
        if kind == "train":
            assert cost.peak_bytes > 0
        if cfg.family == "ssm" or kind == "decode":
            continue
        forward = [name for name in cost.kernels if name.startswith("flash_attention") and "backward" not in name]
        assert len(forward) == 1, cost.kernels
        if kind == "train":
            backward = cost.kernels.get("flash_attention_backward", 0)
            assert backward > 0 and backward % 2 == 0, cost.kernels  # a multiple of the microbatches
            assert cost.kernels == {forward[0]: 2 * backward, "flash_attention_backward": backward}
        else:
            assert cost.kernels == {forward[0]: cost.kernels[forward[0]]}


def test_lm_collectives_match_a_hand_count_on_reduced_deepseek():
    """Reduced deepseek-moe-16b trained on a (2, 4) meta mesh, batch 4 ×
    16 in 2 microbatches: rows a device and pass 4 / 2 / 2 = 1, so 16
    tokens; passes: 4 forward (2 microbatches, each recomputed), 2 backward."""
    cfg = get_reduced("deepseek-moe-16b")
    mesh = make_test_mesh((2, 4), ("data", "model"), device="meta")
    terms, _, _ = dryrun.count_lm(cfg, "train", mesh, batch=4, seq_len=16, microbatches=2)
    d, f, fe, fs, e, k = cfg.d_model, cfg.d_ff, cfg.moe.d_ff_expert, cfg.moe.d_ff_shared, cfg.moe.n_experts, cfg.moe.top_k
    qkv = cfg.n_heads * cfg.dh
    assert (d, qkv, f, fs, fe, e) == (64, 64, 256, 64, 32, 8)  # every dim a multiple of |model| = 4
    tok, act, fwd, bwd = 16, 2, 4, 2
    row = tok * d * act  # a row-parallel output, or a column-parallel input's gradient
    cap = int(max(1, (16 * k * cfg.moe.capacity_factor) // e))  # per-shard capacity: 16 tokens a shard
    erow = e * cap * d * act
    # row-parallel wo, w_down forward; column-parallel inputs backward, once a block: attn
    # (wq, wk, wv), mlp (w_up, w_gate)
    dense_layer = 2 * row * fwd + 2 * row * bwd
    moe_layer = (2 * row * fwd + 2 * row * bwd  # attention and the shared experts
                 + erow * fwd + erow * bwd)  # the experts' w_down; w_up and w_gate's input
    tp = dense_layer + 2 * moe_layer + row * fwd  # + the vocab-sharded embedding
    f32 = 4  # gradients of the replicated leaves, all-reduced over "data" each microbatch
    grads = (cfg.vocab * d / 4 + d  # embedding, final norm
             + (2 * d + 4 * d * qkv / 4 + 3 * d * f / 4)  # the dense layer
             + 2 * (2 * d + 4 * d * qkv / 4 + d * e + 3 * d * fs / 4)) * f32 * 2
    assert terms.coll_breakdown == {"all-reduce": int(tp + grads), "all-to-all": 2 * (e * cap * d) * act * 2 * 6}


def test_full_size_hqi_cell_counts_on_the_production_mesh():
    """hqi_100m_online4k on the 16×16 meta mesh: one device's work is
    256 queries against 6.25M rows."""
    res = dryrun.count_cell("hqi-search", "hqi_100m_online4k", False)
    r = res["roofline"]
    assert r["flops_per_dev"] == 2.0 * 256 * 6_250_000 * 128
    assert r["coll_breakdown"] == {"all-gather": 16 * 256 * K * 8}
    assert res["memory"]["argument_size_in_bytes"] == 6_250_000 * (128 * 4 + 1) + 256 * 128 * 4
    assert res["kernels"] == {"fused_knn_db_stationary": 16} and res["fits_80gb"]


def test_report_renders_the_results_file(tmp_path):
    path = tmp_path / "results.json"
    argv = ["--arch", "hqi-search", "--shape", "hqi_100m_online4k", "--mesh", "single", "--out", str(path)]
    first = dryrun.main(argv)
    rerun = dryrun.main(argv)  # a finished cell is skipped
    assert list(rerun) == ["hqi-search|hqi_100m_online4k|single"] and rerun == first
    table = report.main(["--results", str(path)])
    assert "| hqi-search|hqi_100m_online4k | 0.006 |" in table and "≤80G" in table
    ab = report.main(["--results", str(path), "--ab", str(path)])
    assert "| hqi-search|hqi_100m_online4k |" in ab and "1.0×" in ab


# ------------------------------------------------------------ against the reference


def _port_step(shape, metric, device):
    data = _inputs()
    mesh = make_test_mesh(shape, ("data", "model"), device=device)
    step = make_roofline_search_step(mesh, k=K, metric=metric)
    return step(*(torch.from_numpy(data[key]) for key in ("db", "bitmap", "queries")))


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("shape", MESHES)
def test_roofline_step_matches_reference(reference, shape, metric):
    ref = reference.result()
    tag = f"{shape[0]}x{shape[1]}/{metric}"
    s, i = _port_step(shape, metric, "cpu")
    assert s.shape == (M, K) and i.dtype == torch.int64
    assert_same_results(s.numpy(), i.numpy(), np.asarray(ref[tag + "/scores"], np.float32),
                        np.asarray(ref[tag + "/ids"]))


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_roofline_step_counts_match_reference_hlo(reference, metric):
    """On a (2, 4) meta mesh: collective bytes equal the reference's HLO
    count exactly, FLOPs within 1%."""
    ref = reference.result()
    mesh = make_test_mesh((2, 4), ("data", "model"), device="meta")
    tensors, axes = roofline_search_specs(mesh, n=N, d=D, m=M)
    assert axes == (("model", None), ("model",), (("data",), None))
    (s, i), cost = op_cost.count(make_roofline_search_step(mesh, k=K, metric=metric), *tensors, chips=8)
    assert s.device.type == "meta" and tuple(s.shape) == (M, K)
    assert rl.collective_bytes("hqi-search", mesh.shape, m=M, k=K) == ref[f"2x4/{metric}/coll"]
    assert abs(cost.flops - ref[f"2x4/{metric}/flops"]) <= 0.01 * ref[f"2x4/{metric}/flops"]


def test_prefill_argument_bytes_match_reference(reference):
    """A reduced prefill cell on a (2, 4) mesh without FSDP: argument bytes
    per device equal the reference's ``memory_analysis()``."""
    arch, batch, seq = PREFILL
    mesh = make_test_mesh((2, 4), ("data", "model"), device="meta")
    _, _, argument_bytes = dryrun.count_lm(get_reduced(arch), "prefill", mesh, batch=batch, seq_len=seq)
    assert argument_bytes == reference.result()["prefill_argument_bytes"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_flops_match_reference_hlo(reference_lm, monkeypatch, arch, kind):
    """A reduced LM cell on a (1, 1) mesh, where no work is replicated,
    counted by the port and by the reference's ``hlo_cost`` of the same
    step. Each gap is worked out:

    * attention: the reference's masked softmax computes every (query, key)
      pair; the port's kernels charge only the kept ones. Charged at every
      pair (``kept_pairs`` patched to S·T) the port's count meets the
      reference's. The difference is 4·dh a dropped pair and query head in
      each forward pass and 10·dh in each backward: 18·dh in training (the
      forward, the checkpoint's recompute, the backward), 4·dh in prefill,
      none in decode (which launches no attention kernel);
    * moe training: XLA drops, from the checkpoint's recomputed forward, the
      shared experts' down projection of each moe layer, whose output the
      backward never reads; eager recomputation runs it, 2·tokens·
      d_ff_shared·d more a moe layer (with remat off the counts are equal);
    * ssm training: JAX's transpose of the reference's chunked SSD einsums
      issues other products than autograd of the port's, so the backward's
      counts differ (the forward's are equal: prefill and decode match
      exactly). They agree within 2%; leaving out the backward, the
      recompute or a microbatch moves the count by 25% or more."""
    batch, seq, mb = LM
    cfg = get_reduced(arch)
    assert cfg.window_pattern is None  # causal attention over the whole prefix
    mesh = make_test_mesh((1, 1), ("data", "model"), device="meta")

    def count():
        return dryrun.count_lm(cfg, kind, mesh, batch=batch, seq_len=seq, microbatches=mb if kind == "train" else 1,
                               optimizer=optimizer_for(arch))[1]

    kept = count()
    monkeypatch.setattr(fa, "kept_pairs", lambda s, t, causal, window: s * t)
    every = count()
    attention_layers = 0 if cfg.family == "ssm" else cfg.n_layers
    per_pair = {"train": 18, "prefill": 4, "decode": 0}[kind] * cfg.dh * cfg.n_heads * batch
    assert every.flops - kept.flops == per_pair * attention_layers * (seq * seq - seq * (seq + 1) // 2)
    ref = reference_lm.result()[f"{arch}/{kind}/flops"]
    if kind == "train" and cfg.family == "moe":
        moe_layers = cfg.n_layers - cfg.moe_first_dense
        assert every.flops - ref == moe_layers * 2 * batch * seq * cfg.moe.d_ff_shared * cfg.d_model
    elif kind == "train" and cfg.family == "ssm":
        assert abs(every.flops - ref) <= 0.02 * ref
    else:
        assert every.flops == ref
