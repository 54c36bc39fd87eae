"""The port's data-parallel training against the reference, on the CPU: the
int8 error-feedback compression (``distributed/compression.py``) bit-equal
to ``repro.distributed.compression``; ``allreduce_compressed`` against the
reference's run under ``jax.vmap(..., axis_name="data")``;
``dp_train_step_compressed`` on the reduced minicpm over four data ranks
against the reference's own functions composed on one device; the
reference's 12-step compressed-vs-uncompressed check on the port; and the
logical-axis rules (``distributed/sharding.py``) against the reference's
specs."""
import dataclasses
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.distributed import compression as jcomp
from repro.distributed import sharding as jsharding
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch.configs import get_reduced
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import _mesh, make_test_mesh
from repro_torch.models import api
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.tree import leaves, leaves_with_paths, tree_map
from repro_torch.train import optimizer as topt
from repro_torch.train.fault_tolerance import dp_train_step_compressed
from repro_torch.train.train_step import TrainConfig, make_train_step

RANKS = 4


def _tree(seed, scale=1.0):
    """A nested dict/list of f32 arrays, one leaf all zeros (the 1e-12 clamp);
    keys in sorted order, so the port's leaf order is jax's."""
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return {"a": n(16, 8), "b": n(5), "layers": [{"w": n(4, 4, 3)}, {"w": n(4, 4, 3)}],
            "z": np.zeros((3, 2), np.float32)}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


# ------------------------------------------------------------- compression


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 3e4)])
def test_quantize_int8_bit_equal_to_reference(seed, scale):
    """The int8 codes and the scale are the reference's, bit for bit; so is
    the dequantized tensor."""
    x = (np.random.default_rng(seed).normal(size=(64, 33)) * scale).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]  # halves: round half to even
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    q, s = comp.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.dim() == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(comp.dequantize_int8(q, s).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js)))


def test_compress_tree_matches_reference():
    """Codes and scales bit-equal, the new residual within 1e-7, on a nested
    tree with a nonzero residual and an all-zero leaf; the port's per-layer
    leaves against the reference's stacked ones (one scale over the layers)."""
    g, r = _tree(3), _tree(4, scale=0.01)
    stacked = lambda tree: jax.tree.map(jnp.asarray, params_to_numpy(_t(tree)))
    jq, js, jr = jcomp.compress_tree(stacked(g), stacked(r))
    q, s, res = comp.compress_tree(_t(g), _t(r))
    assert q["layers"][0]["w"].dtype == torch.int8 and s["layers"][0]["w"] is s["layers"][1]["w"]
    for a, b in zip(jax.tree.leaves(params_to_numpy(q)), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(params_to_numpy(s)), jax.tree.leaves(js)):
        assert np.all(a == float(b))
    for a, b in zip(jax.tree.leaves(params_to_numpy(res)), jax.tree.leaves(jr)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-7)
    assert all(float(x.abs().max()) == 0 for x in (q["z"], res["z"]))


def test_allreduce_compressed_matches_vmapped_reference():
    """Four ranks' payloads: the port's gather and mean against the
    reference's ``allreduce_compressed`` under ``jax.vmap(axis_name=)``
    (every rank's output the same; rank 0's taken) within 1e-6."""
    payloads = [comp.compress_tree(_t(_tree(10 + r, scale=r + 1.0)), comp.zero_residual(_t(_tree(0))))
                for r in range(RANKS)]
    qs, ss = [p[0] for p in payloads], [p[1] for p in payloads]
    got = comp.allreduce_compressed(qs, ss)
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x.numpy()) for x in xs]), *trees)
    want = jax.vmap(lambda q, s: jcomp.allreduce_compressed(q, s, "data"), axis_name="data")(stack(qs), stack(ss))
    for a, b in zip(leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        assert all(np.array_equal(b[0], b[i]) for i in range(RANKS))
        np.testing.assert_allclose(a.numpy(), b[0], rtol=0, atol=1e-6)


def test_allreduce_compressed_wants_a_payload_per_rank():
    q, s, _ = comp.compress_tree(_t(_tree(0)), comp.zero_residual(_t(_tree(0))))
    with pytest.raises(ValueError):
        comp.allreduce_compressed([q, q], [s])
    with pytest.raises(ValueError):
        comp.allreduce_compressed([], [])


def test_compression_roundtrip_and_error_feedback():
    """The reference's ``test_compression_roundtrip_and_error_feedback`` on
    the port."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
    q, s = comp.quantize_int8(g)
    deq = comp.dequantize_int8(q, s)
    rel = float((deq - g).abs().max() / g.abs().max())
    assert rel < 1.0 / 120  # half-step bound
    # error feedback: accumulated quantized sum converges to true sum
    res = torch.zeros_like(g)
    acc = torch.zeros_like(g)
    for _ in range(50):
        q, s, res = comp.compress_tree(g, res)
        acc = acc + comp.dequantize_int8(q, s)
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(), rtol=0, atol=float(s) * 1.1)


def test_payload_is_a_quarter_of_f32():
    """int8 codes plus one f32 scale per stacked leaf (the two layers' "w"
    share one): about a quarter of the f32 bytes."""
    g = _t(_tree(5))
    q, s, _ = comp.compress_tree(g, comp.zero_residual(g))
    f32 = sum(x.numel() * 4 for x in leaves(g))
    assert comp.payload_bytes(q, s) == f32 // 4 + 4 * (len(leaves(g)) - 1)


# ------------------------------------------------ the compressed DP step


@functools.lru_cache(maxsize=None)
def _setup():
    """(reference cfg, port cfg, the reference's weights as numpy), reduced
    minicpm in f32."""
    jcfg = dataclasses.replace(jget_reduced("minicpm-2b"), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced("minicpm-2b"), dtype=torch.float32)
    return jcfg, tcfg, jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.key(2)))


def _batches(vocab, n, b=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, vocab, (b, s)).astype(np.int32)} for _ in range(n)]


def _masters(tree, cfg):
    params = params_from_jax(tree, cfg, device="cpu", masters=True)
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def _reference_dp_step(jcfg, ocfg):
    """The reference's ``local_step`` composed on one device: each rank's
    ``value_and_grad`` of ``api.loss_fn`` on its shard, ``compress_tree``
    with its own residual, the vmapped ``allreduce_compressed``, then
    ``clip_by_global_norm`` and ``apply_opt`` once, the loss the ranks' mean."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, jcfg, b)[0]))
    gather = jax.vmap(lambda q, s: jcomp.allreduce_compressed(q, s, "data"), axis_name="data")

    def step(params, opt_state, residuals, batch):
        per = batch["tokens"].shape[0] // RANKS
        qs, ss, new_res, losses = [], [], [], []
        for r in range(RANKS):
            shard = {k: jnp.asarray(v[r * per:(r + 1) * per]) for k, v in batch.items()}
            lval, grads = vg(params, shard)
            q, s, res = jcomp.compress_tree(grads, residuals[r])
            qs.append(q), ss.append(s), new_res.append(res), losses.append(lval)
        stacked = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
        averaged = jax.tree.map(lambda x: x[0], gather(stacked(qs), stacked(ss)))
        grads, gnorm = jopt.clip_by_global_norm(averaged, ocfg.clip_norm)
        params, opt_state = jopt.apply_opt(params, grads, opt_state, ocfg)
        return params, opt_state, new_res, {"loss": jnp.mean(jnp.stack(losses)), "grad_norm": gnorm}, averaged

    return step


def test_dp_step_matches_composed_reference(monkeypatch):
    """Four data ranks on the CPU, the same weights (``params_from_jax``)
    and batches: the first loss within 1e-5, the averaged gradients equal
    but at elements on a rounding boundary (each within one quantization
    step), 3 steps' losses within 1e-3, and rank 0's residual as the
    reference's array reads on the host (its rank 0)."""
    jcfg, tcfg, tree = _setup()
    kw = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    ocfg, jocfg = topt.OptConfig(**kw), jopt.OptConfig(**kw)
    mesh = make_test_mesh((RANKS,), ("data",), device="cpu")
    step = dp_train_step_compressed(tcfg, ocfg, mesh)
    params = _masters(tree, tcfg)
    state = topt.init_opt(params, ocfg)
    res = [comp.zero_residual(params) for _ in range(RANKS)]
    jstep = _reference_dp_step(jcfg, jocfg)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_opt(jp, jocfg)
    jres = [jcomp.zero_residual(jp) for _ in range(RANKS)]

    # the first step's averaged gradients, recorded inside the port's step
    seen = []
    real = comp.allreduce_compressed

    def spy(qs, ss):
        out = real(qs, ss)
        seen.append((tree_map(lambda x: x.clone(), out), [s for s in ss]))
        return out

    monkeypatch.setattr(comp, "allreduce_compressed", spy)
    for i, batch in enumerate(_batches(tcfg.vocab, 3, seed=4)):
        params, state, res, m = step(params, state, res, {k: torch.from_numpy(v) for k, v in batch.items()})
        jp, js, jres, jm, jgrads = jstep(jp, js, jres, batch)
        tol = 1e-5 if i == 0 else 1e-3
        assert abs(float(m["loss"]) - float(jm["loss"])) < tol, (i, float(m["loss"]), float(jm["loss"]))
        if i == 0:
            got, scales = seen[0]
            want = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg, device="cpu", masters=True)
            for (path, a), b, *rank_scales in zip(leaves_with_paths(got), leaves(want),
                                                  *(leaves(t) for t in scales)):
                # a code one step off on one rank moves the mean by that rank's scale / ranks
                off = (a - b).abs()
                assert float(off.max()) <= max(float(x) for x in rank_scales) / RANKS * 1.0001, (path, off.max())
                assert float((off > 1e-6).float().mean()) < 0.01, path
            _check_rank0_residual(res[0], params_from_jax(jax.tree.map(np.asarray, jres[0]), tcfg,
                                                          device="cpu", masters=True))
    assert len(res) == RANKS and all(p.grad is None for p in leaves(params))


def _check_rank0_residual(res0, jres0):
    """Rank 0's residual against the reference's rank 0: within 1e-3 of each
    leaf's quantization step (the gradients' own f32 differences), but at
    elements whose code landed on the other side of a rounding boundary (one
    step apart, fewer than 1%)."""
    for (path, a), b in zip(leaves_with_paths(res0), leaves(jres0)):
        off = (a - b).abs()
        step = max(float(b.abs().max()) * 2, 1e-12)  # a residual lies within half a step either way
        assert float(off.max()) <= step * 1.0001, (path, float(off.max()), step)
        assert float((off > 1e-3 * step).float().mean()) < 0.01, path


def test_compressed_dp_tracks_uncompressed():
    """The reference's ``test_compressed_dp_training`` on the port: 12
    compressed steps over four data ranks against 12 ``make_train_step``
    steps on the same batches from the same weights."""
    cfg = get_reduced("minicpm-2b")
    mesh = make_test_mesh((RANKS,), ("data",), device="cpu")
    ocfg = topt.OptConfig(peak_lr=2e-3, warmup_steps=1, total_steps=30)
    params = api.init_model(cfg, torch.Generator().manual_seed(0), masters=True)
    pc = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    pu = tree_map(lambda p: p.detach().clone().requires_grad_(True), params)
    oc, ou = topt.init_opt(pc, ocfg), topt.init_opt(pu, ocfg)
    res = [comp.zero_residual(pc) for _ in range(RANKS)]
    step_c = dp_train_step_compressed(cfg, ocfg, mesh)
    step_u = make_train_step(cfg, TrainConfig(opt=ocfg))
    rng = np.random.default_rng(0)
    lc = lu = None
    for s in range(12):
        batch = {
            "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)),
        }
        pc, oc, res, mc = step_c(pc, oc, res, batch)
        pu, ou, mu = step_u(pu, ou, batch)
        lc, lu = float(mc["loss"]), float(mu["loss"])
    assert lc < 6.0 and abs(lc - lu) < 0.35, (lc, lu)


def test_dp_step_refuses_bad_operands():
    cfg = get_reduced("minicpm-2b")
    mesh = make_test_mesh((RANKS,), ("data",), device="cpu")
    ocfg = topt.OptConfig()
    params = api.init_model(cfg, torch.Generator().manual_seed(0), masters=True)
    state = topt.init_opt(params, ocfg)
    step = dp_train_step_compressed(cfg, ocfg, mesh)
    batch = {k: torch.zeros((6, 8), dtype=torch.int32) for k in ("tokens", "labels")}
    res = [comp.zero_residual(params) for _ in range(RANKS)]
    with pytest.raises(ValueError):  # 6 rows over 4 ranks
        step(params, state, res, batch)
    with pytest.raises(ValueError):  # one residual tree too few
        step(params, state, res[1:], {k: v[:4] for k, v in batch.items()})
    bf16 = api.init_model(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(TypeError):  # bf16 leaves are not masters
        step(bf16, state, res, {k: v[:4] for k, v in batch.items()})


def test_dp_step_refuses_ranks_on_another_device():
    """A mesh whose data ranks are not all on the parameters' device raises
    before any rank computes: the step has no per-rank copies."""
    cfg = get_reduced("minicpm-2b")
    ocfg = topt.OptConfig()
    mesh = _mesh([torch.device("cpu")] * (RANKS - 1) + [torch.device("meta")], (RANKS,), ("data",))
    params = api.init_model(cfg, torch.Generator().manual_seed(0), masters=True)
    state = topt.init_opt(params, ocfg)
    res = [comp.zero_residual(params) for _ in range(RANKS)]
    batch = {k: torch.zeros((RANKS, 8), dtype=torch.int32) for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="parameters' device"):
        dp_train_step_compressed(cfg, ocfg, mesh)(params, state, res, batch)
    assert all(p.grad is None for p in leaves(params))


# ----------------------------------------------------------- sharding rules


@pytest.mark.parametrize("arch", ["minicpm-2b", "gemma3-27b", "qwen3-32b", "qwen1.5-110b", "mamba2-130m",
                                  "zamba2-2.7b"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 4)])
def test_param_specs_match_reference(arch, shape):
    """Every leaf of the reduced dense, ssm and hybrid configs (the SSM's
    ``in_proj``, ``out_proj`` and ``conv_w`` rules; the hybrid's one
    ``shared_attn``): the port's axes per dim equal the reference's
    ``PartitionSpec`` (without its stacked-layer dim for the layer leaves)
    at a (data, model) mesh of ``shape``, fsdp off."""
    axes = ("data", "model")
    jmesh = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))  # the rules read only these
    jrules = jsharding.ShardingRules(mesh=jmesh)
    rules = sharding.ShardingRules(mesh=make_test_mesh(shape, axes, device="cpu"))
    jspecs = jsharding.tree_param_specs(japi.init_model(jget_reduced(arch), jax.random.key(0)), jrules)
    specs = sharding.tree_param_specs(api.init_model(get_reduced(arch), torch.Generator().manual_seed(0)), rules)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
             for path, spec in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    n_layers = 0
    for path, spec in _spec_leaves(specs):
        if path[0] == "layers":
            n_layers += 1
            want = jflat["/".join(str(p) for p in (path[0],) + path[2:])][1:]
        else:
            want = jflat["/".join(str(p) for p in path)]
        assert spec == want, (path, spec, want)
    assert n_layers > 0
    if shape == (2, 4):
        assert any("model" in spec for _, spec in _spec_leaves(specs))


def _spec_leaves(tree, path=()):
    """(path, spec) of every leaf of a spec tree (specs are tuples)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _spec_leaves(v, path + (i,))
    else:
        yield path, tree


def test_sharding_rules_helpers():
    """``use_rules`` nests and restores; ``shard_activation`` hands its input
    back; fsdp places the batch axes on a free dim."""
    r1, r2 = sharding.ShardingRules(), sharding.ShardingRules(fsdp=True)
    assert sharding.get_rules() is None
    with sharding.use_rules(r1):
        with sharding.use_rules(r2):
            assert sharding.get_rules() is r2
        assert sharding.get_rules() is r1
    assert sharding.get_rules() is None
    x = torch.ones(2, 3)
    assert sharding.shard_activation(x, "hidden") is x
    mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
    rules = sharding.ShardingRules(mesh=mesh, fsdp=True)
    jrules = jsharding.ShardingRules(mesh=types.SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape),
                                     fsdp=True)
    for path, shp in (("layers/0/attn/wq", (64, 256)), ("embedding", (256, 64)), ("final_norm", (64,))):
        # a PartitionSpec stores a one-axis tuple as the axis itself
        got = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                    for a in sharding.param_spec_for(path, shp, rules))
        assert got == tuple(jsharding.param_spec_for(path, shp, jrules))
        assert "data" in str(got)
