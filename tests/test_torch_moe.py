"""The port's moe family against the reference, on the CPU: ``moe_layer_dense``
(dropless and at a low capacity; routing ties on a zero row; the reference's
own batch-independence and dropping tests), the reduced deepseek-moe-16b and
kimi-k2-1t-a32b (forward with the aux values, prefill at the training
capacity factor, decode against the forward at a dropless capacity, the
``SlotServer``'s tokens, loss and gradients, three Adafactor steps), the
expert-parallel layer against the dense one, ``tree.stack_key`` on every
stacked list, the router and expert sharding rules, and kimi's parameter
count. The reference's weights come across through
``convert.params_from_jax``; inputs are drawn with numpy from fixed seeds."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.distributed import sharding as jsharding
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models.transformer import lm_forward as jlm_forward
from repro.serve.server import Request as JRequest
from repro.serve.server import SlotServer as JSlotServer
from repro.train import optimizer as jopt
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_config, get_reduced, optimizer_for
from repro_torch.distributed import sharding
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api, moe
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import lm_forward
from repro_torch.models.tree import leaves, stack_key, tree_map
from repro_torch.serve.server import Request, SlotServer
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import TrainConfig, make_train_step

MOE_ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
F32 = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x, np.float32)


def _tcfg(jcfg):
    return moe.MoEConfig(**dataclasses.asdict(jcfg))


def _layer_params(jcfg, d, seed):
    """The reference's ``init_moe`` (as numpy) and the port's copy in f32."""
    tree = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.key(seed), d, jcfg))
    conv = lambda t: {k: conv(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in t.items()}
    return jax.tree.map(jnp.asarray, tree), conv(tree)


def _aux_close(got, want, **tol):
    assert set(got) == set(want) == set(moe.AUX_KEYS)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), **tol, err_msg=key)


@pytest.mark.parametrize("cf,shared", [(64.0, 2), (0.5, 0), (1.25, 1)])
def test_moe_layer_dense_matches_reference(cf, shared):
    """Outputs and the three aux values in f32 within 1e-5, dropless (cf 64)
    and at capacities that drop pairs."""
    jcfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared_experts=shared, capacity_factor=cf)
    jp, tp = _layer_params(jcfg, 32, 0)
    x = np.random.default_rng(1).normal(size=(2, 24, 32)).astype(np.float32)
    want, waux = jmoe.moe_layer_dense(jp, jnp.asarray(x), jcfg)
    got, gaux = moe.moe_layer_dense(tp, torch.from_numpy(x), _tcfg(jcfg))
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)
    _aux_close(gaux, waux, **LAYER_TOL)
    assert (float(gaux["dropped_frac"]) > 0) == (cf < 64)


def test_routing_ties_break_as_the_reference():
    """A zero row (uniform probabilities) and a repeated one: the chosen
    experts are ``jax.lax.top_k``'s (the lower index first), and so are
    the outputs, at a capacity that drops."""
    jcfg = jmoe.MoEConfig(n_experts=8, top_k=3, d_ff_expert=16, capacity_factor=1.0)
    jp, tp = _layer_params(jcfg, 32, 2)
    x = np.random.default_rng(3).normal(size=(1, 10, 32)).astype(np.float32)
    x[0, 2] = 0.0
    x[0, 7] = 0.0
    x[0, 5] = x[0, 4]
    probs = jax.nn.softmax(jnp.asarray(x[0]) @ jp["router"], axis=-1)
    _, want_idx = jax.lax.top_k(probs, 3)
    r = moe.route(torch.from_numpy(x[0]), tp["router"], _tcfg(jcfg), cap=moe.capacity(10, _tcfg(jcfg)))
    np.testing.assert_array_equal(r.eidx.numpy(), np.asarray(want_idx))
    assert r.eidx[2].tolist() == [0, 1, 2]
    want, waux = jmoe.moe_layer_dense(jp, jnp.asarray(x), jcfg)
    got, gaux = moe.moe_layer_dense(tp, torch.from_numpy(x), _tcfg(jcfg))
    np.testing.assert_allclose(got.numpy(), _np(want), **LAYER_TOL)
    _aux_close(gaux, waux, **LAYER_TOL)


def test_moe_dropless_batch_independent():
    """At near-dropless capacity a row's output does not depend on the other
    rows of the batch (the reference's test, on the port)."""
    mcfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=64.0)
    p = moe.init_moe(torch.Generator().manual_seed(0), 32, mcfg)
    rng = np.random.default_rng(0)
    x1 = torch.from_numpy(rng.normal(size=(1, 6, 32)).astype(np.float32))
    x2 = torch.from_numpy(rng.normal(size=(1, 6, 32)).astype(np.float32))
    y_joint, _ = moe.moe_layer(p, torch.cat([x1, x2]), mcfg)
    y1, _ = moe.moe_layer(p, x1, mcfg)
    np.testing.assert_allclose(y_joint[0].numpy(), y1[0].numpy(), **F32)


def test_moe_drops_at_low_capacity():
    mcfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=0.5)
    p = moe.init_moe(torch.Generator().manual_seed(0), 32, mcfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32)).astype(np.float32))
    _, aux = moe.moe_layer(p, x, mcfg)
    assert float(aux["dropped_frac"]) > 0.0


def test_capacity_is_the_reference_float_floor():
    """deepseek at decode with 4 slots: min(4, 4·6·8 // 64) = 3 slots an
    expert, so a decode step can drop a pair."""
    cfg = get_config("deepseek-moe-16b").moe
    assert moe.capacity(4, cfg, serving=True) == 3
    assert moe.capacity(4096, get_config("kimi-k2-1t-a32b").moe) == 106
    assert moe.capacity(1, cfg) == 1


def test_moe_gradients_match_reference():
    """The gather-only backward (``_Gather``) against ``jax.grad`` of the
    reference's scatter-add formulation: input, router, experts and shared
    MLP, at a capacity that drops pairs."""
    jcfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared_experts=1, capacity_factor=0.75)
    jp, tp = _layer_params(jcfg, 32, 4)
    x = np.random.default_rng(5).normal(size=(2, 12, 32)).astype(np.float32)
    w = np.random.default_rng(6).normal(size=(2, 12, 32)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.moe_layer_dense(p, x, jcfg)
        return jnp.sum(y * w) + aux["lb_loss"] + aux["z_loss"]

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(True), tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_layer_dense(tp, xt, _tcfg(jcfg))
    ((y * torch.from_numpy(w)).sum() + aux["lb_loss"] + aux["z_loss"]).backward()
    assert float(aux["dropped_frac"]) > 0
    np.testing.assert_allclose(xt.grad.numpy(), _np(jgx), **LAYER_TOL)
    got = tree_map(lambda t: t.grad.numpy(), tp)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jgp)):
        np.testing.assert_allclose(a, _np(b), **LAYER_TOL)


# ------------------------------------------------------ the reduced models


def _perturb(tree, rng):
    """Norm weights (zeros at init) drawn at random."""
    return {name: _perturb(v, rng) if isinstance(v, dict)
            else (rng.normal(size=v.shape) * 0.1).astype(np.float32) if name.endswith("norm") else np.asarray(v)
            for name, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _tree(arch):
    """The reference's reduced weights as numpy (norm weights perturbed)."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    return _perturb(jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.key(1))), np.random.default_rng(7))


def _pair(arch, cf=None):
    """(reference cfg, port cfg, reference params as numpy), f32; ``cf``
    sets both capacity factors (the weights do not depend on it)."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf,
                                                                   serve_capacity_factor=cf))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cf,
                                                                   serve_capacity_factor=cf))
    return jcfg, tcfg, _tree(arch)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_matches_reference(arch):
    """Full and reduced configs field by field (the MoE config too);
    kimi keeps its ``OPTIMIZER``."""
    for ours, theirs in ((get_config(arch), jget_config(arch)), (get_reduced(arch), jget_reduced(arch))):
        for f in dataclasses.fields(theirs):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name == "dtype":
                assert a == torch.bfloat16 and jnp.dtype(b) == jnp.bfloat16
            elif f.name == "moe":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, f.name
    assert optimizer_for(arch) == ("adafactor" if arch.startswith("kimi") else "adamw")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_prefill_match_reference(arch):
    """Logits and the summed aux values of ``lm_forward`` (1e-4), then the
    prefill at the training capacity factor 1.25 (which drops pairs here):
    last logits and every cache leaf, and two decode steps."""
    jcfg, tcfg, tree = _pair(arch)
    params = params_from_jax(tree, tcfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    toks = _tokens(jcfg, 2, 40, 0)
    want, waux = jlm_forward(jp, jcfg, jnp.asarray(toks))
    got, gaux = lm_forward(params, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **F32)
    _aux_close(gaux, waux, **F32)
    assert float(gaux["dropped_frac"]) > 0
    jl, jc = japi.serve_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=48)
    tl, tc = api.serve_prefill(params, tcfg, {"tokens": torch.from_numpy(toks)}, max_len=48)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **F32)
    assert set(tc) == set(jc)
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(tc[key].float().numpy(), _np(jc[key]), **F32, err_msg=key)
    for i in range(2):
        jl, jc = japi.serve_decode(jp, jcfg, jnp.asarray(toks[:, i]), jc)
        tl, tc = api.serve_decode(params, tcfg, torch.from_numpy(toks[:, i]), tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward(arch):
    """Prefill + decode reproduce the teacher-forced forward's logits at a
    dropless capacity (64), the reference's ``test_decode_matches_forward``
    on the port."""
    _, tcfg, tree = _pair(arch, 64.0)
    params = params_from_jax(tree, tcfg, device="cpu")
    toks = torch.from_numpy(_tokens(tcfg, 2, 12, 3))
    full, aux = lm_forward(params, tcfg, toks)
    assert float(aux["dropped_frac"]) == 0.0
    logits_p, cache = api.serve_prefill(params, tcfg, {"tokens": toks[:, :11]}, max_len=16)
    np.testing.assert_allclose(logits_p.numpy(), full[:, 10].detach().numpy(), rtol=2e-3, atol=2e-3)
    logits_d, _ = api.serve_decode(params, tcfg, toks[:, 11], cache)
    np.testing.assert_allclose(logits_d.numpy(), full[:, 11].detach().numpy(), rtol=2e-3, atol=2e-3)


def test_slot_server_matches_reference():
    """The reduced deepseek-moe-16b served through both ``SlotServer``s at 3
    slots: the same greedy tokens (decode at the serving capacity, 3 slots
    an expert at 3 slots: 3·2·8 // 8)."""
    jcfg, tcfg, tree = _pair("deepseek-moe-16b")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, jcfg.vocab, n).astype(np.int32) for n in (9, 14, 6, 11)]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    JSlotServer(jax.tree.map(jnp.asarray, tree), jcfg, n_slots=3, max_len=24).run(jreqs)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    SlotServer(params_from_jax(tree, tcfg, device="cpu"), tcfg, n_slots=3, max_len=24).run(reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert all(r.done for r in reqs)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(2, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -100
    return {"tokens": rng.integers(2, cfg.vocab, (b, s)).astype(np.int32), "labels": labels}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_grad_match_reference(arch):
    """``loss_fn`` (with 0.01 lb_loss + 1e-4 z_loss) and its gradient
    against ``jax.value_and_grad`` of the reference's, f32, within 1e-4,
    masters carried over by ``params_from_jax(..., masters=True)``."""
    jcfg, tcfg, tree = _pair(arch)
    batch = _batch(jcfg, 2, 24, 0)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, jcfg, b)[0]))(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(tree, tcfg, device="cpu", masters=True)
    for p in leaves(params):
        p.requires_grad_(True)
    loss, aux = api.loss_fn(params, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert set(aux) == {"ce_loss", *moe.AUX_KEYS} and float(aux["lb_loss"]) > 0
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-4)
    got = params_to_numpy(tree_map(lambda p: p.grad, params))
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, jg))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, _np(b), **F32)


def test_adafactor_steps_on_kimi_match_reference():
    """Three ``make_train_step`` steps of the reduced kimi with its
    Adafactor (the RMS clip over each stacked leaf: ``dense_layers`` and
    ``layers`` apart) and 2 microbatches: losses, grad norms and masters
    within 1e-4."""
    jcfg, tcfg, tree = _pair("kimi-k2-1t-a32b")
    kw = dict(name=optimizer_for("kimi-k2-1t-a32b"), peak_lr=1e-2, warmup_steps=1, total_steps=10)
    jopt_cfg, opt = jopt.OptConfig(**kw), topt.OptConfig(**kw)
    assert opt.name == "adafactor"
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(opt=jopt_cfg, microbatches=2)))
    step = make_train_step(tcfg, TrainConfig(opt=opt, microbatches=2))
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_opt(jp, jopt_cfg)
    params = params_from_jax(tree, tcfg, device="cpu", masters=True)
    state = topt.init_opt(params, opt)
    for i in range(3):
        batch = _batch(jcfg, 4, 16, 20 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, tm = step(params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(params)), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, _np(b), **F32)


# ------------------------------------------------- trees, sharding, counts


def test_stack_key_drops_every_stacked_index():
    for lst in ("layers", "dense_layers", "enc_layers", "dec_layers"):
        assert stack_key((lst, 3, "attn", "wq")) == f"{lst}/attn/wq"
    assert stack_key(("layers", 0, "moe", "experts", "w_up")) == "layers/moe/experts/w_up"
    assert stack_key(("shared_attn", "attn", "wq")) == "shared_attn/attn/wq"
    assert stack_key(("embedding",)) == "embedding"


@pytest.mark.parametrize("dp,shape", [(2, (4, 3, 16)), (4, (4, 5, 16)), (8, (8, 2, 16)), (2, (3, 4, 16))])
def test_moe_layer_ep_matches_dense_at_dropless(dp, shape):
    """``moe_layer`` under rules with a (data, model) mesh of ``dp`` data
    ranks (the expert-parallel path) against ``moe_layer_dense``, dropless:
    outputs, lb_loss, z_loss and dropped_frac; a batch the data axis cannot
    split (3 rows over 2 ranks) goes dense."""
    mcfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared_experts=1, capacity_factor=64.0)
    p = moe.init_moe(torch.Generator().manual_seed(1), 16, mcfg)
    x = torch.from_numpy(np.random.default_rng(dp).normal(size=shape).astype(np.float32))
    want, waux = moe.moe_layer_dense(p, x, mcfg)
    calls = []
    real = moe.moe_layer_dense
    try:
        moe.moe_layer_dense = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        with sharding.use_rules(sharding.ShardingRules(mesh=make_test_mesh((dp, 2), ("data", "model"),
                                                                           device="cpu"))):
            got, gaux = moe.moe_layer(p, x, mcfg)
    finally:
        moe.moe_layer_dense = real
    assert len(calls) == (1 if shape[0] % dp else 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **LAYER_TOL)
    _aux_close(gaux, waux, **LAYER_TOL)


def test_moe_layer_ep_counts_capacity_per_source_shard():
    """At the training capacity each source shard keeps ``cap_e`` pairs an
    expert (the reference's ``_ep_local``): the EP layer's dropped fraction
    is the mean of each shard's own dense routing at that capacity."""
    mcfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, capacity_factor=1.0)
    p = moe.init_moe(torch.Generator().manual_seed(2), 16, mcfg)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(4, 8, 16)).astype(np.float32))
    with sharding.use_rules(sharding.ShardingRules(mesh=make_test_mesh((2, 1), ("data", "model"), device="cpu"))):
        y, aux = moe.moe_layer(p, x, mcfg)
        _, served = moe.moe_layer(p, x, mcfg, serving=True)  # serving never takes the EP path
    shards = [moe.moe_layer_dense(p, x[i * 2:(i + 1) * 2], mcfg) for i in range(2)]
    np.testing.assert_allclose(y.numpy(), torch.cat([s[0] for s in shards]).numpy(), **LAYER_TOL)
    assert float(aux["dropped_frac"]) == pytest.approx(np.mean([float(s[1]["dropped_frac"]) for s in shards]))
    assert float(aux["dropped_frac"]) > 0
    assert float(served["dropped_frac"]) == float(moe.moe_layer_dense(p, x, mcfg, serving=True)[1]["dropped_frac"])


@pytest.mark.parametrize("shape", [(1, 1), (2, 4), (4, 2)])
def test_expert_param_specs_match_reference(shape):
    """The router and expert leaves of the reduced deepseek (and every other
    leaf of it): the port's axes equal the reference's ``PartitionSpec``
    without its stacked-layer entry; the experts on "data" (the EP axis)."""
    import types

    axes = ("data", "model")
    jrules = jsharding.ShardingRules(mesh=types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape))))
    rules = sharding.ShardingRules(mesh=make_test_mesh(shape, axes, device="cpu"))
    jcfg = dataclasses.replace(jget_reduced("deepseek-moe-16b"), moe=dataclasses.replace(
        jget_reduced("deepseek-moe-16b").moe, n_experts=16))
    tcfg = dataclasses.replace(get_reduced("deepseek-moe-16b"), moe=_tcfg(jcfg.moe))
    jspecs = jsharding.tree_param_specs(japi.params_specs(jcfg), jrules)
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
             for path, spec in jax.tree_util.tree_flatten_with_path(
                 jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    specs = sharding.tree_param_specs(api.params_specs(tcfg), rules)
    seen = set()

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            key = stack_key(path)
            want = jflat[key][1:] if key != "/".join(map(str, path)) else jflat[key]
            assert tree == want, (path, tree, want)
            seen.add(key)

    walk(specs, ())
    assert {"layers/moe/router", "layers/moe/experts/w_up", "layers/moe/experts/w_down",
            "dense_layers/mlp/w_gate"} <= seen
    if shape != (1, 1):
        assert specs["layers"][0]["moe"]["experts"]["w_up"] == ("data", None, "model")
        assert specs["layers"][0]["moe"]["experts"]["w_down"] == ("data", "model", None)
        assert specs["layers"][0]["moe"]["router"] == (None, None)


def test_kimi_total_params_about_1t():
    """``count_params`` of kimi's meta-device parameters (nothing allocated)
    within 2% of ``roofline.total_params`` (the reference's check), both in
    0.8–1.3e12, equal to the reference's count; the router is f32."""
    cfg = get_config("kimi-k2-1t-a32b")
    specs = api.params_specs(cfg)
    real = api.count_params(specs)
    assert real == japi.count_params(japi.params_specs(jget_config("kimi-k2-1t-a32b")))
    approx = roofline.total_params(cfg)
    assert 0.8e12 < approx < 1.3e12 and 0.8e12 < real < 1.3e12
    assert abs(real - approx) / real < 0.02
    assert roofline.active_params(cfg) < 0.05 * approx
    serve = api.init_model(cfg, MetaGenerator())
    lp = serve["layers"][0]["moe"]
    assert lp["router"].dtype == torch.float32 and lp["experts"]["w_up"].dtype == torch.bfloat16
    assert tuple(lp["experts"]["w_up"].shape) == (384, 7168, 2048)


def test_cli_serves_deepseek_and_trains_kimi_with_adafactor(tmp_path, capsys, monkeypatch):
    """``launch.serve`` on the reduced deepseek and ``launch.train`` on the
    reduced kimi, which trains with its ``OPTIMIZER``, Adafactor, on the CPU."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as tlaunch

    tserve.main(["--arch", "deepseek-moe-16b", "--device", "cpu", "--requests", "3", "--slots", "2",
                 "--prompt-len", "8", "--max-new", "3"])
    assert "served 3 requests" in capsys.readouterr().out
    made = []
    real = topt.init_opt
    monkeypatch.setattr("repro_torch.train.train_step.init_opt", lambda p, c: made.append(c.name) or real(p, c))
    hist = tlaunch.main(["--arch", "kimi-k2-1t-a32b", "--reduced", "--steps", "3", "--batch", "2", "--seq", "16",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "0"])
    assert made == ["adafactor"] and np.isfinite(hist[-1]["loss"]) and "dropped_frac" in hist[-1]
