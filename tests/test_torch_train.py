"""The port's LM training path against the reference, on the CPU: the copied
data pipeline, the schedules and optimizers, ``loss_fn`` and its gradient on
the reduced minicpm and gemma3 (the reference's weights carried across by
``convert.params_from_jax(..., masters=True)``, norm weights perturbed), the
attention backward's plain version against ``jax.vjp`` of the reference's
chunked softmax, one ``make_train_step`` step, ``lm_hidden_embed``; then the
reference's ``tests/test_train_infra.py`` cases on the port alone (loss
decreases, microbatches, checkpoints, retries, restart) and the training
CLI."""
import dataclasses
import functools
import json
import os
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import api as japi
from repro.models.attention import flash_attention as jflash_attention
from repro.models.transformer import lm_hidden_embed as jlm_hidden_embed
from repro.train import optimizer as jopt
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.configs import get_reduced, optimizer_for, schedule_for
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train as tlaunch
from repro_torch.models import api
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import lm_hidden_embed
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.fault_tolerance import LoopConfig, TrainLoop, elastic_mesh, with_retries
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step
from repro_torch.models.tree import leaves, tree_map

CFG = get_reduced("minicpm-2b")
ARCHS = ["minicpm-2b", "gemma3-27b"]  # GQA 4/4, and 4/2 with windows of 16 on five layers of six
SSM_ARCHS = ["mamba2-130m", "zamba2-2.7b"]  # ssm, and hybrid (two groups of two ssm layers and the shared block)


def _perturb(tree, rng):
    """Norm weights (zeros at init) drawn at random, so the offset form
    changes the result, and the SSM's constants moved (as
    ``tests/test_torch_models.py`` does)."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _perturb(v, rng)
        elif name.endswith("norm"):
            out[name] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        elif name in ("A_log", "dt_bias", "D"):
            out[name] = (np.asarray(v) + rng.normal(size=v.shape) * 0.2).astype(np.float32)
        else:
            out[name] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype):
    """(reference cfg, port cfg, the reference's weights as numpy)."""
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    if dtype == "f32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    tree = _perturb(jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.key(1))),
                    np.random.default_rng(7))
    return jcfg, tcfg, tree


@functools.lru_cache(maxsize=None)
def _jloss_grad(arch, dtype):
    jcfg = _setup(arch, dtype)[0]
    return jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, jcfg, b)[0]))


def _masters(tree, tcfg):
    params = params_from_jax(tree, tcfg, device="cpu", masters=True)
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def _batch(cfg, b, s, seed, ignore=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(2, cfg.vocab, (b, s)).astype(np.int32)
    if ignore:
        labels[0, :5] = -100
        labels[-1, 3] = -1  # any negative label is ignored, not only -100
    return {"tokens": toks, "labels": labels}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("n_shards,step,shard", [(1, 0, 0), (1, 7, 0), (2, 5, 1)])
def test_synthetic_batches_equal_reference(n_shards, step, shard):
    kw = dict(vocab=997, seq_len=33, global_batch=8, seed=3, n_shards=n_shards)
    a = JSyntheticLM(JDataConfig(**kw)).batch(step, shard)
    b = SyntheticLM(DataConfig(**kw)).batch(step, shard)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_prefetcher_replays_the_stream():
    ds = SyntheticLM(DataConfig(vocab=97, seq_len=8, global_batch=2))
    pf = Prefetcher(ds, start_step=3)
    try:
        for s in (3, 4, 5):
            step, b = pf.next()
            assert step == s and np.array_equal(b["tokens"], ds.batch(s)["tokens"])
    finally:
        pf.stop()
        pf.t.join(timeout=10)
    assert not pf.t.is_alive()


# ------------------------------------------------------------- optimizer


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "constant"])
def test_schedules_match_reference(schedule):
    cfg = dict(schedule=schedule, peak_lr=3e-4, warmup_steps=10, total_steps=100)
    jsched, tsched = jopt.make_schedule(jopt.OptConfig(**cfg)), topt.make_schedule(topt.OptConfig(**cfg))
    steps = np.arange(121, dtype=np.int32)
    want = np.asarray(jax.vmap(jsched)(jnp.asarray(steps)))
    got = tsched(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[0] == 0.0  # the first update has rate 0


def test_schedule_shapes():
    """The reference's ``test_schedules`` on the port."""
    for name in ("cosine", "wsd", "constant"):
        sched = topt.make_schedule(topt.OptConfig(schedule=name, peak_lr=1.0, warmup_steps=10, total_steps=100))
        lrs = [float(sched(torch.tensor(s, dtype=torch.int32))) for s in (0, 5, 10, 50, 99)]
        assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
        assert lrs[2] == pytest.approx(1.0)
        if name == "wsd":
            assert lrs[3] == pytest.approx(1.0)
            assert lrs[4] < 0.2


def _stacked_tree(seed):
    """A reference-layout tree (stacked layers) of f32 arrays, and the port's
    unstacked copy, with factored (>= 32 x 32) and unfactored leaves."""
    rng = np.random.default_rng(seed)
    ref = {"embedding": rng.normal(size=(40, 64)).astype(np.float32),
           "final_norm": rng.normal(size=(64,)).astype(np.float32),
           "layers": {"w": rng.normal(size=(3, 64, 48)).astype(np.float32),
                      "norm": rng.normal(size=(3, 64)).astype(np.float32)}}
    port = {"embedding": torch.from_numpy(ref["embedding"].copy()),
            "final_norm": torch.from_numpy(ref["final_norm"].copy()),
            "layers": [{"w": torch.from_numpy(ref["layers"]["w"][i].copy()),
                        "norm": torch.from_numpy(ref["layers"]["norm"][i].copy())} for i in range(3)]}
    return ref, port


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    """Three updates (the first at rate 0) from the same f32 params and
    grads, within 1e-6. Gradients large enough that Adafactor's RMS clip
    acts on some stacked leaves, which the port takes over all layers."""
    cfg = dict(name=name, peak_lr=1e-2, warmup_steps=1, total_steps=10, factored_min_dim=32)
    jcfg, tcfg = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    jp, tp = _stacked_tree(0)
    jp = jax.tree.map(jnp.asarray, jp)
    js, ts = jopt.init_opt(jp, jcfg), topt.init_opt(tp, tcfg)
    for step in range(3):
        jg, tg = _stacked_tree(10 + step)
        jg = jax.tree.map(lambda x: jnp.asarray(x) * (1 + step), jg)
        tg = tree_map(lambda x: x * (1 + step), tg)
        jp, js = jopt.apply_opt(jp, jg, js, jcfg)
        tp, ts = topt.apply_opt(tp, tg, ts, tcfg)
    got = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    state = params_to_numpy(ts["m"] if name == "adamw" else ts["slots"])
    want = js["m"] if name == "adamw" else js["slots"]
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    jg, tg = _stacked_tree(3)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, jg), max_norm)
    tc, tn = topt.clip_by_global_norm(tg, max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tc)), jax.tree.leaves(jax.tree.map(np.asarray, jc))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_config_optimizer_and_schedule():
    assert schedule_for("minicpm-2b") == "wsd" and optimizer_for("minicpm-2b") == "adamw"
    assert schedule_for("gemma3-27b") == "cosine"


# ------------------------------------------------------------- the loss


# bf16 compute: both sides round products and activations to bf16, at places
# that differ (XLA fuses the casts), so the loss agrees to ~5e-4 relative
# and each gradient leaf to a few percent of its norm.
LOSS_TOL = {"f32": (1e-4, 1e-4, 1e-4), "bf16": (2e-3, None, 5e-2)}


@pytest.mark.parametrize("arch,dtype", [("minicpm-2b", "f32"), ("gemma3-27b", "f32"), ("gemma3-27b", "bf16")]
                         + [(arch, dtype) for arch in SSM_ARCHS for dtype in ("f32", "bf16")])
def test_loss_and_grad_match_reference(arch, dtype):
    """``loss_fn`` and its gradient against ``jax.value_and_grad`` of
    ``repro.models.api.loss_fn`` with the same weights and batch (labels
    with -100 and -1 ignored): f32 within 1e-4 (loss relative, gradients
    elementwise); bf16 compute within LOSS_TOL."""
    jcfg, tcfg, tree = _setup(arch, dtype)
    batch = _batch(jcfg, 2, 40, 0)
    jl, jg = _jloss_grad(arch, dtype)(jax.tree.map(jnp.asarray, tree), _jbatch(batch))
    params = _masters(tree, tcfg)
    loss, aux = api.loss_fn(params, tcfg, _tbatch(batch))
    loss.backward()
    assert set(aux) == {"ce_loss", "lb_loss", "z_loss", "dropped_frac"} and aux["ce_loss"] is not None
    rel_loss, atol, rel_grad = LOSS_TOL[dtype]
    assert float(loss.detach()) == pytest.approx(float(jl), rel=rel_loss)
    got = params_to_numpy(tree_map(lambda p: p.grad, params))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax.tree.map(np.asarray, jg))):
        if atol is not None:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
        assert np.linalg.norm(a - b) <= rel_grad * max(np.linalg.norm(b), 1e-12)


def test_all_ignored_batch_gives_zero_loss():
    """Every label ignored: the reference's max(count, 1) gives 0, where
    ``F.cross_entropy(ignore_index=-100)`` would give NaN."""
    jcfg, tcfg, tree = _setup("minicpm-2b", "f32")
    batch = _batch(jcfg, 2, 8, 1)
    batch["labels"][:] = -100
    jl, _ = _jloss_grad("minicpm-2b", "f32")(jax.tree.map(jnp.asarray, tree), _jbatch(batch))
    loss, _ = api.loss_fn(_masters(tree, tcfg), tcfg, _tbatch(batch))
    assert float(loss.detach()) == float(jl) == 0.0


# ---------------------------------------------------- attention backward


# the small f32 shapes of chip_smoke.py's phase T(a):
# b, s, t, hq, hkv, dh, causal, window
BWD_SHAPES = [
    (2, 77, 77, 4, 2, 16, True, 0),  # ragged S, GQA 2
    (2, 50, 50, 4, 4, 16, False, 0),  # not causal
    (1, 90, 90, 4, 2, 16, True, 7),  # a window below the tile
    (1, 40, 40, 8, 1, 16, True, 0),  # a GQA group of 8 on one KV head
    (1, 30, 60, 4, 2, 16, True, 0),  # S < T
]
NO_KEY_SHAPE = (1, 90, 30, 4, 2, 16, False, 8)  # S > T: rows 37.. keep no key


def _qkv_do(b, s, t, hq, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh), (b, s, hq, dh))]


def _autograd_plain(q, k, v, do, causal, window, chunk):
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = fa.flash_attention_plain(*ts, causal=causal, window=window, q_chunk=chunk, kv_chunk=chunk)
    return torch.autograd.grad(o, ts, torch.from_numpy(do))


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", BWD_SHAPES)
def test_plain_backward_matches_jax_vjp(b, s, t, hq, hkv, dh, causal, window):
    """``flash_attention_backward_plain`` against ``jax.vjp`` of the
    reference's chunked online softmax and against ``torch.autograd``
    through ``flash_attention_plain``, within 1e-5 (f32)."""
    q, k, v, do = _qkv_do(b, s, t, hq, hkv, dh, s + hq)
    chunk = 32
    o = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
                                 q_chunk=chunk, kv_chunk=chunk)
    got = fa.flash_attention_backward_plain(*map(torch.from_numpy, (q, k, v)), o, torch.from_numpy(do),
                                            causal=causal, window=window, q_chunk=chunk, kv_chunk=chunk)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash_attention(q_, k_, v_, causal=causal, window=window,
                                                         q_chunk=chunk, kv_chunk=chunk),
                     *map(jnp.asarray, (q, k, v)))
    for g, w, a in zip(got, vjp(jnp.asarray(do)), _autograd_plain(q, k, v, do, causal, window, chunk)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)


def test_rows_that_keep_no_key_get_zero_gradients():
    """S > T with a window: rows 37.. keep no key and return 0, so their dq
    is 0 and they add nothing to dk, dv (against autograd through the plain
    forward; the reference's forward returns a mean of V there, the
    difference ROADMAP.md §3 records)."""
    b, s, t, hq, hkv, dh, causal, window = NO_KEY_SHAPE
    q, k, v, do = _qkv_do(b, s, t, hq, hkv, dh, 5)
    o = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    got = fa.flash_attention_backward_plain(*map(torch.from_numpy, (q, k, v)), o, torch.from_numpy(do),
                                            causal=causal, window=window)
    for g, a in zip(got, _autograd_plain(q, k, v, do, causal, window, 1024)):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.all(got[0][:, t + window - 1:] == 0) and torch.any(got[0][:, : t + window - 1] != 0)


def test_flash_attention_under_grad_goes_through_the_function():
    """With an input that requires grad the result's grad_fn is the
    Function's; its backward is the plain backward on the CPU (not autograd
    through the plain forward); without grad nothing changes."""
    q, k, v, do = _qkv_do(1, 40, 40, 4, 2, 16, 9)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    f0, b0 = fa.flash_attention_plain.calls, fa.flash_attention_backward_plain.calls
    o = fa.flash_attention(*ts, window=5)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    grads = torch.autograd.grad(o, ts, torch.from_numpy(do))
    assert fa.flash_attention_plain.calls == f0 + 1 and fa.flash_attention_backward_plain.calls == b0 + 1
    for g, a in zip(grads, _autograd_plain(q, k, v, do, True, 5, 1024)):
        np.testing.assert_allclose(g.numpy(), a.numpy(), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert fa.flash_attention(*ts, window=5).grad_fn is None


LSE_SHAPES = BWD_SHAPES + [NO_KEY_SHAPE]


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _reference_lse(q, k, causal, window):
    """``jax.nn.logsumexp`` over the keys of the reference's masked logits
    ((q · scale) · k in f32, NEG_INF where a key is not kept), [B, Hq, S]."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qf = q.reshape(b, s, hkv, hq // hkv, dh) * dh**-0.5
    logits = jnp.einsum("bqhgd,bkhd->bhgqk", qf, k)
    q_pos, k_pos = jnp.arange(s)[:, None], jnp.arange(t)[None, :]
    mask = jnp.ones((s, t), dtype=bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = jnp.where(mask, logits, fa.NEG_INF)
    return jax.nn.logsumexp(logits, axis=-1).reshape(b, hq, s)


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", LSE_SHAPES)
def test_plain_forward_lse_matches_logsumexp(b, s, t, hq, hkv, dh, causal, window):
    """The plain forward's lse (m + log l of its chunked online softmax)
    against ``jax.nn.logsumexp`` of the reference's masked logits from the
    same numpy inputs, within 1e-5; rows that keep no key get NEG_INF (the
    reference's logsumexp of NEG_INF entries rounds to it in f32). The
    output is the one without lse."""
    q, k, v, _ = _qkv_do(b, s, t, hq, hkv, dh, s + t)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = fa.flash_attention_plain(*ts, causal=causal, window=window, q_chunk=32, kv_chunk=32,
                                      return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    assert torch.equal(o, fa.flash_attention_plain(*ts, causal=causal, window=window, q_chunk=32, kv_chunk=32))
    want = np.asarray(_reference_lse(jnp.asarray(q), jnp.asarray(k), causal=causal, window=window))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    if (b, s, t, hq, hkv, dh, causal, window) == NO_KEY_SHAPE:
        assert torch.all(lse[..., t + window - 1:] == fa.NEG_INF) and torch.all(lse[..., : t + window - 1] > -1e3)


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", LSE_SHAPES)
def test_plain_backward_with_lse_matches_without(b, s, t, hq, hkv, dh, causal, window):
    """The plain backward given the forward's lse (no statistics sweep)
    against the same backward recomputing them (``lse=None``), within
    1e-6."""
    q, k, v, do = _qkv_do(b, s, t, hq, hkv, dh, s + 2 * t)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = fa.flash_attention_plain(*ts, causal=causal, window=window, q_chunk=32, kv_chunk=32,
                                      return_lse=True)
    given = fa.flash_attention_backward_plain(*ts, o, torch.from_numpy(do), lse, causal=causal, window=window,
                                              q_chunk=32, kv_chunk=32)
    swept = fa.flash_attention_backward_plain(*ts, o, torch.from_numpy(do), causal=causal, window=window,
                                              q_chunk=32, kv_chunk=32)
    for a, w in zip(given, swept):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,s,t,hq,hkv,dh,causal,window", [
    (1, 40, 40, 2, 1, 320, True, 5),  # a wide head, causal with a window
    (1, 24, 40, 4, 2, 320, False, 0),  # S < T, not causal, GQA 2
])
def test_plain_backward_wide_head_matches_jax_vjp(b, s, t, hq, hkv, dh, causal, window):
    """At a head width past 256 (the card's wide pair): the plain backward,
    given the forward's lse, against ``jax.vjp`` of the reference's chunked
    online softmax, within 1e-5 (f32)."""
    q, k, v, do = _qkv_do(b, s, t, hq, hkv, dh, dh + s)
    chunk = 16
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = fa.flash_attention_plain(*ts, causal=causal, window=window, q_chunk=chunk, kv_chunk=chunk,
                                      return_lse=True)
    got = fa.flash_attention_backward_plain(*ts, o, torch.from_numpy(do), lse, causal=causal, window=window,
                                            q_chunk=chunk, kv_chunk=chunk)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash_attention(q_, k_, v_, causal=causal, window=window,
                                                         q_chunk=chunk, kv_chunk=chunk),
                     *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_function_saves_lse_and_hands_it_to_the_backward(monkeypatch):
    """On the CPU ``FlashAttentionFn`` saves the forward's lse beside q, k,
    v and o and passes it to ``flash_attention_backward`` (a spy on the
    module's function): the lse of ``flash_attention(..., return_lse=True)``
    on the same inputs. ``return_lse`` under grad raises (its result would
    be invisible to autograd)."""
    q, k, v, do = _qkv_do(1, 40, 40, 4, 2, 16, 11)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    seen = []
    real = fa.flash_attention_backward

    def spy(*args, **kw):
        seen.append(args[5])
        return real(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_backward", spy)
    o = fa.flash_attention(*ts, window=5)
    saved = o.grad_fn.saved_tensors
    torch.autograd.grad(o, ts, torch.from_numpy(do))
    with torch.no_grad():
        _, want = fa.flash_attention(*ts, window=5, return_lse=True)
    assert len(saved) == 5 and torch.equal(saved[4], want)
    assert len(seen) == 1 and torch.equal(seen[0], want)
    with pytest.raises(ValueError, match="return_lse"):
        fa.flash_attention(*ts, window=5, return_lse=True)


def test_backward_rejects_mismatched_operands():
    q, k, v, do = (torch.from_numpy(x) for x in _qkv_do(1, 8, 8, 2, 1, 16, 1))
    with pytest.raises(ValueError):
        fa.flash_attention_backward(q, k, v, q[:, :4], do)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, q, do, torch.zeros(1, 2, 4))


# ------------------------------------------------------------ train step


@functools.lru_cache(maxsize=None)
def _jstep(m):
    jcfg = _setup("minicpm-2b", "f32")[0]
    opt = jopt.OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    return jax.jit(jmake_train_step(jcfg, JTrainConfig(opt=opt, microbatches=m)))


@pytest.mark.parametrize("m", [1, 2])
def test_train_step_matches_reference(m):
    """Two ``make_train_step`` steps (the first at rate 0) from the same
    weights and batches, microbatches 1 and 2: losses, grad norms and the
    updated masters within 1e-4."""
    jcfg, tcfg, tree = _setup("minicpm-2b", "f32")
    opt = topt.OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(tcfg, TrainConfig(opt=opt, microbatches=m))
    params = _masters(tree, tcfg)
    state = topt.init_opt(params, opt)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init_opt(jp, jopt.OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10))
    for i in range(2):
        batch = _batch(jcfg, 4, 16, 10 + i)
        jp, js, jm = _jstep(m)(jp, js, _jbatch(batch))
        params, state, tm = step(params, state, _tbatch(batch))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(params)), jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    assert all(p.grad is None for p in leaves(params))


# ------------------------------------------- the reference's infra cases


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_loss_decreases(opt):
    tcfg = TrainConfig(opt=topt.OptConfig(name=opt, peak_lr=3e-3, warmup_steps=5, total_steps=60))
    params, state = init_train_state(CFG, tcfg, torch.Generator().manual_seed(0))
    step = make_train_step(CFG, tcfg)
    data = SyntheticLM(DataConfig(vocab=CFG.vocab, seq_len=32, global_batch=8))
    losses = []
    for s in range(30):
        params, state, m = step(params, state, _tbatch(data.batch(s)))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::8]


def test_microbatch_equivalence():
    """Gradient accumulation over 4 microbatches == one big batch."""
    opt = topt.OptConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    params, _ = init_train_state(CFG, TrainConfig(opt=opt), torch.Generator().manual_seed(1))
    data = SyntheticLM(DataConfig(vocab=CFG.vocab, seq_len=16, global_batch=8))
    out = []
    for m in (1, 4):
        p = tree_map(lambda x: x.detach().clone(), params)
        st = topt.init_opt(p, opt)
        st["step"].fill_(1)  # a nonzero rate for this one update
        p, _, metrics = make_train_step(CFG, TrainConfig(opt=opt, microbatches=m))(p, st, _tbatch(data.batch(0)))
        out.append((float(metrics["loss"]), leaves(p)))
    # the reference's bounds: Adam's normalised step turns the last bits of a
    # near-zero gradient into up to lr of a parameter
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-3)
    assert max(float((a - b).abs().max()) for a, b in zip(out[0][1], out[1][1])) < 5e-3


def test_checkpoint_roundtrip(tmp_path):
    tcfg = TrainConfig(opt=topt.OptConfig())
    params, state = init_train_state(CFG, tcfg, torch.Generator().manual_seed(2))
    tree = {"params": params, "opt": state, "step": 7}
    path = ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 7 and restored["step"] == 7
    for a, b in zip(leaves(tree), leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.requires_grad == b.requires_grad and torch.equal(a, b)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and "params/layers/0/attn/wq" in manifest["arrays"]
    assert manifest["arrays"]["opt/step"]["dtype"] == "int32"


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"w": torch.arange(16, dtype=torch.float32)}
    path = ckpt.save(str(tmp_path), 1, tree)
    npz = os.path.join(path, "arrays.npz")
    data = bytearray(open(npz, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(npz, "wb").write(bytes(data))
    with pytest.raises(Exception):
        ckpt.restore(str(tmp_path), tree)


def test_checkpoint_async_snapshots_before_returning(tmp_path, monkeypatch):
    """``save_async`` copies to host memory before it returns: the leaf is
    changed in place before the writer thread may run (held by an event),
    and the checkpoint holds the old values."""
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    release = threading.Event()
    real_save = ckpt.save

    def held_save(*a, **kw):
        assert release.wait(timeout=30)
        return real_save(*a, **kw)

    monkeypatch.setattr(ckpt, "save", held_save)
    t = ckpt.save_async(str(tmp_path), 3, tree)
    tree["w"].add_(1000.0)
    release.set()
    ckpt.wait_pending(str(tmp_path))
    t.join(timeout=30)
    assert not t.is_alive()
    restored, _ = ckpt.restore(str(tmp_path), {"w": torch.zeros(64)})
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(64))


def test_retry_wrapper():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient device failure")
        return 42

    assert with_retries(flaky, max_retries=3)() == 42
    calls["n"] = -10
    with pytest.raises(RuntimeError):
        with_retries(flaky, max_retries=1)()


def _loop(tmp_path, name, seed, **kw):
    dcfg = DataConfig(vocab=CFG.vocab, seq_len=16, global_batch=4)
    tcfg = TrainConfig(opt=topt.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=kw.pop("total", 20)))
    lc = LoopConfig(ckpt_dir=str(tmp_path / name), log_every=1, **kw)
    return TrainLoop(CFG, tcfg, dcfg, lc, seed=seed, device="cpu")


def test_trainloop_failure_recovery(tmp_path):
    """A failure injected mid-run: the retries complete the run, equal to
    the run without failures."""
    fails = {"left": 2}

    def injector(step):
        if step == 5 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("simulated node failure")

    h1 = _loop(tmp_path, "a", 0, ckpt_every=0, max_retries=2).run(10, fail_injector=injector)
    h2 = _loop(tmp_path, "b", 0, ckpt_every=0).run(10)
    assert fails["left"] == 0
    assert [r["loss"] for r in h1] == [r["loss"] for r in h2]


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_trainloop_checkpoint_restart(tmp_path, async_ckpt):
    """Kill after 10 steps, restore, continue to 20 == uninterrupted 20,
    exactly on the CPU."""
    loop_a = _loop(tmp_path, "run1", 3, ckpt_every=10, async_ckpt=async_ckpt, total=40)
    loop_a.run(10)
    loop_b = _loop(tmp_path, "run1", 3, ckpt_every=10, async_ckpt=async_ckpt, total=40)
    assert loop_b.maybe_restore() and loop_b.state["step"] == 10
    h_b = loop_b.run(10)
    loop_c = _loop(tmp_path, "run2", 3, ckpt_every=0, total=40)
    h_c = loop_c.run(20)
    assert [r["loss"] for r in h_b] == [r["loss"] for r in h_c[10:]]
    for a, b in zip(leaves(loop_b.state["params"]), leaves(loop_c.state["params"])):
        assert torch.equal(a, b)


def test_trainloop_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is for hosts without one")
    dcfg = DataConfig(vocab=CFG.vocab, seq_len=16, global_batch=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainLoop(CFG, TrainConfig(), dcfg, LoopConfig(ckpt_every=0))


def test_elastic_mesh_single_device():
    m = elastic_mesh((8, 1), ("data", "model"), device="cpu")
    assert m.shape == {"data": 1, "model": 1} and m.devices.ravel()[0] == torch.device("cpu")


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    hist = tlaunch.main(["--arch", "minicpm-2b", "--reduced", "--steps", "12", "--batch", "4", "--seq", "16",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"])
    assert [r["step"] for r in hist] == [0, 10]
    assert ckpt.latest_step(str(tmp_path)) == 12
    printed = json.loads(capsys.readouterr().out)
    assert printed[-1]["step"] == 10 and np.isfinite(printed[-1]["loss"])


# ------------------------------------------------------- lm_hidden_embed


@pytest.mark.parametrize("arch", ARCHS + SSM_ARCHS)
def test_lm_hidden_embed_matches_reference(arch):
    """[B, D] for dense; for ssm and hybrid the reference's mean of the
    logits, [B, V]."""
    jcfg, tcfg, tree = _setup(arch, "f32")
    toks = _batch(jcfg, 3, 20, 4)["tokens"]
    want = np.asarray(jlm_hidden_embed(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks)))
    got = lm_hidden_embed(params_from_jax(tree, tcfg, device="cpu"), tcfg, torch.from_numpy(toks))
    width = tcfg.d_model if tcfg.family == "dense" else tcfg.vocab
    assert got.dtype == torch.float32 and got.shape == (3, width) == want.shape and got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
