"""The port's LM serving path against the reference, on the CPU: the four
dense archs, mamba2-130m (ssm) and zamba2-2.7b (hybrid) at their reduced
configs in f32, with the reference's weights carried across by
``convert.params_from_jax`` (norm weights, biases and the SSM constants
drawn at random so their branches count): forward logits, prefill logits
and cache (K/V, SSM and conv states), one decode step, and the
``SlotServer`` as a whole (the ssm and hybrid servers in
``tests/test_torch_ssm.py``)."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import api as japi
from repro.models.transformer import lm_forward as jlm_forward
from repro.serve.server import Request as JRequest
from repro.serve.server import SlotServer as JSlotServer
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.models import api
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import ModelConfig, init_lm, lm_forward
from repro_torch.serve.server import Request, SlotServer

DENSE = ["gemma3-27b", "minicpm-2b", "qwen3-32b", "qwen1.5-110b"]
PORTED = DENSE + ["mamba2-130m", "zamba2-2.7b"]
TOL = dict(rtol=2e-3, atol=2e-3)


def _perturb(tree, rng):
    """Norm weights and biases (zeros at init) drawn at random, so the offset
    form, qk-norm and QKV-bias branches change the result; the SSM's A_log,
    dt_bias and D (constants at init) moved by random steps."""
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out[name] = _perturb(v, rng)
        elif name.endswith("norm") or name in ("bq", "bk", "bv"):
            out[name] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        elif name in ("A_log", "dt_bias", "D"):
            out[name] = (np.asarray(v) + rng.normal(size=v.shape) * 0.2).astype(np.float32)
        else:
            out[name] = np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params, port params), f32."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    tree = _perturb(jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.key(1))),
                    np.random.default_rng(7))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(2, cfg.vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", PORTED)
def test_config_matches_reference(arch):
    """Full and reduced configs equal the reference's field by field (dtype
    mapped, the SSM config field by field), and so do the per-layer windows
    and ``subquadratic``."""
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_reduced(arch), jget_reduced(arch))):
        for f in dataclasses.fields(theirs):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name == "dtype":
                assert a == torch.bfloat16 and jnp.dtype(b) == jnp.bfloat16
            elif f.name == "ssm" and b is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
                assert (a.d_inner, a.n_heads) == (b.d_inner, b.n_heads)
            else:
                assert a == b, f.name
        assert ours.layer_windows() == np.asarray(theirs.layer_windows()).tolist()
        assert ours.subquadratic == theirs.subquadratic
    assert sorted(ARCHS) == sorted(JARCHS)


def test_gemma3_windows():
    assert get_config("gemma3-27b").layer_windows()[:12] == [1024] * 5 + [0] + [1024] * 5 + [0]
    assert get_reduced("gemma3-27b").layer_windows() == [16] * 5 + [0]


@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg, 2, 40, 0)
    want, _ = jlm_forward(jp, jcfg, jnp.asarray(toks))
    got, aux = lm_forward(tp, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and set(aux) == {"lb_loss", "z_loss", "dropped_frac"}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_reference(arch):
    """serve_prefill (last logits, every cache leaf: the padded K/V, the SSM
    and conv states, the lengths; the same leaves in the same shapes), then
    one serve_decode step from that cache."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg, 2, 37, 1)
    jl, jc = japi.serve_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=44)
    tl, tc = api.serve_prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, max_len=44)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc) == set(jc)
    for name in jc:
        assert tc[name].shape == jc[name].shape, name
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), **TOL)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist()

    nxt = np.array([5, 9], np.int32)
    jl1, jc1 = japi.serve_decode(jp, jcfg, jnp.asarray(nxt), jc)
    tl1, tc1 = api.serve_decode(tp, tcfg, torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), **TOL)
    for name in jc1:
        np.testing.assert_allclose(tc1[name].numpy(), np.asarray(jc1[name]), **TOL)
    assert tc1["len"].tolist() == [38, 38]


@pytest.mark.parametrize("arch", PORTED)
def test_decode_reproduces_forward(arch):
    """The port's own prefill + decode reproduce its teacher-forced forward."""
    _, tcfg, _, tp = _pair(arch)
    toks = torch.from_numpy(_tokens(tcfg, 2, 30, 2))
    full, _ = lm_forward(tp, tcfg, toks)
    logits_p, cache = api.serve_prefill(tp, tcfg, {"tokens": toks[:, :28]}, max_len=34)
    np.testing.assert_allclose(logits_p.numpy(), full[:, 27].numpy(), **TOL)
    for i in (28, 29):
        logits_d, cache = api.serve_decode(tp, tcfg, toks[:, i], cache)
        np.testing.assert_allclose(logits_d.numpy(), full[:, i].numpy(), **TOL)


def test_slot_server_matches_reference():
    """Reduced gemma3 (window 16, f32): the reference's SlotServer and the
    port's return identical tokens for 5 requests of 20-60 tokens through 3
    slots, 6 new tokens each. Every greedy step has a top-2 margin above
    1e-3 in the reference's teacher-forced logits, so a flip is a fault."""
    jcfg, tcfg, jp, tp = _pair("gemma3-27b")
    rng = np.random.default_rng(0)
    lens = [20, 60, 33, 47, 25]
    prompts = [rng.integers(2, jcfg.vocab, n).astype(np.int32) for n in lens]
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    JSlotServer(jp, jcfg, n_slots=3, max_len=74).run(jreqs)
    launches, calls = fa.flash_attention.launches, fa.flash_attention_plain.calls
    SlotServer(tp, tcfg, n_slots=3, max_len=74).run(treqs)
    assert fa.flash_attention.launches == launches
    assert fa.flash_attention_plain.calls == calls + len(prompts) * tcfg.n_layers
    for jr, tr in zip(jreqs, treqs):
        assert jr.done and tr.done
        assert tr.out_tokens == jr.out_tokens, tr.rid
        seq = np.concatenate([jr.prompt, np.asarray(jr.out_tokens[:-1], np.int32)])
        logits, _ = jlm_forward(jp, jcfg, jnp.asarray(seq[None]))
        steps = np.asarray(logits)[0, len(jr.prompt) - 1:]
        top2 = np.sort(steps, axis=-1)[:, -2:]
        assert (np.argmax(steps, axis=-1) == np.asarray(jr.out_tokens)).all()
        assert (top2[:, 1] - top2[:, 0] > 1e-3).all()


def test_count_params_matches_reference():
    for arch in PORTED:
        jcfg, tcfg, jp, tp = _pair(arch)
        assert api.count_params(tp) == japi.count_params(jp)


def test_init_lm_draws_dense_weights():
    """Random init on a generator: stored types, shapes, and a seed that
    repeats."""
    cfg = dataclasses.replace(get_reduced("qwen1.5-110b"), dtype=torch.bfloat16)
    a = init_lm(cfg, torch.Generator().manual_seed(3))
    b = init_lm(cfg, torch.Generator().manual_seed(3))
    assert a["embedding"].dtype == torch.float32 and a["final_norm"].dtype == torch.float32
    lp = a["layers"][0]
    assert lp["attn"]["wq"].dtype == torch.bfloat16 and lp["attn"]["bq"].dtype == torch.bfloat16
    assert lp["attn_norm"].dtype == torch.float32 and len(a["layers"]) == cfg.n_layers
    assert torch.equal(a["layers"][1]["mlp"]["w_up"], b["layers"][1]["mlp"]["w_up"])
    jcfg, _, jp, _ = _pair("qwen1.5-110b")
    assert api.count_params(a) == japi.count_params(jp)


def test_other_families_are_not_ported():
    """Every family of the reference is ported: the four archs of the moe,
    vlm and encdec families are in the registry and their entry points
    run; a family the reference does not have raises ``ValueError`` at
    every entry point."""
    for arch in ("deepseek-moe-16b", "internvl2-2b", "whisper-large-v3", "kimi-k2-1t-a32b"):
        cfg = get_reduced(arch)
        assert get_config(arch).name == arch and arch in ARCHS
        params = api.init_model(cfg, torch.Generator().manual_seed(0))
        assert api.count_params(params) > 0 and set(api.init_cache(cfg, 1, 8, device="cpu")) >= {"len", "k", "v"}
    cfg = ModelConfig(name="toy", family="retrieval", n_layers=2, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
                      vocab=64)
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for fn in (lambda: init_lm(cfg, torch.Generator()), lambda: api.init_cache(cfg, 1, 8, device="cpu"),
               lambda: lm_forward({}, cfg, toks), lambda: api.serve_prefill({}, cfg, {"tokens": toks}),
               lambda: api.input_specs(cfg, "prefill", batch=1, seq_len=4)):
        with pytest.raises(ValueError, match="unknown family"):
            fn()


def test_decode_raises_on_a_full_cache():
    """The reference clamps the cache write at the end; the port raises."""
    _, tcfg, _, tp = _pair("minicpm-2b")
    toks = torch.from_numpy(_tokens(tcfg, 1, 6, 3))
    _, cache = api.serve_prefill(tp, tcfg, {"tokens": toks}, max_len=7)
    _, cache = api.serve_decode(tp, tcfg, toks[:, 0], cache)
    with pytest.raises(ValueError, match="max_len"):
        api.serve_decode(tp, tcfg, toks[:, 0], cache)


def test_serve_cli_runs_on_cpu(capsys):
    tserve.main(["--arch", "gemma3-27b", "--device", "cpu", "--requests", "3", "--slots", "2",
                 "--prompt-len", "20", "--max-new", "4"])
    assert "served 3 requests" in capsys.readouterr().out
