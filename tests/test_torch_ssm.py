"""The port's ssm and hybrid families against the reference, on the CPU: the
Mamba2 pieces (``_causal_conv``, ``ssd_chunked``, ``ssm_block``) on seeded
inputs in f32, the port's own chunk invariance and chunked-equals-recurrence,
the reduced mamba2-130m and zamba2-2.7b served through ``SlotServer``
(tokens equal to the reference's; the port also at ``n_slots=2``, where the
reference's axis guess fails), the ``launch`` CLIs on both, and the dry-run
shape specs (``configs.shapes``, ``api.input_specs``, ``init_cache_specs``,
``params_specs``) of every ported config against the reference's. The
models' forward, prefill, decode and parameter counts are in
``tests/test_torch_models.py``, the loss and gradients in
``tests/test_torch_train.py``."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.configs import shapes as jshapes
from repro.models import api as japi
from repro.models import ssm as jssm
from repro.serve.server import Request as JRequest
from repro.serve.server import SlotServer as JSlotServer
from repro_torch.configs import ARCHS, get_config, get_reduced, shapes
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import api, ssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import lm_forward
from repro_torch.models.tree import leaves_with_paths, path_key, stack_key
from repro_torch.serve.server import Request, SlotServer

F32 = dict(rtol=1e-4, atol=1e-4)
SSM_ARCHS = ["mamba2-130m", "zamba2-2.7b"]


def _np(x):
    return np.asarray(x, np.float32)


def _block_params(cfg, seed):
    """The reference's ``init_ssm`` with A_log, dt_bias, D and the norm drawn
    at random (their inits are constants), as numpy; and the port's copy."""
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.key(seed), cfg))
    h = cfg.n_heads
    p["A_log"] = (rng.normal(size=h) * 0.5).astype(np.float32)
    p["dt_bias"] = (-2.0 + rng.normal(size=h) * 0.5).astype(np.float32)
    p["D"] = (1.0 + rng.normal(size=h) * 0.3).astype(np.float32)
    p["norm"] = (rng.normal(size=p["norm"].shape) * 0.1).astype(np.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _tcfg(jcfg):
    return ssm.SSMConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(0)
    xbc = rng.normal(size=(2, 13, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32) * 0.5
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state else None
    want, want_st = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w), None if st is None else jnp.asarray(st))
    got, got_st = ssm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w),
                                   None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    np.testing.assert_array_equal(got_st.numpy(), _np(want_st))


@pytest.mark.parametrize("s,chunk,init", [(37, 8, False), (37, 8, True), (16, 16, True), (5, 32, False),
                                          (64, 16, False)])
def test_ssd_chunked_matches_reference(s, chunk, init):
    """Ragged S (padded to chunks), S below one chunk, and a carried-in
    state: y and the final state within 1e-4."""
    rng = np.random.default_rng(s + chunk)
    b, h, p, n = 2, 3, 4, 5
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)) - 1.0)).astype(np.float32)
    a = -np.exp(rng.normal(size=h) * 0.5).astype(np.float32)
    bm = rng.normal(size=(b, s, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, n)).astype(np.float32)
    st = rng.normal(size=(b, h, n, p)).astype(np.float32) if init else None
    args = (xh, dt, a, bm, cm)
    want_y, want_s = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                                      init_state=None if st is None else jnp.asarray(st))
    got_y, got_s = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk,
                                   init_state=None if st is None else torch.from_numpy(st))
    assert got_y.shape == (b, s, h, p) and got_s.shape == (b, h, n, p)
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), **F32)
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), **F32)


@pytest.mark.parametrize("mode", ["chunked", "single-token"])
def test_ssm_block_matches_reference(mode):
    """The whole block in f32: the chunked path over 29 tokens (chunk 8),
    and one decode step from a random state; output and both new states."""
    jcfg = jssm.SSMConfig(d_model=16, d_state=8, head_dim=8, expand=2, chunk=8)
    jp, tp = _block_params(jcfg, 3)
    rng = np.random.default_rng(4)
    s = 29 if mode == "chunked" else 1
    x = rng.normal(size=(2, s, 16)).astype(np.float32)
    state = None
    if mode == "single-token":
        state = {"ssm": rng.normal(size=(2, jcfg.n_heads, 8, 8)).astype(np.float32),
                 "conv": rng.normal(size=(2, 3, jcfg.d_inner + 16)).astype(np.float32)}
    want, wst = jssm.ssm_block(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jcfg,
                               state=None if state is None else jax.tree.map(jnp.asarray, state))
    got, gst = ssm.ssm_block(tp, torch.from_numpy(x), _tcfg(jcfg),
                             state=None if state is None else {k: torch.from_numpy(v) for k, v in state.items()})
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)
    for k in ("ssm", "conv"):
        assert gst[k].shape == wst[k].shape
        np.testing.assert_allclose(gst[k].numpy(), _np(wst[k]), **F32)


def test_ssd_chunk_invariance():
    """The port's chunked SSD does not depend on the chunk size (the
    reference's test, on the port)."""
    cfg16 = ssm.SSMConfig(d_model=32, d_state=8, head_dim=8, expand=2, chunk=16)
    cfg4 = dataclasses.replace(cfg16, chunk=4)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), cfg16)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 32)).astype(np.float32))
    y16, _ = ssm.ssm_block(p, x, cfg16)
    y4, _ = ssm.ssm_block(p, x, cfg4)
    np.testing.assert_allclose(y16.numpy(), y4.numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_matches_recurrence():
    """The port's chunked SSD (training and prefill) equals its
    token-by-token recurrence (decode), within the reference's 5e-3; the
    final states too."""
    cfg = ssm.SSMConfig(d_model=16, d_state=8, head_dim=8, expand=2, chunk=8)
    p = ssm.init_ssm(torch.Generator().manual_seed(2), cfg)
    s = 20
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(1, s, 16)).astype(np.float32))
    y_chunk, fin = ssm.ssm_block(p, x, cfg)
    state = {"ssm": torch.zeros((1, cfg.n_heads, cfg.d_state, cfg.head_dim)),
             "conv": torch.zeros((1, cfg.conv_width - 1, cfg.d_inner + 2 * cfg.d_state))}
    ys = []
    for t in range(s):
        y, state = ssm.ssm_block(p, x[:, t:t + 1], cfg, state=state)
        ys.append(y)
    np.testing.assert_allclose(y_chunk.numpy(), torch.cat(ys, dim=1).numpy(), rtol=5e-3, atol=5e-3)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(fin[k].numpy(), state[k].numpy(), rtol=5e-3, atol=5e-3)


def test_ssd_masked_decay_has_finite_gradients():
    """A chunk long and steep enough that exp(cum_i - cum_j) above the
    diagonal would overflow f32: the output and its gradients stay finite."""
    b, s, h, p, n = 1, 64, 2, 4, 3
    gen = torch.Generator().manual_seed(0)
    xh = torch.randn((b, s, h, p), generator=gen, requires_grad=True)
    dt = torch.full((b, s, h), 4.0, requires_grad=True)
    a = torch.tensor([-1.0, -2.0], requires_grad=True)
    bm, cm = torch.randn((b, s, n), generator=gen), torch.randn((b, s, n), generator=gen)
    y, st = ssm.ssd_chunked(xh, dt, a, bm, cm, 64)
    (y.sum() + st.sum()).backward()
    for t in (y, xh.grad, dt.grad, a.grad):
        assert torch.isfinite(t).all()


# --------------------------------------------------------------- serving


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params, port params), f32, the
    ssm constants and norms perturbed."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    rng = np.random.default_rng(7)
    tree = jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.key(1)))

    def perturb(t):
        out = {}
        for name, v in t.items():
            if isinstance(v, dict):
                out[name] = perturb(v)
            elif name.endswith("norm") or name in ("A_log", "dt_bias", "D"):
                out[name] = (np.asarray(v) + rng.normal(size=v.shape) * 0.2).astype(np.float32)
            else:
                out[name] = np.asarray(v)
        return out

    tree = perturb(tree)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, device="cpu")


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_slot_server_matches_reference(arch):
    """5 requests of 20-60 tokens through 3 slots, 6 new tokens each: the
    reference's tokens. The hybrid's server launches (on the CPU: calls the
    plain version of) the attention kernel once per group and prefill."""
    jcfg, tcfg, jp, tp = _pair(arch)
    prompts = _prompts(jcfg.vocab, [20, 60, 33, 47, 25], 0)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    JSlotServer(jp, jcfg, n_slots=3, max_len=74).run(jreqs)
    calls = fa.flash_attention_plain.calls
    SlotServer(tp, tcfg, n_slots=3, max_len=74).run(treqs)
    groups = tcfg.n_groups if tcfg.family == "hybrid" else 0
    assert fa.flash_attention_plain.calls == calls + len(prompts) * groups
    for jr, tr in zip(jreqs, treqs):
        assert jr.done and tr.done
        assert tr.out_tokens == jr.out_tokens, tr.rid


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_slot_server_at_two_slots(arch):
    """At ``n_slots=2`` the reduced zamba2's cache has G = E = 2 = n_slots:
    the reference's ``admit`` takes a group axis for the batch axis and
    raises; the port copies by the layout's axes and serves the same tokens
    as the reference does at 3 slots. The reduced mamba2 serves at 2 in
    both."""
    jcfg, tcfg, jp, tp = _pair(arch)
    prompts = _prompts(jcfg.vocab, [10, 10, 10], 1)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    JSlotServer(jp, jcfg, n_slots=3, max_len=20).run(jreqs)
    treqs = [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    SlotServer(tp, tcfg, n_slots=2, max_len=20).run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    at_two = [JRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    if arch == "zamba2-2.7b":
        with pytest.raises(ValueError):
            JSlotServer(jp, jcfg, n_slots=2, max_len=20).run(at_two)
    else:
        JSlotServer(jp, jcfg, n_slots=2, max_len=20).run(at_two)
        assert [r.out_tokens for r in at_two] == [r.out_tokens for r in jreqs]


def test_ssm_decode_has_no_length_limit():
    """An SSM cache holds no K/V: decoding past ``max_len`` goes on, and its
    logits stay those of the teacher-forced forward."""
    _, tcfg, _, tp = _pair("mamba2-130m")
    toks = torch.from_numpy(np.random.default_rng(3).integers(2, tcfg.vocab, (1, 12)).astype(np.int32))
    full, _ = lm_forward(tp, tcfg, toks)
    _, cache = api.serve_prefill(tp, tcfg, {"tokens": toks[:, :6]}, max_len=6)
    assert set(cache) == {"len", "ssm", "conv"}
    for i in range(6, 12):
        logits, cache = api.serve_decode(tp, tcfg, toks[:, i], cache)
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(), rtol=2e-3, atol=2e-3)
    assert cache["len"].tolist() == [12]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_cli_runs_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3", "--slots", "2",
                 "--prompt-len", "20", "--max-new", "4"])
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_train_cli_runs_on_cpu(arch, tmp_path, capsys):
    hist = tlaunch.main(["--arch", arch, "--reduced", "--steps", "12", "--batch", "4", "--seq", "16",
                         "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "0"])
    assert [r["step"] for r in hist] == [0, 10]
    assert all(np.isfinite(r["loss"]) for r in hist) and hist[-1]["loss"] < hist[0]["loss"]


# ---------------------------------------------------------- shape specs


def test_shapes_match_reference():
    assert shapes.SHAPES == {k: shapes.ShapeSpec(**dataclasses.asdict(v)) for k, v in jshapes.SHAPES.items()}
    assert shapes.LONG_OK_FAMILIES == jshapes.LONG_OK_FAMILIES
    for family in ("dense", "moe", "ssm", "hybrid", "vlm", "encdec"):
        assert shapes.shapes_for(family) == jshapes.shapes_for(family)


def _shape_tree(tree):
    """{path: shape} of a port tree, the layers stacked as the reference's
    ``[L, ...]`` leaves (one key per stacked leaf, L counted)."""
    out, count = {}, {}
    for path, x in leaves_with_paths(tree):
        assert x.device.type == "meta", path
        key = stack_key(path)
        if key != path_key(path):
            count[key] = count.get(key, 0) + 1
        out[key] = tuple(x.shape)
    return {k: ((count[k],) + s if k in count else s) for k, s in out.items()}


def _jshape_tree(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(x.shape)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


_CASES = [(arch, name) for arch in sorted(ARCHS) for name in shapes.shapes_for(get_config(arch).family)]


@pytest.mark.parametrize("arch,shape", _CASES)
def test_input_specs_match_reference(arch, shape):
    """Every assigned shape of every ported config (long_500k for ssm and
    hybrid): the step's inputs, the decode cache and the parameters as the
    reference's ``ShapeDtypeStruct``s have them, every tensor on ``meta``."""
    cfg, jcfg, spec = get_config(arch), jget_config(arch), shapes.SHAPES[shape]
    got = api.input_specs(cfg, spec.kind, batch=spec.global_batch, seq_len=spec.seq_len)
    want = japi.input_specs(jcfg, spec.kind, batch=spec.global_batch, seq_len=spec.seq_len)
    assert _shape_tree(got) == _jshape_tree(want)
    for path, x in leaves_with_paths(got):
        ref = want
        for p in path:
            ref = ref[p]
        assert str(x.dtype).replace("torch.", "") == str(jnp.dtype(ref.dtype)), path
    if shape == shapes.shapes_for(cfg.family)[0]:
        assert _shape_tree(api.params_specs(cfg)) == _jshape_tree(japi.params_specs(jcfg))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_have_the_port_types(arch):
    """The specs' dtypes are those of the port's own ``init_model(...,
    masters=True)`` and ``init_cache`` (reduced config, on the CPU)."""
    cfg = get_reduced(arch)
    real = api.init_model(cfg, torch.Generator().manual_seed(0), masters=True)
    spec = api.params_specs(cfg)
    assert ([(path, x.dtype, tuple(x.shape)) for path, x in leaves_with_paths(spec)]
            == [(path, x.dtype, tuple(x.shape)) for path, x in leaves_with_paths(real)])
    cache = api.init_cache(cfg, 3, 16, device="cpu")
    cspec = api.init_cache_specs(cfg, 3, 16)
    assert {k: (v.dtype, tuple(v.shape)) for k, v in cache.items()} == \
        {k: (v.dtype, tuple(v.shape)) for k, v in cspec.items()}
    assert all(v.device.type == "meta" for v in cspec.values())


def test_long_context_specs_allocate_nothing():
    """zamba2 at long_500k: k/v for 524,288 tokens (48 GB a batch row in
    bf16) and 2.34 B parameters come back as meta tensors."""
    cfg = get_config("zamba2-2.7b")
    spec = shapes.SHAPES["long_500k"]
    got = api.input_specs(cfg, "decode", batch=spec.global_batch, seq_len=spec.seq_len)
    k = got["cache"]["k"]
    assert k.device.type == "meta" and k.numel() * k.element_size() == 9 * 524_288 * 32 * 80 * 2 * 1
    assert api.count_params(api.params_specs(cfg)) == japi.count_params(japi.params_specs(jget_config("zamba2-2.7b")))


def test_unported_families_raise_in_the_specs():
    """A vlm config's specs now carry its patch embeddings and build its
    parameters and cache on the meta device; a family the reference does
    not have raises ``ValueError`` in every spec function."""
    cfg = dataclasses.replace(get_reduced("minicpm-2b"), name="vlm-toy", family="vlm", vision_patches=4)
    spec = api.input_specs(cfg, "train", batch=1, seq_len=8)
    assert tuple(spec["vision_embeds"].shape) == (1, 4, cfg.d_model) and spec["vision_embeds"].device.type == "meta"
    assert api.count_params(api.params_specs(cfg)) == api.count_params(api.params_specs(get_reduced("minicpm-2b")))
    assert api.init_cache_specs(cfg, 1, 8)["k"].device.type == "meta"
    cfg = dataclasses.replace(cfg, name="toy", family="retrieval")
    for fn in (lambda: api.input_specs(cfg, "train", batch=1, seq_len=8), lambda: api.params_specs(cfg),
               lambda: api.init_cache_specs(cfg, 1, 8)):
        with pytest.raises(ValueError, match="unknown family"):
            fn()