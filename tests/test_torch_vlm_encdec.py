"""The port's vlm and encdec families against the reference, on the CPU, at
the reduced internvl2-2b and whisper-large-v3 in f32 (the reference's
weights carried across by ``convert.params_from_jax``, norm weights drawn at
random): internvl2's forward with patch embeddings, its loss over the text
positions, prefill and decode; whisper's ``encode``, ``decode_train``,
prefill and decode steps, loss and gradients; the ``vision_embeds`` and
``frames`` entries of ``api.input_specs``; ``lm_hidden_embed`` of the vlm
and moe families and its refusal of encdec; and the ``SlotServer``'s
refusal of vlm and encdec. Inputs are drawn
with numpy from fixed seeds."""
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import api as japi
from repro.models import encdec as jed
from repro.models.transformer import lm_forward as jlm_forward
from repro.models.transformer import lm_hidden_embed as jlm_hidden_embed
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import api, encdec
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import lm_forward, lm_hidden_embed
from repro_torch.models.tree import leaves, tree_map
from repro_torch.serve.server import SlotServer

F32 = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    return np.asarray(x, np.float32)


def _perturb(tree, rng):
    """Norm weights (zeros at init) drawn at random."""
    return {name: _perturb(v, rng) if isinstance(v, dict)
            else (rng.normal(size=v.shape) * 0.1).astype(np.float32) if name.endswith("norm") else np.asarray(v)
            for name, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params as jax arrays, port params), f32."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    tree = _perturb(jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.key(1))), np.random.default_rng(7))
    return jcfg, tcfg, tree, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, device="cpu")


def _inputs(cfg, b, s, seed):
    """tokens and labels int32 [b, s] (a few labels ignored), and the
    family's extra input in f32: patch embeddings or frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(2, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(2, cfg.vocab, (b, s)).astype(np.int32)}
    batch["labels"][0, :2] = -100
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(size=(b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    else:
        batch["frames"] = rng.normal(size=(b, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    return batch


def _j(batch, *keys):
    return {k: jnp.asarray(batch[k]) for k in keys}


def _t(batch, *keys):
    return {k: torch.from_numpy(batch[k]) for k in keys}


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-large-v3"])
def test_config_matches_reference(arch):
    for ours, theirs in ((get_config(arch), jget_config(arch)), (get_reduced(arch), jget_reduced(arch))):
        for f in dataclasses.fields(theirs):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if f.name == "dtype":
                assert a == torch.bfloat16 and jnp.dtype(b) == jnp.bfloat16
            else:
                assert a == b, f.name


# ------------------------------------------------------------------ vlm


def test_vlm_forward_with_patches_matches_reference():
    """Logits over patches + tokens [B, P + S, V] within 1e-4."""
    jcfg, tcfg, _, jp, tp = _pair("internvl2-2b")
    batch = _inputs(jcfg, 2, 20, 0)
    want, _ = jlm_forward(jp, jcfg, jnp.asarray(batch["tokens"]), vision_embeds=jnp.asarray(batch["vision_embeds"]))
    got, aux = lm_forward(tp, tcfg, torch.from_numpy(batch["tokens"]),
                          vision_embeds=torch.from_numpy(batch["vision_embeds"]))
    assert got.shape == (2, jcfg.vision_patches + 20, jcfg.vocab)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), **F32)
    assert all(float(v) == 0.0 for v in aux.values())


def test_vlm_loss_over_text_positions_and_gradients():
    """``loss_fn`` takes the loss over ``logits[:, P:]`` only: loss and every
    gradient leaf against ``jax.value_and_grad`` of the reference's."""
    jcfg, tcfg, tree, jp, _ = _pair("internvl2-2b")
    batch = _inputs(jcfg, 2, 16, 1)
    keys = ("tokens", "labels", "vision_embeds")
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, jcfg, b)[0]))(jp, _j(batch, *keys))
    params = params_from_jax(tree, tcfg, device="cpu", masters=True)
    for p in leaves(params):
        p.requires_grad_(True)
    loss, aux = api.loss_fn(params, tcfg, _t(batch, *keys))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-4)
    assert float(aux["ce_loss"]) == pytest.approx(float(jl), rel=1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tree_map(lambda p: p.grad, params))), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, _np(b), **F32)


def test_vlm_prefill_and_decode_match_reference():
    """The prefill over P + S positions (every cache leaf, padded to
    ``max_len``), then three decode steps, and decode against the forward."""
    jcfg, tcfg, _, jp, tp = _pair("internvl2-2b")
    batch = _inputs(jcfg, 2, 12, 2)
    keys = ("tokens", "vision_embeds")
    max_len = jcfg.vision_patches + 12 + 4
    jl, jc = japi.serve_prefill(jp, jcfg, _j(batch, *keys), max_len=max_len)
    tl, tc = api.serve_prefill(tp, tcfg, _t(batch, *keys), max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **F32)
    assert set(tc) == set(jc) and tc["k"].shape == jc["k"].shape == (2, 2, max_len, 2, 16)
    for key in jc:
        np.testing.assert_allclose(tc[key].float().numpy(), _np(jc[key]), **F32, err_msg=key)
    for i in range(3):
        jl, jc = japi.serve_decode(jp, jcfg, jnp.asarray(batch["tokens"][:, i]), jc)
        tl, tc = api.serve_decode(tp, tcfg, torch.from_numpy(batch["tokens"][:, i]), tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **F32)
    toks = torch.from_numpy(batch["tokens"])
    full, _ = lm_forward(tp, tcfg, toks, vision_embeds=torch.from_numpy(batch["vision_embeds"]))
    _, cache = api.serve_prefill(tp, tcfg, {"tokens": toks[:, :11], "vision_embeds": _t(batch, *keys)["vision_embeds"]},
                                 max_len=max_len)
    logits, _ = api.serve_decode(tp, tcfg, toks[:, 11], cache)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].detach().numpy(), rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------- encdec


def test_sinusoids_match_reference():
    np.testing.assert_allclose(encdec.sinusoids(37, 64).numpy(), _np(jed.sinusoids(37, 64)), rtol=1e-5, atol=1e-5)


def test_encode_and_decode_train_match_reference():
    """The bidirectional encoder over the frames (through the attention
    kernel's plain version with ``causal=False``), and the teacher-forced
    decoder with cross-attention, each within 1e-4."""
    jcfg, tcfg, _, jp, tp = _pair("whisper-large-v3")
    batch = _inputs(jcfg, 2, 10, 3)
    want_enc = jed.encode(jp, jcfg, jnp.asarray(batch["frames"]))
    got_enc = encdec.encode(tp, tcfg, torch.from_numpy(batch["frames"]))
    np.testing.assert_allclose(got_enc.numpy(), _np(want_enc), **F32)
    want = jed.decode_train(jp, jcfg, jnp.asarray(batch["tokens"]), want_enc)
    got = encdec.decode_train(tp, tcfg, torch.from_numpy(batch["tokens"]), got_enc)
    assert got.dtype == torch.float32 and got.shape == (2, 10, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_encoder_attends_both_ways():
    """Changing the last frame changes the encoder's first position (no
    causal mask), and the decoder's first logits through cross-attention."""
    _, tcfg, _, _, tp = _pair("whisper-large-v3")
    frames = torch.from_numpy(_inputs(tcfg, 1, 4, 4)["frames"])
    moved = frames.clone()
    moved[0, -1] += 1.0
    a, b = encdec.encode(tp, tcfg, frames), encdec.encode(tp, tcfg, moved)
    assert float((a[0, 0] - b[0, 0]).abs().max()) > 1e-4


def test_encdec_loss_and_gradients_match_reference():
    """``loss_fn`` on {tokens, labels, frames} returns {"ce_loss"} alone, as
    the reference; loss and every gradient leaf (encoder, decoder, cross
    attention, embedding) within 1e-4."""
    jcfg, tcfg, tree, jp, _ = _pair("whisper-large-v3")
    batch = _inputs(jcfg, 2, 12, 5)
    keys = ("tokens", "labels", "frames")
    (jl, jaux), jg = jax.jit(jax.value_and_grad(lambda p, b: japi.loss_fn(p, jcfg, b), has_aux=True))(
        jp, _j(batch, *keys))
    params = params_from_jax(tree, tcfg, device="cpu", masters=True)
    for p in leaves(params):
        p.requires_grad_(True)
    loss, aux = api.loss_fn(params, tcfg, _t(batch, *keys))
    loss.backward()
    assert set(aux) == set(jaux) == {"ce_loss"}
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-4)
    got = params_to_numpy(tree_map(lambda p: p.grad, params))
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, jg))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, _np(b), **F32)


def test_encdec_prefill_and_decode_match_reference():
    """The prefill (last logits; self K/V padded to ``max_len``, the cross
    K/V over the frames), four decode steps, and greedy tokens equal."""
    jcfg, tcfg, _, jp, tp = _pair("whisper-large-v3")
    batch = _inputs(jcfg, 3, 4, 6)
    keys = ("tokens", "frames")
    jl, jc = japi.serve_prefill(jp, jcfg, _j(batch, *keys), max_len=12)
    tl, tc = api.serve_prefill(tp, tcfg, _t(batch, *keys), max_len=12)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **F32)
    assert set(tc) == set(jc) == {"len", "k", "v", "xk", "xv"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        np.testing.assert_allclose(tc[key].float().numpy(), _np(jc[key]), **F32, err_msg=key)
    jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    jtoks, ttoks = [], []
    for _ in range(4):
        jl, jc = japi.serve_decode(jp, jcfg, jtok.astype(jnp.int32), jc)
        tl, tc = api.serve_decode(tp, tcfg, ttok.to(torch.int32), tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **F32)
        jtok, ttok = jnp.argmax(jl, -1), torch.argmax(tl, -1)
        jtoks.append(np.asarray(jtok).tolist())
        ttoks.append(ttok.tolist())
    assert ttoks == jtoks
    assert tc["len"].tolist() == [8, 8, 8]


def test_encdec_decode_raises_on_a_full_cache():
    _, tcfg, _, _, tp = _pair("whisper-large-v3")
    batch = _inputs(tcfg, 1, 4, 7)
    _, cache = api.serve_prefill(tp, tcfg, _t(batch, "tokens", "frames"), max_len=5)
    _, cache = api.serve_decode(tp, tcfg, torch.tensor([3], dtype=torch.int32), cache)
    with pytest.raises(ValueError, match="max_len"):
        api.serve_decode(tp, tcfg, torch.tensor([3], dtype=torch.int32), cache)


# ------------------------------------------------- specs, embeds, serving


@pytest.mark.parametrize("arch,kind", [("internvl2-2b", "train"), ("internvl2-2b", "prefill"),
                                       ("whisper-large-v3", "train"), ("whisper-large-v3", "prefill")])
def test_input_specs_carry_patches_and_frames(arch, kind):
    """``vision_embeds`` f32 [B, P, D] and ``frames`` f32 [B, F, D] beside the
    tokens, on the meta device, as the reference's ``ShapeDtypeStruct``s."""
    cfg = get_config(arch)
    got = api.input_specs(cfg, kind, batch=4, seq_len=2048)
    want = japi.input_specs(jget_config(arch), kind, batch=4, seq_len=2048)
    assert set(got) == set(want)
    name = "vision_embeds" if cfg.family == "vlm" else "frames"
    assert tuple(got[name].shape) == want[name].shape == (4, 256 if name == "vision_embeds" else 1500, cfg.d_model)
    assert got[name].dtype == torch.float32 and got[name].device.type == "meta"
    assert got["tokens"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["internvl2-2b", "deepseek-moe-16b"])
def test_lm_hidden_embed_matches_reference(arch):
    """vlm: the dense path without patches, f32 [B, D]; moe: the logits'
    mean [B, V], as the reference's fallback (1e-4). The dense, ssm and
    hybrid families: ``tests/test_torch_train.py``."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(get_reduced(arch), dtype=torch.float32)
    tree = jax.tree.map(np.asarray, japi.init_model(jcfg, jax.random.key(2)))
    toks = np.random.default_rng(8).integers(2, jcfg.vocab, (3, 10)).astype(np.int32)
    want = jlm_hidden_embed(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(toks))
    got = lm_hidden_embed(params_from_jax(tree, tcfg, device="cpu"), tcfg, torch.from_numpy(toks))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.shape[1] == (jcfg.d_model if jcfg.family in ("dense", "vlm") else jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **F32)


def test_lm_hidden_embed_refuses_encdec():
    """The reference's ``lm_hidden_embed`` falls back to ``lm_forward``,
    which raises ``ValueError`` for encdec; so does the port's."""
    jcfg, tcfg, _, jp, tp = _pair("whisper-large-v3")
    toks = np.zeros((1, 4), np.int32)
    with pytest.raises(ValueError):
        jlm_hidden_embed(jp, jcfg, jnp.asarray(toks))
    with pytest.raises(ValueError):
        lm_hidden_embed(tp, tcfg, torch.from_numpy(toks))


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-large-v3"])
def test_slot_server_refuses_vlm_and_encdec(arch):
    """The reference's server prefills tokens only, and its
    ``api.serve_prefill`` then raises ``KeyError``; the port refuses at
    construction, naming ``api.serve_prefill``."""
    _, tcfg, _, _, tp = _pair(arch)
    with pytest.raises(ValueError, match="api.serve_prefill"):
        SlotServer(tp, tcfg, n_slots=2, max_len=32)


def test_serve_cli_keeps_the_encdec_exit():
    with pytest.raises(SystemExit, match="decoder-only"):
        tserve.main(["--arch", "whisper-large-v3", "--device", "cpu"])
