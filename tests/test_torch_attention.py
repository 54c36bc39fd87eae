"""The port's attention against the reference, on the CPU: the flash-attention
wrapper (its plain version here) against the Pallas kernel in interpret mode
and the whole-row oracle, the plain chunked version against the reference's
chunked ``models.attention.flash_attention``, the oracle itself, and the
layers around attention (norm, rotary, MLP, projections, decode step).
Inputs come from numpy and go to both packages."""
import importlib.util
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

RNG = np.random.default_rng(0)

# b, s, hq, hkv, dh, causal, window
SHAPES = [
    # the four shapes of tests/test_kernels.py
    (2, 64, 4, 2, 32, True, 0),
    (1, 100, 4, 4, 16, True, 32),
    (2, 33, 8, 2, 64, False, 0),
    (1, 256, 2, 1, 32, True, 64),
    # a window smaller than a 32-row chunk, S over four chunks
    (1, 160, 4, 2, 16, True, 8),
    # GQA group 8
    (1, 64, 8, 1, 32, True, 0),
    # ragged S (not a multiple of the chunk) with a window
    (2, 77, 4, 2, 16, True, 20),
    # causal=False with a window
    (1, 96, 4, 2, 16, False, 24),
]
IDS = [f"b{b}-s{s}-h{hq}/{hkv}-dh{dh}-{'causal' if c else 'full'}-w{w}"
       for b, s, hq, hkv, dh, c, w in SHAPES]


def _qkv(b, s, hq, hkv, dh, t=None, seed=0):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.normal(size=(b, s, hq, dh)).astype(np.float32),
            rng.normal(size=(b, t, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, t, hkv, dh)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window", SHAPES, ids=IDS)
def test_flash_attention_matches_pallas_and_ref(b, s, hq, hkv, dh, causal, window):
    """The wrapper on CPU tensors (the plain version, 32-row chunks) against
    the Pallas kernel in interpret mode (32-row blocks) and the oracle."""
    q, k, v = _qkv(b, s, hq, hkv, dh)
    got = fa.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             q_chunk=32, kv_chunk=32).numpy()
    pallas = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window, bq=32, bk=32, interpret=True)
    oracle = jref.flash_attention_ref(
        *(jnp.moveaxis(jnp.asarray(a), 1, 2) for a in (q, k, v)),
        causal=causal, window=window or None,
    )
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(oracle), 1, 2), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("chunks", [(16, 32), (1024, 1024)], ids=str)
@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window", SHAPES, ids=IDS)
def test_plain_matches_reference_chunked(b, s, hq, hkv, dh, causal, window, chunks):
    """The plain version against the reference's chunked online softmax at the
    same chunk sizes: the same sums in the same order up to skipped chunks."""
    q, k, v = _qkv(b, s, hq, hkv, dh, seed=1)
    qc, kc = chunks
    got = fa.flash_attention_plain(*_t(q, k, v), causal=causal, window=window,
                                   q_chunk=qc, kv_chunk=kc).numpy()
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                 window=window, q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_plain_matches_reference_chunked_bf16():
    """bf16 in, f32 inside, bf16 out: within one bf16 rounding of the reference."""
    q, k, v = _qkv(1, 70, 4, 2, 32, seed=2)
    got = fa.flash_attention_plain(*(x.to(torch.bfloat16) for x in _t(q, k, v)), window=16,
                                   q_chunk=32, kv_chunk=32)
    want = jattn.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), window=16,
                                 q_chunk=32, kv_chunk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize(
    "s,t,causal,window",
    [(40, 40, True, None), (40, 40, True, 8), (8, 20, True, None), (8, 20, True, 5),
     (12, 30, False, None), (1, 33, True, 7)],
)
def test_ref_matches_reference(s, t, causal, window):
    """The whole-row oracle, S != T included (right-aligned query positions)."""
    q, k, v = _qkv(2, s, 4, 2, 16, t=t, seed=3)
    q, k, v = (np.moveaxis(a, 1, 2).copy() for a in (q, k, v))  # [B, H, S, dh]
    got = tref.flash_attention_ref(*_t(q, k, v), causal=causal, window=window).numpy()
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _t(*_qkv(1, 20, 2, 1, 8))
    launches, calls = fa.flash_attention.launches, fa.flash_attention_plain.calls
    out = fa.flash_attention(q, k, v, window=4)
    assert fa.flash_attention.launches == launches
    assert fa.flash_attention_plain.calls == calls + 1
    assert out.shape == q.shape and out.dtype == q.dtype


def test_rows_that_keep_no_key_are_zero():
    """S > T with a window leaves late rows no key: they return 0 (the
    kernel's rule; the Pallas tile would average what it had seen)."""
    q, k, v = _t(*_qkv(1, 20, 2, 1, 8, t=6))
    out = fa.flash_attention(q, k, v, causal=False, window=4)
    assert torch.equal(out[:, 10:], torch.zeros_like(out[:, 10:]))
    assert torch.isfinite(out).all() and out[:, :8].abs().sum() > 0


@pytest.mark.parametrize("dh,ok", [(16, True), (128, True), (256, True), (257, False), (512, False)])
def test_kernel_head_width_limit(dh, ok):
    """dh <= 256 fits the tiled kernels' shared-memory tiles; beyond it the
    wrapper takes the wide kernels (``wide_head``), which hold O in column
    slices within a block's shared memory. The plain version has no limit."""
    assert fa.wide_head(dh) != ok
    assert fa.wide_launch_shape(1, 3, 1, dh, 4)[4] <= 227 * 1024
    q, k, v = _t(*_qkv(1, 3, 1, 1, dh))
    assert fa.flash_attention(q, k, v).shape == q.shape


def test_wrapper_rejects_bad_inputs():
    q, k, v = _t(*_qkv(1, 8, 3, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q, k, v)
    q, k, v = _t(*_qkv(1, 8, 2, 1, 8))
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())


# ------------------------------------- the bf16 kernel's arithmetic, emulated

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.4426950408889634


def _attn_tol():
    """``chip_smoke.py``'s ATTN_TOL, the limits the card holds the kernel to."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.ATTN_TOL


def _bf16_kernel_emulation(q, k, v, *, causal, window, bn, exact_keys=64.0):
    """The arithmetic of the bf16 kernel (``flash_fwd_wgmma_kernel`` in
    ``csrc/flash_attention.cu``) in plain torch, for this test only. Per
    64-row warpgroup, the BN-key tiles of its band in ascending order:
    logits are bf16 q·k products summed in f32, multiplied by
    scale·log2(e) after the product; only tiles that cross the diagonal,
    the window's lower edge or T are masked (to -inf); the running max is
    in log2 units from -3e38; p = exp2(logit - max) in f32 feeds the row
    sums; P enters P·V (f32 sums) rounded to bf16, plus its bf16 remainder
    on the tiles where some row of the warpgroup has fewer than
    ``exact_keys`` effective keys, (sum p)^2 / sum p^2 (0 turns that off);
    the output is acc / max(l, 1e-30), rounded to bf16."""
    b, s, hq, dh = q.shape
    t, hkv = k.shape[1], k.shape[2]
    c = torch.tensor(dh**-0.5, dtype=torch.float32) * LOG2E
    qf, kf, vf = (x.float() for x in (q, k, v))
    out = torch.zeros((b, s, hq, dh), dtype=torch.float32)
    for wq0 in range(0, s, 64):
        rows = min(64, s - wq0)
        qpos = torch.arange(wq0, wq0 + 64)
        w_lo = max(0, wq0 - window + 1) if window > 0 else 0
        w_hi = min(t, wq0 + rows) if causal else t
        for h in range(hq):
            qh = torch.zeros((b, 64, dh))
            qh[:, :rows] = qf[:, wq0:wq0 + rows, h]
            kh, vh = kf[:, :, h // (hq // hkv)], vf[:, :, h // (hq // hkv)]
            m = torch.full((b, 64), -3.0e38)
            l = torch.zeros((b, 64))
            l2 = torch.zeros((b, 64))
            acc = torch.zeros((b, 64, dh))
            for t0 in range((w_lo // bn) * bn, w_hi, bn):
                kpos = torch.arange(t0, t0 + bn)
                kt = torch.zeros((b, bn, dh))
                vt = torch.zeros((b, bn, dh))
                n = min(bn, t - t0)
                kt[:, :n], vt[:, :n] = kh[:, t0:t0 + n], vh[:, t0:t0 + n]
                logits = torch.einsum("bqd,bkd->bqk", qh, kt)
                if (t0 + bn > t or (causal and t0 + bn - 1 > wq0)
                        or (window > 0 and t0 <= wq0 + 63 - window)):
                    keep = kpos[None, :] < t
                    if causal:
                        keep = keep & (kpos[None, :] <= qpos[:, None])
                    if window > 0:
                        keep = keep & (kpos[None, :] > qpos[:, None] - window)
                    logits = logits.masked_fill(~keep, float("-inf"))
                m_new = torch.maximum(m, logits.amax(-1) * c)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(logits * c - m_new[..., None])
                l = l * alpha + p.sum(-1)
                l2 = l2 * alpha * alpha + (p * p).sum(-1)
                hi = p.to(torch.bfloat16).float()
                split = (l[:, :rows] ** 2 < exact_keys * l2[:, :rows]).any(-1)
                lo = (p - hi).to(torch.bfloat16).float() * split[:, None, None]
                acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", hi + lo, vt)
                m = m_new
            out[:, wq0:wq0 + rows, h] = (acc / l.clamp_min(1e-30)[..., None])[:, :rows]
    return out.to(torch.bfloat16)


@pytest.mark.parametrize(
    "s,window,dh,bn",
    [(1100, 1024, 128, 128), (1024, 0, 128, 128), (300, 0, 256, 64), (260, 0, 512, 32),
     (200, 100, 384, 32)],
    ids=["gemma3-window-1024", "gemma3-global", "dh256-bn64", "dh512-bn32", "dh384-bn32-window"],
)
def test_bf16_kernel_arithmetic_within_attn_tol(s, window, dh, bn):
    """Justifies ``ATTN_TOL`` in bf16 before any card run. The kernel's new
    roundings are P to bf16 before P·V and the scale applied after the
    product (f32 rounding only). One bf16 rounding of P errs by up to 2^-9
    of each p, about 1e-3 of |o| on average; on rows with few effective
    keys that reaches the atol of 2e-3 where outputs cancel to near 0, so
    the kernel adds P's bf16 remainder there (exact to ~2^-17). At
    gemma3-like heads (4/2) its emulation stays within rtol 2e-2, atol 2e-3
    of the plain version on the same bf16 inputs, at most a third of the
    limit elementwise (the outputs' own bf16 rounding), with
    ||got - want|| / ||want|| far under the 1e-2 limit."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(torch.bfloat16)
               for sh in ((1, s, 4, dh), (1, s, 2, dh), (1, s, 2, dh)))
    got = _bf16_kernel_emulation(q, k, v, causal=True, window=window, bn=bn).float()
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window).float()
    rtol, atol, rel_tol = _attn_tol()[2]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    worst = float(((got - want).abs() / (atol + rtol * want.abs())).max())
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    assert worst <= 0.5 and rel <= rel_tol / 4


# ---------------------------------------------------------------- layers


def test_rmsnorm_rope_mlp_match_reference():
    x = RNG.normal(size=(2, 9, 4, 16)).astype(np.float32)
    w = RNG.normal(size=(16,)).astype(np.float32) * 0.1
    pos = np.broadcast_to(np.arange(9)[None], (2, 9)).astype(np.int32) + 5
    np.testing.assert_allclose(
        tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), rtol=1e-5, atol=1e-5)
    h = RNG.normal(size=(2, 5, 16)).astype(np.float32)
    p = {n: RNG.normal(size=sh).astype(np.float32) * 0.2
         for n, sh in (("w_up", (16, 24)), ("w_gate", (16, 24)), ("w_down", (24, 16)))}
    np.testing.assert_allclose(
        tlayers.mlp({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(h)).numpy(),
        np.asarray(jlayers.mlp({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(h))),
        rtol=1e-5, atol=1e-5)


def test_embed_scale_rounds_like_reference():
    """gemma multiplies by sqrt(d) rounded to the working type: 73.5 in bf16."""
    assert float(tlayers.embed_scale(5376, torch.bfloat16)) == 73.5
    assert float(tlayers.embed_scale(5376, torch.bfloat16)) == float(jnp.asarray(5376**0.5, jnp.bfloat16))


def _attn_params(cfg, rng):
    dh = cfg.dh
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    p = {"wq": (cfg.d_model, hq), "wk": (cfg.d_model, hkv), "wv": (cfg.d_model, hkv),
         "wo": (hq, cfg.d_model), "bq": (hq,), "bk": (hkv,), "bv": (hkv,),
         "q_norm": (dh,), "k_norm": (dh,)}
    return {n: (rng.normal(size=sh) * (0.2 if len(sh) == 2 else 0.1)).astype(np.float32)
            for n, sh in p.items()}


@pytest.mark.parametrize("qk_norm,qkv_bias", [(False, False), (True, False), (False, True)])
def test_attention_block_matches_reference(qk_norm, qkv_bias):
    """Prefill and one decode step of the whole sub-block (projections, norm
    and bias branches, rotary, attention, output projection)."""
    rng = np.random.default_rng(4)
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=qk_norm,
              qkv_bias=qkv_bias, rope_theta=1e6)
    jcfg, tcfg = jattn.AttnConfig(**kw), tattn.AttnConfig(**kw)
    p = _attn_params(jcfg, rng)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    b, s, T = 2, 21, 24
    x = rng.normal(size=(b, s, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    jo, (jk, jv) = jattn.attention_block(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                         window=jnp.int32(6), q_chunk=8, kv_chunk=8)
    to, (tk, tv) = tattn.attention_block(tp, torch.from_numpy(x), tcfg,
                                         positions=torch.from_numpy(pos), window=6,
                                         q_chunk=8, kv_chunk=8)
    for a, c in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=2e-4, atol=2e-4)

    # decode: caches padded to T, one new token per row at different lengths
    lens = np.array([s + 1, s - 3], np.int32)
    kc = np.zeros((b, T, 2, 8), np.float32)
    vc = np.zeros((b, T, 2, 8), np.float32)
    kc[:, :s], vc[:, :s] = np.asarray(jk), np.asarray(jv)
    x1 = rng.normal(size=(b, 1, 32)).astype(np.float32)
    p1 = (lens - 1)[:, None]
    jo1, (jkc, jvc) = jattn.attention_block(
        jp, jnp.asarray(x1), jcfg, positions=jnp.asarray(p1), window=jnp.int32(6),
        kv_cache=(jnp.asarray(kc), jnp.asarray(vc)), cache_len=jnp.asarray(lens))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    to1, _ = tattn.attention_block(
        tp, torch.from_numpy(x1), tcfg, positions=torch.from_numpy(p1), window=6,
        kv_cache=(tkc, tvc), cache_len=torch.from_numpy(lens))
    np.testing.assert_allclose(to1.numpy(), np.asarray(jo1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(3, 1, 8, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 30, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 30, 2, 16)).astype(np.float32)
    lens = np.array([1, 17, 30], np.int32)
    got = tattn.decode_attention(*_t(q, kc, vc), torch.from_numpy(lens), window=window)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(lens), window=jnp.int32(window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
