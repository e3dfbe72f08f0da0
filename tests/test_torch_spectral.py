"""Port parity: the spectral ops (``tante_tpu_torch.ops.spectral``,
``ops.fused_spectral``) against the JAX package, f32 on the CPU, from
numpy-seeded inputs.

The mode-mixing wrapper runs its plain version here (CPU tensors); it is
held against the Pallas kernel in interpret mode and against
``spectral_mode_matmul_xla`` at atol 1e-4, the JAX package's own tolerance
for that kernel (``tests/test_pallas_kernels.py``): f32 sums over up to 48
channels in another order.  The convolutions are held at 1e-4 abs / 1e-4
rel (a forward and an inverse transform around the mixing).  Under bf16 the
two packages round the two field-sized contractions at different places, so
that case is held at 3e-2 + 3e-2 |want| (bf16 keeps 8 mantissa bits)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (sets the intra-op thread count)
from tante_tpu.models import uno as juno
from tante_tpu.ops import pallas_spectral as jps
from tante_tpu.ops import spectral as jsp
from tante_tpu_torch.models import uno as tuno
from tante_tpu_torch.ops import fused_spectral as fs
from tante_tpu_torch.ops import spectral as tsp

ATOL = RTOL = 1e-4


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def tt(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


# --------------------------------------------------------------------------
# spectral_mode_matmul: the three cases of tests/test_pallas_kernels.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_mode_matmul_matches_jax(reference):
    b, m, ci, co = 4, 22, 48, 48  # non-multiples exercise the Pallas padding
    args = (rand(0, b, m, ci), rand(1, b, m, ci), rand(2, m, ci, co, scale=0.1),
            rand(3, m, ci, co, scale=0.1))
    jargs = tuple(jnp.asarray(a) for a in args)
    if reference == "xla":
        want = jps.spectral_mode_matmul_xla(*jargs)
    else:
        want = jps.spectral_mode_matmul(*jargs, interpret=True)
    got = fs.spectral_mode_matmul(*tt(*args))
    ref = fs.spectral_mode_matmul_ref(*tt(*args))
    for g, r, w in zip(got, ref, want):
        close(g, w, rtol=0)
        close(r, w, rtol=0)


def test_mode_matmul_complex_semantics():
    """(a+bi)(c+di) = (ac-bd) + (ad+bc)i on a 1-mode toy case."""
    one = lambda v: torch.tensor([[[v]]])  # noqa: E731
    o_re, o_im = fs.spectral_mode_matmul(one(2.0), one(3.0), one(5.0), one(7.0))
    assert float(o_re[0, 0, 0]) == 2 * 5 - 3 * 7
    assert float(o_im[0, 0, 0]) == 2 * 7 + 3 * 5


@pytest.mark.parametrize("dft", [True, False])
def test_spectral_conv2d_matches_the_pallas_path(dft):
    x, w = rand(0, 2, 16, 24, 5), rand(1, 5, 7, 4, 6, 2, scale=0.1)
    orig = jps.spectral_mode_matmul
    with mock.patch.object(jps, "spectral_mode_matmul",
                           lambda *a, **k: orig(*a, interpret=True, **k)):
        want = jsp.spectral_conv2d(jnp.asarray(x), jnp.asarray(w), 4, 6, use_pallas=True)
    got = tsp.spectral_conv2d(*tt(x, w), 4, 6, dft=dft)
    close(got, want, rtol=0)
    close(got, jsp.spectral_conv2d(jnp.asarray(x), jnp.asarray(w), 4, 6), rtol=0)


@pytest.mark.parametrize("modes", [(6,), (3, 5), (2, 3, 4)])
def test_mode_matmul_takes_strided_views_and_mode_dims(modes):
    """The weight as stored, (Cin, Cout, *modes, 2), through permuted views,
    and x channel-major: the einsums see what the kernel would be given."""
    b, ci, co = 3, 5, 4
    n = len(modes)
    x = rand(4, 2, b, *modes, ci)
    w = rand(5, ci, co, *modes, 2, scale=0.3)
    perm = (*range(2, 2 + n), 0, 1)
    wt = torch.from_numpy(w)
    xr, xi = tt(x[0], x[1])
    # x with the channel axis moved before the last mode axis in memory
    xr_cm, xi_cm = (t.transpose(-1, -2).contiguous().transpose(-1, -2) for t in (xr, xi))
    got = fs.spectral_mode_matmul(xr_cm, xi_cm, wt[..., 0].permute(perm), wt[..., 1].permute(perm))
    wc = w[..., 0] + 1j * w[..., 1]
    want = np.einsum("b...i,io...->b...o", x[0] + 1j * x[1], wc)
    close(got[0], want.real, atol=1e-5)
    close(got[1], want.imag, atol=1e-5)
    assert got[0].shape == (b, *modes, co)


def test_mode_matmul_rejects_mismatched_operands():
    xr, xi, wr, wi = tt(rand(0, 2, 6, 5), rand(1, 2, 6, 5), rand(2, 6, 5, 4), rand(3, 6, 5, 4))
    with pytest.raises(ValueError, match="modes"):
        fs.spectral_mode_matmul(xr, xi, wr[:5], wi[:5])
    with pytest.raises(ValueError):
        fs.spectral_mode_matmul(xr, xi[:1], wr, wi)
    with pytest.raises(ValueError):
        fs.spectral_mode_matmul(xr[:, 0], xi[:, 0], wr[0], wi[0])  # no mode axis


def test_kernel_tile_orientation_follows_the_weight_strides():
    stored = torch.zeros(5, 4, 3, 6, 2)  # (Cin, Cout, m1, m2, 2)
    wr, wi = (stored[..., i].permute(2, 3, 0, 1) for i in (0, 1))
    x = torch.zeros(2, 3, 6, 5)
    out = torch.zeros(2, 3, 6, 4)
    # The stored weight: modes flat at stride 2, im beside re -> float4 loads.
    assert fs.vector_flags(x, x.clone(), wr, wi, out, out.clone()) == (1, 0, 1)
    # (M, Cin, Cout) contiguous: modes are not the fastest axis.
    w = torch.zeros(18, 5, 4)
    assert fs.vector_flags(x, x, w, w.clone(), out, out)[0] == 0
    # A cropped weight (m2 < stored m2) is not flat over its modes; nor an odd M.
    assert fs.vector_flags(x, x, wr[:, :4], wi[:, :4], out, out)[0] == 0
    assert fs.vector_flags(x, x, wr[:1, :5], wi[:1, :5], out, out)[0] == 0
    # Channel-major x (B, K, C, L) seen as (B, K, L, C): no 2-channel loads.
    assert fs.vector_flags(torch.zeros(2, 3, 6, 6).transpose(-1, -2), x, wr, wi, out, out)[1] == 0
    x = torch.zeros(2, 3, 5, 6).permute(0, 1, 3, 2)              # (B, K, L, C) view of (B, K, C, L)
    out = fs._empty_like_layout(x, 7)
    assert out.shape == (2, 3, 6, 7) and out.permute(0, 1, 3, 2).is_contiguous()
    assert fs._empty_like_layout(torch.zeros(2, 9, 5), 4).is_contiguous()


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_mode_matmul_function_gradients_match_jax(which, monkeypatch):
    """The autograd Function around the launch (the launch itself replaced
    by the plain version here): gradient w.r.t. each of the four operands
    against jax.grad of the XLA form, 1e-5."""
    args = (rand(0, 3, 7, 5), rand(1, 3, 7, 5), rand(2, 7, 5, 4, scale=0.3),
            rand(3, 7, 5, 4, scale=0.3))
    cot = (rand(4, 3, 7, 4), rand(5, 3, 7, 4))

    def jloss(*a):
        o_re, o_im = jps.spectral_mode_matmul_xla(*a)
        return jnp.sum(o_re * cot[0]) + jnp.sum(o_im * cot[1])

    want = jax.grad(jloss, argnums=which)(*(jnp.asarray(a) for a in args))
    monkeypatch.setattr(fs, "_launch", lambda *a: fs.spectral_mode_matmul_ref(*a))
    targs = [t.requires_grad_(i == which) for i, t in enumerate(tt(*args))]
    o_re, o_im = fs._PlainGrad.apply(*targs)
    tcot = tt(*cot)
    ((o_re * tcot[0]).sum() + (o_im * tcot[1]).sum()).backward()
    close(targs[which].grad, want, atol=1e-5, rtol=1e-5)
    assert all(t.grad is None for i, t in enumerate(targs) if i != which)


# --------------------------------------------------------------------------
# The partial DFT's constants
# --------------------------------------------------------------------------


@pytest.mark.parametrize("args,kw", [
    ((16, 24, 4, 4, 6), {}),
    ((16, 25, 3, 2, 7), {}),                                     # odd W, centered rows
    ((12, 8, 2, 2, 5), {}),                                      # Nyquist column kept
    ((16, 24, 3, 3, 5), dict(norm="forward", h_out=8, w_out=12)),   # UNO, down
    ((8, 12, 2, 2, 4), dict(norm="forward", h_out=32, w_out=48)),   # UNO, up
])
def test_partial_rdft_mats_match_jax(args, kw):
    want = jsp._partial_rdft_mats(*args, **kw)
    got = tsp._partial_rdft_mats(*args, **kw)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        close(g, w, atol=1e-6, rtol=0)


def test_dft_constants_are_cached_and_survive_inference_mode():
    """Built once per (geometry, device, dtype), also when first asked for
    under inference_mode: a training step may use them next."""
    tsp._cached_mats.cache_clear()
    x = torch.from_numpy(rand(0, 1, 8, 12, 2))
    with torch.inference_mode():
        first = tsp.dft_mats(x, 8, 12, 2, 2, 3)
    assert tsp.dft_mats(x, 8, 12, 2, 2, 3) is first
    assert tsp.dft_mats(x.bfloat16(), 8, 12, 2, 2, 3).fw.dtype == torch.bfloat16
    assert first.fh_cos.dtype == torch.float32 and not first.fw.is_inference()
    w = torch.from_numpy(rand(1, 2, 3, 2, 3, 2)).requires_grad_(True)
    tsp.spectral_conv2d(x, w, 2, 3).sum().backward()
    assert w.grad is not None and bool(torch.isfinite(w.grad).all())


# --------------------------------------------------------------------------
# The convolutions, both routes to mode space
# --------------------------------------------------------------------------


def jax_dft(monkeypatch, dft: bool):
    """The JAX package's module-level route switch (an environment variable
    there, an argument in the port)."""
    monkeypatch.setattr(jsp, "_SPECTRAL_DFT", dft)


@pytest.mark.parametrize("dft", [True, False])
@pytest.mark.parametrize("shape,modes", [
    ((2, 16, 24, 5), (4, 6)),
    ((2, 16, 25, 5), (4, 6)),     # odd W
    ((1, 6, 10, 3), (4, 3)),      # 2*m1 > h: overlapping corners, FFT route either way
    ((1, 6, 8, 3), (0, 3)),       # no kept mode
    ((2, 8, 6, 4), (3, 9)),       # m2 clamped to W//2 + 1
])
def test_spectral_conv2d_matches_jax(shape, modes, dft, monkeypatch):
    jax_dft(monkeypatch, dft)
    x = rand(0, *shape)
    w = rand(1, shape[-1], 7, max(modes[0], 1), modes[1], 2, scale=0.2)
    want = jsp.spectral_conv2d(jnp.asarray(x), jnp.asarray(w), *modes)
    got = tsp.spectral_conv2d(*tt(x, w), *modes, dft=dft)
    assert got.shape == want.shape == (*shape[:-1], 7)
    close(got, want)


@pytest.mark.parametrize("dft", [True, False])
@pytest.mark.parametrize("shape,modes", [
    ((2, 16, 24, 6), (8, 8)),
    ((2, 16, 25, 6), (5, 6)),     # odd W, odd m1 (3 positive + 2 negative rows)
    ((1, 8, 12, 4), (1, 4)),      # a single positive row, no negative one
])
def test_spectral_conv2d_centered_matches_jax(shape, modes, dft, monkeypatch):
    jax_dft(monkeypatch, dft)
    x = rand(2, *shape)
    w = rand(3, shape[-1], 5, modes[0], modes[1] // 2 + 1, 2, scale=0.2)
    want = jsp.spectral_conv2d_centered(jnp.asarray(x), jnp.asarray(w), *modes)
    got = tsp.spectral_conv2d_centered(*tt(x, w), *modes, dft=dft)
    close(got, want)


@pytest.mark.parametrize("shape,modes", [((2, 16, 6, 24), (8, 8)), ((2, 16, 6, 25), (5, 6))])
def test_spectral_conv2d_centered_cw_matches_jax_and_the_wc_form(shape, modes):
    x = rand(4, *shape)  # (B, H, C, W)
    w = rand(5, shape[2], 5, modes[0], modes[1] // 2 + 1, 2, scale=0.2)
    want = jsp.spectral_conv2d_centered_cw(jnp.asarray(x), jnp.asarray(w), *modes)
    tx, tw = tt(x, w)
    got = tsp.spectral_conv2d_centered_cw(tx, tw, *modes)
    assert got.shape == want.shape == (shape[0], shape[1], 5, shape[3])
    close(got, want)
    wc = tsp.spectral_conv2d_centered(tx.transpose(-1, -2), tw, *modes)
    close(got, wc.transpose(-1, -2))
    with pytest.raises(ValueError):
        tsp.spectral_conv2d_centered_cw(tx, tw, 0, 8)


@pytest.mark.parametrize("shape,modes", [
    ((1, 8, 8, 12, 3), (4, 4, 6)),
    ((2, 6, 5, 9, 2), (3, 1, 4)),   # odd sizes; one axis keeps a single row
])
def test_spectral_conv3d_centered_matches_jax(shape, modes):
    x = rand(6, *shape)
    w = rand(7, shape[-1], 4, modes[0], modes[1], modes[2] // 2 + 1, 2, scale=0.2)
    want = jsp.spectral_conv3d_centered(jnp.asarray(x), jnp.asarray(w), *modes)
    got = tsp.spectral_conv3d_centered(*tt(x, w), *modes)
    close(got, want)


@pytest.mark.parametrize("dft", [True, False])
@pytest.mark.parametrize("hw,out_hw,modes", [
    ((16, 24), (8, 12), (4, 5)),     # down
    ((8, 12), (16, 24), (4, 5)),     # up
    ((16, 24), (16, 24), (8, 9)),    # same size
    ((4, 6), (1, 1), (4, 5)),        # a 1-pixel level keeps no mode
])
def test_uno_spectral_conv_matches_jax(hw, out_hw, modes, dft, monkeypatch):
    jax_dft(monkeypatch, dft)
    x = rand(8, 2, *hw, 3)
    w1, w2 = (rand(9 + i, 3, 5, *modes, 2, scale=0.2) for i in range(2))
    want = juno.uno_spectral_conv(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), out_hw)
    got = tuno.uno_spectral_conv(*tt(x, w1, w2), out_hw, dft=dft)
    assert got.shape == want.shape == (2, *out_hw, 5)
    close(got, want)


@pytest.mark.parametrize("conv", ["corner", "centered", "centered_cw"])
def test_bf16_gate_matches_jax(conv):
    """bf16 field in -> bf16 field out, mode space (and the weight) f32."""
    x, w = rand(10, 2, 16, 24, 6), rand(11, 6, 5, 4, 5, 2, scale=0.2)
    if conv == "centered_cw":
        x = np.ascontiguousarray(np.swapaxes(x, -1, -2))
    jfn = {"corner": jsp.spectral_conv2d, "centered": jsp.spectral_conv2d_centered,
           "centered_cw": jsp.spectral_conv2d_centered_cw}[conv]
    tfn = {"corner": tsp.spectral_conv2d, "centered": tsp.spectral_conv2d_centered,
           "centered_cw": tsp.spectral_conv2d_centered_cw}[conv]
    modes = (4, 5) if conv == "corner" else (4, 8)  # both keep 4 x 5 modes
    want = jfn(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), *modes)
    got = tfn(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), *modes)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close(got.float(), np.asarray(want, np.float32), atol=3e-2, rtol=3e-2)
    # and against the f32 result: the gate only costs bf16 rounding
    full = tfn(torch.from_numpy(x), torch.from_numpy(w), *modes)
    close(got.float(), full, atol=3e-2, rtol=3e-2)
