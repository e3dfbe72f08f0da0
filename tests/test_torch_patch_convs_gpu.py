"""The overlapping patch convs' f32 convolutions on the card, under PyTorch's
default backend flags, against float64.

PyTorch lets cuDNN take TF32 for f32 convolutions by default
(``torch.backends.cudnn.allow_tf32`` is True).  ``conv_nhwc`` keeps a dense
f32 conv off cuDNN and ``conv_transpose_nhwc`` turns cuDNN's TF32 off for
its own call, so both compute in f32 wherever the caller left the flags.
Each is held to the same function in float64 on the CPU within 1e-5 of the
largest output (f32 sums of at most 256 x 4 products; TF32 keeps 10
mantissa bits and misses that by two orders), and the flags are left as
they were found.

Marked ``gpu``; each test skips when no CUDA device is present.  Run on the
card (no JAX there, so skip the JAX conftest and the xdist addopts):
    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_patch_convs_gpu.py
"""

import pytest
import torch

from tante_tpu_torch.ops.convs import conv_nhwc, conv_transpose_nhwc

pytestmark = pytest.mark.gpu

# (label, B, H, W, Cin, Cout, patch, stride): the decoders' first and last
# stages of the flagship at overlap 0.5 and of TANTE-FNO's 4x4 stage at
# 0.25, and the matching encoder stages.
CASES = [
    ("flagship stage 0", 8, 16, 48, 256, 128, 2, 1),
    ("flagship last stage", 8, 64, 192, 64, 4, 2, 1),
    ("FNO 4x4 stage", 8, 32, 96, 64, 4, 4, 3),
]
REL = 1e-5


@pytest.fixture
def default_flags():
    """PyTorch's defaults for the duration of the test: cuDNN TF32 on,
    matmul TF32 off; asserted unchanged afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m gpu)")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
        assert torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "transposed"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_f32_patch_convs_stay_f32_under_default_flags(default_flags, case, transposed):
    _, b, h, w, cin, cout, p, stride = case
    gen = torch.Generator().manual_seed(0)
    if transposed:
        x = torch.randn(b, h, w, cin, generator=gen)
        k = torch.randn(p, p, cin, cout, generator=gen) / (p * p * cin) ** 0.5
    else:  # the encoder's stage: the mirror of the decoder's
        x = torch.randn(b, h * p, w * p, cout, generator=gen)
        k = torch.randn(p, p, cout, cin, generator=gen) / (p * p * cout) ** 0.5
    bias = torch.randn(k.shape[-1], generator=gen)
    pad = ((p - 1) // 2,) * 2

    def run(*args):
        if transposed:
            return conv_transpose_nhwc(*args, stride)
        return conv_nhwc(*args, stride, (pad, pad), 1)

    got = run(x.cuda(), k.cuda(), bias.cuda())
    want = run(x.double(), k.double(), bias.double())
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got.cpu().double() - want).abs().max())
    assert err <= REL * float(want.abs().max()), (err, float(want.abs().max()))
