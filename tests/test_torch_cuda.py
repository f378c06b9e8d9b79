"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one.  The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from vatl4pose_tpu_torch.kernels import (bottleneck_chain_reference,
                                         fused_bottleneck_chain,
                                         fused_postprocess,
                                         postprocess_reference,
                                         reset_launch_counts)

RNG = np.random.default_rng(8111)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    # parity mode: the plain versions' cuDNN convolutions in full f32
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def chain_operands(nb, C, P, dtype, device):
    """Folded chain weights: w1, s1, b1, w2, s2, b2, w3, s3, b3."""
    ws = [RNG.normal(0, 0.1, (nb, C, P)), RNG.uniform(0.5, 1.5, (nb, P)),
          RNG.normal(0, 0.2, (nb, P)), RNG.normal(0, 0.1, (nb, 3, 3, P, P)),
          RNG.uniform(0.5, 1.5, (nb, P)), RNG.normal(0, 0.2, (nb, P)),
          RNG.normal(0, 0.1, (nb, P, C)), RNG.uniform(0.5, 1.5, (nb, C)),
          RNG.normal(0, 0.2, (nb, C))]
    return [torch.tensor(w, dtype=dtype if i in (0, 3, 6) else torch.float32,
                         device=device) for i, w in enumerate(ws)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chain_kernel_matches_plain_on_card(cuda, dtype):
    # ragged sizes: pixel rows and channels that fill no whole tile
    x = torch.tensor(RNG.normal(0, 1, (3, 13, 11, 96)), dtype=dtype,
                     device=cuda).relu()
    ws = chain_operands(3, 96, 24, dtype, cuda)
    reset_launch_counts()
    got = fused_bottleneck_chain(x, *ws)
    assert fused_bottleneck_chain.launches == 1
    ref = bottleneck_chain_reference(x, *ws)
    # f32: summation order only; bf16: a one-ulp flip of an epilogue's
    # rounding propagates down the chain
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


def planted_heatmaps(n, k, h, w):
    """Noise plus an all-negative sample, tied maxima, maxima on the
    border and in corners, a quantized sample full of ties and an all-zero
    map."""
    hms = RNG.normal(0.1, 0.4, (n, k, h, w)).astype(np.float32)
    hms[1] = -np.abs(hms[1]) - 1e-3
    hms[2, :, 3, 4] = hms[2, :, 9, 7] = 5.0
    hms[3, :, 0, 5] = 6.0
    hms[3, 1, h - 1, w - 1] = 7.0
    hms[4] = np.round(hms[4] * 3) / 3
    hms[5, 0] = 0.0
    hms[6, :, 0, 0] = hms[6, :, h - 1, 0] = 9.0
    hms[7, :, 1, 1] = 8.0
    return hms


@pytest.mark.cuda
def test_postprocess_kernel_matches_plain_on_card(cuda):
    hms = torch.from_numpy(planted_heatmaps(16, 17, 64, 48)).to(cuda)
    reset_launch_counts()
    coords, maxvals, gc = fused_postprocess(hms)
    assert fused_postprocess.launches == 1
    r_coords, r_maxvals, r_gc = postprocess_reference(hms)
    assert torch.equal(coords, r_coords) and torch.equal(maxvals, r_maxvals)
    # gc: the same float sums in another order
    torch.testing.assert_close(gc, r_gc, rtol=1e-5, atol=0)
