"""(d) ofb_tpu_torch/ops/pmim.py against ofb_tpu/ops/pmim.py.

Tolerance: fp32 on both sides. norm_targets divides by a local standard
deviation computed as E[x²] - E[x]² over up to 47 x 47 pixels, so its
cancellation magnifies summation-order differences: rtol 1e-4 / atol 1e-4
on unit-scale outputs. Masks, shuffles and patchify are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ofb_tpu.ops import pmim as JP
from ofb_tpu_torch.ops import pmim as P

torch.set_num_threads(1)


@pytest.mark.parametrize("size", [224, 32])
def test_norm_targets_matches(size):
    """224 x 224 (the DeiT input) and 32 x 32, where the 47-window is
    larger than the image and every count comes from the clipped edges."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (1 if size == 224 else 3, size, size, 3)).astype(
        np.float32)
    want = np.asarray(JP.norm_targets(x, 47))
    got = P.norm_targets(torch.from_numpy(x), 47).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        P.norm_targets(torch.from_numpy(x), 8)


def test_reconstruction_loss_with_injected_mask():
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    rec = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 16)) < 0.4).astype(np.float32)
    want = float(JP.mim_reconstruction_loss(imgs, rec, mask, 8, 3))
    got = P.mim_reconstruction_loss(torch.from_numpy(imgs),
                                    torch.from_numpy(rec),
                                    torch.from_numpy(mask), 8, 3)
    assert float(got) == pytest.approx(want, rel=1e-5)
    none = P.mim_reconstruction_loss(torch.from_numpy(imgs),
                                     torch.from_numpy(rec),
                                     torch.zeros(2, 16), 8, 3)
    assert float(none) == 0.0


def test_pixel_shuffle_and_patchify_exact():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 4, 3 * 8 * 8)).astype(np.float32)
    np.testing.assert_array_equal(
        P.pixel_shuffle_nhwc(torch.from_numpy(x), 8).numpy(),
        np.asarray(JP.pixel_shuffle_nhwc(x, 8)))
    # torch's own PixelShuffle order, in NCHW
    ps = torch.nn.PixelShuffle(8)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(
        P.pixel_shuffle_nhwc(torch.from_numpy(x), 8).numpy(),
        ps.permute(0, 2, 3, 1).numpy())
    imgs = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(P.patchify(torch.from_numpy(imgs), 8).numpy(),
                                  np.asarray(JP.patchify(imgs, 8)))


@pytest.mark.parametrize("keep", [0.5, 0.75, 0.95, 1.0])
def test_random_token_mask_keeps_count(keep):
    L = 196
    kc = torch.floor(L * torch.tensor(keep)).to(torch.int32)
    m = P.random_token_mask(4, L, kc, generator=torch.Generator().manual_seed(0))
    assert m.shape == (4, L) and m.dtype == torch.float32
    jm = JP.random_token_mask(jax.random.PRNGKey(0), 4, L,
                              jnp.floor(L * jnp.float32(keep)).astype(jnp.int32))
    # the draws differ between frameworks; the kept count must not
    np.testing.assert_array_equal((1 - m).sum(1).numpy(),
                                  (1 - np.asarray(jm)).sum(1))
