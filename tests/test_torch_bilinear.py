"""tdspa_torch's bilinear sampling against tdspa's: the kernel's plain
version against the Pallas kernel in interpret mode (the grid's dtype out)
and against the XLA gather the JAX tail uses (f32 out), points outside the
grid included; the tail's samplers route through the wrapper.

Tolerance 1e-6 abs for O(1) grid values: the same f32 products and sums,
which XLA may fuse into multiply-adds (~1 ulp). The Pallas kernel takes only
f32 grids (it cannot store its f32 products into a bf16 output ref), so a
bf16 grid is held to the XLA gather, whose f32 result the bf16 output rounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdspa.kernels.bilinear import bilinear_sample_pallas
from tdspa.ops import geometry as jgeo
from tdspa_torch.kernels import bilinear as kbl
from tdspa_torch.ops import geometry

TOL = dict(rtol=0, atol=1e-6)


def _inputs(seed, frames=3, height=7, width=9, channels=8, points=11, margin=3.0):
    rng = np.random.default_rng(seed)
    grid = rng.standard_normal((frames, height, width, channels)).astype(np.float32)
    coords = np.stack([rng.uniform(-margin, width + margin, (points, frames)),
                       rng.uniform(-margin, height + margin, (points, frames))], -1)
    return grid, coords.astype(np.float32)


@pytest.mark.parametrize("shape", [dict(), dict(channels=16, points=20, margin=0.0),
                                   dict(channels=1, points=5)])
def test_reference_matches_pallas_kernel(shape):
    grid, coords = _inputs(0, **shape)
    want = np.asarray(bilinear_sample_pallas(jnp.asarray(grid), jnp.asarray(coords),
                                             interpret=True))
    got = kbl.bilinear_sample(torch.from_numpy(grid), torch.from_numpy(coords))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("grid_dtype", ["f32", "bf16"])
def test_tail_sampler_matches_jax_xla_gather(grid_dtype):
    grid, coords = _inputs(1, channels=5)
    jgrid = jnp.asarray(grid) if grid_dtype == "f32" else jnp.asarray(grid).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(jgeo.bilinear_sample)(jgrid, jnp.asarray(coords)))
    tgrid = torch.from_numpy(np.array(jgrid.astype(jnp.float32)))
    if grid_dtype == "bf16":
        tgrid = tgrid.to(torch.bfloat16)  # exact: the values are bf16 already
    got = geometry.bilinear_sample(tgrid, torch.from_numpy(coords))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The TPU kernel's default: the grid's dtype, from the same f32 values.
    own = kbl.bilinear_sample(tgrid, torch.from_numpy(coords))
    assert own.dtype == tgrid.dtype
    assert torch.equal(own, got.to(tgrid.dtype))


def test_cpu_dispatch_launches_nothing_and_checks_shapes():
    grid, coords = _inputs(2)
    before = kbl.bilinear_sample.launches
    kbl.bilinear_sample(torch.from_numpy(grid), torch.from_numpy(coords))
    geometry.lift_2d_to_3d(torch.from_numpy(coords),
                           torch.from_numpy(np.abs(grid[..., :1]) + 1.0))
    assert kbl.bilinear_sample.launches == before
    with pytest.raises(ValueError, match=r"coords \[N,T,2\]"):
        kbl.bilinear_sample(torch.from_numpy(grid), torch.from_numpy(coords[:, :2]))


@pytest.mark.parametrize("margin", [0.0, 4.0])
def test_grid_sample_with_border_padding_is_the_reference_function(margin):
    """``grid_sample(mode="bilinear", padding_mode="border",
    align_corners=True)`` equals ``bilinear_sample_reference`` inside the
    grid and beyond every edge: a corner clamped on its own, with weights
    from the unclamped floor, gives the edge value that clamping the
    coordinate gives. This makes it the kernel's library yardstick (timed
    only, in chip_smoke.py). grid_sample runs in f64 here, so that the
    normalised coordinate's round trip does not move a point; tolerance
    1e-5 for the f32 reference's own rounding of O(1) values."""
    grid, coords = _inputs(3, frames=5, height=36, width=36, channels=16, points=300,
                           margin=margin)
    tgrid, tcoords = torch.from_numpy(grid), torch.from_numpy(coords)
    want = kbl.bilinear_sample_reference(tgrid, tcoords)
    frames, height, width, _ = grid.shape
    c64 = tcoords.double()
    g = torch.stack([c64[..., 0] * (2.0 / (width - 1)) - 1.0,
                     c64[..., 1] * (2.0 / (height - 1)) - 1.0], dim=-1)
    got = torch.nn.functional.grid_sample(
        tgrid.double().permute(0, 3, 1, 2), g.permute(1, 0, 2)[:, None], mode="bilinear",
        padding_mode="border", align_corners=True)  # [T, C, 1, N]
    got = got[:, :, 0].permute(2, 0, 1)  # [N, T, C]
    if margin:
        x, y = coords[..., 0], coords[..., 1]
        assert (x < 0).any() and (x > width - 1).any() and (y < 0).any() and (y > height - 1).any()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_kernel_builds_without_contraction():
    """The kernel equals the plain gather bit for bit only without fused multiply-adds."""
    assert "--fmad=false" in kbl.build.flags("bilinear")
