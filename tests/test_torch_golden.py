"""The port's tiny TrackAutoEncoder3D against the stored goldens
(tests/golden/goldens.npz): JAX initialises the tiny 3D model at PRNGKey(7)
on ``synthetic_batch(PRNGKey(1234))`` with T = 12 and features
(tests/golden/generate_goldens.py), the parameters are converted, and the
port's outputs must equal the stored 3D keys.

Tolerance: 2e-5, the port's f32 agreement with flax (summation order only,
tests/test_torch_model.py); the JAX package holds itself to the goldens at
1e-5 (tests/golden/test_golden.py).
"""

import jax
import numpy as np
import torch

from tdspa.utils.testing import synthetic_batch, tiny_model_3d as jax_tiny_model_3d
from tests.golden.generate_goldens import GOLDEN_PATH
from tdspa_torch.infer.convert import params_from_flax
from tdspa_torch.utils.testing import tiny_model_3d

T = 12
TOL = dict(rtol=2e-5, atol=2e-5)


def test_tiny_3d_model_matches_the_stored_goldens():
    batch = synthetic_batch(jax.random.PRNGKey(1234), num_coords=3, num_frames=T,
                            with_features=True)
    params = jax.jit(jax_tiny_model_3d(T).init)(jax.random.PRNGKey(7), batch)["params"]
    model = tiny_model_3d(T, device="cpu")
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    with torch.no_grad():
        out = model(tbatch)
        latents = model.encode(tbatch)
    with np.load(GOLDEN_PATH) as stored:
        got = {"tracks_3d": out.tracks, "visible_logits_3d": out.visible_logits,
               "latents_3d": latents}
        for key, value in got.items():
            assert value.shape == stored[key].shape, key
            np.testing.assert_allclose(value.numpy(), stored[key], **TOL, err_msg=key)
