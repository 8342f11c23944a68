"""Part-A2-free (``PartA2Free``) of pdanet_tpu_torch over the dense UNetV2
against the JAX package, on the CPU: the checks of
``test_torch_parta2_free.py`` (eval in float32, the float64 training step)
at the same tiny config with ``BACKBONE_3D.NAME`` UNetV2, the backbone
``test_parta2.py``'s Part-A2-free test builds.
"""

import pytest
import torch

from test_torch_parta2 import make_batch
from test_torch_parta2_free import free_run_checks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_parta2_free_dense_unet_matches_jax():
    """Over the dense UNet: eval in float32 and the float64 training step
    (``test_torch_parta2_free.free_run_checks``)."""
    free_run_checks("UNetV2", make_batch())
