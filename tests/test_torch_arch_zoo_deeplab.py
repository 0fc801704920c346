"""The DeepLab family of the port's model zoo against the JAX package's, at
the default depth (``n_blocks`` (2, 2, 2, 2)), B = 2 at 32^2: the checks and
tolerances of ``test_torch_arch_zoo.py`` (readings there)."""

import pytest

from test_torch_arch_zoo import FAMILIES, check_bf16_forward, check_family
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

DEEPLABS = ("deeplabv2", "deeplabv3", "deeplabv3plus")


@pytest.mark.parametrize("arch", DEEPLABS)
def test_family_matches_jax(arch):
    check_family(arch, *FAMILIES[arch])


@pytest.mark.parametrize("arch", DEEPLABS)
def test_family_bf16_forward(arch):
    check_bf16_forward(arch, *FAMILIES[arch])
