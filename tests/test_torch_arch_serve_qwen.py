"""tests/test_torch_arch_serve.py's engine parity on qwen2_5_32b (dense,
GQA 40 / 8 at full width, QKV bias): smoke, float32, non-zero biases,
paged and contiguous."""
import jax
import pytest

from test_torch_arch_serve import check_engines
from torch_arch import smoke_models
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("arch", ["qwen2_5_32b"])
def test_engine_matches_reference(pallas_interpret, arch, paged):
    check_engines(smoke_models(arch), paged)
