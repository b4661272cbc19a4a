"""tests/test_torch_arch_serve.py's engine parity on qwen2_moe_a2_7b (MoE
with shared experts, QKV bias; `models/moe.py` in every layer): smoke
(dropless, capacity_factor 8), float32, non-zero biases, paged and
contiguous."""
import jax
import pytest

from test_torch_arch_serve import check_engines
from torch_arch import smoke_models
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b"])
def test_engine_matches_reference(pallas_interpret, arch, paged):
    check_engines(smoke_models(arch), paged)
