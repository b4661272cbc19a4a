"""tests/test_torch_arch_serve.py's engine parity on qwen2_vl_2b (M-RoPE
in text mode, GQA 12 / 2 at full width, QKV bias): smoke, float32,
non-zero biases, paged and contiguous `LLMEngine` — tokens, finish
reasons, ticks, the paged `pool_report` and the pages (within the page
rule) equal to the reference's."""
import jax
import pytest

from test_torch_arch_serve import check_engines
from torch_arch import smoke_models
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_matches_reference(pallas_interpret, paged):
    check_engines(smoke_models("qwen2_vl_2b"), paged)
