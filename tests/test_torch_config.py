"""The port's configs equal the reference's, field by field: internlm2_1_8b
and the nine served beside it (llama3_2_3b, codeqwen1_5_7b, qwen2_5_32b,
qwen2_moe_a2_7b, mixtral_8x22b, recurrentgemma_9b, xlstm_350m,
qwen2_vl_2b, whisper_small), full and smoke; the two registries list the
same architectures and resolve each name alike."""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch  # noqa: F401  (both frameworks in one process, as every port test)

from repro.configs import internlm2_1_8b as ref_cfg
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.configs.registry import get_config as ref_get
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import internlm2_1_8b as port_cfg

jax.config.update("jax_platform_name", "cpu")


def _same(ref_val, port_val):
    """Dtype fields are jnp dtypes in the reference and names in the port."""
    if isinstance(port_val, str) and not isinstance(ref_val, str):
        return np.dtype(ref_val).name == port_val
    return ref_val == port_val


NEW_ARCHS = ("llama3_2_3b", "codeqwen1_5_7b", "qwen2_5_32b",
             "qwen2_moe_a2_7b", "mixtral_8x22b", "recurrentgemma_9b",
             "xlstm_350m", "qwen2_vl_2b", "whisper_small")


def _fields_match(ref, port, variant):
    ref_fields = [f.name for f in dataclasses.fields(ref)]
    assert [f.name for f in dataclasses.fields(port)] == ref_fields
    for name in ref_fields:
        rv, pv = getattr(ref, name), getattr(port, name)
        if name == "quant":
            for qf in dataclasses.fields(rv):
                assert _same(getattr(rv, qf.name), getattr(pv, qf.name)), \
                    (variant, qf.name)
        else:
            assert _same(rv, pv), (variant, name, rv, pv)


@pytest.mark.parametrize("variant", ["config", "smoke"])
def test_every_field_matches_reference(variant):
    _fields_match(getattr(ref_cfg, variant)(), getattr(port_cfg, variant)(),
                  variant)


@pytest.mark.parametrize("variant", ["config", "smoke"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_served_arch_fields_match_reference(arch, variant):
    ref = getattr(importlib.import_module(f"repro.configs.{arch}"), variant)
    port = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                   variant)
    _fields_match(ref(), port(), variant)


@pytest.mark.parametrize("smoke", [False, True])
def test_registry_resolves_like_reference(smoke):
    for name in ("internlm2_1_8b", "internlm2-1_8b"):
        assert get_config(name, smoke) == getattr(
            port_cfg, "smoke" if smoke else "config")()
        assert get_config(name, smoke).name == ref_get(name, smoke).name
    # the reference's last two architectures resolve as its registry
    # resolves them, and the registries list the same ten
    for name in ("qwen2_vl_2b", "whisper-small"):
        _fields_match(ref_get(name, smoke), get_config(name, smoke),
                      "smoke" if smoke else "config")
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper_large")


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_served_arch_resolves_like_reference(arch, smoke):
    for name in (arch, arch.replace("_", "-")):
        got, ref = get_config(name, smoke), ref_get(name, smoke)
        _fields_match(ref, got, "smoke" if smoke else "config")
