"""The port's configs equal the reference's, field by field."""
import dataclasses

import jax
import numpy as np
import pytest
import torch  # noqa: F401  (both frameworks in one process, as every port test)

from repro.configs import internlm2_1_8b as ref_cfg
from repro.configs.registry import get_config as ref_get
from repro_torch.configs import get_config
from repro_torch.configs import internlm2_1_8b as port_cfg

jax.config.update("jax_platform_name", "cpu")


def _same(ref_val, port_val):
    """Dtype fields are jnp dtypes in the reference and names in the port."""
    if isinstance(port_val, str) and not isinstance(ref_val, str):
        return np.dtype(ref_val).name == port_val
    return ref_val == port_val


@pytest.mark.parametrize("variant", ["config", "smoke"])
def test_every_field_matches_reference(variant):
    ref = getattr(ref_cfg, variant)()
    port = getattr(port_cfg, variant)()
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


@pytest.mark.parametrize("smoke", [False, True])
def test_registry_resolves_like_reference(smoke):
    for name in ("internlm2_1_8b", "internlm2-1_8b"):
        assert get_config(name, smoke) == getattr(
            port_cfg, "smoke" if smoke else "config")()
        assert get_config(name, smoke).name == ref_get(name, smoke).name
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config("llama3_2_3b")
