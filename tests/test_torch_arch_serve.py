"""The port's serving stack on llama3_2_3b and codeqwen1_5_7b (smoke,
float32, non-zero QKV biases on codeqwen) against the reference's, the
reference on its Pallas kernels in interpret mode: `LLMEngine.generate`
gives identical token streams, finish reasons and ticks on the paged and
the contiguous backend (tests/torch_arch.py's protocol), the paged pool
reports agree (every key both have but the TTFTs: page counts and bytes,
counters), and the paged pools' pages and scales agree within the page
rule (int8 values at most one step apart in at most 5e-3 of the places,
scales within 1e-5 relative). tests/test_torch_arch_serve_qwen.py
holds qwen2_5_32b, tests/test_torch_arch_serve_moe.py qwen2_moe_a2_7b
(one file each, so each stays near a minute under the suite's six
workers)."""
import jax
import pytest

from test_mixed_precision_plan import _layer_cache as ref_layer_cache
from test_torch_mixed_plan import assert_pages_close
from torch_arch import serve_both, smoke_models
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


def check_engines(models, paged: bool):
    (ref, routs), (eng, outs) = serve_both(models, paged)
    assert [o.token_ids for o in outs] == [o.token_ids for o in routs]
    assert [o.finish_reason for o in outs] == \
        [o.finish_reason for o in routs] == ["length"] * len(outs)
    assert eng.ticks == ref.ticks
    assert eng.batcher.decode_tokens_computed == \
        ref.batcher.decode_tokens_computed
    if not paged:
        return
    rep, rrep = eng.pool_report(), ref.pool_report()
    same = [k for k in rrep if k in rep and "ttft" not in k]
    assert "device_bytes_live" in same and "pages_free" in same
    assert {k: rep[k] for k in same} == {k: rrep[k] for k in same}
    cfg = models[1][0]
    for layer in range(cfg.n_layers):
        assert_pages_close(ref_layer_cache(ref.batcher.state, layer).pool,
                           eng.batcher.state[layer].pool, "int8",
                           f"layer {layer}")


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("arch", ["llama3_2_3b", "codeqwen1_5_7b"])
def test_engine_matches_reference(pallas_interpret, arch, paged):
    check_engines(smoke_models(arch), paged)
