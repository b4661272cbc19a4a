"""The port's CUDA kernels on the card (``gpu`` marker): each kernel against
its plain PyTorch version on the same CUDA tensors, for int8, fp8_e4m3
and int4 pages at the smoke shapes and at internlm2_1_8b's widths, and
the smoke engine's greedy tokens on the card against the CPU. Skipped
where there is no card; imports no JAX (the card's machine has none).

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: float32, |a - b| <= 1e-5 + 1e-4 |b| — the kernel sums in
another order than the plain version (tile-wise online softmax)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import ops
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import quant_prefill as QP
from torch_parity import cuda_device  # noqa: F401  (fixture)

DTYPES = ["int8", "fp8_e4m3", "int4"]
TOL = dict(atol=1e-5, rtol=1e-4)
# (H, H_kv, D, page) — the smoke config's widths and the full model's
WIDTHS = [(4, 2, 16, 8), (16, 8, 128, 256)]


def _pool(kv_dtype, n_pages, Hkv, D, ps, gen, dev):
    x = torch.randn((2, Hkv, n_pages * ps, D), generator=gen, device=dev)
    q, s = Q.quantize_pages(x, ps, kv_dtype)
    pages = q.reshape(2, Hkv, n_pages, -1, D).permute(0, 2, 3, 1, 4)
    scales = s.permute(0, 2, 1, 3)
    return (pages[0].contiguous(), scales[0].contiguous(),
            pages[1].contiguous(), scales[1].contiguous())


def _table(B, NT, n_pages, gen, dev):
    perm = 1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
    return perm[:B * NT].reshape(B, NT).to(torch.int32).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_decode_kernel_matches_plain(kv_dtype, width, cuda_device):
    H, Hkv, D, ps = width
    NT = 8
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    lengths = torch.tensor([0, 1, ps - 1, ps, 3 * ps + 5, NT * ps],
                           dtype=torch.int32, device=cuda_device)
    B = len(lengths)
    pool = _pool(kv_dtype, B * NT + 1, Hkv, D, ps, gen, cuda_device)
    args = (torch.randn((B, H, D), generator=gen, device=cuda_device),
            *pool, _table(B, NT, B * NT + 1, gen, cuda_device), lengths,
            kv_dtype)
    before = QA.paged_decode_partials_cuda.launches
    got = ops.paged_attention_decode_partials(*args[:-1], kv_dtype=kv_dtype)
    torch.cuda.synchronize()
    assert QA.paged_decode_partials_cuda.launches == before + 1
    for g, w in zip(got, QA.paged_decode_partials_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_prefill_kernel_matches_plain(kv_dtype, width, cuda_device):
    H, Hkv, D, ps = width
    G, NT, C = H // Hkv, 8, 4 * ps
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    hist = [0, ps, 3 * ps, NT * ps - C]
    valid = [C, 1, C - 1, C // 2 + 3]
    B = len(hist)
    pool = _pool(kv_dtype, B * NT + 1, Hkv, D, ps, gen, cuda_device)
    table = _table(B, NT, B * NT + 1, gen, cuda_device)
    q = torch.randn((B, H, C, D), generator=gen, device=cuda_device)
    k = torch.randn((B, Hkv, C, D), generator=gen, device=cuda_device)
    v = torch.randn((B, Hkv, C, D), generator=gen, device=cuda_device)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    for hb in (0, 1, 3, NT):
        before = QP.paged_prefill_cuda.launches
        got = ops.paged_attention_prefill(q, k, v, *pool, table, i32(hist),
                                          i32(valid), hist_blocks=hb,
                                          kv_dtype=kv_dtype)
        torch.cuda.synchronize()
        assert QP.paged_prefill_cuda.launches == before + 1
        qg = (q.reshape(B, Hkv, G * C, D) * QA.logit_scale(D)).contiguous()
        want = QP.paged_prefill_plain(qg, k, v, *pool, table, i32(hist),
                                      i32(valid), hb, kv_dtype)
        want = want.reshape(B, H, C, D)
        for b in range(B):                # positions past valid: garbage
            torch.testing.assert_close(got[b, :, :valid[b]],
                                       want[b, :, :valid[b]], **TOL)


@pytest.mark.gpu
def test_smoke_engine_tokens_match_cpu(cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, LLMEngine, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32")
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 70, 5, 40, 21)]
    sp = SamplingParams.greedy(max_new_tokens=8)

    def run(device, p):
        eng = LLMEngine(p, cfg, EngineConfig(batch=2, max_len=128),
                        device=device)
        return [o.token_ids for o in eng.generate(prompts, sp)]

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v) for v in x]
        return x.to(cuda_device)

    assert run(cuda_device, to(params)) == run("cpu", params)
