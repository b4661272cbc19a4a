"""The port's CUDA kernels on the card (``gpu`` marker): each kernel against
its plain PyTorch version on the same CUDA tensors — the paged kernels for
int8, fp8_e4m3 and int4 pages, the flat decode kernel per block and per
channel (ring windows included), the quantize/dequantize family — at the
smoke shapes and at internlm2_1_8b's widths, and the smoke engines'
greedy tokens on the card against the CPU (paged and contiguous, and
`greedy_generate`). Skipped where there is no card; imports no JAX (the
card's machine has none).

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: attention in float32, |a - b| <= 1e-5 + 1e-4 |b| — the kernel
sums in another order than the plain version (tile-wise online softmax);
the quantize family bitwise."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import quantization as Q
from repro_torch.kernels import ops
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import quant_prefill as QP
from repro_torch.kernels import quantize as QK
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
@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["per_block", "per_channel"])
@pytest.mark.parametrize("width", WIDTHS)
def test_flat_decode_kernel_matches_plain(per_channel, width, cuda_device):
    H, Hkv, D, bs = width
    T = 4 * bs + 8 if per_channel else 8 * bs     # per channel: T % 64 != 0
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=cuda_device)
    lengths = i32([0, 1, bs - 1, 3 * bs + 5, T, T + bs + 3])
    windows = i32([T, T, T, 2 * bs, T, bs + 2])   # two rows windowed
    B = len(lengths)
    k = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    v = torch.randn((B, Hkv, T, D), generator=gen, device=cuda_device)
    quant = (QK.quantize_per_channel_plain if per_channel
             else lambda x: QK.quantize_blocked_plain(x, bs))
    (kq, ks), (vq, vs) = quant(k), quant(v)
    if per_channel:
        ks, vs = ks[:, :, None].contiguous(), vs[:, :, None].contiguous()
    q = torch.randn((B, H, D), generator=gen, device=cuda_device)
    args = (q, kq, ks, vq, vs, lengths, windows)
    before = QA.flat_decode_partials_cuda.launches
    got = QA.flat_decode_partials_cuda(*args)
    torch.cuda.synchronize()
    assert QA.flat_decode_partials_cuda.launches == before + 1
    for g, w in zip(got, QA.flat_decode_partials_plain(*args)):
        torch.testing.assert_close(g, w, **TOL)
    assert float(got[2][0].abs().max()) == 0.0            # empty row: l = 0


def _bitwise(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,bs", [((2, 2, 40, 16), 8),
                                      ((4, 8, 2048, 128), 256),
                                      ((1, 1, 1032, 128), 8)])
def test_quantize_kernels_bitwise(shape, bs, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.rand(shape, generator=gen, device=cuda_device) * 2 - 1
    x[..., 2] = 0.0                                # an all-zero channel
    x[..., 3] *= 1e-29                             # absmax below 127e-30
    x[..., 0, 3] = 1e-29
    counts = [QK.absmax_cuda.launches, QK.quantize_with_scales_cuda.launches,
              QK.quantize_blocked_cuda.launches, QK.dequantize_cuda.launches]
    got = QK.quantize_per_channel_cuda(x)
    for g, w in zip(got, QK.quantize_per_channel_plain(x)):
        _bitwise(g, w)
    got = QK.quantize_blocked_cuda(x, bs)
    for g, w in zip(got, QK.quantize_blocked_plain(x, bs)):
        _bitwise(g, w)
    q, s = got
    for dt in (torch.float32, torch.bfloat16):
        _bitwise(QK.dequantize_cuda(q, s, dt), QK.dequantize_plain(q, s, dt))
    pq, ps = QK.quantize_per_channel_plain(x)
    _bitwise(QK.dequantize_cuda(pq, ps), QK.dequantize_plain(pq, ps))
    torch.cuda.synchronize()
    assert [QK.absmax_cuda.launches, QK.quantize_with_scales_cuda.launches,
            QK.quantize_blocked_cuda.launches, QK.dequantize_cuda.launches] \
        == [counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3] + 3]
    # ops routes a CUDA tensor to the kernels
    before = QK.quantize_blocked_cuda.launches
    ops.quantize_blocked(x, bs)
    assert QK.quantize_blocked_cuda.launches == before + 1


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return x.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("granularity", ["per_block", "per_channel"])
def test_contiguous_smoke_tokens_match_cpu(granularity, cuda_device):
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import (EngineConfig, LLMEngine, SamplingParams,
                                     greedy_generate)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32",
                              quant=Q.QuantConfig(granularity, 8))
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
               for n in (13, 30, 5, 20)]
    sp = SamplingParams.greedy(max_new_tokens=7)

    def run(device, p):
        eng = LLMEngine(p, cfg, EngineConfig(batch=2, max_len=64),
                        device=device)
        toks = [o.token_ids for o in eng.generate(prompts, sp)]
        gen = greedy_generate(p, cfg, np.stack([prompts[0], prompts[3][:13]]),
                              steps=6, device=device)
        return toks, gen.cpu().tolist()

    before = QA.flat_decode_partials_cuda.launches
    assert run(cuda_device, _to(params, cuda_device)) == run("cpu", params)
    assert QA.flat_decode_partials_cuda.launches > before


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
        eng = LLMEngine(p, cfg, EngineConfig(batch=2, max_len=128,
                                             paged=True), device=device)
        return [o.token_ids for o in eng.generate(prompts, sp)]

    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v) for v in x]
        return x.to(cuda_device)

    assert run(cuda_device, to(params)) == run("cpu", params)
