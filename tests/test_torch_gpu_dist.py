"""The port's sharded training and serving on the card (``gpu`` marker;
JAX-free): ranks share cuda:0 over gloo (their collectives staged
through pinned host buffers), each a process of
tests/torch_dist_worker.py.

- a sharded step of internlm2_1_8b's smoke config (float32) on a (data 1,
  model 2) and a (data 2, model 1) mesh against the single-process step
  on the card: metrics and every gathered leaf within 1e-5;
- `int8_psum` of CUDA tensors over 2 ranks against the plain sum of the
  dequantized payloads in rank order, bit for bit;
- sharded `compress_with_feedback` on the card: the compressed gradients
  and the error state (so the scales) bit for bit the single-process
  ones;
- sharded serving: `make_serve_fns` of internlm2_1_8b's smoke config
  (float32) on 4 ranks at (data 2, model 2), contiguous per block and
  per channel and paged, against the one-process functions on the card:
  logits within 2e-3, greedy tokens equal, the same bits on every rank,
  each rank's path kernels launched;
- the sharded ring: flat decode's CUDA kernel over each rank's slots of a
  wrapped ring at `core.kvcache.ring_slot_args`' length and window,
  merged in rank order, against the plain kernel over the whole ring;
  and `make_serve_fns` of recurrentgemma_9b (RG-LRU + local-attention
  ring) and mixtral_8x22b (sliding-window ring) on 4 ranks at (data 1,
  model 4), 40-token prompts (the 16-slot ring wrapped twice), against
  the one-process functions on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import quantize as QZ
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, compression
from repro_torch.training.step import init_opt_state, make_train_step
from torch_dist import run_ranks, step_task
from torch_dist_worker import load_tree, save_tree
from torch_parity import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.gpu

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)
RTOL = 1e-5


def _smoke(dev):
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    return cfg, params


def _close(a, b, path=""):
    if isinstance(b, dict):
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}.{i}")
    else:
        tol = RTOL * (np.abs(b) + np.abs(b).max())
        assert (np.abs(a - b) <= tol).all(), path


@pytest.mark.parametrize("mesh", [(1, 2), (2, 1)])
def test_sharded_step_on_the_card_matches_one_process(mesh, tmp_path,
                                                      cuda_device):
    cfg, params = _smoke(cuda_device)
    save_tree(tmp_path / "w.npz", bridge.tree_to_numpy(params, cfg))
    rng = np.random.RandomState(3)
    toks = rng.randint(0, cfg.vocab, (4, 33)).astype(np.int32)
    save_tree(tmp_path / "b.npz", {"tokens": toks[:, :-1],
                                   "labels": toks[:, 1:]})
    run_ranks(tmp_path, 2, [step_task(
        "internlm2_1_8b", mesh, ("data", "model"), tmp_path / "w.npz",
        tmp_path / "b.npz", tmp_path / "r.npz", OPT)], device="cuda")
    got = load_tree(tmp_path / "r.npz")
    opt = init_opt_state(params, cfg)
    step = make_train_step(cfg, AdamWConfig(**OPT))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(cuda_device),
             "labels": torch.from_numpy(toks[:, 1:]).to(cuda_device)}
    params, opt, m = step(params, opt, batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got["metrics"][k]), float(m[k]),
                                   rtol=RTOL, err_msg=k)
    _close(got["params"], bridge.tree_to_numpy(params, cfg), "params")
    for k in ("m", "v", "master"):
        _close(got[k], bridge.tree_to_numpy(opt["adam"][k], cfg), k)


def test_int8_psum_of_cuda_tensors(tmp_path, cuda_device):
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 96, 64) * rng.rand(1, 1, 64) * 3).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    run_ranks(tmp_path, 2, [{
        "kind": "psum", "mesh": [1, 2], "axes": ["data", "model"],
        "over": "model", "inputs": str(tmp_path / "x.npy"),
        "result": str(tmp_path / "psum.npy")}], device="cuda")
    got = np.load(tmp_path / "psum.npy")
    want = 0
    for r in range(2):
        q, s = QZ.quantize_per_channel_plain(torch.from_numpy(x[r]))
        want = want + QZ.dequantize_plain(q, s)
    for r in range(2):
        np.testing.assert_array_equal(got[r], want.numpy())


def test_sharded_compression_scales_bitwise(tmp_path, cuda_device):
    cfg, params = _smoke(cuda_device)
    rng = np.random.RandomState(11)
    ref = bridge.tree_to_numpy(params, cfg)
    grads = _map(ref, lambda p: (rng.randn(*p.shape)
                                 * 10.0 ** rng.randint(-6, 1)).astype(
                                     np.float32))
    err = _map(grads, lambda g: (rng.randn(*g.shape) * 1e-3).astype(
        np.float32))
    save_tree(tmp_path / "g.npz", grads)
    save_tree(tmp_path / "e.npz", err)
    run_ranks(tmp_path, 2, [{
        "kind": "compress", "arch": "internlm2_1_8b", "mesh": [2, 1],
        "axes": ["data", "model"], "grads": str(tmp_path / "g.npz"),
        "err": str(tmp_path / "e.npz"), "result": str(tmp_path / "c.npz")}],
        device="cuda")
    got = load_tree(tmp_path / "c.npz")
    pg = bridge.params_from_numpy(grads, cfg, cuda_device)
    pe = bridge.opt_state_from_numpy(
        {"adam": {"m": grads, "v": grads, "master": grads, "step": 0},
         "grad_err": err}, cfg, cuda_device)["grad_err"]
    comp, new = compression.compress_with_feedback(pg, pe, cfg)
    _equal(got["grads"], bridge.tree_to_numpy(comp, cfg))
    _equal(got["err"], bridge.tree_to_numpy(new))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _equal(a, b):
    if isinstance(b, dict):
        for k in b:
            _equal(a[k], b[k])
    elif isinstance(b, list):
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


# -- sharded serving ----------------------------------------------------------

# 32-token prompts over 24 slots a "model" rank: both ranks hold prompt
# slots, so both launch the prefill's quantizer
SERVE_B, SERVE_S, SERVE_LEN, SERVE_STEPS = 4, 32, 48, 8
# (granularity, paged, chunk) -> the kernels each rank must launch
SERVE_ROUTES = {
    "per_block": (("per_block", False, False),
                  ("flash_fwd_cuda", "quantize_blocked_cuda",
                   "flat_decode_partials_cuda")),
    "per_channel": (("per_channel", False, False),
                    ("flash_fwd_cuda", "absmax_cuda",
                     "quantize_with_scales_cuda",
                     "flat_decode_partials_cuda")),
    "paged": (("per_block", True, True),
              ("paged_prefill_cuda", "paged_decode_partials_cuda"))}


@pytest.mark.parametrize("route", list(SERVE_ROUTES))
def test_sharded_serving_on_the_card_matches_one_process(route, tmp_path,
                                                         cuda_device):
    """`make_serve_fns` on 4 ranks sharing the card, mesh (data 2, model
    2), against the one-process functions on the card: logits within
    2e-3 (an int8 value one step apart moves them; the ranks' flat decode
    walks split other slot ranges), the greedy tokens equal, the same
    bits on every rank, and each rank launched its path's kernels."""
    from repro_torch.core.paging import HostPageAllocator
    from repro_torch.serving.engine import (make_chunk_prefill_fn,
                                            make_serve_fns)
    from torch_dist_worker import allocate_rows
    (gran, paged, chunk), kernels = SERVE_ROUTES[route]
    cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, granularity=gran))
    params = T.init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), device=cuda_device)
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab, (SERVE_B, SERVE_S)).astype(np.int32)
    init, prefill, decode = make_serve_fns(cfg, max_len=SERVE_LEN,
                                           paged=paged, n_pages=32,
                                           device=cuda_device)
    state = init(SERVE_B)
    t = torch.from_numpy(toks).to(cuda_device)
    if paged:
        table = allocate_rows(HostPageAllocator(32), SERVE_B,
                              SERVE_LEN // cfg.quant.block_size)
        for c in state:
            c.page_table.copy_(torch.from_numpy(table))
        z = torch.zeros(SERVE_B, dtype=torch.int32, device=cuda_device)
        lg, state = make_chunk_prefill_fn(cfg)(
            params, t, state, z, torch.full_like(z, SERVE_S),
            torch.ones(SERVE_B, dtype=torch.bool, device=cuda_device))
    else:
        lg, state = prefill(params, t, state)
    logits, stream = [lg], []
    pos = torch.full((SERVE_B,), SERVE_S, dtype=torch.int32,
                     device=cuda_device)
    for _ in range(SERVE_STEPS):
        tok = lg[:, :cfg.vocab].argmax(-1).to(torch.int32)
        stream.append(tok.cpu().numpy())
        lg, state = decode(params, tok[:, None], state, pos)
        logits.append(lg)
        pos = pos + 1
    want = np.stack([x.cpu().numpy() for x in logits])
    save_tree(tmp_path / "w.npz", bridge.tree_to_numpy(params, cfg))
    save_tree(tmp_path / "b.npz", {"tokens": toks,
                                   "stream": np.stack(stream)})
    run_ranks(tmp_path, 4, [{
        "kind": "serve", "arch": "internlm2_1_8b", "mesh": [2, 2],
        "axes": ["data", "model"], "weights": str(tmp_path / "w.npz"),
        "batch": str(tmp_path / "b.npz"), "max_len": SERVE_LEN,
        "granularity": gran, "paged": paged, "chunk": chunk, "n_pages": 32,
        "result": str(tmp_path / "r")}], device="cuda")
    ranks = [load_tree(tmp_path / f"r.{r}.npz") for r in range(4)]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"], want, atol=2e-3, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(
            np.argmax(got["logits"][..., :cfg.vocab], -1),
            np.argmax(want[..., :cfg.vocab], -1))
        np.testing.assert_array_equal(got["logits"], ranks[0]["logits"])
        for k in kernels:
            assert int(got["launches"][k]) > 0, (r, k, got["launches"])


# -- the sharded ring -----------------------------------------------------------

@pytest.mark.parametrize("length,window", [(40, 32), (35, 30), (70, 30),
                                           (100, 5)])
def test_sharded_ring_decode_on_the_card(length, window, cuda_device):
    """A 32-slot ring (blocks of 8) cut in 4 ranks' parts: flat decode's
    kernel on each part at its ring_slot_args, merged in rank order,
    against the plain version over the whole ring (35 and 70 at window
    30 leave rank 0 two runs of live slots)."""
    from repro_torch.core.kvcache import ring_slot_args
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_attention import (
        flat_decode_partials_plain, merge_rank_partials)
    B, H, Hkv, D, ring, bs = 2, 16, 1, 256, 32, 8
    g = torch.Generator().manual_seed(length)
    kq = torch.randint(-127, 128, (B, Hkv, ring, D), generator=g,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, Hkv, ring, D), generator=g,
                       dtype=torch.int8)
    ks = torch.rand((B, Hkv, ring // bs, D), generator=g) * 0.02 + 1e-3
    vs = torch.rand((B, Hkv, ring // bs, D), generator=g) * 0.02 + 1e-3
    q = torch.randn((B, H, D), generator=g)
    dev = lambda t: t.to(cuda_device)
    parts = []
    for r in range(4):
        ln, wn = ring_slot_args(length, window, ring, r * 8, 8)
        cut = slice(r * 8, (r + 1) * 8)
        parts.append(ops.quant_attention_decode_partials(
            dev(q), dev(kq[:, :, cut]), dev(ks[:, :, r:r + 1]),
            dev(vq[:, :, cut]), dev(vs[:, :, r:r + 1]), ln, window=wn))
    o, m, l = merge_rank_partials(*[torch.stack(x) for x in zip(*parts)])
    i32 = lambda v: torch.full((B,), v, dtype=torch.int32)
    fo, fm, fl = flat_decode_partials_plain(q, kq, ks, vq, vs, i32(length),
                                            i32(window))
    np.testing.assert_allclose(
        (o / torch.clamp_min(l, 1e-30)).cpu().numpy(),
        (fo / torch.clamp_min(fl, 1e-30)).numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "mixtral_8x22b"])
def test_sharded_ring_serving_on_the_card(arch, tmp_path, cuda_device):
    """`make_serve_fns` on 4 ranks sharing the card at (data 1, model 4),
    a 40-token prompt a row (the ring wrapped twice, 4 slots a rank, its
    blocks of 8 straddling two ranks), 8 teacher-forced steps through a
    block flush, against the one-process functions on the card: logits
    within 2e-3, greedy tokens equal, the same bits on every rank, and
    flash, quantize_blocked and flat decode launched on each rank."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = T.init_params(cfg, torch.Generator(device=cuda_device)
                           .manual_seed(0), device=cuda_device)
    from repro_torch.serving.engine import make_serve_fns
    S = 40
    toks = np.random.RandomState(1).randint(
        0, cfg.vocab, (SERVE_B, S)).astype(np.int32)
    init, prefill, decode = make_serve_fns(cfg, max_len=SERVE_LEN,
                                           device=cuda_device)
    state = init(SERVE_B)
    lg, state = prefill(params, torch.from_numpy(toks).to(cuda_device),
                        state)
    logits, stream = [lg], []
    pos = torch.full((SERVE_B,), S, dtype=torch.int32, device=cuda_device)
    for _ in range(SERVE_STEPS):
        tok = lg[:, :cfg.vocab].argmax(-1).to(torch.int32)
        stream.append(tok.cpu().numpy())
        lg, state = decode(params, tok[:, None], state, pos)
        logits.append(lg)
        pos = pos + 1
    want = np.stack([x.cpu().numpy() for x in logits])
    save_tree(tmp_path / "w.npz", bridge.tree_to_numpy(params, cfg))
    save_tree(tmp_path / "b.npz", {"tokens": toks,
                                   "stream": np.stack(stream)})
    run_ranks(tmp_path, 4, [{
        "kind": "serve", "arch": arch, "mesh": [1, 4],
        "axes": ["data", "model"], "weights": str(tmp_path / "w.npz"),
        "batch": str(tmp_path / "b.npz"), "max_len": SERVE_LEN,
        "result": str(tmp_path / "r")}], device="cuda")
    ranks = [load_tree(tmp_path / f"r.{r}.npz") for r in range(4)]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"], want, atol=2e-3, rtol=0,
                                   err_msg=f"rank {r}")
        np.testing.assert_array_equal(
            np.argmax(got["logits"][..., :cfg.vocab], -1),
            np.argmax(want[..., :cfg.vocab], -1))
        np.testing.assert_array_equal(got["logits"], ranks[0]["logits"])
        for k in ("flash_fwd_cuda", "quantize_blocked_cuda",
                  "flat_decode_partials_cuda"):
            assert int(got["launches"][k]) > 0, (r, k, got["launches"])
