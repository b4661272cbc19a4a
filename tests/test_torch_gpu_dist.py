"""The port's sharded training on the card (``gpu`` marker; JAX-free):
ranks share cuda:0 over gloo (their collectives staged through pinned
host buffers), each a process of tests/torch_dist_worker.py.

- a sharded step of internlm2_1_8b's smoke config (float32) on a (data 1,
  model 2) and a (data 2, model 1) mesh against the single-process step
  on the card: metrics and every gathered leaf within 1e-5;
- `int8_psum` of CUDA tensors over 2 ranks against the plain sum of the
  dequantized payloads in rank order, bit for bit;
- sharded `compress_with_feedback` on the card: the compressed gradients
  and the error state (so the scales) bit for bit the single-process
  ones.
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
