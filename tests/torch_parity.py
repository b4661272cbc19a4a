"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py):
moving arrays between JAX/numpy and torch, and the fixtures that pick
the kernels' implementations."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def to_torch(a, device="cpu") -> torch.Tensor:
    """numpy / jax array -> torch tensor. fp8 goes through its bytes and
    bfloat16 through float32 (both exact)."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.int8).copy()).view(
            torch.float8_e4m3fn).to(device)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t) -> np.ndarray:
    """torch tensor / jax array -> numpy; fp8 and bfloat16 as their bytes /
    as float32, so two arrays compare bitwise."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.int8).numpy()
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.int8)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Make the reference run its Pallas kernels (interpret mode) where it
    would pick its bf16 XLA twin on the CPU: ``resolve_impl("auto")``
    answers "pallas_interpret" for this test only."""
    from repro.kernels import ops
    orig = ops.resolve_impl
    monkeypatch.setattr(
        ops, "resolve_impl",
        lambda impl="auto": "pallas_interpret" if impl == "auto"
        else orig(impl))


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; run on the card")
    return torch.device("cuda")
