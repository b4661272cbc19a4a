"""PyTorch/CUDA port of the paged INT8 KV-cache serving stack, and of its
dense training path, for NVIDIA Hopper (H100).

Mirrors ``repro``'s subpackages (configs, core, kernels, models, serving,
training, optim, data, checkpoint, runtime, launch) but imports neither
``repro`` nor ``jax``: the JAX package is the reference the parity tests
compare against, so sharing code with it would make those tests compare
the code with itself.

Entry points (``LLMEngine``, ``ContinuousBatcher``, ``init_params``,
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``) default to ``device="cuda"`` and raise when no
card is present; pass ``device="cpu"`` explicitly to run the kernels'
plain PyTorch versions.
"""
