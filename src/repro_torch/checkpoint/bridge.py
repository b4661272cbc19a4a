"""Weight bridge: the reference's ``init_params`` pytree, already turned
into numpy arrays, to the port's parameter dict.

The reference stacks its layers on a leading ``n_groups`` axis under
``tree["blocks"]["p0"]`` (one attention block per group for a dense
stack) and holds ``embed``, ``lm_head`` and ``final_norm`` beside it.
Arrays go through float32, which is exact for bfloat16 (numpy's
ml_dtypes bfloat16 cannot go through `torch.from_numpy`), then to the
config's dtype on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import check_servable


def params_from_numpy(tree, cfg, device) -> dict:
    check_servable(cfg)
    dt = cfg.activation_dtype

    def t(a, dtype=dt):
        return torch.from_numpy(np.array(a, np.float32)).to(
            device=device, dtype=dtype)

    blocks = tree["blocks"]["p0"]
    n = np.asarray(blocks["norm1"]["scale"]).shape[0]
    if n != cfg.n_layers or tree.get("tail"):
        raise ValueError(f"expected {cfg.n_layers} stacked layers and no "
                         f"tail, got {n} and {len(tree.get('tail') or [])}")
    layers = []
    for i in range(n):
        layers.append({
            "norm1": {"scale": t(blocks["norm1"]["scale"][i], torch.float32)},
            "attn": {k: t(blocks["attn"][k][i])
                     for k in ("wq", "wk", "wv", "wo")},
            "norm2": {"scale": t(blocks["norm2"]["scale"][i], torch.float32)},
            "mlp": {k: t(blocks["mlp"][k][i])
                    for k in ("w_gate", "w_up", "w_down")},
        })
    return {"embed": t(tree["embed"]),
            "lm_head": t(tree["lm_head"]),
            "final_norm": {"scale": t(tree["final_norm"]["scale"],
                                      torch.float32)},
            "layers": layers}
