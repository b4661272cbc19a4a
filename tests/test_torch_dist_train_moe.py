"""The port's sharded MoE training step (the reference's MoE
``_apply_shard_map``: experts' d shards gathered over the FSDP axes,
dispatch per row over the WHOLE sequence, the down-projection's partial
sums reduced over "model", the aux loss's mean over every row) on 4 gloo
ranks on the CPU against the reference's jitted unsharded step and the
port's single-process step, as tests/test_torch_dist_train.py holds the
dense ones: qwen2_moe_a2_7b (shared experts, QKV bias; plain and with
--grad-compression) and mixtral_8x22b (its window of 16 spans the
sequence shards of 16; plain and at 2 microbatches) on meshes (data 2,
model 2) and (pod 2, data 1, model 2); one case at capacity factor 1.0,
where the capacity comes from the full S and tokens drop."""
import dataclasses

import jax
import numpy as np
import pytest

import torch_train_parity as TP
from repro_torch.checkpoint import bridge
from repro_torch.configs import get_config
from torch_dist import run_ranks, step_task
from torch_dist_worker import load_tree, save_tree

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "pod": ((2, 1, 2), ("pod", "data", "model"))}
# (arch, mode, config fields replaced)
CASES = [("qwen2_moe_a2_7b", "plain", {}), ("qwen2_moe_a2_7b", "gc", {}),
         ("mixtral_8x22b", "plain", {}), ("mixtral_8x22b", "mb", {}),
         ("mixtral_8x22b", "drops", {"capacity_factor": 1.0})]
B, S = 4, 32


def pp_cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _kw(mode):
    return {"gc": mode == "gc", "mb": 2 if mode == "mb" else 1}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_moe")
    out, tasks = {}, []
    for arch, mode, rep in CASES:
        mods = TP.models(arch, **rep)
        b = TP.batch(mods[0][0], B, S)
        key = f"{arch}-{mode}"
        save_tree(d / f"{key}.w.npz", jax.tree.map(np.asarray, mods[0][1]))
        save_tree(d / f"{key}.b.npz", b)
        out[key] = TP.step_both(mods, b, **_kw(mode))
        for m, (sizes, axes) in MESHES.items():
            tasks.append(step_task(arch, sizes, axes, d / f"{key}.w.npz",
                                   d / f"{key}.b.npz", d / f"{key}.{m}.npz",
                                   TP.OPT, replace=rep, **_kw(mode)))
    run_ranks(d, 4, tasks, name="moe")
    return d, out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,mode", [(a, m) for a, m, _ in CASES])
def test_sharded_moe_step_matches_reference(results, arch, mode, mesh):
    d, out = results
    key = f"{arch}-{mode}"
    got = load_tree(d / f"{key}.{mesh}.npz")
    (rp, ro, rm), (pp, po, pm) = out[key]
    flips = 1e-4 if mode == "gc" else 0.0
    for k in ("loss", "aux_loss", "grad_norm", "lr"):
        for want in (rm[k], pm[k]):
            np.testing.assert_allclose(float(got["metrics"][k]), float(want),
                                       rtol=TP.RTOL,
                                       atol=1e-7 if k == "aux_loss" else 0,
                                       err_msg=k)
    assert float(got["metrics"]["aux_loss"]) > 0
    TP.close_trees(got["params"], jax.tree.map(np.asarray, rp), TP.RTOL,
                   flips=flips)
    TP.close_trees(got["params"], bridge.tree_to_numpy(pp, pp_cfg(arch)),
                   TP.RTOL, flips=flips)
    ra = jax.tree.map(np.asarray, ro["adam"])
    for k in ("m", "v", "master"):
        TP.close_trees(got[k], ra[k], TP.RTOL, flips=flips)
    if mode == "gc":
        TP.check_grad_err(got["grad_err"], ro, rm, TP.RTOL, flips)
