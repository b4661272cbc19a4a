"""The port's dry run (`launch.dryrun`, `launch.roofline`,
`launch.op_cost`) and the configs' shape cells and parameter counts
against the reference's.

Exact equality with the reference for all ten configs, full and smoke:
`param_count`, `active_param_count`, `is_subquadratic`, `has_decoder`,
`kv_cache_bytes` and the three model-flops functions at every `SHAPES`
cell; `SHAPES`, `get_shape`, `all_configs`; `skip_reason` for the 40
(arch, shape) pairs, `TRAIN_MICROBATCHES` and `input_specs`' shapes and
dtypes (``repro.launch.dryrun`` sets XLA_FLAGS when imported, so it is
imported in a subprocess only). The roofline's arithmetic on given
inputs; each kernel's cost function at PERF.md's table shapes (the
bases of its bound column). And the dry run itself in a subprocess (its
fake process group never in this worker): every smoke config in each of
the three kinds on a fake (2, 2) mesh, and internlm2_1_8b x decode_32k
on the fake 256-rank pod."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.configs import SHAPES as RSHAPES
from repro.configs import all_configs as ref_all_configs
from repro.configs import get_shape as ref_get_shape
from repro.launch import roofline as RRF
from repro_torch.configs import SHAPES, all_configs, get_config, get_shape
from repro_torch.configs.registry import ARCHS
from repro_torch.kernels import flash_fwd as FF
from repro_torch.kernels import quant_attention as QA
from repro_torch.kernels import quant_prefill as QP
from repro_torch.kernels import quantize as QK
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as M
from repro_torch.launch import roofline as RF
from torch_dryrun import run_json_many

ROOT = Path(__file__).resolve().parents[1]

_REFERENCE = r'''
import json
from repro.configs import SHAPES, get_config
from repro.configs.registry import ARCHS
from repro.launch import dryrun as D
print(json.dumps({
    "skip": {f"{a}|{s.name}": D.skip_reason(a, s.name)
             for a in ARCHS for s in SHAPES},
    "mb": D.TRAIN_MICROBATCHES, "long_ok": sorted(D.LONG_OK),
    "inputs": {f"{a}|{s.name}|{smoke}": {
        k: [list(v.shape), str(v.dtype)]
        for k, v in D.input_specs(get_config(a, smoke), s).items()}
        for a in ARCHS for s in SHAPES for smoke in (False, True)}}))
'''


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_and_model_flops_match_reference(arch):
    from repro.configs import get_config as ref_get_config
    for smoke in (False, True):
        got, want = get_config(arch, smoke), ref_get_config(arch, smoke)
        label = f"{arch} smoke={smoke}"
        assert got.param_count() == want.param_count(), label
        assert RF.active_param_count(got) == RRF.active_param_count(want)
        assert got.is_subquadratic == want.is_subquadratic, label
        assert got.has_decoder == want.has_decoder, label
        for s in SHAPES:
            B, S = s.global_batch, s.seq_len
            for nbytes in (1, 2, 4, 0.5):
                assert got.kv_cache_bytes(B, S, nbytes) == \
                    want.kv_cache_bytes(B, S, nbytes), (label, s.name)
            assert RF.train_model_flops(got, B * S) == \
                RRF.train_model_flops(want, B * S), (label, s.name)
            assert RF.prefill_model_flops(got, B, S) == \
                RRF.prefill_model_flops(want, B, S), (label, s.name)
            assert RF.decode_model_flops(got, B, S) == \
                RRF.decode_model_flops(want, B, S), (label, s.name)


def test_shapes_and_registry_match_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in SHAPES] \
        == [(s.name, s.seq_len, s.global_batch, s.kind) for s in RSHAPES]
    for s in RSHAPES:
        assert get_shape(s.name) == DR.get_shape(s.name)
        assert (get_shape(s.name).seq_len, get_shape(s.name).kind) == \
            (ref_get_shape(s.name).seq_len, ref_get_shape(s.name).kind)
    with pytest.raises(KeyError):
        get_shape("train_8k")
    for smoke in (False, True):
        got, want = all_configs(smoke), ref_all_configs(smoke)
        assert set(got) == set(want) == set(ARCHS)
        for a in ARCHS:
            assert got[a].name == want[a].name
            assert got[a].param_count() == want[a].param_count()
    from repro_torch import configs
    for name in ("SHAPES", "ShapeConfig", "get_shape", "all_configs",
                 "canonical", "ARCHS", "get_config"):
        assert name in configs.__all__ and hasattr(configs, name)


def test_skip_reason_and_microbatches_match_reference(reference):
    got = {f"{a}|{s.name}": DR.skip_reason(a, s.name)
           for a in ARCHS for s in SHAPES}
    assert len(got) == 40 and got == reference["skip"]
    assert sum(v is not None for v in got.values()) == 7
    assert DR.TRAIN_MICROBATCHES == reference["mb"]
    assert sorted(DR.LONG_OK) == reference["long_ok"]


def test_input_specs_match_reference(reference):
    names = {"torch.int32": "int32", "torch.float32": "float32"}
    for a in ARCHS:
        for s in SHAPES:
            for smoke in (False, True):
                specs = DR.input_specs(get_config(a, smoke), s)
                got = {k: [list(v.shape), names[str(v.dtype)]]
                       for k, v in specs.items()}
                assert got == reference["inputs"][f"{a}|{s.name}|{smoke}"]
                assert all(v.device.type == "meta" for v in specs.values())


def test_roofline_arithmetic():
    """The terms on given counts, by hand, at the H100's published rates
    (bf16 989 TFLOP/s, float32 67 TFLOP/s, HBM 3.35 TB/s, NVLink 450 GB/s
    a direction)."""
    assert (M.PEAK_FLOPS_BF16, M.PEAK_FLOPS_F32, M.HBM_BW, M.NVLINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)
    r = RF.Roofline(flops=2e12, hbm_bytes=6.7e9, coll_bytes=9e8, chips=256,
                    model_flops=1e14, flops_f32=0.67e12,
                    coll_detail={"all_gather:model": 9e8})
    compute = 1.33e12 / 989e12 + 0.67e12 / 67e12
    assert r.compute_s == pytest.approx(compute, rel=1e-12)
    assert r.memory_s == pytest.approx(2e-3, rel=1e-12)
    assert r.collective_s == pytest.approx(2e-3, rel=1e-12)
    assert r.step_time_s == max(r.compute_s, r.memory_s, r.collective_s)
    assert r.bottleneck == "compute"
    assert r.mfu == pytest.approx(1e14 / (compute * 256 * 989e12))
    assert r.useful_flops_ratio == pytest.approx(1e14 / (2e12 * 256))
    assert set(r.row()) == {
        "compute_s", "memory_s", "collective_s", "bottleneck", "flops",
        "hbm_bytes", "coll_bytes", "model_flops", "useful_ratio", "mfu",
        "step_time_s"}
    assert set(r.row()) == set(RRF.Roofline(1, 1, 1, 1, 1).row())
    m = RF.Roofline(flops=0, hbm_bytes=1.0, coll_bytes=0, chips=1,
                    model_flops=0)
    assert (m.bottleneck, m.mfu, m.useful_flops_ratio) == ("memory", 0.0,
                                                          0.0)


# PERF.md §6's table: each kernel's bound basis at its timed shapes
@pytest.mark.parametrize("kernel", ["paged_decode", "paged_prefill",
                                    "flat_decode", "pair", "quantize_blocked",
                                    "dequantize", "flash_fwd"])
def test_kernel_cost_reproduces_the_bound_basis(kernel):
    if kernel == "paged_decode":        # 4 rows, lengths 2048..512, int8
        nbytes, _ = QA.paged_decode_cost(4, 16, 8, 128,
                                         [2048, 1536, 1024, 512], 256)
        assert round(nbytes / 1e6, 2) == 10.72
        assert nbytes == 10_715_744
    elif kernel == "paged_prefill":     # C 1024, the full dispatch
        _, flops = QP.paged_prefill_cost(16, 8, 1024, 128,
                                         [0, 256, 1024, 1792],
                                         [1024, 511, 1, 1024], 256)
        assert round(flops / 1e9, 2) == 25.78
        assert flops == 25_782_394_880
    elif kernel == "flat_decode":       # 4 rows x 2048 slots, per block
        nbytes, _ = QA.flat_decode_cost(4, 16, 8, 128, 8, [2048] * 4)
        assert round(nbytes / 1e6, 2) == 17.11
    elif kernel == "pair":              # (4, 8, 2048, 128) float32
        a, _ = QK.quantize_cost("absmax", (4, 8, 2048, 128))
        q, _ = QK.quantize_cost("quantize_with_scales", (4, 8, 2048, 128))
        assert (round(a / 1e6, 2), round(q / 1e6, 2)) == (33.57, 41.98)
    elif kernel in ("quantize_blocked", "dequantize"):
        nbytes, _ = QK.quantize_cost(kernel, (4, 8, 2048, 128), 256)
        assert round(nbytes / 1e6, 2) == 42.07
    else:                               # (4, 16, 2048, 128) bf16 causal
        _, flops = FF.flash_cost(4, 16, 8, 2048, 2048, 128, 2)
        assert round(flops / 1e9, 2) == 68.75
        assert FF.live_pairs(2048, 2048) == 2048 * 2049 // 2
        # queries 512..811 over 812 keys, a window of 256: 256 keys each
        assert FF.live_pairs(300, 812, True, 256, 512) == 300 * 256


# -- the dry run itself (a subprocess: the fake process group) ----------------

_CELLS = r'''
import functools, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as DR, op_cost
out = {"smoke": {}}
mesh = DR.fake_mesh((2, 2), ("data", "model"))
for a in sys.argv[1:]:
    if a == "pod":
        out["pod"] = DR.run_cell("internlm2_1_8b", "decode_32k", False,
                                 verbose=False)
        continue
    if a == "loops":       # host loops collapsed, then every trip run
        measure, out["loops"] = op_cost.measure, []
        for collapse in (True, False):
            op_cost.measure = functools.partial(measure, collapse=collapse)
            t = DR.trace_train(get_config("internlm2_1_8b", smoke=True),
                               mesh, 4, 32, 2)
            s = DR.trace_serve(get_config("xlstm_350m", smoke=True), mesh,
                               4, 32, 64)
            out["loops"].append({k: {f: r[f] for f in (
                "coll_detail", "coll_calls", "flops", "hbm_bytes")}
                for k, r in (("train", t), ("prefill", s["prefill"]),
                             ("decode", s["decode"]))})
        op_cost.measure = measure
        continue
    cfg = get_config(a, smoke=True)
    row = {}
    try:
        t = DR.trace_train(cfg, mesh, 4, 32, 2)
        s = DR.trace_serve(cfg, mesh, 4, 32, 64)
        for k, r in (("train", t), ("prefill", s["prefill"]),
                     ("decode", s["decode"])):
            row[k] = {f: r[f] for f in ("status", "bytes_per_device",
                                        "arg_bytes", "flops", "hbm_bytes",
                                        "coll_bytes", "step_time_s", "rank",
                                        "kernels")}
    except Exception as e:
        row["error"] = f"{type(e).__name__}: {e}"
    row["long_500k"] = DR.skip_reason(a, "long_500k")
    out["smoke"][a] = row
DR.close_fake_group()
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def cells():
    """The smoke cells in two interpreters, the pod cell in a third and
    the host loops' collectives in a fourth, side by side."""
    half = len(ARCHS) // 2
    parts = run_json_many(_CELLS, [ARCHS[:half], ARCHS[half:], ("pod",),
                                   ("loops",)], timeout=600)
    out = {"smoke": {}}
    for p in parts:
        out["smoke"].update(p["smoke"])
        out.update({k: v for k, v in p.items() if k != "smoke"})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_trace_on_a_2x2_mesh(cells, arch):
    """Train (2 microbatches), prefill and decode of the smoke config on
    the last rank of a fake (2, 2) mesh end ok; long_500k is skipped by
    the reference's rule exactly for the full-attention archs."""
    row = cells["smoke"][arch]
    assert "error" not in row, row.get("error")
    for kind in ("train", "prefill", "decode"):
        r = row[kind]
        assert r["status"] == "ok" and r["rank"] == 3
        assert r["bytes_per_device"] > r["arg_bytes"] > 0
        assert r["flops"] > 0 and r["hbm_bytes"] > 0 and r["coll_bytes"] > 0
        assert math.isfinite(r["step_time_s"]) and r["step_time_s"] > 0
    cfg = get_config(arch, smoke=True)
    if cfg.family != "ssm":             # every attention stack's flash
        assert row["train"]["kernels"]["flash_fwd"]["launches"] > 0
        assert row["prefill"]["kernels"]["flash_fwd"]["launches"] > 0
    assert (row["long_500k"] is None) == (arch in DR.LONG_OK)


def test_full_size_cell_traces_on_the_pod(cells):
    """internlm2_1_8b x decode_32k on the fake 256-rank (16, 16) mesh: the
    last rank's shards (its weights at a sixteenth of the 1.8 B bf16
    parameters' model axis, its 8 rows' cache slots), the flat decode
    kernel a layer, the reference's row keys."""
    r = cells["pod"]
    assert r["status"] == "ok" and r["chips"] == 256 and r["mesh"] == "16x16"
    assert r["rank"] == 255 and r["rank_coords"] == {"data": 15,
                                                     "model": 15}
    cfg = get_config("internlm2_1_8b")
    assert r["kernels"]["flat_decode"]["launches"] == cfg.n_layers
    # the weights cut over "model" (16), the int8 cache's rows over "data"
    # (16) and slots over "model": a 256th of it, with its scale rows
    assert 2 * cfg.param_count() / 16 < r["weight_bytes"] < \
        2 * cfg.param_count() / 8
    cache = cfg.kv_cache_bytes(128, 32768, 1) // 256
    assert cache < r["state_bytes"] < 1.3 * cache   # + bf16 residuals
    assert r["arg_bytes"] > r["weight_bytes"] + r["state_bytes"]
    assert r["bytes_per_device"] < M.HBM_BYTES
    for key in ("arch", "shape", "mesh", "chips", "model_flops", "status",
                "compile_s", "bytes_per_device", "temp_bytes", "arg_bytes",
                "compute_s", "memory_s", "collective_s", "bottleneck",
                "flops", "hbm_bytes", "coll_bytes", "useful_ratio", "mfu",
                "step_time_s", "kernel_adjusted_memory_s"):
        assert key in r, key
    assert r["model_flops"] == RF.decode_model_flops(cfg, 128, 32768)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "recurrentgemma_9b",
                                  "xlstm_350m", "whisper_small"])
def test_one_process_trace_holds_the_real_bytes(arch):
    """`trace_serve` with no mesh (one process on the whole weights, the
    runs chip_smoke times without a process group): its weight and state
    bytes are exactly those of the smoke model's real weights and fresh
    state on the CPU, it sends nothing, and both kinds have a roofline."""
    import torch

    from repro_torch.launch import op_cost
    from repro_torch.models import encdec
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import make_serve_fns
    cfg = get_config(arch, smoke=True)
    rows = DR.trace_serve(cfg, None, 4, 32, 64)
    init = encdec.init_params if cfg.family == "encdec" else T.init_params
    params = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    state = make_serve_fns(cfg, max_len=64, device="cpu")[0](4)
    for kind, r in rows.items():
        assert r["rank"] == 0 and r["coll_detail"] == {}
        assert r["weight_bytes"] == op_cost.tree_bytes(params)
        assert r["state_bytes"] == op_cost.tree_bytes(state)
        assert r["arg_bytes"] > r["weight_bytes"] + r["state_bytes"]
        assert r["step_time_s"] > 0 and r["flops"] > 0


def test_collapsed_host_loop_counts_every_collective(cells):
    """On a fake (2, 2) mesh, a smoke train step's 2 microbatches traced
    once send what running both sends: every collective's calls and bytes
    in `Mesh.stats`, by op and axes, and the flops and bytes; likewise
    xlstm_350m's prefill and decode (its sLSTM token loop)."""
    once, every = cells["loops"]
    assert once == every
    assert sum(every["train"]["coll_calls"].values()) > 0
    assert every["train"]["coll_detail"] == once["train"]["coll_detail"]


@pytest.mark.parametrize("loop", ["slstm_tokens", "mlstm_chunks",
                                  "microbatches"])
def test_collapsed_host_loop_counts_every_trip(loop):
    """A host loop traced once and counted by its trips
    (`core.costing.host_loop`, as the reference's cost model multiplies a
    while body by its trip count) costs exactly what running every trip
    costs: flops, bytes (by op too) and kernels, on real CPU tensors
    (the sLSTM's 37 tokens and the mLSTM's 5 chunks without grad, a
    smoke train step's 2 microbatches with it)."""
    import dataclasses

    import torch

    from repro_torch.launch import op_cost
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as X
    from repro_torch.optim import AdamWConfig
    from repro_torch.training.step import init_opt_state, make_train_step
    gen = torch.Generator().manual_seed(0)
    if loop == "microbatches":
        cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True),
                                  dtype="float32")
        params = T.init_params(cfg, gen, device="cpu")
        opt = init_opt_state(params, cfg)
        tok = torch.randint(0, cfg.vocab, (4, 16), generator=gen)
        batch = {"tokens": tok, "labels": tok}
        step = make_train_step(cfg, AdamWConfig(), microbatches=2)
        fn = lambda: step(params, opt, batch)
    else:
        cfg = dataclasses.replace(get_config("xlstm_350m", smoke=True),
                                  dtype="float32")
        x = torch.randn(2, 37 if loop == "slstm_tokens" else 40,
                        cfg.d_model, generator=gen)
        if loop == "slstm_tokens":
            p = X.slstm_init(cfg, gen, "cpu")
            fn = lambda: X.slstm_seq(p, x, cfg)
        else:
            p = X.mlstm_init(cfg, gen, "cpu")
            fn = lambda: X.mlstm_hidden_seq(p, x, cfg, chunk=8)
    costs = []
    for collapse in (True, False):
        with torch.no_grad() if loop != "microbatches" else \
                torch.enable_grad():
            costs.append(op_cost.measure(fn, collapse=collapse)[1])
    once, every = costs
    assert every.flops > 0 and every.bytes > 0
    assert (once.flops, once.flops_f32, once.bytes, once.kernels) == \
        (every.flops, every.flops_f32, every.bytes, every.kernels)
    assert once.bytes_by_op == every.bytes_by_op
