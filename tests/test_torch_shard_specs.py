"""The port's sharding specs against the reference's (`repro.launch.specs`,
`repro.parallel.shard`), dimension by dimension: `logical_spec` on the
reference's own TestLogicalSpec cases; `param_shardings`,
`opt_shardings` (with the error state), `replicated`, `batch_shardings`,
`cache_shardings` (every layer kind's serving state) and
`paged_cache_specs` of all ten configs, smoke and full, at meshes (1, 1),
(2, 4), (2, 2, 2), (16, 16) and (2, 16, 16). The reference runs on a
`jax.sharding.AbstractMesh` (shapes from ``jax.eval_shape``, one device),
the port on a `MeshShape` and meta-device trees. A stacked reference leaf
is compared with each of its layers' port leaves, its layer axis
dropped. Also the meshes' named errors."""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs.registry import get_config as ref_get_config
from repro.core import paging as RPG
from repro.launch import specs as RS
from repro.models import encdec as RE
from repro.models import transformer as RT
from repro.parallel import shard as RSH
from repro.training import step as RSTEP
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core.paging import PagedQuantizedKVCache
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as T
from repro_torch.parallel.shard import (MeshShape, logical_spec,
                                        paged_cache_specs)
from repro_torch.training.step import init_opt_state

jax.config.update("jax_platform_name", "cpu")

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _both(sizes, axes):
    return AbstractMesh(tuple(sizes), tuple(axes)), MeshShape(axes, sizes)


def _norm(spec, ndim: int) -> tuple:
    """A PartitionSpec as the port writes a spec: a tuple of axes a dim."""
    parts = list(spec) + [None] * (ndim - len(spec))
    return tuple(() if p is None else (p,) if isinstance(p, str)
                 else tuple(p) for p in parts)


def _ref_specs(shardings, shapes):
    """The reference's NamedSharding tree -> normalized specs (dicts,
    lists, dataclass fields as dicts)."""
    if isinstance(shapes, dict):
        return {k: _ref_specs(shardings[k], v) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_ref_specs(s, v) for s, v in zip(shardings, shapes)]
    return _norm(shardings.spec, len(shapes.shape))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, smoke: bool):
    cfg = ref_get_config(arch, smoke=smoke)
    init = RE.init_params if cfg.family == "encdec" else RT.init_params
    return cfg, jax.eval_shape(lambda k: init(cfg, k), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, smoke: bool):
    cfg = get_config(arch, smoke=smoke)
    return cfg, SP.param_shapes(cfg)


def _layers(cfg) -> list:
    """(reference stack key, port list key, layers in the stack) a stack."""
    if cfg.family == "encdec":
        return [("enc_blocks", "enc_layers", cfg.n_encoder_layers),
                ("dec_blocks", "dec_layers", cfg.n_layers)]
    return [("blocks", "layers", None)]


def _strip(tree):
    """A stacked leaf's spec without its layer axis."""
    return jax.tree.map(lambda s: s[1:], tree,
                        is_leaf=lambda s: isinstance(s, tuple))


def _compare(ref, port, cfg, path=""):
    """The reference's specs (stacked layout) against the port's (a list a
    stack): every layer's leaf equal to its stack's leaf minus the layer
    axis; the other leaves equal."""
    ref, port = dict(ref), dict(port)
    for rkey, pkey, n in _layers(cfg):
        rstack, players = ref.pop(rkey), port.pop(pkey)
        if rkey == "blocks":
            period = len(cfg.block_pattern)
            want = [_strip(rstack[f"p{i}"])
                    for _ in range(cfg.n_layers // period)
                    for i in range(period)] + list(ref.pop("tail", []))
        else:
            want = [_strip(rstack)] * n
        assert len(want) == len(players), (path, rkey)
        for i, (w, p) in enumerate(zip(want, players)):
            assert p == w, (f"{path}{pkey}.{i}", p, w)
    assert port == ref, path


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, smoke):
    rcfg, rshapes = _ref_params(arch, smoke)
    pcfg, pshapes = _port_params(arch, smoke)
    ropt = jax.eval_shape(lambda p: RSTEP.init_opt_state(
        p, grad_compression=True), rshapes)
    popt = init_opt_state(pshapes, pcfg, grad_compression=True)
    for sizes, axes in MESHES:
        rmesh, pmesh = _both(sizes, axes)
        ref = _ref_specs(RS.param_shardings(rshapes, rmesh), rshapes)
        port = SP.param_shardings(pshapes, pmesh)
        _compare(ref, port, pcfg, f"{sizes} ")
        assert SP.param_specs(pcfg, pmesh) == port
        _compare(_ref_specs(RS.replicated(rshapes, rmesh), rshapes),
                 SP.replicated(pshapes), pcfg, f"{sizes} replicated ")
        ro = _ref_specs(RS.opt_shardings(ropt, rmesh), ropt)
        po = SP.opt_shardings(popt, pmesh)
        for k in ("m", "v", "master"):
            _compare(ro["adam"][k], po["adam"][k], pcfg, f"{sizes} {k} ")
        assert po["adam"]["step"] == ro["adam"]["step"] == ()
        err = ro["grad_err"]
        if "tail" in err and not err["tail"]:
            del err["tail"]
        assert po["grad_err"] == err == SP.error_specs(pcfg, pmesh)


def _unstack(c, s) -> list:
    """A stacked reference state and its shardings -> {field: spec} a
    layer, the layer axis dropped."""
    fields = [f for f in SP.CACHE_RULES if hasattr(c, f)]
    n = getattr(c, fields[0]).shape[0]
    one = {f: _norm(getattr(s, f).spec, len(getattr(c, f).shape))[1:]
           for f in fields}
    return [one] * n


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_reference(arch):
    pcfg = get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    B, L = 8, 64
    enc = pcfg.family == "encdec"
    if enc:
        from repro_torch.models import encdec as PE
        rstate = jax.eval_shape(lambda: RE.init_decode_state(rcfg, B, L))
        pstate = PE.init_decode_state(pcfg, B, L, device="cpu")
    else:
        rstate = jax.eval_shape(lambda: RT.init_decode_state(rcfg, B, L))
        pstate = T.init_decode_state(pcfg, B, L, device="cpu")
    batch = {"tokens": np.zeros((B, 33), np.int32),
             "labels": np.zeros((B, 33), np.int32)}
    for sizes, axes in MESHES:
        rmesh, pmesh = _both(sizes, axes)
        rsh = RS.cache_shardings(rstate, rmesh)
        if enc:
            want = {k: _unstack(rstate[k], rsh[k]) for k in rstate}
        else:
            period = len(rcfg.block_pattern)
            per = [_unstack(rstate[f"p{i}"], rsh[f"p{i}"])
                   for i in range(period)]
            want = [per[i][g] for g in range(len(per[0]))
                    for i in range(period)]
            for c, s in zip(rstate.get("tail", []), rsh.get("tail", [])):
                want.append({f: _norm(getattr(s, f).spec,
                                      len(getattr(c, f).shape))
                             for f in SP.CACHE_RULES if hasattr(c, f)})
        assert SP.cache_shardings(pstate, pmesh, pcfg) == want, sizes
        rb = RS.batch_shardings(batch, rmesh)
        assert SP.batch_shardings(batch, pmesh) == {
            k: _norm(v.spec, 2) for k, v in rb.items()}


@pytest.mark.parametrize("sizes,axes", MESHES)
def test_paged_cache_specs_match_reference(sizes, axes):
    rmesh, pmesh = _both(sizes, axes)
    cfg = get_config("internlm2_1_8b", smoke=True)
    rc = RPG.PagedQuantizedKVCache.init(8, 4, 64, 16, cfg.quant, n_pages=17)
    pc = PagedQuantizedKVCache.init(8, 4, 64, 16, cfg.quant, n_pages=17,
                                    device="cpu")
    rs = RSH.paged_cache_specs(rc, rmesh)
    ps = paged_cache_specs(pc, pmesh)
    for f, spec in ps["pool"].items():
        assert spec == _norm(getattr(rs.pool, f), np.ndim(getattr(rc.pool,
                                                                  f))), f
    for f in ("page_table", "resid_k", "resid_v", "length"):
        assert ps[f] == _norm(getattr(rs, f), getattr(rc, f).ndim), f


# the reference's TestLogicalSpec cases, and a few of the fallbacks
@pytest.mark.parametrize("logical,shape,sizes,axes", [
    (("batch", None, "ffn"), (16, 32, 64), (2, 4), ("data", "model")),
    (("batch", "heads"), (16, 3), (2, 4), ("data", "model")),
    (("seq_shard", "ffn"), (16, 64), (2, 4), ("data", "model")),
    (("batch", None), (16, 8), (2, 2, 2), ("pod", "data", "model")),
    (("batch", None), (1, 8), (2, 4), ("data", "model")),
    (("fsdp", "vocab"), (6, 256), (2, 3, 16), ("pod", "data", "model")),
    (("batch", "seq_shard", None), (3, 31, 64), (2, 2), ("data", "model")),
    (("kv_heads", "heads"), (2, 32), (1, 4), ("data", "model")),
])
def test_logical_spec_matches_reference(logical, shape, sizes, axes):
    rmesh, pmesh = _both(sizes, axes)
    want = _norm(RSH.logical_spec(logical, shape, rmesh), len(shape))
    assert logical_spec(logical, shape, pmesh) == want


def test_meshes_refuse_another_world_size():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        PM.make_production_mesh("cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        PM.make_production_mesh("cpu", multi_pod=True)
