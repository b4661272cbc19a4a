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


SSM_MESHES = [((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
              ((2, 2, 2), ("pod", "data", "model")),
              ((16, 16), ("data", "model"))]


@pytest.mark.parametrize("arch", ["xlstm_350m", "recurrentgemma_9b",
                                  "internlm2_1_8b"])
def test_specs_under_the_ssm_override_match_reference(arch):
    """`mesh_context(mesh, SSM_RULES)` (the reference's dry-run override
    for family "ssm", dryrun.py:101-104) on both sides: the parameter,
    serving-state and batch specs of the smoke config, dimension by
    dimension, with the override in force (the batch takes "model", so
    the state's "heads" / "ffn" dims replicate)."""
    from repro_torch.parallel.shard import SSM_RULES, mesh_context
    assert SSM_RULES == {"batch": ("pod", "data", "model")}
    pcfg = get_config(arch, smoke=True)
    rcfg = ref_get_config(arch, smoke=True)
    _, rshapes = _ref_params(arch, True)
    pshapes = SP.param_shapes(pcfg)
    B, L = 8, 64
    rstate = jax.eval_shape(lambda: RT.init_decode_state(rcfg, B, L))
    pstate = T.init_decode_state(pcfg, B, L, device="cpu")
    batch = {"tokens": np.zeros((B, 33), np.int32)}
    for sizes, axes in SSM_MESHES:
        rmesh, pmesh = _both(sizes, axes)
        with RSH.mesh_context(rmesh, dict(SSM_RULES)), \
                mesh_context(None, SSM_RULES):
            ref = _ref_specs(RS.param_shardings(rshapes, rmesh), rshapes)
            _compare(ref, SP.param_shardings(pshapes, pmesh), pcfg,
                     f"{sizes} ssm ")
            want = _ref_cache_specs(rcfg, rstate,
                                    RS.cache_shardings(rstate, rmesh))
            got = SP.cache_shardings(pstate, pmesh, pcfg)
            assert got == want, sizes
            rb = RS.batch_shardings(batch, rmesh)
            assert SP.batch_shardings(batch, pmesh) == {
                k: _norm(v.spec, 2) for k, v in rb.items()}
        # the override moves the batch onto "model" where it divides
        with mesh_context(None, SSM_RULES):
            bspec = logical_spec(("batch",), (B,), pmesh)[0]
        if B % pmesh.size == 0:
            assert bspec == tuple(axes), (sizes, bspec)


def _ref_cache_specs(rcfg, rstate, rsh) -> list:
    """The reference's stacked state shardings -> {field: spec} a layer,
    in layer order (as `test_cache_and_batch_specs_match_reference`)."""
    period = len(rcfg.block_pattern)
    per = [_unstack(rstate[f"p{i}"], rsh[f"p{i}"]) for i in range(period)]
    want = [per[i][g] for g in range(len(per[0])) for i in range(period)]
    for c, s in zip(rstate.get("tail", []), rsh.get("tail", [])):
        want.append({f: _norm(getattr(s, f).spec, len(getattr(c, f).shape))
                     for f in SP.CACHE_RULES if hasattr(c, f)})
    return want


@pytest.mark.parametrize("sizes,axes", SSM_MESHES[:2])
def test_recurrent_state_leaf_specs(sizes, axes):
    """Each recurrent state leaf at full width, against the reference's
    `_spec_for` on its stacked leaf, and what the rules make of it: the
    mLSTM matrix memory C (B, nh, dh, dh) shards its KEY dim (the third:
    the readout contracts it, ``einsum("bhde,bhd->bhe", C, q)``), n
    (B, nh, dh) the same dim, m (B, nh) the rows only; the sLSTM n
    (B, d), stacked three dims deep under a three-name rule, keeps its
    rows whole; h and c (B, d) and the RG-LRU h and conv tail shard
    their channels over "model"."""
    from repro.launch.specs import _spec_for
    from jax.tree_util import DictKey
    rmesh, pmesh = _both(sizes, axes)
    model = ("model",)
    rows = ("data",)
    for arch in ("xlstm_350m", "recurrentgemma_9b"):
        pcfg = get_config(arch)
        rcfg = ref_get_config(arch)
        B = 8
        rstate = jax.eval_shape(lambda: RT.init_decode_state(rcfg, B, 512))
        pspecs = SP.cache_shardings(
            T.init_decode_state(pcfg, B, 512, device="meta"), pmesh, pcfg)
        period = len(rcfg.block_pattern)
        for i, kind in enumerate(rcfg.block_pattern):
            if kind in ("attn", "local_attn", "moe"):
                continue
            c = rstate[f"p{i}"]
            for f in SP.CACHE_RULES:
                if not hasattr(c, f):
                    continue
                leaf = getattr(c, f)
                ref = _norm(_spec_for([DictKey(f)], leaf, SP.CACHE_RULES,
                                      rmesh).spec, leaf.ndim)[1:]
                assert pspecs[i][f] == ref, (arch, kind, f, pspecs[i][f],
                                             ref)
            got = pspecs[i]
            if kind == "mlstm":
                assert got["C"] == (rows, (), model, ())
                assert got["n"] == (rows, (), model)
                assert got["m"] == (rows, ())
                assert got["C_s"] == (rows, (), model)
            elif kind == "slstm":
                assert got["n"] == ((), model), got["n"]
                assert got["h"] == got["c"] == (rows, model)
                assert got["m"] == (rows, ())
            else:
                assert got["h"] == (rows, model)
                assert got["conv"] == (rows, (), model)
        assert period


def test_spec_cache_is_keyed_on_the_rules():
    """JAX-free: one config and mesh shape under two rule sets give two
    specs (the cache answers each with its own rules' specs, in any
    order), and the default rules come back after the override."""
    from repro_torch.parallel.shard import (LOGICAL_RULES, current_rules,
                                            mesh_context)
    cfg = get_config("internlm2_1_8b", smoke=True)
    mesh = MeshShape(("data", "model"), (2, 2))
    base = SP.param_specs(cfg, mesh)
    base_err = SP.error_specs(cfg, mesh)
    over = {"vocab": (), "heads": ()}
    with mesh_context(None, over):
        assert current_rules() == {**LOGICAL_RULES, **over}
        alt = SP.param_specs(cfg, mesh)
        assert alt == SP.param_shardings(SP.param_shapes(cfg), mesh)
    assert current_rules() == LOGICAL_RULES
    assert alt != base
    assert alt["embed"] == ((), ("data",)) != base["embed"]
    assert alt["layers"][0]["attn"]["wq"] == (("data",), ())
    assert SP.param_specs(cfg, mesh) == base
    with mesh_context(None, over):
        assert SP.param_specs(cfg, mesh) == alt
        assert SP.error_specs(cfg, mesh) != base_err
    assert SP.error_specs(cfg, mesh) == base_err
