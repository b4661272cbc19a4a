"""Helpers of the sharded serving parity tests
(tests/test_torch_dist_serve*.py): the reference's smoke models in
float32 (QKV biases seeded non-zero, tests/torch_arch.py), its jitted
UNSHARDED `make_serve_fns` / `make_chunk_prefill_fn` on its Pallas
kernels in interpret mode, its serving state as numpy in the layout of
the port's `checkpoint.bridge.serve_state_to_numpy`, the `serve` tasks
of tests/torch_dist_worker.py, and the checks of each rank's results
against the reference's.

Holding the sharded port against the unsharded reference is valid
because GSPMD's shardings do not change the reference's values, and the
reference's own sharded serving test (tests/test_distribution.py::
test_sharded_decode_step_runs) fails under jax 0.9 (ROADMAP queue 3)."""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from repro.serving import engine as RE
from torch_arch import smoke_models
from torch_dist_worker import allocate_rows, save_tree
from torch_parity import to_numpy

jax.config.update("jax_platform_name", "cpu")

B, S, MAX_LEN, STEPS = 4, 24, 48, 8
# logits: a K or V value on an int8 rounding boundary may land one step
# apart between the packages (float32 sums in other orders), and the
# steps that read it move by more than rounding
# (tests/test_torch_arch_forward.py measured up to 1.6e-3)
ATOL = 2e-3
# the page rule: int8 values at most one step apart in at most this share
# of the places (tests/test_torch_prefix_cache.py)
INT8_STEP_FRAC = 5e-3
# scale rows: float32 absmax of the same K/V up to the sums' order
SCALE_RTOL = 1e-5
# the bf16 residual of K/V that differ by float32 rounding: one bf16 step
RESID_RTOL = 2.0 ** -7
# a recurrent state's float leaves: float32 sums of another order through
# the layers below (the logits' ATOL as a share of the leaf's largest
# |value|)
STATE_TOL = 1e-4
MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
AXES = ["data", "model"]
CACHE = ("k_q", "v_q", "k_s", "v_s", "resid_k", "resid_v", "length")
POOL = ("k_q", "v_q", "k_s", "v_s")
VIEW = ("page_table", "resid_k", "resid_v", "length")


def models(arch: str, granularity: str = "per_block", **replace):
    """(reference cfg, reference params) of ``arch``'s smoke config in
    float32 at ``granularity`` (whisper_small's from `encdec.init_params`;
    ``replace``: fields that leave the weights alone, its
    ``encoder_seq``)."""
    if arch == "whisper_small":
        from repro.configs.registry import get_config as ref_get_config
        from repro.models import encdec as RED
        rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                                   dtype="float32", **replace)
        return rcfg, RED.init_params(rcfg, jax.random.PRNGKey(0))
    (rcfg, rparams), _ = smoke_models(arch)
    if granularity != rcfg.quant.granularity:
        rcfg = dataclasses.replace(rcfg, quant=dataclasses.replace(
            rcfg.quant, granularity=granularity))
    return rcfg, rparams


@contextlib.contextmanager
def pallas_interpret():
    """The reference on its Pallas kernels in interpret mode (where it
    would take its bf16 XLA twin on the CPU), as tests/torch_parity.py's
    fixture, for a block of code."""
    from repro.kernels import ops
    orig = ops.resolve_impl
    ops.resolve_impl = (lambda impl="auto": "pallas_interpret"
                        if impl == "auto" else orig(impl))
    try:
        yield
    finally:
        ops.resolve_impl = orig


def state_numpy(state) -> dict:
    """The reference's serving state -> numpy in the bridge's layout (a
    recurrent state's dataclass fields)."""
    def fields(c):
        if hasattr(c, "pool"):
            return {"pool": {f: to_numpy(getattr(c.pool, f)) for f in POOL},
                    **{f: to_numpy(getattr(c, f)) for f in VIEW}}
        names = CACHE if hasattr(c, "k_q") else \
            [f.name for f in dataclasses.fields(c)]
        return {f: to_numpy(getattr(c, f)) for f in names}
    return {k: ([fields(c) for c in v] if isinstance(v, list) else
                fields(v)) for k, v in state.items()}


def page_table(n_pages: int, max_len: int, block: int) -> np.ndarray:
    """Every row's pages from the reference's `HostPageAllocator`, in the
    worker's order (`allocate_rows`): the table each rank's replicated
    allocator must hand out."""
    from repro.core.paging import HostPageAllocator
    return allocate_rows(HostPageAllocator(n_pages), B, max_len // block)


def run_reference(rcfg, rparams, toks, *, paged=False, chunk=False,
                  n_pages=None, max_len=MAX_LEN, steps=STEPS,
                  kv_cache_dtype="int8", frames=None) -> dict:
    """Prefill ``toks`` (B, S) (``chunk``: one chunk through
    `make_chunk_prefill_fn`), then ``steps`` greedy decode steps, jitted
    and unsharded: {"logits" (steps + 1, B, Vp), "stream" (steps, B) the
    tokens fed, "prefill_state" and "state" as numpy, "table" the page
    table where paged}. ``kv_cache_dtype`` as the reference's
    `make_serve_fns` takes it (a per-layer list: a mixed plan, whose
    ``p{i}`` are lists of layers); ``frames`` an encoder-decoder's
    (B, T_enc, d), fed with the prompt."""
    out = {}
    if isinstance(kv_cache_dtype, list):
        kv_cache_dtype = tuple(kv_cache_dtype)
    with pallas_interpret():
        init, prefill, decode = RE.make_serve_fns(
            rcfg, max_len=max_len, paged=paged, n_pages=n_pages,
            kv_cache_dtype=kv_cache_dtype)
        state = init(B)
        if paged:
            first = state["p0"][0] if isinstance(state["p0"], list) else \
                state["p0"]
            table = page_table(first.pool.k_q.shape[-4], max_len,
                               rcfg.quant.block_size)

            def put(c):
                return dataclasses.replace(c, page_table=jnp.broadcast_to(
                    jnp.asarray(table), c.page_table.shape))
            state = {k: ([put(c) for c in v] if isinstance(v, list) else
                         put(v)) for k, v in state.items()}
            out["table"] = table
        t = jnp.asarray(toks)
        if chunk:
            fn = jax.jit(RE.make_chunk_prefill_fn(
                rcfg, kv_cache_dtype=kv_cache_dtype))
            lg, state = fn(rparams, t, state, jnp.zeros(B, jnp.int32),
                           jnp.full(B, toks.shape[1], jnp.int32),
                           jnp.ones(B, bool))
        else:
            inputs = {"tokens": t}
            if frames is not None:
                inputs["frames"] = jnp.asarray(frames)
            lg, state = jax.jit(prefill)(rparams, inputs, state)
        out["prefill_state"] = state_numpy(state)
        dec = jax.jit(decode)
        logits, stream = [np.asarray(lg)], []
        pos = jnp.full((B,), toks.shape[1], jnp.int32)
        for _ in range(steps):
            tok = jnp.argmax(lg[:, :rcfg.vocab], -1).astype(jnp.int32)
            stream.append(np.asarray(tok))
            lg, state = dec(rparams, tok[:, None], state, pos)
            logits.append(np.asarray(lg))
            pos = pos + 1
    out.update(logits=np.stack(logits), stream=np.stack(stream),
               state=state_numpy(state))
    return out


def run_port(arch: str, toks, stream, *, kv_cache_dtype, n_pages: int,
             max_len=MAX_LEN) -> np.ndarray:
    """The port's own unsharded paged run of ``arch``'s smoke model (the
    reference's weights bridged): one chunk prefill of ``toks`` on the
    reference allocator's pages, then ``stream`` teacher-forced. Returns
    every step's logits (steps + 1, B, Vp)."""
    import torch

    from repro_torch.serving.engine import (make_chunk_prefill_fn,
                                            make_serve_fns)
    _, (pcfg, pparams) = smoke_models(arch)
    kv = tuple(kv_cache_dtype) if isinstance(kv_cache_dtype, list) else \
        kv_cache_dtype
    init, _, decode = make_serve_fns(pcfg, max_len=max_len, paged=True,
                                     n_pages=n_pages, kv_cache_dtype=kv,
                                     device="cpu")
    state = init(B)
    table = torch.from_numpy(page_table(n_pages, max_len,
                                        pcfg.quant.block_size))
    for c in state:
        c.page_table.copy_(table)
    z = torch.zeros(B, dtype=torch.int32)
    lg, state = make_chunk_prefill_fn(pcfg)(
        pparams, torch.from_numpy(toks), state, z,
        torch.full_like(z, toks.shape[1]), torch.ones(B, dtype=torch.bool))
    logits = [lg.numpy()]
    pos = torch.full((B,), toks.shape[1], dtype=torch.int32)
    for tok in stream:
        lg, state = decode(pparams, torch.from_numpy(tok[:, None]), state,
                           pos)
        logits.append(lg.numpy())
        pos = pos + 1
    return np.stack(logits)


def tokens(rcfg, seed: int = 1, s: int = S) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, rcfg.vocab,
                                               (B, s)).astype(np.int32)


def frames(rcfg) -> np.ndarray:
    """An encoder-decoder's (B, encoder_seq, d) `make_frames` frames."""
    from repro.data import pipeline as RD
    return RD.make_frames(RD.DataConfig(seq_len=S, global_batch=B,
                                        vocab=rcfg.vocab),
                          rcfg.d_model, rcfg.encoder_seq)


def write_inputs(d, key: str, rparams, toks, ref,
                 frames=None) -> tuple[str, str]:
    """The reference's weights and the batch (prompts, tokens fed, an
    encoder-decoder's frames) as the worker reads them: (weights path,
    batch path)."""
    w, b = d / f"{key}.w.npz", d / f"{key}.b.npz"
    save_tree(w, jax.tree.map(np.asarray, rparams))
    batch = {"tokens": toks, "stream": ref["stream"]}
    if frames is not None:
        batch["frames"] = frames
    save_tree(b, batch)
    return str(w), str(b)


def run_port_encdec(arch: str, encoder_seq: int, weights: str,
                    batch: str) -> dict:
    """The port's own unsharded `make_serve_fns` run of the
    encoder-decoder ``arch`` (smoke, float32, at ``encoder_seq``) on the
    worker's files: the prompt and frames prefilled, the stream
    teacher-forced. Returns {"logits", "state"} as numpy."""
    import torch

    from repro_torch.checkpoint import bridge
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import make_serve_fns
    from torch_dist_worker import load_tree
    pcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype="float32", encoder_seq=encoder_seq)
    params = bridge.params_from_numpy(load_tree(weights), pcfg, "cpu")
    data = load_tree(batch)
    init, prefill, decode = make_serve_fns(pcfg, max_len=MAX_LEN,
                                           device="cpu")
    toks = torch.from_numpy(data["tokens"])
    lg, state = prefill(params, {"tokens": toks, "frames": torch.from_numpy(
        data["frames"])}, init(B))
    logits = [lg.numpy()]
    pos = torch.full((B,), toks.shape[1], dtype=torch.int32)
    for tok in data["stream"]:
        lg, state = decode(params, torch.from_numpy(tok[:, None]), state,
                           pos)
        logits.append(lg.numpy())
        pos = pos + 1
    return {"logits": np.stack(logits),
            "state": bridge.serve_state_to_numpy(state, pcfg)}


def serve_task(arch, mesh, weights, batch, result, **kw) -> dict:
    return {"kind": "serve", "arch": arch, "mesh": MESHES[mesh],
            "axes": AXES, "weights": weights, "batch": batch,
            "max_len": MAX_LEN, "result": str(result), **kw}


def tp_sent(cfg, mesh: str, mode: str, S: int, paged: bool, *,
            rules: str = "default", only: str | None = None,
            state_quant: bool = False) -> dict:
    """The bytes a rank sends, by "op:axes" (`Mesh.stats`' ring counts,
    each call's count rounded down), over one tensor-parallel serving
    step of ``cfg`` (float32) on ``mesh``: ``mode`` "decode" (S 1),
    "prefill" (make_serve_fns' whole prompt of S tokens) or "chunk"
    (make_chunk_prefill_fn's). Reckoned from the shapes alone, per layer
    by kind: the embedding's all-reduce; an attention layer's heads
    gathered (the rank's outputs over a pool of its kv heads or in a
    prompt; Q, K and V over a cache holding every head), a contiguous
    prompt's K/V, the sequence-sharded cache's flash partials and
    per-channel absmax, the ``wo`` columns; an RG-LRU's hidden and its
    ``w_out`` columns (state_quant: its rows' absmax MAX); an mLSTM's
    q / k / v heads gathered and its readout all-reduced (decode) or its
    final state refit from heads to key dims and its hidden gathered
    (prefill), and its ``wo`` columns; an sLSTM's previous and new h and
    its n's rows (the state only: whole weights); the FFN's hidden
    activations and output columns; whisper's encoder (heads, ``wo``
    and MLP columns over every frame), its cross K/V and heads, its
    cross caches' absmax and its decode step's q heads and partials; and
    the last position's logits over the rows' and vocabulary's axes:
    activations only. ``rules`` "ssm": "model" takes the rows, nothing
    is cut. ``only``: one layer of that kind's mixer alone (the
    worker's ``recurrent`` task)."""
    n_d, n_m = MESHES[mesh]
    ssm = rules == "ssm"                # "model" holds rows: no cut
    Bl, a = B // (n_d * n_m if ssm else n_d), 4
    n_cut = 1 if ssm else n_m
    H, Hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    kv = Hkv % n_m == 0
    q = H % n_m == 0 and (kv or (H // Hkv) % (H // n_m) == 0)
    tok = Bl * S
    out = {}

    def add(key, numel, n=n_cut, elsize=a, reduce=False):
        if n > 1:
            out[key] = out.get(key, 0) + int(numel * elsize * (2 if reduce
                                                                else 1)
                                              * (n - 1) / n)

    def attn(tok, cache, ctok=None):
        """One attention layer: ``cache`` "paged", "contiguous", "cross"
        (whisper's, ``ctok`` the encoder's tokens) or None (its
        encoder's); the queries' ``tok`` tokens."""
        if cache == "paged" and kv:             # the rank's kv heads
            add("all_gather:model", H * tok * hd)
        elif mode == "prefill":
            if kv and cache is not None:        # the cache's K and V
                add("all_gather:model", 2 * Hkv * (ctok or tok) * hd)
            if q:                               # the flash's heads
                add("all_gather:model", H * tok * hd)
            if cache == "cross" or (
                    cache == "contiguous"
                    and cfg.quant.granularity == "per_channel"):
                add("all_reduce_max:model", 2 * Bl * Hkv * hd, reduce=True)
        elif cache == "cross":                  # q's heads
            add("all_gather:model", (H if q else 0) * tok * hd)
            add("all_gather:model", n_m * Bl * H * (hd + 2))
        else:                                   # every head everywhere
            add("all_gather:model", ((H if q else 0) + (2 * Hkv if kv
                                                        else 0)) * tok * hd)
            if cache == "contiguous" and mode == "decode":
                add("all_gather:model", n_m * Bl * H * (hd + 2))
        add("all_gather:model", tok * d)                   # wo

    def ffn(tok):
        if cfg.n_experts:
            C = int(max(8, round(cfg.top_k * S / cfg.n_experts
                                 * cfg.capacity_factor)))
            add("all_gather:model", cfg.n_experts * Bl * C * cfg.moe_d_ff)
            if cfg.n_shared_experts:
                add("all_gather:model",
                    tok * cfg.moe_d_ff * cfg.n_shared_experts)
        else:
            add("all_gather:model", tok * cfg.d_ff)
        add("all_gather:model", tok * d)                   # w_down

    def recurrent(kind):
        nh, dh, w = H, d // H, cfg.rnn_width
        if kind == "rglru":
            if state_quant and mode == "decode":
                add("all_reduce_max:model", Bl, reduce=True)
            add("all_gather:model", tok * w)               # the hidden
            add("all_gather:model", tok * d)               # w_out
        elif kind == "mlstm":
            if mode == "decode":
                add("all_gather:model", 3 * tok * d)       # q, k, v
                if dh % n_m == 0:                          # the readout
                    add("all_reduce_sum:model", Bl * nh * (dh + 1),
                        reduce=True)
            elif nh % n_m == 0:           # C, n, m, C_s: heads -> keys
                add("all_gather:model", Bl * nh * (dh * dh + 2 * dh + 1))
            if mode != "decode":
                add("all_gather:model", tok * d)           # the hidden
            add("all_gather:model", tok * d)               # wo
        elif ssm:               # slstm: n whole over its rows, its
            if mode == "decode":  # channels over "model"
                add("all_gather:model", B * d, n=n_m)      # n, read
            add("all_gather:data+model", B * d, n=n_d * n_m)  # n, kept
        else:
            if mode == "decode":
                add("all_gather:model", 2 * Bl * d)        # h, twice
            add("all_gather:data", B * d // (n_m if mode == "decode"
                                             else 1), n=n_d)  # n's rows
    if only is not None:
        recurrent(only)
        return out
    add("all_reduce_sum:model", tok * d, reduce=True)     # the embedding
    if cfg.family == "encdec":
        T = cfg.encoder_seq
        if mode == "prefill":
            for _ in range(cfg.n_encoder_layers):
                attn(Bl * T, None)
                ffn(Bl * T)
        for _ in range(cfg.n_layers):
            attn(tok, "contiguous")
            attn(tok, "cross", Bl * T)
            ffn(tok)
    else:
        for i in range(cfg.n_layers):
            kind = cfg.block_kind(i)
            if kind in ("attn", "local_attn", "moe"):
                attn(tok, "paged" if paged else "contiguous")
            else:
                recurrent(kind)
            if cfg.d_ff or cfg.n_experts:
                ffn(tok)
    vp = -(-cfg.vocab // 128) * 128
    axes = "+".join(a for a, n in zip(AXES, MESHES[mesh]) if n > 1)
    add(f"all_gather:{axes}", B * vp, n=math.prod(MESHES[mesh]))
    return out


def check_tensor_parallel(got, cfg, mesh: str, label: str, *, paged=False,
                          prefill: str | None = "prefill", s: int = S,
                          rules: str = "default", only: str | None = None,
                          state_quant: bool = False):
    """A tensor-parallel rank's serving (`torch_dist_worker._held_params`
    and the bytes its steps sent): its parameters' storages, after the
    run, exactly the bytes its serving specs give its shards, none of the
    leaves the specs split held whole (and some split; under ``rules``
    "ssm", where "model" holds rows, none split), and every decode
    step's and the prefill's (``prefill``, the route: "prefill" or
    "chunk"; None: none, a carried state; ``s`` tokens a row) bytes by
    collective as `tp_sent` reckons them, activations only: no weight
    byte gathered. ``only``: one layer of that kind's mixer (the
    worker's ``recurrent`` task)."""
    p = got["params"]
    assert p["held_bytes"] == p["spec_bytes"], (label, p)
    assert p["split_whole"] == 0, (label, p)
    assert (p["split"] > 0) == (rules != "ssm"), (label, p)
    kw = dict(rules=rules, only=only, state_quant=state_quant)
    want = tp_sent(cfg, mesh, "decode", 1, paged, **kw)
    sent = got.get("decode_sent", {})           # an empty dict is no key
    assert {k: int(v) for k, v in sent.items()} == want, (label, sent, want)
    assert set(got["sent"].tolist()) == {sum(want.values())}, (
        label, got["sent"], want)
    if prefill is not None:
        want = tp_sent(cfg, mesh, prefill, s, paged, **kw)
        sent = got.get("prefill_sent", {})
        assert {k: int(v) for k, v in sent.items()} == want, (label, sent,
                                                               want)


def close_int8(got, want, label):
    """The page rule."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max(initial=0) <= 1, (label, d.max())
    assert (d > 0).mean() <= INT8_STEP_FRAC, (label, (d > 0).mean())


def check_logits(got, ref, vocab: int, label: str):
    """Logits within ATOL and the greedy tokens identical (the argmax of
    every step, teacher-forced on the reference's stream)."""
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0, err_msg=label)
    np.testing.assert_array_equal(np.argmax(got[..., :vocab], -1),
                                  np.argmax(ref[..., :vocab], -1),
                                  err_msg=label)


def check_contiguous(got, ref, where, label, flushed: int | None = None):
    """A rank's contiguous cache (its rows, slots and scale rows) against
    the reference cache's slice: int8 values by the page rule, scale rows
    within SCALE_RTOL, the bf16 residual within RESID_RTOL, the length
    equal. ``flushed``: the first scale row of a per-block cache that a
    decode step flushed from the bf16 residual; those rows are the
    absmax of bf16 values, which move by one bf16 step where the two
    packages' float32 K/V round to either side of a bf16 boundary, so
    they are held within RESID_RTOL."""
    r, t, s = (slice(*where[k]) for k in ("rows", "slots", "scales"))
    for key in ref:
        if key == "tail":
            continue
        g, w = got[key], ref[key]
        for n in ("k_q", "v_q"):
            assert g[n].shape == w[n][:, r, :, t].shape, (label, n)
            close_int8(g[n], w[n][:, r, :, t], f"{label} {n}")
        for n in ("k_s", "v_s"):
            want = w[n][:, r, :, s]
            f = want.shape[3] if flushed is None else \
                min(max(flushed - s.start, 0), want.shape[3])
            for cut, rtol in ((slice(0, f), SCALE_RTOL),
                              (slice(f, None), RESID_RTOL)):
                np.testing.assert_allclose(g[n][:, :, :, cut],
                                           want[:, :, :, cut], rtol=rtol,
                                           atol=0, err_msg=f"{label} {n}")
        for n in ("resid_k", "resid_v"):
            np.testing.assert_allclose(g[n], w[n][:, r], rtol=RESID_RTOL,
                                       atol=1e-30, err_msg=f"{label} {n}")
        np.testing.assert_array_equal(g["length"], w["length"],
                                      err_msg=label)


def layer_leaf(tree, cfg, i: int) -> dict:
    """Layer ``i``'s fields in the bridge's stacked layout (``p{j}`` with
    its group axis, ``tail``)."""
    period = len(cfg.block_pattern)
    n_groups = cfg.n_layers // period
    if i >= n_groups * period:
        return tree["tail"][i - n_groups * period]
    return {f: v[i // period] for f, v in tree[f"p{i % period}"].items()}


def check_state(got, ref, slices, cfg, label):
    """Every layer of a rank's state (a ring cache, or a recurrent state)
    against the reference state's slice where the rank's specs put its
    shard (``slices``, the worker's `_slices`): int8 values by the page
    rule, scale rows within SCALE_RTOL, the bf16 residual within
    RESID_RTOL, lengths equal, and a recurrent state's float leaves
    within STATE_TOL of the leaf's largest |value|."""
    for i in range(cfg.n_layers):
        g, w = layer_leaf(got, cfg, i), layer_leaf(ref, cfg, i)
        for f in g:
            name = f"{label} layer {i} {f}"
            if f == "length":
                np.testing.assert_array_equal(g[f], w[f], err_msg=name)
                continue
            want = w[f][tuple(slice(*se) for se in slices[f"{i}.{f}"])]
            assert g[f].shape == want.shape, (name, g[f].shape, want.shape)
            if g[f].dtype == np.int8:
                close_int8(g[f], want, name)
            elif f in ("k_s", "v_s"):
                np.testing.assert_allclose(g[f], want, rtol=SCALE_RTOL,
                                           atol=0, err_msg=name)
            elif f.startswith("resid"):
                np.testing.assert_allclose(g[f], want, rtol=RESID_RTOL,
                                           atol=1e-30, err_msg=name)
            else:
                err = np.abs(g[f] - want).max(initial=0)
                assert err <= STATE_TOL * np.abs(w[f]).max(initial=0), (
                    name, err, np.abs(w[f]).max(initial=0))


def recurrent_reference(arch: str, kind: str, state_quant: bool,
                        steps: int, path) -> dict:
    """The reference's decode of the first ``kind`` layer of ``arch``'s
    smoke model (`mlstm_step` / `apply_step`, ``state_quant`` as given)
    from its initial state (int8 under state_quant), ``steps`` seeded
    inputs of B rows, jitted; writes the layer's weights and the inputs
    to ``path`` for `recurrent_task`. Returns {"out" (steps, B, 1, d),
    "state": the final state's fields}."""
    from repro.models import rglru as RG
    from repro.models import xlstm as RX
    rcfg, rparams = models(arch)
    i = list(rcfg.block_pattern).index(kind)
    lp = jax.tree.map(lambda a: a[0], rparams["blocks"][f"p{i}"][kind])
    x = np.random.RandomState(5).randn(steps, B, 1, rcfg.d_model).astype(
        np.float32)
    if kind == "mlstm":
        state = RX.mlstm_init_state(rcfg, B, state_quant=state_quant)
        step = jax.jit(lambda s, t: RX.mlstm_step(
            lp, t, rcfg, s, state_quant=state_quant))
    else:
        state = RG.init_state(rcfg, B)
        step = jax.jit(lambda s, t: RG.apply_step(
            lp, t, rcfg, s, state_quant=state_quant))
    outs = []
    for t in range(steps):
        out, state = step(state, jnp.asarray(x[t]))
        outs.append(np.asarray(out))
    save_tree(path, {"weights": jax.tree.map(np.asarray, lp), "x": x})
    return {"out": np.stack(outs),
            "state": {f.name: np.asarray(getattr(state, f.name))
                      for f in dataclasses.fields(state)}}


def recurrent_task(arch, kind, mesh, state_quant, rules, inputs,
                   result) -> dict:
    return {"kind": "recurrent", "arch": arch, "layer_kind": kind,
            "mesh": MESHES[mesh], "axes": AXES, "state_quant": state_quant,
            "rules": rules, "inputs": str(inputs), "result": str(result)}


def check_recurrent(ref, ranks, label):
    """Each rank's outputs (its rows) within ATOL, and its state's shards
    against the reference state's slices (int8 by the page rule, floats
    within STATE_TOL of the leaf's largest |value|)."""
    for r, got in enumerate(ranks):
        rows = slice(*got["rows"])
        np.testing.assert_allclose(got["out"], ref["out"][:, rows],
                                   atol=ATOL, rtol=0,
                                   err_msg=f"{label} rank {r}")
        for f, g in got["state"].items():
            w = ref["state"][f]
            want = w[tuple(slice(*se) for se in got["slices"][f])]
            name = f"{label} rank {r} {f}"
            assert g.shape == want.shape, (name, g.shape, want.shape)
            if g.dtype == np.int8:
                close_int8(g, want, name)
            else:
                err = np.abs(g - want).max(initial=0)
                assert err <= STATE_TOL * np.abs(w).max(initial=0), (
                    name, err)


def page_values(q: np.ndarray, kv_dtype: str) -> np.ndarray:
    """Stored page values as integers one quantization step apart: int8
    as it is, int4 unpacked to its nibbles (on its token axis, the one
    before last), fp8 codes (their bytes) as signed magnitudes."""
    if kv_dtype == "int4":
        import torch

        from repro_torch.core.quantization import unpack_int4
        t = torch.from_numpy(np.ascontiguousarray(q)).movedim(-3, -2)
        return unpack_int4(t).movedim(-2, -3).numpy().astype(np.int32)
    q = q.astype(np.int32)
    if kv_dtype == "fp8_e4m3":
        mag = q & 0x7F
        return np.where(q < 0, -mag, mag)
    return q


def _stacked(layers):
    """A stack position's layers (stacked arrays, or a mixed plan's list
    of layers) -> one tree a layer, each leaf with a layer axis of 1."""
    if isinstance(layers, list):
        cut = [lambda a: np.asarray(a)[None]] * len(layers)
        return [{k: ({n: f(a) for n, a in v.items()} if isinstance(v, dict)
                     else f(v)) for k, v in c.items()}
                for f, c in zip(cut, layers)]
    n = len(layers["length"])
    return [{k: ({f: a[g:g + 1] for f, a in v.items()} if isinstance(v, dict)
                 else v[g:g + 1]) for k, v in layers.items()}
            for g in range(n)]


def check_paged(got, ref, where, label):
    """A rank's paged cache against the reference's: its rows' page
    tables, lengths and residuals (its kv heads), and its pool's pages
    of its rows at its kv heads (values by the page rule, scale rows
    within SCALE_RTOL). A rank's pool holds the pages of its own rows:
    the replicas over "data" are not kept alike, as no rank reads
    another's rows' pages."""
    r, h = slice(*where["rows"]), slice(*where["heads"])
    for key in ref:
        if key == "tail":
            continue
        for i, (g, w) in enumerate(zip(_stacked(got[key]),
                                       _stacked(ref[key]))):
            _check_paged_layer(g, w, r, h, f"{label} {key}[{i}]", "int8")


def check_paged_formats(got, ref, where, label, ruled: dict):
    """`check_paged` on the layers ``ruled`` names ((``p{i}``, group) ->
    page dtype: every layer above stores int8); on the others, the rows'
    tables and lengths equal and their pages' scale rows written in the
    same places (off their initial 1e-30)."""
    r, h = slice(*where["rows"]), slice(*where["heads"])
    for key in ref:
        if key == "tail":
            continue
        for i, (g, w) in enumerate(zip(_stacked(got[key]),
                                       _stacked(ref[key]))):
            tag = f"{label} {key}[{i}]"
            if (key, i) in ruled:
                _check_paged_layer(g, w, r, h, tag, ruled[(key, i)])
                continue
            np.testing.assert_array_equal(g["page_table"],
                                          w["page_table"][:, r])
            np.testing.assert_array_equal(g["length"], w["length"][:, r])
            pages = np.unique(w["page_table"][:, r])
            for n in ("k_s", "v_s"):
                written = [x[:, pages] != np.float32(1e-30) for x in
                           (g["pool"][n], w["pool"][n][:, :, h])]
                np.testing.assert_array_equal(*written, err_msg=f"{tag} {n}")


def _check_paged_layer(g, w, r, h, label, dt):
    np.testing.assert_array_equal(g["page_table"], w["page_table"][:, r])
    np.testing.assert_array_equal(g["length"], w["length"][:, r])
    for n in ("resid_k", "resid_v"):
        np.testing.assert_allclose(g[n], w[n][:, r, h], rtol=RESID_RTOL,
                                   atol=1e-30, err_msg=f"{label} {n}")
    pages = np.unique(w["page_table"][:, r])
    for n in POOL:
        gp, wp = g["pool"][n][:, pages], w["pool"][n][:, pages]
        wp = wp[:, :, h] if n.endswith("_s") else wp[:, :, :, h]
        assert gp.shape == wp.shape, (label, n, gp.shape, wp.shape)
        if n.endswith("_s"):
            np.testing.assert_allclose(gp, wp, rtol=SCALE_RTOL, atol=0,
                                       err_msg=f"{label} {n}")
        else:
            close_int8(page_values(gp, dt), page_values(wp, dt),
                       f"{label} {n}")
