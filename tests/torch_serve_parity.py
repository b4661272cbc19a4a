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
MESHES = {"2x2": [2, 2], "1x4": [1, 4]}
AXES = ["data", "model"]
CACHE = ("k_q", "v_q", "k_s", "v_s", "resid_k", "resid_v", "length")
POOL = ("k_q", "v_q", "k_s", "v_s")
VIEW = ("page_table", "resid_k", "resid_v", "length")


def models(arch: str, granularity: str = "per_block"):
    """(reference cfg, reference params) of ``arch``'s smoke config in
    float32 at ``granularity``."""
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
    """The reference's serving state -> numpy in the bridge's layout."""
    def fields(c):
        if hasattr(c, "pool"):
            return {"pool": {f: to_numpy(getattr(c.pool, f)) for f in POOL},
                    **{f: to_numpy(getattr(c, f)) for f in VIEW}}
        return {f: to_numpy(getattr(c, f)) for f in CACHE}
    return {k: ([fields(c) for c in v] if k == "tail" else fields(v))
            for k, v in state.items()}


def page_table(n_pages: int, max_len: int, block: int) -> np.ndarray:
    """Every row's pages from the reference's `HostPageAllocator`, in the
    worker's order (`allocate_rows`): the table each rank's replicated
    allocator must hand out."""
    from repro.core.paging import HostPageAllocator
    return allocate_rows(HostPageAllocator(n_pages), B, max_len // block)


def run_reference(rcfg, rparams, toks, *, paged=False, chunk=False,
                  n_pages=None, max_len=MAX_LEN, steps=STEPS) -> dict:
    """Prefill ``toks`` (B, S) (``chunk``: one chunk through
    `make_chunk_prefill_fn`), then ``steps`` greedy decode steps, jitted
    and unsharded: {"logits" (steps + 1, B, Vp), "stream" (steps, B) the
    tokens fed, "prefill_state" and "state" as numpy, "table" the page
    table where paged}."""
    out = {}
    with pallas_interpret():
        init, prefill, decode = RE.make_serve_fns(rcfg, max_len=max_len,
                                                  paged=paged,
                                                  n_pages=n_pages)
        state = init(B)
        if paged:
            table = page_table(state["p0"].pool.k_q.shape[1], max_len,
                               rcfg.quant.block_size)
            state["p0"] = dataclasses.replace(
                state["p0"], page_table=jnp.broadcast_to(
                    jnp.asarray(table), state["p0"].page_table.shape))
            out["table"] = table
        t = jnp.asarray(toks)
        if chunk:
            fn = jax.jit(RE.make_chunk_prefill_fn(rcfg))
            lg, state = fn(rparams, t, state, jnp.zeros(B, jnp.int32),
                           jnp.full(B, toks.shape[1], jnp.int32),
                           jnp.ones(B, bool))
        else:
            lg, state = jax.jit(prefill)(rparams, {"tokens": t}, state)
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


def tokens(rcfg, seed: int = 1, s: int = S) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, rcfg.vocab,
                                               (B, s)).astype(np.int32)


def write_inputs(d, key: str, rparams, toks, ref) -> tuple[str, str]:
    """The reference's weights and the batch (prompts, tokens fed) as the
    worker reads them: (weights path, batch path)."""
    w, b = d / f"{key}.w.npz", d / f"{key}.b.npz"
    save_tree(w, jax.tree.map(np.asarray, rparams))
    save_tree(b, {"tokens": toks, "stream": ref["stream"]})
    return str(w), str(b)


def serve_task(arch, mesh, weights, batch, result, **kw) -> dict:
    return {"kind": "serve", "arch": arch, "mesh": MESHES[mesh],
            "axes": AXES, "weights": weights, "batch": batch,
            "max_len": MAX_LEN, "result": str(result), **kw}


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


def check_contiguous(got, ref, where, label):
    """A rank's contiguous cache (its rows, slots and scale rows) against
    the reference cache's slice: int8 values by the page rule, scale rows
    within SCALE_RTOL, the bf16 residual within RESID_RTOL, the length
    equal."""
    r, t, s = (slice(*where[k]) for k in ("rows", "slots", "scales"))
    for key in ref:
        if key == "tail":
            continue
        g, w = got[key], ref[key]
        for n in ("k_q", "v_q"):
            assert g[n].shape == w[n][:, r, :, t].shape, (label, n)
            close_int8(g[n], w[n][:, r, :, t], f"{label} {n}")
        for n in ("k_s", "v_s"):
            np.testing.assert_allclose(g[n], w[n][:, r, :, s],
                                       rtol=SCALE_RTOL, atol=0,
                                       err_msg=f"{label} {n}")
        for n in ("resid_k", "resid_v"):
            np.testing.assert_allclose(g[n], w[n][:, r], rtol=RESID_RTOL,
                                       atol=1e-30, err_msg=f"{label} {n}")
        np.testing.assert_array_equal(g["length"], w["length"],
                                      err_msg=label)


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
        g, w = got[key], ref[key]
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
                close_int8(gp, wp, f"{label} {n}")
