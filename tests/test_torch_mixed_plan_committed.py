"""The committed per-layer plan, PLAN_kv_mixed.json (int4, int8, int4,
int4), on the 4-layer smoke model and through the serve CLI's
``--kv-cache-plan``: the port against the reference on the CPU (helpers
in tests/test_torch_mixed_plan_stacks.py)."""
import json

import jax
import pytest

from test_torch_mixed_plan import PLAN_JSON
from test_torch_mixed_plan_stacks import check_stack
from torch_parity import pallas_interpret  # noqa: F401  (fixture)

jax.config.update("jax_platform_name", "cpu")


def test_committed_plan_stack_matches_reference(pallas_interpret):
    """The committed plan by path on 4 layers: tokens, reports and memory
    reports identical; layer 0 within the page rule, the layers below
    its int4 layer 0 by place."""
    rep, ruled = check_stack(4, PLAN_JSON)
    assert rep["kv_cache_layer_dtypes"] == ["int4", "int8", "int4", "int4"]
    assert ruled == [0]


def _cli_lines(out: str) -> dict:
    lines = out.splitlines()
    reqs = []
    for ln in lines:
        if ln.startswith("  req "):
            head, rest = ln.strip().split(": ", 1)
            toks = rest[:rest.index("]") + 1]
            reqs.append((head, len(json.loads(toks)),
                         rest.split("finish=")[1].split(",")[0].rstrip(")")))
    pick = lambda key: [ln for ln in lines if key in ln]
    return {"reqs": reqs, "plan": pick("[serve] precision plan:"),
            "pool": pick("[serve] page pool:"),
            "ticks": [ln.split("over ")[-1] for ln in pick(" ticks)")]}


def test_serve_cli_kv_cache_plan(capsys):
    """`--smoke --layers 4 --kv-cache-plan PLAN_kv_mixed.json` through both
    CLIs: the same precision plan and page pool lines, and the same
    `req N:` lines up to their tokens (uids, token counts, finish
    reasons; the CLIs' random weights differ)."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    argv = ["--arch", "internlm2_1_8b", "--smoke", "--layers", "4",
            "--batch", "2", "--max-len", "64", "--requests", "3",
            "--prompt-len", "13", "--max-new", "4",
            "--kv-cache-plan", PLAN_JSON]
    got = []
    for main, extra in ((ref_serve.main, []), (serve.main, ["--device",
                                                            "cpu"])):
        assert main(argv + extra) == 0
        got.append(_cli_lines(capsys.readouterr().out))
    ref, port = got
    assert port == ref
    assert port["plan"] == ["[serve] precision plan: int4/int8/int4/int4 "
                            "(25% page bytes saved vs uniform int8)"]
    assert len(port["reqs"]) == 3


def test_serve_cli_plan_excludes_dtype(capsys):
    """`--kv-cache-plan` with `--kv-cache-dtype` is a usage error in both
    CLIs, with the same message."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve
    argv = ["--arch", "internlm2_1_8b", "--smoke", "--kv-cache-plan",
            PLAN_JSON, "--kv-cache-dtype", "int4"]
    errs = []
    for main in (ref_serve.main, serve.main):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert errs[0] == errs[1] and "mutually exclusive" in errs[1]
