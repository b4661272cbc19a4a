"""`optim.compression.int8_psum` (the compressed all-reduce: each rank's
int8 payload and float32 scale row all-gathered, the dequantized
payloads summed in rank order) against the reference's ``int8_psum``
under ``shard_map_compat`` on 4 forced host devices (a fresh process:
the device count is fixed when JAX starts; meshes with Auto axes), over
4 ranks (a (1, 4) mesh) and over 2 (the "model" axis of a (2, 2) mesh),
4 gloo ranks of tests/torch_dist_worker.py. They agree within the
summation order: |a - b| <= 4 ulp of the sum of the magnitudes."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from torch_dist import run_ranks

SRC = Path(__file__).resolve().parents[1] / "src"

REFERENCE = textwrap.dedent("""
    import sys
    import jax
    import numpy as np
    from jax.sharding import AxisType, PartitionSpec as P
    from repro.optim.compression import int8_psum
    from repro.parallel.shard import shard_map_compat
    x = np.load(sys.argv[1])
    auto = lambda n: (AxisType.Auto,) * n
    m4 = jax.make_mesh((4,), ("model",), axis_types=auto(1))
    m2 = jax.make_mesh((2, 2), ("data", "model"), axis_types=auto(2))
    def run(mesh, xs):
        f = shard_map_compat(lambda g: int8_psum(g[0], "model")[None],
                             mesh=mesh, in_specs=P("model"),
                             out_specs=P("model"))
        return np.asarray(jax.jit(f)(xs))
    np.savez(sys.argv[2], four=run(m4, x), two=run(m2, x[:2]))
""")


@pytest.fixture(scope="module")
def sums(tmp_path_factory):
    d = tmp_path_factory.mktemp("psum")
    rng = np.random.RandomState(7)
    # channels of mixed magnitude, a (d, 1)-like width no multiple of 4
    x = (rng.randn(4, 48, 30) * 10.0 ** rng.randint(-4, 2, (1, 1, 30))
         ).astype(np.float32)
    np.save(d / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    subprocess.run([sys.executable, "-c", REFERENCE, str(d / "x.npy"),
                    str(d / "ref.npz")], check=True, env=env, timeout=300)
    run_ranks(d, 4, [
        {"kind": "psum", "mesh": [1, 4], "axes": ["data", "model"],
         "over": "model", "inputs": str(d / "x.npy"),
         "result": str(d / "four.npy")},
        {"kind": "psum", "mesh": [2, 2], "axes": ["data", "model"],
         "over": "model", "inputs": str(d / "x.npy"),
         "result": str(d / "two.npy")}], name="psum")
    ref = np.load(d / "ref.npz")
    sent = {n: json.loads((d / f"{n}.npy.json").read_text())
            for n in ("four", "two")}
    return x, ref, {n: np.load(d / f"{n}.npy") for n in ("four", "two")}, \
        sent


@pytest.mark.parametrize("n", ["four", "two"])
def test_int8_psum_matches_reference(sums, n):
    x, ref, got, _ = sums
    k = 4 if n == "four" else 2
    bound = 4 * np.finfo(np.float32).eps * (
        np.abs(x[:k]).sum(0) + np.abs(x[:k]).max(1, keepdims=True).sum(0))
    want = ref[n]
    assert want.shape == (k, 48, 30)
    # every rank holds the same sum, the reference's within the order
    for r in range(got[n].shape[0]):
        np.testing.assert_array_less(np.abs(got[n][r] - want[0]),
                                     bound + 1e-30)
    # and it is the compressed sum: int8 steps from the exact one
    step = np.abs(x[:k]).max(1, keepdims=True).sum(0) / 127
    assert (np.abs(want[0] - x[:k].sum(0)) <= step).all()
    assert np.abs(want[0] - x[:k].sum(0)).max() > 0


@pytest.mark.parametrize("n", ["four", "two"])
def test_int8_psum_sends_int8_payloads(sums, n):
    """On the wire (`Mesh.stats`, bytes a rank sends on a ring): each
    rank's int8 payload (48 x 32 channels, padded to 16-byte rows) and
    its float32 scale row, all-gathered over "model"; nothing else."""
    k = 4 if n == "four" else 2
    sent = sums[3][n]
    assert sent == {"all_gather:model": (k * 48 * 32 + k * 32 * 4)
                    * (k - 1) / k}
    # a float32 ring all-reduce of the same gradient sends 2 x 4 bytes an
    # element (n - 1) / n
    assert sent["all_gather:model"] < 2 * 48 * 30 * 4 * (k - 1) / k
